"""Meshes of process groups (port of vegs_tpu/parallel/mesh.py and
`tp_trainer.make_dp_mesh_2d`).

A JAX `Mesh` names device axes; here a `Mesh` holds, for this rank, one
`comm.Comm` per axis: the process group of the ranks that share this rank's
coordinates on every other axis. Ranks are laid out row-major over the
axes, so on a (data, shard) mesh the shard groups are contiguous ranks,
as the JAX package keeps its heavy all-to-all on neighbouring devices.

The process group itself is started by `launch.spawn` (local ranks over a
`file://` rendezvous) or `initialize_distributed` (multi-host, over TCP).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch.distributed as dist

from .comm import Comm

DATA_AXIS = "data"


class Mesh:
    """This rank's view of a mesh: axis names, their sizes, and the `Comm`
    of each axis."""

    def __init__(self, axis_names, shape, comms):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.comms = dict(zip(self.axis_names, comms))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def comm(self, axis: Optional[str] = None) -> Comm:
        """The `Comm` of `axis` (default: the first axis)."""
        return self.comms[axis or self.axis_names[0]]

    def index(self, axis: Optional[str] = None) -> int:
        """This rank's coordinate along `axis`."""
        return self.comm(axis).index


def _world(n: int) -> tuple[int, str]:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "vegs_torch.parallel.launch.spawn or "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: the "
                         "port runs one process per mesh position")
    return world, dist.get_backend()


def make_grid_mesh(axis_names, shape) -> Mesh:
    """A mesh of the world's ranks laid out row-major over `shape`. Every
    rank creates every group, in the same order, as `dist.new_group`
    requires; an axis that spans the whole world uses the default group."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    world, backend = _world(n)
    me = dist.get_rank()
    coords = list(itertools.product(*[range(s) for s in shape]))
    comms = []
    for a, size in enumerate(shape):
        mine = None
        lines = {}
        for c in coords:  # ranks that differ only along axis a
            key = c[:a] + c[a + 1:]
            lines.setdefault(key, []).append(coords.index(c))
        for ranks in lines.values():
            if size == world:
                group = None
            else:
                group = dist.new_group(ranks)
            if me in ranks:
                mine = Comm(group, ranks, backend)
        comms.append(mine)
    return Mesh(axis_names, shape, comms)


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the world's ranks (n_devices, default the world size,
    must equal it)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return make_grid_mesh((axis_name,), (n,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "nccl") -> int:
    """Multi-host bootstrap: one process per rank, `num_processes` ranks in
    all, this one `process_id`, meeting at `tcp://coordinator_address`
    (host:port; nothing tells a program of a cluster, so all three are
    given; `tcp://host:port` is taken as well). Returns the world size; a
    no-op when a group exists."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("multi-host runs need --coordinator_address, "
                         "--num_processes and --process_id")
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()
