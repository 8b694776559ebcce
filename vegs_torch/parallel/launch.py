"""Start the ranks of a mesh on this host (the single-process launch of the
JAX package, which `shard_map`s inside one process).

`spawn(fn, world_size, *args, backend=, init_file=)` starts `world_size`
processes with the `spawn` start method (the parent may have touched CUDA;
`fork` would copy its CUDA context), each in a process group that meets over
`file://<init_file>`, and calls `fn(rank, *args)` in each. Under NCCL rank r
uses card r. Each rank's return value is written next to the rendezvous
file with `torch.save` and handed back in rank order. A rank that raises
makes the whole call raise (the others are stopped), with the traceback of
every rank that failed.
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _result_path(init_file: str, rank: int) -> Path:
    return Path(f"{init_file}.rank{rank}.pt")


def _error_path(init_file: str, rank: int) -> Path:
    return Path(f"{init_file}.rank{rank}.err")


def _entry(rank, fn, world_size, backend, init_file, threads, args):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world_size, rank=rank)
        try:
            result = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        # every failing rank's own traceback: the one the parent is told of
        # first may be a peer's lost connection
        _error_path(init_file, rank).write_text(traceback.format_exc())
        raise
    torch.save(result, _result_path(init_file, rank))


def spawn(fn, world_size: int, *args, backend: str, init_file,
          threads: Optional[int] = None) -> list:
    """Run fn(rank, *args) on `world_size` local ranks; return their
    results in rank order. `fn` must be importable by the children (a
    module-level function), and `init_file` a path that does not exist yet
    (its directory does). `threads` sets each rank's intra-op threads;
    by default gloo ranks share the host's cores (ranks that each take
    every core spin against one another), NCCL ranks keep PyTorch's
    default."""
    init_file = os.fspath(init_file)
    if threads is None and backend == "gloo":
        threads = max(1, (os.cpu_count() or 1) // world_size)
    if os.path.exists(init_file):
        raise FileExistsError(f"rendezvous file {init_file} exists")
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise ValueError(f"nccl needs a card per rank: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards")
    try:
        mp.start_processes(_entry, args=(fn, world_size, backend, init_file,
                                         threads, args),
                           nprocs=world_size, join=True, start_method="spawn")
    except Exception as e:
        errors = [f"rank {r}:\n{_error_path(init_file, r).read_text()}"
                  for r in range(world_size)
                  if _error_path(init_file, r).exists()]
        raise RuntimeError("ranks failed\n" + "\n".join(errors)) from e
    out = []
    for r in range(world_size):
        p = _result_path(init_file, r)
        out.append(torch.load(p, weights_only=False))
        p.unlink()
    return out
