"""Multi-device training on `torch.distributed` (port of vegs_tpu/parallel/).

The JAX package runs one process and `shard_map`s over a device mesh; the
port runs one process per rank (`launch.spawn` on one host, or one process
per rank across hosts), and rank r does what device r of the JAX mesh does.
Every collective is explicit (`comm`), on an axis of a `mesh.Mesh` of
process groups:

  * data parallel -- `vegs_torch.train.train_step(comm=...)`, the one
    step of the static field and the full model, and the Trainer that
    runs it (`dp_devices=`); `sharded_step` stacks a camera batch;
  * Gaussian-axis sharding -- `gauss_sharded`;
  * tile-axis sharding with an all-to-all splat exchange -- `tile_sharded`;
  * the fully sharded trainer, with its 2-D data x shard hybrid --
    `tp_trainer`.

The transport is the process group's backend: NCCL with one rank per card,
or gloo (CPU tensors; CUDA tensors staged through the host, "gloo-host",
the one way to run two ranks on one card).
"""

from .gauss_sharded import (  # noqa: F401
    make_gauss_mesh, make_gauss_sharded_rasterize, shard_field_arrays)
from .mesh import make_mesh  # noqa: F401
