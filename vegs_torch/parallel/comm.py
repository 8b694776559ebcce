"""Collectives on a process group: what `shard_map` gave the JAX package.

The JAX package runs one process and `shard_map`s over a mesh; the port runs
one process per rank, and rank r does what device r of the JAX mesh does.
Every `psum`, `pmax`, `all_gather` and `all_to_all` of the JAX code is an
explicit collective here, on one axis of a `mesh.Mesh` (a `Comm`: the
process group of this rank's row or column). Where the JAX code
differentiates through a collective, the port's carries a gradient:

  * `all_gather(x, comm, dim)` (tiled) -- its backward all-reduces the
    cotangent and keeps this rank's slice, the transpose of JAX's tiled
    `all_gather` (`psum_scatter`);
  * `all_to_all(x, comm)` (tiled along dim 0: chunk d goes to rank d) --
    its backward is the reverse exchange, the same `all_to_all` on the
    cotangent.

`psum`, `psum_mean`, `pmax` and `broadcast` reduce values the step does not
differentiate (gradients, statistics, metrics) and carry none.

The transport is the group's backend, which the caller chose when it
started the ranks; nothing here picks one because another failed:
  * "nccl": CUDA tensors, one rank per card;
  * "gloo" on CPU tensors (the tests);
  * "gloo" given CUDA tensors copies each collective's tensors to the host
    and back ("gloo-host"): the only way to run two ranks on one card,
    which NCCL refuses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """One mesh axis as seen from this rank: the process group (None = the
    default group), the axis's global ranks in axis order, and the
    backend."""

    def __init__(self, group, ranks, backend: str):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.backend = backend

    def transport(self, device) -> str:
        """'nccl', 'gloo', or 'gloo-host' (gloo staging CUDA tensors
        through the host) for tensors on `device`."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo-host"
        return self.backend

    def _staged(self, op, inputs, outputs=()):
        """Run `op(*inputs, *outputs)` through this group's backend, the
        outputs written in place: NCCL takes CUDA tensors only; gloo takes
        CPU tensors, and CUDA tensors through host copies (the outputs
        copied back)."""
        tensors = [*inputs, *outputs]
        dev = tensors[0].device
        if self.backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("the nccl transport takes CUDA tensors; "
                                 f"got {dev}")
            op(*tensors)
            return
        if dev.type == "cpu":
            op(*tensors)
            return
        host = [t.cpu() for t in tensors]
        op(*host)
        for t, h in zip(outputs, host[len(inputs):]):
            t.copy_(h)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def psum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Sum over the axis (a new tensor; every rank gets the same bits)."""
    y = x.detach().clone().contiguous()
    comm._staged(lambda t: dist.all_reduce(t, group=comm.group), (), (y,))
    return y


def psum_mean(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """psum(x) / axis size, as the JAX step's `_psum_mean`."""
    return psum(x, comm) / comm.size


def pmax(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    comm._staged(lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX,
                                           group=comm.group), (), (y,))
    return y


def broadcast(x: torch.Tensor, comm: Comm, src: int = 0) -> torch.Tensor:
    """The axis rank `src`'s x on every rank (x gives the shape and dtype
    on the others)."""
    y = x.detach().clone().contiguous()
    comm._staged(lambda t: dist.broadcast(t, comm.ranks[src],
                                          group=comm.group), (), (y,))
    return y


def _tree_op(tree: dict, comm: Comm, op) -> dict:
    """`op` (psum or pmax) over a dict of tensors in one collective per
    dtype: the leaves flattened into one buffer and cut back."""
    out = {}
    by_dtype: dict = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = op(torch.cat([tree[k].reshape(-1) for k in keys]), comm)
        for k, part in zip(keys, flat.split([tree[k].numel() for k in keys])):
            out[k] = part.view(tree[k].shape)
    return out


def psum_tree(tree: dict, comm: Comm) -> dict:
    return _tree_op(tree, comm, psum)


def pmax_tree(tree: dict, comm: Comm) -> dict:
    return _tree_op(tree, comm, pmax)


def broadcast_tree(tree: dict, comm: Comm, src: int = 0) -> dict:
    return _tree_op(tree, comm, lambda x, c: broadcast(x, c, src))


def checksum(tensors) -> torch.Tensor:
    """[2] int64 bit checksum of float tensors (on their device): the sum of
    their int32 views, and that sum weighted by position mod 65521. Ranks
    that hold replicated state compare theirs (`all_gather`)."""
    s = torch.zeros(2, dtype=torch.int64, device=tensors[0].device)
    for t in tensors:
        b = t.detach().float().contiguous().view(torch.int32).reshape(-1)
        b = b.to(torch.int64)
        w = torch.arange(1, b.numel() + 1, device=b.device) % 65521
        s += torch.stack([b.sum(), (b * w).sum()])
    return s


def _gather_cat(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(comm.size)]

    def op(t, *outs):
        dist.all_gather(list(outs), t, group=comm.group)

    comm._staged(op, (x,), parts)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return _gather_cat(x, comm, dim)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        total = psum(g, comm)
        return (total.narrow(ctx.dim, comm.index * ctx.n, ctx.n).contiguous(),
                None, None)


def all_gather(x: torch.Tensor, comm: Comm, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the ranks' x concatenated along `dim` in axis
    order. Backward: the cotangent summed over the axis, this rank's slice
    (JAX's transpose of a tiled `all_gather`)."""
    return _AllGather.apply(x, comm, dim)


def _exchange(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    comm._staged(lambda t, o: dist.all_to_all_single(o, t, group=comm.group),
                 (x,), (out,))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _exchange(x, comm)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.comm), None


def all_to_all(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Tiled all-to-all along dim 0 (JAX's `all_to_all(x, axis, 0, 0,
    tiled=True)`): x's rows cut into `comm.size` equal chunks, chunk d sent
    to axis rank d; the received chunks concatenated in source order.
    Backward: the reverse exchange of the cotangent."""
    if x.shape[0] % comm.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{comm.size} ranks")
    if x.requires_grad:
        return _AllToAll.apply(x, comm)
    return _exchange(x, comm)
