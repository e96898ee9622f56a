"""MPI-like collectives over replicated/per-worker state (paper §3.2).

The paper manages one copy of every Theano shared variable per GPU and
exposes NCCL collectives (broadcast, all-reduce, scatter, gather) plus
get/set on individual devices.

The port of the reference's ``core/collectives.py``.  The reference holds
per-worker state as one array with a leading worker axis over the mesh;
the port runs one process per card, so a :class:`LocalValues` holds THIS
rank's copy (a tree of tensors on its device), and each collective is the
``torch.distributed`` call over the context's group that gives every rank
what the reference's function returns:

* ``all_reduce`` — ``dist.all_reduce`` (avg/mean as a sum over the world
  size; prod as ``ReduceOp.PRODUCT``, which NCCL and gloo both have);
* ``broadcast``/``get_value``/``as_replicated`` — ``dist.broadcast`` from
  a rank; ``gather`` — ``dist.all_gather``;
* ``distribute``/``replicate`` — rank 0's values broadcast to every rank
  (the paper's master copy).

One worker without a process group makes every collective a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from . import context as ctx_mod
from .tree import map_tree

_OPS = ("avg", "mean", "sum", "max", "min", "prod")
_REDUCE = {"avg": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "prod": dist.ReduceOp.PRODUCT}


@dataclasses.dataclass
class LocalValues:
    """A tree with one value per data-parallel worker: this rank's copy,
    on its device — the paper's replicated shared variables, whose local
    updates may diverge until a collective combines them."""

    tree: Any

    def local(self, fn_tree=None):
        return self.tree


def _ctx(ctx):
    return ctx or ctx_mod.current()


def _on_device(x, ctx) -> torch.Tensor:
    """A fresh copy of ``x`` on this rank's device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.detach().to(ctx.device, copy=True).contiguous()


def _broadcast(x: torch.Tensor, root: int, ctx) -> torch.Tensor:
    x = x.detach().clone().contiguous()
    if ctx.n_data > 1:
        dist.broadcast(x, src=root, group=ctx.pg)
    return x


def distribute(tree: Any, ctx: ctx_mod.SynkContext | None = None) -> LocalValues:
    """Paper's ``synk.distribute()``: replicate state onto every worker.

    Returns per-worker copies (LocalValues) so that subsequent local updates
    may diverge, exactly as Theano shared variables replicated per GPU do.
    Every rank gets rank 0's values.
    """
    ctx = _ctx(ctx)
    return LocalValues(map_tree(lambda x: _broadcast(_on_device(x, ctx), 0, ctx), tree))


def replicate(tree: Any, ctx: ctx_mod.SynkContext | None = None) -> Any:
    """Single-copy replication: one logical tree, rank 0's values on every
    rank (the reference's replicated sharding)."""
    return distribute(tree, ctx).tree


# ---------------------------------------------------------------------------
# NCCL-style collectives over LocalValues
# ---------------------------------------------------------------------------

def all_reduce(values: LocalValues, op: str = "avg", ctx=None) -> LocalValues:
    """Paper's ``synk.all_reduce``: combine all workers' copies.

    After this call every worker holds the reduced value (NCCL all-reduce).
    """
    ctx = _ctx(ctx)
    if op not in _OPS:
        raise ValueError(f"op {op!r} not in {_OPS}")

    def per_leaf(x):
        x = x.detach().clone().contiguous()
        if ctx.n_data > 1:
            dist.all_reduce(x, op=_REDUCE[op], group=ctx.pg)
            if op in ("avg", "mean"):
                x = x / ctx.n_data
        return x

    return LocalValues(map_tree(per_leaf, values.tree))


def broadcast(values: LocalValues, root: int = 0, ctx=None) -> LocalValues:
    """NCCL broadcast: overwrite all workers' copies with ``root``'s."""
    ctx = _ctx(ctx)
    return LocalValues(map_tree(lambda x: _broadcast(x, root, ctx), values.tree))


def reduce_to(values: LocalValues, op: str = "avg", root: int = 0, ctx=None) -> Any:
    """NCCL reduce: combine copies, return the root's (reduced) value.
    Every rank gets it, as every caller of the reference's does."""
    return all_reduce(values, op=op, ctx=ctx).tree


def _stack(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every rank's copy of ``x`` stacked on a leading worker axis."""
    x = x.detach().contiguous()
    if ctx.n_data == 1:
        return x[None].clone()
    parts = [torch.empty_like(x) for _ in range(ctx.n_data)]
    dist.all_gather(parts, x, group=ctx.pg)
    return torch.stack(parts)


def gather(values: LocalValues, ctx=None) -> Any:
    """Gather per-worker copies to the host: numpy with a leading worker
    axis (every rank gets them)."""
    ctx = _ctx(ctx)
    return map_tree(lambda x: _stack(x, ctx).cpu().numpy(), values.tree)


def get_value(values: LocalValues, rank: int, ctx=None) -> Any:
    """Paper: 'get ... values on any individual GPU' (as numpy)."""
    ctx = _ctx(ctx)
    return map_tree(lambda x: _broadcast(x, rank, ctx).cpu().numpy(), values.tree)


def set_value(values: LocalValues, rank: int, new: Any, ctx=None) -> LocalValues:
    """Paper: 'set values on any individual GPU': ``rank`` takes ``new``,
    every other rank keeps its copy."""
    ctx = _ctx(ctx)
    if ctx.rank != rank:
        return LocalValues(map_tree(lambda x: x.clone(), values.tree))
    return LocalValues(map_tree(lambda x, v: _on_device(v, ctx).to(x.dtype).reshape(x.shape),
                                values.tree, new))


def scatter_shared(tree: Any, ctx=None) -> LocalValues:
    """Paper §4.2: split arrays by first axis into per-worker shared state."""
    ctx = _ctx(ctx)
    n = ctx.n_data

    def per_leaf(x):
        x = _on_device(x, ctx)
        if x.shape[0] % n != 0:
            raise ValueError(
                f"scatter_shared: leading dim {x.shape[0]} not divisible by {n}"
            )
        k = x.shape[0] // n
        return x[ctx.rank * k:(ctx.rank + 1) * k].clone()

    return LocalValues(map_tree(per_leaf, tree))


def as_replicated(values: LocalValues, check: bool = True, ctx=None) -> Any:
    """Collapse per-worker copies to one logical tree (after an all-reduce
    or broadcast made them identical): worker 0's copy on every rank.
    ``check`` raises when the copies differ (the reference's test)."""
    ctx = _ctx(ctx)

    def per_leaf(x):
        if check:
            xs = _stack(x, ctx)
            first = xs[0][None]
            same = torch.isclose(xs, first) | ~torch.isfinite(xs) & ~torch.isfinite(first)
            if not bool(same.all()):
                raise ValueError("worker copies diverged; all_reduce/broadcast first")
            return xs[0].clone()
        return _broadcast(x, 0, ctx)

    return map_tree(per_leaf, values.tree)
