"""Automated input slicing with aggregation (paper §5.1).

When a function call is too large for one device invocation, the worker
computes its result by looping over ``num_slices`` subsets of its assigned
data and aggregating in place on the device.  Aggregation follows each
output's reduce spec; results are reduced across workers only once, after
the loop (paper: "Slice results are aggregated in-place on the GPU. Worker
results are reduced once back to the master process").

All slices see the *original* values of broadcast inputs (paper: "all
slices are computed using the original values, with updates accumulated and
applied only once at the end") — i.e. this is gradient accumulation when
the sliced function computes gradients.

The port of the reference's ``core/slicing.py``: a Python loop over the
slices where the reference runs a ``lax.scan``, with the same accumulators
(fp32 for bf16/fp16 means and sums) in the same order.  An eager function
could write into a broadcast input in place, which JAX cannot; the loop
checks every broadcast tensor's version counter after each slice and
raises if the function changed one.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import tree
from .specs import Reduce

ACCUMULATED = ("mean", "sum", "max", "min")


def _split_leading(x, k: int):
    b = x.shape[0]
    if b % k != 0:
        raise ValueError(
            f"num_slices={k} must divide the per-worker batch {b} "
            f"(paper pads inputs 'as equal as possible'; pass a divisible batch)"
        )
    return x.reshape((k, b // k) + tuple(x.shape[1:]))


def _acc_init(val: torch.Tensor, op: str):
    if op == "max":
        return torch.full(val.shape, -torch.inf, dtype=val.dtype, device=val.device)
    if op == "min":
        return torch.full(val.shape, torch.inf, dtype=val.dtype, device=val.device)
    # mean / sum accumulate in the output dtype; float accumulators promoted
    # to f32 to avoid bf16 drift across many slices.
    dt = val.dtype
    if dt in (torch.bfloat16, torch.float16):
        dt = torch.float32
    return torch.zeros(val.shape, dtype=dt, device=val.device)


def _acc_update(acc, val, op: str, k: int):
    if op == "mean":
        return acc + val.to(acc.dtype) / k
    if op == "sum":
        return acc + val.to(acc.dtype)
    if op == "max":
        return torch.maximum(acc, val)
    if op == "min":
        return torch.minimum(acc, val)
    raise AssertionError(op)


def _as_tensor(x, device):
    return x if torch.is_tensor(x) else torch.as_tensor(x, device=device)


def sliced_call(
    fn: Callable,
    args: Sequence[Any],
    sliced_mask: Sequence[bool],
    out_ops: Any,               # tree of Reduce matching fn's output
    num_slices: int,
):
    """Run ``fn(*args)`` as a loop over ``num_slices`` slices.

    ``sliced_mask[i]`` — whether args[i] (every tensor leaf of it) is split
    along its leading axis.  Outputs with op mean/sum/max/min are
    accumulated; ``concat``/``None`` outputs are stacked and re-flattened;
    ``last`` keeps the final slice's value.
    """
    k = num_slices
    split_args = [
        tree.map_tree(lambda x: _split_leading(x, k), a) if m else a
        for a, m in zip(args, sliced_mask)
    ]
    fixed = [x for a, m in zip(args, sliced_mask) if not m
             for x in tree.leaves(a) if torch.is_tensor(x)]
    versions = [x._version for x in fixed]
    out_tree = op_leaves = dev = dtypes = None
    accs, lasts, ys = [], [], []
    for i in range(k):
        sl_args = [tree.map_tree(lambda x: x[i], a) if m else a
                   for a, m in zip(split_args, sliced_mask)]
        out = fn(*sl_args)
        if any(x._version != v for x, v in zip(fixed, versions)):
            raise RuntimeError(
                "the sliced function wrote into a broadcast input in place; every "
                "slice must see the original values (paper §5.1)")
        flat = tree.leaves(out)
        if out_tree is None:
            out_tree = tree.map_tree(lambda _: 0, out)      # the structure only
            op_leaves = flatten_ops(out_ops, out)
            dev = next((x.device for x in flat if torch.is_tensor(x)), None)
            flat = [_as_tensor(v, dev) for v in flat]
            dtypes = [v.dtype for v in flat]
            accs = [_acc_init(v, op.op) if op.op in ACCUMULATED else None
                    for v, op in zip(flat, op_leaves)]
            lasts = [None] * len(flat)
            ys = [[] for _ in flat]
        else:
            flat = [_as_tensor(v, dev) for v in flat]
        for j, (val, op) in enumerate(zip(flat, op_leaves)):
            if op.op in ACCUMULATED:
                accs[j] = _acc_update(accs[j], val, op.op, k)
            elif op.op == "last":
                lasts[j] = val
            else:  # concat / None: stack slices
                ys[j].append(val)

    out_flat = []
    for j, op in enumerate(op_leaves):
        if op.op in ACCUMULATED:
            out_flat.append(accs[j].to(dtypes[j]))
        elif op.op == "last":
            out_flat.append(lasts[j])
        else:  # k x (b/k, ...) -> (b, ...)
            out_flat.append(torch.cat(ys[j]) if ys[j][0].dim() else torch.stack(ys[j]))
    return tree.unflatten(out_tree, out_flat)


def flatten_ops(out_ops, out) -> list[Reduce]:
    """Broadcast a Reduce spec (single or tree PREFIX) over the output
    tree: a Reduce at an interior position applies to every leaf below it
    (so ``(Reduce("mean"), Reduce(None))`` matches ``(loss, params_dict)``)."""
    flat = tree.broadcast_prefix(out_ops, out, lambda s: isinstance(s, Reduce))
    return [op if isinstance(op, Reduce) else Reduce(op) for op in flat]
