"""Flattened-parameter buffers (paper §3.3).

"These store the gradients of all variables into one (flattened) array for
faster inter-GPU communication": a single contiguous fp32 buffer means the
gradient all-reduce is ONE collective (or one per bucket, see
``buckets.py``) instead of one per parameter, and the optimizer update is
one fused elementwise pass (``kernels/flat_adam``).  The buffer is padded
to a multiple of ``align`` so it splits evenly over any number of workers.

Leaf order is the reference's (``jax.tree.flatten``): dict keys sorted at
every level.  Offsets, bucket boundaries and ZeRO's scattered layout then
match the reference's element for element.

Zero-copy round trip.  :func:`unflatten` returns views into the buffer it
is given, and :func:`flatten` hands back that buffer itself when a tree is
exactly such a view (same base, the layout's offsets).  The train step
keeps its fp32 parameters and Adam moments as views of flat buffers, so
"flatten" and "unflatten" cost no copy at any step; any other tree is
copied once into a new buffer, with the same numbers.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import tree_from_leaves, tree_leaves


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    paths: tuple[tuple[str, ...], ...]     # the tree structure (sorted keys)
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    total: int                             # padded length

    @property
    def unpadded(self) -> int:
        return self.offsets[-1] + self.sizes[-1] if self.sizes else 0


def make_layout(tree, align: int = 512) -> FlatLayout:
    """Layout of ``tree``, whose leaves have ``.shape`` and ``.dtype``
    (tensors, or the meta tensors of ``registry.abstract_params``)."""
    pairs = list(tree_leaves(tree))
    shapes = tuple(tuple(l.shape) for _, l in pairs)
    dtypes = tuple(l.dtype for _, l in pairs)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    total = -(-off // align) * align if off else align
    return FlatLayout(tuple(p for p, _ in pairs), shapes, dtypes,
                      tuple(offsets), sizes, total)


def _view_base(layout: FlatLayout, leaves, dtype):
    """The flat buffer ``leaves`` are views of at the layout's offsets, or
    None."""
    base = leaves[0]._base if leaves else None
    if base is None or base.dim() != 1 or base.numel() != layout.total \
            or base.dtype != dtype:
        return None
    for leaf, off in zip(leaves, layout.offsets):
        if leaf._base is not base or not leaf.is_contiguous() \
                or leaf.storage_offset() != base.storage_offset() + off:
            return None
    return base


def flatten(layout: FlatLayout, tree, dtype=torch.float32) -> torch.Tensor:
    """One ``(layout.total,)`` buffer: every leaf in layout order, cast to
    ``dtype``, then zero padding.  Returns the base buffer itself (no copy)
    when ``tree`` is :func:`unflatten`'s view of one."""
    leaves = [l for _, l in tree_leaves(tree)]
    if len(leaves) != len(layout.sizes):
        raise ValueError(f"tree has {len(leaves)} leaves, layout {len(layout.sizes)}")
    base = _view_base(layout, leaves, dtype)
    if base is not None:
        return base
    dev = leaves[0].device if leaves else None
    parts = [l.detach().reshape(-1).to(dtype) for l in leaves]
    pad = layout.total - layout.unpadded
    if pad:
        parts.append(torch.zeros(pad, dtype=dtype, device=dev))
    return torch.cat(parts)


def unflatten(layout: FlatLayout, buf: torch.Tensor, dtype=None) -> dict:
    """Rebuild the tree from a flat buffer.  Leaves are views of ``buf``
    where no cast is needed (``dtype``, or the layout's dtype, equals
    ``buf.dtype``); ``dtype`` overrides the per-leaf dtype."""
    leaves = []
    for off, size, shape, dt in zip(layout.offsets, layout.sizes,
                                    layout.shapes, layout.dtypes):
        leaves.append(buf[off: off + size].view(shape).to(dt if dtype is None else dtype))
    return tree_from_leaves(layout.paths, leaves)


# ---------------------------------------------------------------------------
# Flat Adam (the plain formula; kernels/flat_adam fuses it on the card)
# ---------------------------------------------------------------------------


def flat_adam_update(p, g, m, v, step, *, lr, beta1=0.9, beta2=0.95, eps=1e-8):
    """One elementwise pass over the flat buffers (all fp32 1-D).  ``step``
    is the 1-based step, a tensor (on the buffers' device) or a number."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    t = torch.as_tensor(step, device=p.device).to(torch.float32)
    mhat = m / (1 - beta1 ** t)
    vhat = v / (1 - beta2 ** t)
    p = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return p, m, v
