"""FSDP on the per-parameter path: the shard layout and what moves it.

The reference's default train program shards every parameter that names
an FSDP dimension (``ParamSpec.logical``) over its data axis and lets the
optimizer state inherit those shardings (``optim/rules.py``
``state_pspecs``).  Here each rank of a
:class:`~repro_torch.launch.mesh.DataGroup` holds the contiguous 1/N slice
``[r k, (r + 1) k)`` of such a leaf's FSDP dimension (``k = n / N``) as a
tensor of its own, and the same slice of its Adam moments.  A leaf whose
FSDP dimension the world does not divide raises, as the reference's
placement does (``jax.device_put`` of such a sharding raises
``ValueError``); no configuration of ``ARCH_IDS`` has one at 2, 4 or 8
ranks.

* :class:`ShardLayout` / :func:`make_shard_layout`: each leaf's FSDP
  dimension, its full and local shapes and this rank's slice;
* :func:`shard_tree` / :func:`full_tree`: full leaves to this rank's
  shards and back (the gather one leaf at a time, in slices of at most
  ``GATHER_CHUNK`` bytes, for checkpoints);
* :func:`init_shards`: exactly the values ``init`` draws for a seed, with
  only this rank's shards kept;
* :func:`bytes_per_rank`: parameter, gradient and optimizer bytes a rank
  holds, from the shapes alone.

The collectives along a dimension and their host counters
(``all_gather``, ``reduce_scatter_mean``, ``COUNTS``) live beside the
weight gather that calls them, in ``models/common.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import common, registry
from repro_torch.models.common import (
    ShardRules,
    all_gather,
    init_param,
    init_scale,
    tree_from_leaves,
    tree_leaves,
)

# a full_tree gather moves at most this many bytes of a leaf at a time
GATHER_CHUNK = 256 << 20


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where each leaf's shard lies: ``dims[i]`` is leaf ``i``'s FSDP
    dimension (None: replicated), ``shapes[i]`` its full shape; this rank
    holds ``[rank k, (rank + 1) k)`` of that dimension."""
    world: int
    rank: int
    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dims: tuple[int | None, ...]

    @property
    def sharded(self) -> frozenset:
        """The paths of the leaves held as shards."""
        return frozenset(p for p, d in zip(self.paths, self.dims) if d is not None)

    @property
    def gather_dims(self) -> dict:
        """``{path: FSDP dimension}`` of the sharded leaves, what
        ``models.common.fsdp_program`` takes."""
        return {p: d for p, d in zip(self.paths, self.dims) if d is not None}

    def local_shape(self, i: int) -> tuple[int, ...]:
        shape, d = self.shapes[i], self.dims[i]
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.world,) + shape[d + 1:]


def make_shard_layout(cfg, rules: ShardRules, world: int, rank: int = 0) -> ShardLayout:
    """The layout of ``cfg``'s parameters under ``rules`` over ``world``
    ranks (at world 1 a shard is its whole leaf, and a group of one still
    gathers and reduce-scatters it); a leaf whose FSDP dimension ``world``
    does not divide raises."""
    dims = registry.param_shard_dims(cfg, rules)
    pairs = list(tree_leaves(registry.abstract_params(cfg)))
    paths = tuple(p for p, _ in pairs)
    shapes = tuple(tuple(t.shape) for _, t in pairs)
    out = []
    for path, shape in zip(paths, shapes):
        d = dims[path]
        if d is not None and shape[d] % world:
            raise ValueError(
                f"{'/'.join(path)}: its FSDP dimension {d} ({shape[d]} of shape {shape}) "
                f"does not divide over {world} ranks")
        out.append(d)
    return ShardLayout(world, rank, paths, shapes, tuple(out))


def _slice(x, dim: int, lo: int, hi: int):
    """``x[..., lo:hi, ...]`` on ``dim``, as a copy of its own (a tensor or
    a numpy array)."""
    idx = (slice(None),) * dim + (slice(lo, hi),)
    part = x[idx]
    return part.clone() if isinstance(part, torch.Tensor) else np.array(part)


def check_shards(layout: ShardLayout, tree) -> None:
    """Raise unless ``tree`` holds this layout's leaves at their local
    shapes (a tree of full leaves passed at world > 1, say)."""
    pairs = list(tree_leaves(tree))
    if tuple(p for p, _ in pairs) != layout.paths:
        raise ValueError("tree does not have the layout's leaves")
    for i, (path, x) in enumerate(pairs):
        if tuple(x.shape) != layout.local_shape(i):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(x.shape)} is not this "
                             f"rank's shard {layout.local_shape(i)} of {layout.shapes[i]}")


def shard_tree(layout: ShardLayout, tree) -> dict:
    """This rank's shards of a tree of full leaves (tensors or numpy
    arrays, the parameters' structure); a replicated leaf is kept as it is."""
    pairs = list(tree_leaves(tree))
    if tuple(p for p, _ in pairs) != layout.paths:
        raise ValueError("tree does not have the layout's leaves")
    out = []
    for i, (_, x) in enumerate(pairs):
        d = layout.dims[i]
        if d is not None:
            k = layout.shapes[i][d] // layout.world
            x = _slice(x, d, layout.rank * k, (layout.rank + 1) * k)
        out.append(x)
    return tree_from_leaves(layout.paths, out)


def full_tree(layout: ShardLayout, tree, group) -> dict:
    """The full leaves of a tree of this rank's shards (the parameters, or
    an Adam moment), on the host.  Every rank must call it: one leaf at a
    time is gathered, in slices of at most ``GATHER_CHUNK`` bytes along an
    axis other than the FSDP one, and each slice lands on the host before
    the next is gathered."""
    out = []
    for i, (_, x) in enumerate(tree_leaves(tree)):
        d = layout.dims[i]
        if d is None or group.pg is None:
            out.append(x.cpu())
            continue
        full = torch.empty(layout.shapes[i], dtype=x.dtype)
        # slices of another axis than the FSDP one: the leading axis, or
        # the second where the leading axis is the FSDP dimension
        ax = 0 if d != 0 else min(1, x.dim() - 1)
        if ax == d:
            full.copy_(all_gather(x, d, group))
        else:
            per = x.numel() // x.shape[ax] * x.element_size() * layout.world
            step = max(1, GATHER_CHUNK // max(per, 1))
            for a in range(0, x.shape[ax], step):
                part = x.narrow(ax, a, min(step, x.shape[ax] - a))
                full.narrow(ax, a, part.shape[ax]).copy_(all_gather(part, d, group))
        out.append(full)
    return tree_from_leaves(layout.paths, out)


def _draw_shard(gen, spec, d: int, world: int, rank: int, device) -> torch.Tensor:
    """This rank's shard of ``init_param(gen, spec)``: the same chunks of
    normal draws, each consumed from ``gen`` in full, with only the
    elements in the shard kept."""
    shape = spec.shape
    n_d, inner = shape[d], math.prod(shape[d + 1:])
    k = n_d // world
    row = n_d * inner                  # values per index of the dims before d
    lo, seg = rank * k * inner, k * inner   # the shard's segment in each row
    out = torch.empty(shape[:d] + (k,) + shape[d + 1:], dtype=spec.dtype, device=device)
    flat = out.view(-1)
    total, scale = math.prod(shape), init_scale(spec)
    chunk = common.INIT_CHUNK         # init_param's, read at call time
    for i in range(0, total, chunk):
        m = min(chunk, total - i)
        vals = torch.randn(m, generator=gen, device=device, dtype=torch.float32) * scale
        end = i + m
        a0, a1 = i // row, (end - 1) // row
        full_lo = a0 if i == a0 * row else a0 + 1          # rows wholly in the chunk
        full_hi = a1 + 1 if end == (a1 + 1) * row else a1
        if full_lo < full_hi:
            rows = vals[full_lo * row - i: full_hi * row - i].view(-1, row)
            flat.view(-1, seg)[full_lo:full_hi] = rows[:, lo:lo + seg]
        for a in sorted({a0, a1}):                      # rows the chunk cuts
            if full_lo <= a < full_hi:
                continue
            s, e = a * row + lo, a * row + lo + seg
            s2, e2 = max(s, i), min(e, end)
            if s2 < e2:
                flat[a * seg + s2 - s: a * seg + e2 - s] = vals[s2 - i: e2 - i]
    return out


def init_shards(cfg, layout: ShardLayout, seed: int, device) -> dict:
    """This rank's shards of ``init(cfg, seed)``: one seeded generator, the
    leaves in sorted order, every draw of the unsharded init made and only
    the shard's elements kept, so the values are ``init``'s whatever the
    world.  A rank never holds a sharded leaf whole, only one chunk of
    draws (``common.INIT_CHUNK``) beside its shard."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = list(tree_leaves(registry.get_module(cfg).param_specs(cfg)))
    out = []
    for i, (_, spec) in enumerate(specs):
        d = layout.dims[i]
        if d is None:
            out.append(init_param(gen, spec, device))
        elif spec.init_scale == 0.0:
            out.append(torch.zeros(layout.local_shape(i), dtype=spec.dtype, device=device))
        else:
            out.append(_draw_shard(gen, spec, d, layout.world, layout.rank, device))
    return tree_from_leaves(layout.paths, out)


def bytes_per_rank(cfg, opt, world: int) -> dict:
    """Bytes one rank holds on the per-parameter path over ``world`` ranks,
    from the layout alone (nothing is allocated): the parameters, their
    gradients (a shard's, as the gather's backward leaves them) and the
    fp32 optimizer state (``m`` for momentum, ``v`` for rmsprop, both for
    adam).  Activations and the gathered layer in flight are not counted."""
    layout = make_shard_layout(cfg, ShardRules.for_group(None), world)
    pairs = list(tree_leaves(registry.abstract_params(cfg)))
    moments = {"sgd": 0, "momentum": 1, "rmsprop": 1, "adam": 2, "adamw": 2}[opt.kind]
    params = state = 0
    for i, (_, t) in enumerate(pairs):
        n = math.prod(layout.local_shape(i))
        params += n * t.element_size()
        state += n * 4 * moments
    return {"world": world, "params": params, "grads": params, "opt_state": state,
            "total": 2 * params + state}
