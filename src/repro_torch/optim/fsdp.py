"""FSDP and the model axis on the per-parameter path: the shard layout and
what moves it.

The reference's default train program shards every parameter that names
an FSDP dimension (``ParamSpec.logical``) over its data axis, splits every
one that names a ``"tp"`` dimension over its model axis, and lets the
optimizer state inherit those shardings (``optim/rules.py``
``state_pspecs``).  Here a rank at mesh coordinates ``(d, m)`` holds, as a
tensor of its own, the contiguous model slice ``[m t, (m + 1) t)`` of a
leaf's tensor-parallel dimension (``t = n / N_model``) and, within it, the
contiguous data shard ``[d k, (d + 1) k)`` of its FSDP dimension (``k =
n / N_data``), and the same of its Adam moments.  A data group is the mesh
``(N, 1)``.  A leaf whose dimension the axis does not divide raises, as
the reference's placement does (``jax.device_put`` of such a sharding
raises ``ValueError``; ``registry.param_shard_dims``).

* :class:`ShardLayout` / :func:`make_shard_layout`: each leaf's
  tensor-parallel and FSDP dimensions, its full and local shapes and this
  rank's coordinates;
* :func:`shard_tree` / :func:`full_tree`: full leaves to this rank's
  shards and back (:func:`local_shards`: shards as they are, else
  ``shard_tree``) (the gather one leaf at a time, in slices of at most
  ``GATHER_CHUNK`` bytes, for checkpoints);
* :func:`init_shards`: exactly the values ``init`` draws for a seed, with
  only this rank's box of each leaf kept;
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
    dimension and ``tp_dims[i]`` its tensor-parallel one (None: not split
    on that axis), ``shapes[i]`` its full shape; this rank holds ``[rank k,
    (rank + 1) k)`` of the FSDP dimension within ``[model_rank t,
    (model_rank + 1) t)`` of the tensor-parallel one."""
    world: int
    rank: int
    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dims: tuple[int | None, ...]
    tp_dims: tuple[int | None, ...]
    model: int = 1
    model_rank: int = 0

    @property
    def sharded(self) -> frozenset:
        """The paths of the leaves held as FSDP shards."""
        return frozenset(p for p, d in zip(self.paths, self.dims) if d is not None)

    @property
    def model_sharded(self) -> frozenset:
        """The paths of the leaves split over the model axis."""
        return frozenset(p for p, d in zip(self.paths, self.tp_dims) if d is not None)

    @property
    def gather_dims(self) -> dict:
        """``{path: FSDP dimension}`` of the sharded leaves, what
        ``models.common.fsdp_program`` takes."""
        return {p: d for p, d in zip(self.paths, self.dims) if d is not None}

    def box(self, i: int) -> tuple[tuple[int, int], ...]:
        """This rank's ``(lo, hi)`` along each dimension of leaf ``i``."""
        out = [(0, n) for n in self.shapes[i]]
        for d, n, r in ((self.tp_dims[i], self.model, self.model_rank),
                        (self.dims[i], self.world, self.rank)):
            if d is not None:
                k = self.shapes[i][d] // n
                out[d] = (r * k, (r + 1) * k)
        return tuple(out)

    def local_shape(self, i: int) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.box(i))


def make_shard_layout(cfg, rules: ShardRules, world: int, rank: int = 0, *,
                      model: int = 1, model_rank: int = 0) -> ShardLayout:
    """The layout of ``cfg``'s parameters under ``rules`` at coordinates
    ``(rank, model_rank)`` of a ``(world, model)`` mesh (at world 1 a shard
    is its whole leaf, and a group of one still gathers and
    reduce-scatters it); a leaf whose dimension its axis does not divide
    raises."""
    dims = registry.param_shard_dims(cfg, rules, world, model)
    pairs = list(tree_leaves(registry.abstract_params(cfg)))
    paths = tuple(p for p, _ in pairs)
    shapes = tuple(tuple(t.shape) for _, t in pairs)
    return ShardLayout(world, rank, paths, shapes, tuple(dims[p][1] for p in paths),
                       tuple(dims[p][0] for p in paths), model, model_rank)


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
        box = layout.box(i)
        if box != tuple((0, n) for n in layout.shapes[i]):
            part = x[tuple(slice(lo, hi) for lo, hi in box)]
            x = part.clone() if isinstance(part, torch.Tensor) else np.array(part)
        out.append(x)
    return tree_from_leaves(layout.paths, out)


def local_shards(layout: ShardLayout, tree) -> dict:
    """This rank's shards of ``tree``: the tree itself where its leaves
    already have the shards' shapes (:func:`init_shards`'s, or a serving
    replica's weights handed to the next), else :func:`shard_tree` of its
    whole leaves."""
    shapes = [tuple(x.shape) for _, x in tree_leaves(tree)]
    if shapes == [layout.local_shape(i) for i in range(len(layout.paths))]:
        check_shards(layout, tree)
        return tree
    return shard_tree(layout, tree)


def full_tree(layout: ShardLayout, tree, group, model=None) -> dict:
    """The full leaves of a tree of this rank's shards (the parameters, or
    an Adam moment), on the host: gathered over ``group`` (the FSDP axis)
    along each leaf's FSDP dimension and over ``model`` (the model axis'
    group, where the layout splits one) along its tensor-parallel one.
    Every rank must call it: one leaf at a time is gathered, in slices of
    at most ``GATHER_CHUNK`` bytes along an axis that neither splits where
    the leaf has one, and each slice lands on the host before the next is
    gathered."""
    out = []
    for i, (_, x) in enumerate(tree_leaves(tree)):
        moves = [(d, g) for d, g in ((layout.dims[i], group), (layout.tp_dims[i], model))
                 if d is not None and g is not None and g.pg is not None]
        if not moves:
            out.append(x.cpu())
            continue
        full = torch.empty(layout.shapes[i], dtype=x.dtype)
        free = [a for a in range(x.dim()) if a not in {d for d, _ in moves}]
        ax = free[0] if free else None
        if ax is None:
            part = x
            for d, g in moves:
                part = all_gather(part, d, g)
            full.copy_(part)
        else:
            per = x.numel() // x.shape[ax] * x.element_size() * math.prod(
                g.world for _, g in moves)
            step = max(1, GATHER_CHUNK // max(per, 1))
            for a in range(0, x.shape[ax], step):
                part = x.narrow(ax, a, min(step, x.shape[ax] - a))
                n = part.shape[ax]
                for d, g in moves:
                    part = all_gather(part, d, g)
                full.narrow(ax, a, n).copy_(part)
        out.append(full)
    return tree_from_leaves(layout.paths, out)


def _draw_box(gen, spec, box, device) -> torch.Tensor:
    """This rank's box (``(lo, hi)`` a dimension) of ``init_param(gen,
    spec)``: the same chunks of normal draws, each consumed from ``gen`` in
    full, with only the elements in the box kept.  The box is a run of
    equal-length segments of the row-major stream (one for each index of
    the dimensions before its last cut one), written in order."""
    shape = spec.shape
    cut = [d for d, (lo, hi) in enumerate(box) if (lo, hi) != (0, shape[d])]
    local = tuple(hi - lo for lo, hi in box)
    out = torch.empty(local, dtype=spec.dtype, device=device)
    flat = out.view(-1)
    last = cut[-1]
    inner = math.prod(shape[last + 1:])
    seg = local[last] * inner                   # each segment's length
    strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    # the segments' starts in the stream, in row-major order of the box
    starts = torch.zeros(1, dtype=torch.int64)
    for d in range(last + 1):
        idx = torch.arange(box[d][0], box[d][0] + 1 if d == last else box[d][1],
                           dtype=torch.int64)
        starts = (starts[:, None] + idx[None, :] * strides[d]).reshape(-1)
    starts_l = starts.tolist()
    total, scale = math.prod(shape), init_scale(spec)
    chunk = common.INIT_CHUNK         # init_param's, read at call time
    for i in range(0, total, chunk):
        m = min(chunk, total - i)
        vals = torch.randn(m, generator=gen, device=device, dtype=torch.float32) * scale
        end = i + m
        # the segments this chunk touches, [s0, s1), and those wholly in it,
        # [w0, w1)
        s0 = int(torch.searchsorted(starts, i - seg, right=True))
        s1 = int(torch.searchsorted(starts, end))
        w0 = int(torch.searchsorted(starts, i))
        w1 = max(w0, int(torch.searchsorted(starts, end - seg, right=True)))
        if w1 > w0 and seg < 4096:
            idx = (starts[w0:w1, None] - i
                   + torch.arange(seg, dtype=torch.int64)[None, :]).reshape(-1)
            flat[w0 * seg: w1 * seg] = vals[idx.to(vals.device)]
        else:
            for t in range(w0, w1):
                flat[t * seg: (t + 1) * seg] = vals[starts_l[t] - i: starts_l[t] - i + seg]
        for t in [*range(s0, w0), *range(w1, s1)]:
            a, b = max(starts_l[t], i), min(starts_l[t] + seg, end)
            if a < b:
                flat[t * seg + a - starts_l[t]: t * seg + b - starts_l[t]] = vals[a - i: b - i]
    return out


def init_shards(cfg, layout: ShardLayout, seed: int, device) -> dict:
    """This rank's shards of ``init(cfg, seed)``: one seeded generator, the
    leaves in sorted order, every draw of the unsharded init made and only
    the elements of this rank's box kept, so the values are ``init``'s
    whatever the mesh.  A rank never holds a sharded leaf whole, only one
    chunk of draws (``common.INIT_CHUNK``) beside its shard."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = list(tree_leaves(registry.get_module(cfg).param_specs(cfg)))
    out = []
    for i, (_, spec) in enumerate(specs):
        box = layout.box(i)
        if box == tuple((0, n) for n in spec.shape):
            out.append(init_param(gen, spec, device))
        elif spec.init_scale == 0.0:
            out.append(torch.zeros(layout.local_shape(i), dtype=spec.dtype, device=device))
        else:
            out.append(_draw_box(gen, spec, box, device))
    return tree_from_leaves(layout.paths, out)


def bytes_per_rank(cfg, opt, data: int, model: int = 1) -> dict:
    """Bytes one rank holds on the per-parameter path on a ``(data,
    model)`` mesh (``data`` ranks of a data group at ``model=1``), from the
    layout alone (nothing is allocated): the parameters, their gradients (a
    shard's, as the gather's backward leaves them) and the fp32 optimizer
    state (``m`` for momentum, ``v`` for rmsprop, both for adam), under the
    FSDP rules (``for_mesh``'s where ``model > 1``).  Activations and the
    gathered layer in flight are not counted."""
    rules = ShardRules.for_group(None)
    if model > 1:
        rules = dataclasses.replace(rules, tp="model", sp=True)
    layout = make_shard_layout(cfg, rules, data, model=model)
    pairs = list(tree_leaves(registry.abstract_params(cfg)))
    moments = {"sgd": 0, "momentum": 1, "rmsprop": 1, "adam": 2, "adamw": 2}[opt.kind]
    params = state = 0
    for i, (_, t) in enumerate(pairs):
        n = math.prod(layout.local_shape(i))
        params += n * t.element_size()
        state += n * 4 * moments
    return {"world": data * model, "data": data, "model": model, "params": params,
            "grads": params, "opt_state": state, "total": 2 * params + state}
