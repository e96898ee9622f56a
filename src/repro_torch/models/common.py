"""Shared model machinery: parameter declaration and initialisation,
sharding rules and the FSDP weight gather, norms, the loss and
rematerialisation.

The port of the reference's ``models/common.py``.  Parameters are nested
dicts of tensors with the reference's tree structure (layers stacked on
axis 0), so a converted JAX pytree and a tree from :func:`init_tree` are
interchangeable.  Every :class:`ParamSpec` names its dimensions'
*logical* axes, as the reference's does, and :class:`ShardRules` maps them
onto a data group's one axis (``for_group``: ``fsdp`` is ``"data"`` unless
the rules are faithful, the paper's replicated program) or onto a mesh's
``data`` and ``model`` axes (``for_mesh``, the reference's: ``tp`` is
``"model"`` and ``sp`` on wherever the mesh has a model axis).

Sharding lives on the per-parameter train program (``train/step.py``)
and the serving mesh program (:func:`serve_program`, the serve engine's
on a mesh): each rank holds its model slice of every leaf with a
``"tp"`` dimension and 1/N_data of that slice along its FSDP dimension,
and while such a program runs (:class:`fsdp_program`) the models read
such a leaf through :func:`use_layer` / :func:`use`, which cast the
shard to the compute dtype
and all-gather it over ``data`` only (:class:`Gather`, the counterpart of
the reference's ``wuse``; its backward reduce-scatters the fp32 cotangent
as a mean), giving the model slice.  Under a mesh program the models also
read the model axis (:func:`model_axis`) and move activations over it with
the tensor-parallel Functions below (copy-to-model, reduce-from-model, and
the all-gather / reduce-scatter pair of the sequence-sharded residual
stream), and the loss is :func:`vocab_parallel_cross_entropy`.  With no
program active everything returns what it was given, cast as before, so
one-device serving and the flat programs read the same tensors as ever.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.tree import map_tree, tree_leaves  # noqa: F401  (the port's one tree walker)


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardRules:
    """Logical-axis -> group-axis mapping, the reference's fields:

      ``dp``    batch (data parallel; the paper's scatter axis)
      ``tp``    tensor parallel (heads / ffn hidden / vocab / experts)
      ``fsdp``  parameter and optimizer-state sharding (``None`` in the
                paper-faithful replicated mode)
      ``sp``    sequence-parallel residual stream between blocks

    The reference's also carries its mesh; a data group is one axis of
    ranks, so these carry none."""

    dp: tuple[str, ...] = ("pod", "data")
    tp: str | None = "model"
    fsdp: str | None = "data"
    sp: bool = True

    def axis(self, logical: str | None):
        if logical is None:
            return None
        if logical == "dp":
            return self.dp
        if logical == "tp":
            return self.tp
        if logical == "fsdp":
            return self.fsdp
        if logical == "sp":
            return self.tp if self.sp else None
        raise ValueError(f"unknown logical axis {logical!r}")

    @classmethod
    def faithful(cls, dp=("pod", "data"), tp="model") -> "ShardRules":
        return cls(dp=dp, tp=tp, fsdp=None, sp=False)

    @classmethod
    def for_group(cls, group, *, faithful: bool = False) -> "ShardRules":
        """The rules of a :class:`~repro_torch.launch.mesh.DataGroup`: one
        data axis and no model axis, so ``tp`` is None and ``sp`` False;
        ``fsdp`` is ``"data"`` unless ``faithful``.  A mesh takes
        :meth:`for_mesh`."""
        del group
        if faithful:
            return cls.faithful(dp=("data",), tp=None)
        return cls(dp=("data",), tp=None, fsdp="data", sp=False)

    @classmethod
    def for_mesh(cls, mesh, *, faithful: bool = False) -> "ShardRules":
        """The reference's ``for_mesh`` on a
        :class:`~repro_torch.launch.mesh.MeshGroup`: ``dp`` its data axes,
        ``tp`` ``"model"`` wherever it has that axis (of any size) with
        ``sp`` on, ``fsdp`` ``"data"`` unless ``faithful`` (which keeps
        ``tp`` and turns ``sp`` off)."""
        names = mesh.axes
        dp = tuple(a for a in ("pod", "data") if a in names)
        tp = "model" if "model" in names else None
        if faithful:
            return cls.faithful(dp=dp, tp=tp)
        return cls(dp=dp, tp=tp, fsdp="data" if "data" in names else None,
                   sp=tp is not None)


# ---------------------------------------------------------------------------
# Parameter declaration: shapes and logical axes declared together
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init_scale: float | None = None   # None -> fan-in scaled normal

    def __post_init__(self):
        if len(self.logical) != len(self.shape):
            raise ValueError(f"logical axes {self.logical} do not match shape {self.shape}")

    def shard_dim(self, rules: ShardRules) -> int | None:
        """The dimension ``rules`` shard over the data axis (where the
        reference's ``pspec`` names ``rules.fsdp``), or None."""
        return self._dim(rules, rules.fsdp)

    def tp_dim(self, rules: ShardRules) -> int | None:
        """The dimension ``rules`` split over the model axis (where the
        reference's ``pspec`` names ``rules.tp``), or None."""
        return self._dim(rules, rules.tp)

    def _dim(self, rules: ShardRules, axis) -> int | None:
        if axis is None:
            return None
        dims = [i for i, l in enumerate(self.logical) if rules.axis(l) == axis]
        if len(dims) > 1:
            raise ValueError(f"{self.logical}: more than one dimension on {axis!r}")
        return dims[0] if dims else None


# fp32 normal draws at a time (268 MB): every leaf is drawn in chunks of
# this many values, so neither init nor the sharded init
# (``optim.fsdp.init_shards``, which draws the same chunks) holds more of a
# leaf at full size than one chunk; a layer slice of qwen3-moe-30b-a3b's
# expert leaves is 201 x 10^6 values
INIT_CHUNK = 1 << 26


def init_param(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    """Zeros where ``init_scale == 0``; ``init_scale * N(0, 1)`` where it is
    set; else a fan-in normal (``1/sqrt(shape[-2])``), as the reference.
    The normal is drawn in fp32, ``INIT_CHUNK`` values at a time, into a leaf
    of the stored dtype, so a full-width model (gemma2-27b: 54 GB in bf16)
    never holds a whole fp32 copy of its largest leaf beside it.  The
    sharded init (``optim.fsdp.init_shards``) draws the same chunks."""
    if spec.init_scale == 0.0:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    scale = init_scale(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=device,
                                    dtype=torch.float32) * scale
    return out


def init_scale(spec: ParamSpec) -> float:
    """The normal's scale: ``init_scale`` where set, else ``1/sqrt(fan_in)``
    with ``fan_in = shape[-2]``, as the reference."""
    if spec.init_scale is not None:
        return spec.init_scale
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return 1.0 / math.sqrt(fan_in)


def tree_from_leaves(paths, leaves) -> dict:
    """Inverse of :func:`tree_leaves`: a nested dict from paths and leaves."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def cast_tree(tree: dict, dtype: torch.dtype, keep: frozenset, device=None) -> dict:
    """A copy of a parameter tree with every leaf in ``dtype`` on ``device``
    except the leaves named in ``keep`` (norm scales and other leaves read
    in fp32), which keep their stored dtype.  ``.to`` returns the leaf
    itself where nothing changes."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = cast_tree(leaf, dtype, keep, device)
        else:
            dt = leaf.dtype if name in keep else dtype
            out[name] = leaf.to(device=device or leaf.device, dtype=dt)
    return out


def init_tree(seed: int, tree, device) -> dict:
    """Initialise every :class:`ParamSpec` of ``tree`` from one seeded
    ``torch.Generator`` on ``device``, drawn in sorted-key leaf order.
    The numbers are not the reference's (``jax.random`` bits have no
    PyTorch twin); shapes and scales are."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = list(tree_leaves(tree))
    return tree_from_leaves([p for p, _ in pairs],
                            [init_param(gen, spec, device) for _, spec in pairs])


# ---------------------------------------------------------------------------
# FSDP and the model axis: the program state and the collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis of a running mesh program: the group the
    tensor-parallel collectives run over (a ``DataGroup`` view: ``pg``,
    ``rank``, ``world``) and whether the residual stream between blocks is
    sequence-sharded over it (``ShardRules.sp``)."""
    group: Any
    sp: bool

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world


@dataclasses.dataclass(frozen=True)
class ServeSplit:
    """Serving's data-axis share under a serving mesh program: the mesh
    (``launch.mesh.MeshGroup``; its ``data`` group the ranks that split
    the lanes or the pool's blocks) and the slotted cache's
    ``attention.DecodeSharding`` (None for a paged engine, whose pool's
    blocks split over ``mesh.data``)."""
    mesh: Any
    decode: Any = None


# the running program, if any: (the FSDP axis' group, {leaf path: the FSDP
# dimension of the stored leaf}, the model axis or None, the serving split
# or None)
_FSDP: tuple[Any, dict, ModelAxis | None, ServeSplit | None] | None = None


class fsdp_program:
    """While active, :func:`use_layer` and :func:`use` gather the leaves
    ``dims`` names (``{path: FSDP dimension of the stored leaf}``) over
    ``group``, and, with ``model`` given, the models run tensor, sequence
    and expert parallelism over it (:func:`model_axis`).  The per-parameter
    train program holds it around its loss and its backward, inside which
    remat's recompute gathers again.  The counterpart of the reference's
    ``manual_mode`` switch, the other way round: the models shard only while
    it is on.  It also holds the saved-tensor hooks (:func:`_pack`) that
    keep a gathered weight saved outside a rematted body as its shard,
    gathered again in the backward."""

    def __init__(self, group, dims: dict, model: ModelAxis | None = None,
                 serve: ServeSplit | None = None):
        self._state = (group, dims, model, serve)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)

    def __enter__(self):
        global _FSDP
        self._prev, _FSDP = _FSDP, self._state
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        global _FSDP
        self._hooks.__exit__(*exc)
        _FSDP = self._prev
        return False


def serve_program(mesh, dims: dict, decode=None) -> fsdp_program:
    """The serving mesh program on ``mesh``: the weights ``dims`` names
    gathered over ``data`` a layer at a time, tensor and expert
    parallelism over ``model`` with the residual stream whole on every
    model rank (no ``sp``: a decode step has one position, and a prefill's
    stream stays whole too, so every serving function runs on the same
    layout), and the caches split over the data axes (:func:`serve_split`:
    the slotted cache's lanes as ``decode``, an ``attention.DecodeSharding``,
    lays them out; the paged pool's blocks)."""
    return fsdp_program(mesh.axis("data"), dims, ModelAxis(mesh.model, sp=False),
                        ServeSplit(mesh, decode))


def model_axis() -> ModelAxis | None:
    """The running program's model axis (None outside a mesh program: the
    models then run as they always have)."""
    return None if _FSDP is None else _FSDP[2]


def serve_split() -> ServeSplit | None:
    """The running serving mesh program's data-axis split (None outside
    one)."""
    return None if _FSDP is None else _FSDP[3]


# collectives called by the running program, by kind, each counted where it
# is called, as the kernel wrappers count their launches (reset by
# assignment): the FSDP gather and its reduce-scatter; and each
# tensor-parallel Function's collectives, forward and backward, under its
# own name; ``vocab_ce`` the loss's all-reduces; ``decode_combine`` the
# sequence-sharded decode attention's (``attention.decode_attention``);
# serving's data axes: ``data_all_gather`` the logits of the rank's lanes
# gathered over them, ``data_combine`` the paged decode's merge of the
# ranks' partials (``attention.data_combine``), ``block_gather`` a
# continuation chunk's gather of its lane (``attention.gather_lane``),
# ``block_copy`` a copy-on-write block sent between two ranks, ``tier_move``
# a host-tier payload restored on another data rank than its holder's
# (``serve.step``'s transport); ``norm_sum`` the Mamba2 out-norm's row sums
# over the model axis (``ssm.SplitGatedNorm``, forward and backward)
COUNTS = {"all_gather": 0, "reduce_scatter": 0, "copy_to_model": 0, "reduce_from_model": 0,
          "model_all_gather": 0, "model_reduce_scatter": 0, "vocab_ce": 0,
          "decode_combine": 0, "data_all_gather": 0, "data_combine": 0, "block_gather": 0,
          "block_copy": 0, "tier_move": 0, "norm_sum": 0}


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, shape = group.world, tuple(x.shape)
    dim = dim % x.dim()
    out = torch.empty((n * shape[0],) + shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group.pg)
    if dim == 0 or n == 1:
        return out
    full = torch.empty(shape[:dim] + (n * shape[dim],) + shape[dim + 1:],
                       dtype=x.dtype, device=x.device)
    full.view(shape[:dim] + (n, shape[dim]) + shape[dim + 1:]).copy_(
        out.view((n,) + shape).movedim(0, dim))
    return full


def _scatter_sum(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group.world
    dim = dim % g.dim()
    parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, parts.view((-1,) + tuple(parts.shape[2:])),
                               op=dist.ReduceOp.SUM, group=group.pg)
    return out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group.pg)
    return out


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (rank order), as a
    tensor of its own (never a view of another)."""
    COUNTS["all_gather"] += 1
    return _gather(x, dim, group)


def data_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Serving's gather over the data axes (the logits of each rank's
    lanes): the ranks' ``x`` concatenated along ``dim``, counted in
    ``COUNTS["data_all_gather"]``; the identity without a process
    group."""
    if group.pg is None:
        return x
    COUNTS["data_all_gather"] += 1
    return _gather(x, dim, group)


def reduce_scatter_mean(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the mean of the ranks' ``g``:
    summed by the collective, then divided by the world."""
    COUNTS["reduce_scatter"] += 1
    return _scatter_sum(g, dim, group).div_(group.world)


class Gather(torch.autograd.Function):
    """The full tensor of one shard: cast to ``dtype`` first, then
    all-gathered along ``dim`` over the group, so the collective moves
    compute-dtype bytes, as the reference's ``wuse`` asks.  Backward: the
    cotangent taken to fp32 and reduce-scattered as the mean over the
    group, in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, dim: int, dtype, group):
        ctx.dim, ctx.group, ctx.shard_dtype = dim, group, shard.dtype
        return all_gather(shard.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter_mean(g.float(), ctx.dim, ctx.group)
        return out.to(ctx.shard_dtype), None, None, None


# ---------------------------------------------------------------------------
# The model axis: tensor-parallel Functions and the vocab-parallel loss
# ---------------------------------------------------------------------------
#
# The convention (Megatron's): a tensor replicated over the model axis
# holds its whole gradient on every rank, a partial sum holds its own part.
# Column-parallel products read a replicated input and give local columns;
# row-parallel products give partial sums.  Each Function's forward and
# backward are the two sides of one collective pair, SUM throughout.


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces (SUM) the partial gradients
    the ranks' column-parallel products give the replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        COUNTS["copy_to_model"] += 1
        return _all_reduce(g, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce (SUM) of the ranks' partial sums; identity backward (the
    replicated sum's gradient is every part's)."""

    @staticmethod
    def forward(ctx, x, group):
        COUNTS["reduce_from_model"] += 1
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelAllGather(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; backward
    reduce-scatters (SUM) the ranks' partial gradients of the whole."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        COUNTS["model_all_gather"] += 1
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        COUNTS["model_all_gather"] += 1
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class ModelReduceScatter(torch.autograd.Function):
    """This rank's slice along ``dim`` of the ranks' partial sums (SUM);
    backward all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        COUNTS["model_reduce_scatter"] += 1
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        COUNTS["model_reduce_scatter"] += 1
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x, group):
    return x if group.pg is None else CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return x if group.pg is None else ReduceFromModel.apply(x, group)


def model_all_gather(x, dim: int, group):
    return x if group.pg is None else ModelAllGather.apply(x, dim, group)


def model_reduce_scatter(x, dim: int, group):
    if x.shape[dim] % group.world:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} (the sequence, where the "
                         f"residual stream is sharded) does not divide over {group.world} "
                         "model ranks")
    return x if group.pg is None else ModelReduceScatter.apply(x, dim, group)


def tp_enter(x, dim: int = 1):
    """The residual stream (or anything in its layout) as a column-parallel
    product reads it: under a mesh program the whole sequence, gathered
    along ``dim`` where the stream is sequence-sharded, else through
    copy-to-model; unchanged outside one."""
    tp = model_axis()
    if tp is None:
        return x
    if tp.sp:
        return model_all_gather(x, dim, tp.group)
    return copy_to_model(x, tp.group)


def tp_exit(y, dim: int = 1):
    """A row-parallel product's partial sums back in the residual layout:
    reduce-scattered along ``dim`` onto this rank's sequence shard, or
    all-reduced where the stream is not sequence-sharded; unchanged outside
    a mesh program."""
    tp = model_axis()
    if tp is None:
        return y
    if tp.sp:
        return model_reduce_scatter(y, dim, tp.group)
    return reduce_from_model(y, tp.group)


class GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class VocabParallelCE(torch.autograd.Function):
    """Per-token negative log-likelihood of logits split over the model
    axis by vocabulary: this rank holds columns ``[offset, offset + V_loc)``.
    The row maximum is all-reduced (MAX), then the sum of exponentials and
    the gold logit (each rank's where the label is its own, else 0) in one
    all-reduce (SUM); the full logits are never gathered.  The arithmetic
    is ``torch.logsumexp``'s (``log(sum(exp(x - m))) + m``) and the
    backward its backward plus the gold term's scatter, so over one rank
    both sides are the plain loss's bit for bit."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        x = logits.float()
        v_loc = x.shape[-1]
        off = group.rank * v_loc
        m = x.amax(dim=-1, keepdim=True)
        if group.pg is not None:
            COUNTS["vocab_ce"] += 1
            m = _all_reduce(m, group, dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == math.inf, 0)
        s = (x - m).exp_().sum(dim=-1)
        idx = labels.long() - off
        inside = (idx >= 0) & (idx < v_loc)
        idx = idx.clamp(0, v_loc - 1)[..., None]
        gold = torch.where(inside, torch.gather(x, -1, idx)[..., 0], 0.0)
        if group.pg is not None:
            COUNTS["vocab_ce"] += 1
            both = _all_reduce(torch.stack([s, gold]), group)
            s, gold = both[0], both[1]
        logz = s.log_().add_(m[..., 0])
        ctx.save_for_backward(logits, logz, idx, inside)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, inside = ctx.saved_tensors
        grad = g[..., None] * (logits.float() - logz[..., None]).exp()
        grad.scatter_add_(-1, idx, torch.where(inside, -g, 0.0)[..., None])
        return grad.to(logits.dtype), None, None


def vocab_parallel_cross_entropy(logits, labels, group):
    """Mean token-level cross entropy of vocabulary-split logits
    (:class:`VocabParallelCE`); over one rank without a process group the
    plain :func:`cross_entropy_loss`."""
    if group.pg is None and group.world == 1:
        return cross_entropy_loss(logits, labels)
    return VocabParallelCE.apply(logits, labels, group).mean()


# ---------------------------------------------------------------------------
# Reading the weights
# ---------------------------------------------------------------------------


def wuse(w, dim: int, dtype, group):
    """Shard ``w`` in ``dtype``, gathered along ``dim`` (:class:`Gather`);
    without a process group (one worker) the shard is the whole leaf and
    this is the plain cast.  The full tensor remembers its shard, so that
    the autograd graph keeps the shard in its place (:func:`_pack`)."""
    if group.pg is None:
        return w.to(dtype)
    full = Gather.apply(w, dim, dtype, group)
    full._fsdp_source = (w.detach(), dim, dtype, group)
    return full


def _pack(t: torch.Tensor):
    """Saved-tensor hook of an FSDP program: a gathered weight (or a view
    of one) that an operation saves for its backward is kept as its shard
    and its view's geometry, so no full copy outlives the forward that
    used it; anything else is kept as it is.  Inside a rematted body
    checkpoint's own hooks take precedence, and its recompute gathers."""
    base = t if t._base is None else t._base
    src = getattr(base, "_fsdp_source", None)
    if src is None:
        return t
    return src, tuple(t.shape), t.stride(), t.storage_offset()


def _unpack(packed):
    """The backward's side of :func:`_pack`: gather the shard again (an
    all-gather of the same bytes, so the same full tensor) and take the
    saved view of it."""
    if isinstance(packed, torch.Tensor):
        return packed
    (shard, dim, dtype, group), shape, stride, offset = packed
    return all_gather(shard.to(dtype), dim, group).as_strided(shape, stride, offset)


def use_layer(cfg, bp: dict, prefix: tuple, lead: int = 1) -> dict:
    """A block's weights as its body reads them.  ``bp`` holds one layer's
    slices of the stacked leaves under ``prefix`` (``lead`` layer axes
    indexed away); under an FSDP program each sharded one is gathered in
    the compute dtype over the FSDP axis alone (under a mesh program a
    leaf held on both axes becomes its model slice), the others come back
    as given.  Called inside a rematted body, so that the recompute
    gathers again and no full copy outlives its layer."""
    if _FSDP is None:
        return bp
    group, dims = _FSDP[:2]
    cdt = dtype_of(cfg.compute_dtype)
    out = {}
    for name, w in bp.items():
        d = dims.get(prefix + (name,))
        out[name] = w if d is None else wuse(w, d - lead, cdt, group)
    return out


def use(cfg, params: dict, name: str):
    """Top-level leaf ``name`` (an embedding or a projection) in the
    compute dtype: gathered over the FSDP axis under an FSDP program where
    it is sharded (its model slice under a mesh program), else cast."""
    cdt = dtype_of(cfg.compute_dtype)
    if _FSDP is not None:
        group, dims = _FSDP[:2]
        d = dims.get((name,))
        if d is not None:
            return wuse(params[name], d, cdt, group)
    return params[name].to(cdt)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def decode_positions(cur_index, batch: int, device=None) -> torch.Tensor:
    """``(B, 1)`` int32 RoPE position row per sequence for a decode step.

    ``cur_index`` is a scalar (every sequence at the same position) or a
    ``(B,)`` vector (the serve engine's lanes, each at its own length).
    """
    cur = torch.as_tensor(cur_index, dtype=torch.int32, device=device)
    return torch.broadcast_to(cur, (batch,))[:, None]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """fp32 mean-square, ``(1 + gamma)`` scale, output in ``x.dtype``."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def norm(cfg, x, gamma):
    """RMSNorm of a model's blocks: the CUDA kernel's wrapper under
    ``attn_impl="kernel"`` (its plain version on a CPU tensor), else the
    plain :func:`rms_norm`."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm
        return rmsnorm(x, gamma, eps=cfg.norm_eps)
    return rms_norm(x, gamma, cfg.norm_eps)


def norm_add(cfg, x, residual, gamma):
    """``s = x + residual`` and ``rms_norm(s)``; returns ``(normed, s)``.
    The kernel normalises the fp32 sum before it rounds to ``x.dtype``; the
    plain path rounds first, as the reference does (``x = x + o`` then
    ``rms_norm(x)``).  ``s`` is the same in both."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm_add
        return rmsnorm_add(x, residual, gamma, eps=cfg.norm_eps)
    s = x + residual
    return rms_norm(s, gamma, cfg.norm_eps), s


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level cross entropy; logits (..., V) promoted to fp32:
    logsumexp minus the gold logit, averaged (over ``mask`` when given)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep matmul outputs,
    recompute everything else (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, remat):
    """Apply a rematerialisation policy to a block function.

    remat: False (keep every activation) | True (save the block's inputs
    only and recompute its forward in the backward) | "dots" (save matmul
    outputs, recompute the rest).  Both checkpointing forms are
    ``torch.utils.checkpoint`` without re-entry."""
    if not remat:
        return body
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(body, *a, use_reentrant=False, context_fn=ctx)
    return lambda *a: checkpoint(body, *a, use_reentrant=False)
