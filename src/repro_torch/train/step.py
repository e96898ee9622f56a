"""Train-step builder: loss -> grads -> update, with the paper's §5.1 input
slicing (gradient accumulation), remat, and the flat bucketed gradient
engine, over a :class:`~repro_torch.launch.mesh.DataGroup` or a
:class:`~repro_torch.launch.mesh.MeshGroup`.

Each worker runs the returned ``train_step(params, opt_state, batch)`` on
ITS rows of the global batch (the loop hands data rank ``r`` rows
``[r B/N, (r+1) B/N)``; the ranks of one data column, along the model
axis, get the same rows), as the reference's ``shard_map`` hands each
worker its block.  Three programs:

* **faithful** (``faithful=True``) — the paper's Appendix-A program:
  gradients flattened into ONE fp32 buffer (§3.3), one
  ``all_reduce(SUM) / N`` per ~4 MiB parameter-aligned bucket, clipping
  from the flat sum of squares, and the fused flat-Adam kernel on the
  replicated flat ``p/m/v``.
* **zero** (``flat_engine="zero"``) — per-bucket reduce-scatter, the
  flat-Adam kernel on the owned 1/N shard (ZeRO optimizer-state sharding:
  ``m``/``v`` are flat scattered buffers), per-bucket all-gather of the
  updated parameters.
* **per-parameter** (``flat_engine="off"``, a non-adam rule, the ``moe``
  family, or the default non-faithful settings) — ``optim.apply_update``
  on each leaf, under :class:`~repro_torch.models.common.ShardRules`
  (``ShardRules.for_group(group, faithful=settings.faithful)`` unless
  given), as the reference's.  FSDP rules (the default): every leaf with
  an FSDP dimension is held as this rank's 1/N shard (``optim/fsdp.py``),
  and so are its Adam moments; the models gather a layer's shards in the
  compute dtype while the layer runs (``common.fsdp_program``), again in
  remat's recompute or, outside a rematted block, in the backward (no
  full copy outlives its use), and the gather's backward hands each
  shard its gradient already reduce-scattered, the mean in fp32.  The replicated
  leaves (norms, the MoE router) and, under faithful rules, every leaf
  take one ``all_reduce`` of the mean each.

  On a :class:`~repro_torch.launch.mesh.MeshGroup` the rules default to
  ``ShardRules.for_mesh`` (the reference's: ``tp="model"``, ``sp`` on,
  ``fsdp="data"`` unless faithful; ``sp`` off for the hybrid family, as
  the reference's launcher sets it) and the families of
  ``registry.MESH_TRAIN_FAMILIES`` (dense, gemma2, moe, hybrid) run the
  mesh program: each rank holds its model slice of every ``"tp"`` leaf
  and 1/N_data of that slice, the blocks are column-parallel into local
  heads, FFN columns or experts and row-parallel out, the residual stream
  between them is sequence-sharded over ``model`` where ``sp`` is on
  (``models/lm.py``, ``models/moe.py``; zamba2's Mamba2 blocks split their
  heads, ``models/ssm.py``), and the loss is vocab-parallel.  Gradients: a
  leaf split over ``model`` takes no model reduction; a leaf replicated
  over it that computes on per-rank work (all of them under ``sp``;
  without it the leaves read inside the tensor-parallel region,
  ``registry.tp_region_leaves``: :func:`model_partial_paths`) holds a
  partial sum on each model rank and takes an ``all_reduce`` SUM over
  ``model``; every leaf is then averaged over the data axes (FSDP leaves
  by the gather's backward over ``data`` and an ``all_reduce`` over any
  other data axis).  The other families run at a model axis of size 1 as
  on the mesh's data group and raise at a live one; the flat programs
  refuse a live one, as the reference's.

Every family of the reference trains here through its module's
``loss_fn``: dense, gemma2's pairs, vlm (``patch_embeds`` in the batch),
hybrid (zamba), ssm (xlstm), audio (whisper, ``frames``) and moe (its
``lb_loss`` term).  §5.1 slicing splits every entry of the batch on its
leading axis, the frontend extras with the tokens, and averages the loss
and each metric (``lb_loss``, ``drop_frac``) over the slices.

Both flat programs keep the fp32 parameters and the Adam moments as views
of flat buffers (``optim.flat``), so flattening them costs no copy; a step
copies the gradient once into its flat buffer (none with §5.1 slicing,
which accumulates into one), and the skip guard's ``torch.where`` makes
one more copy of p, m and v.  The step counter and the ``skipped`` flag
stay device tensors: a step makes no host sync.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import MeshGroup
from repro_torch.models import registry
from repro_torch.models.common import ModelAxis, ShardRules, fsdp_program
from repro_torch.optim import OptConfig, apply_update, init_state
from repro_torch.optim.fsdp import ShardLayout, check_shards, make_shard_layout
from repro_torch.optim.buckets import (
    BucketLayout,
    bucketed_all_gather,
    bucketed_all_reduce,
    bucketed_reduce_scatter,
    flat_adam_apply,
    make_buckets,
    resolve_bucket_bytes,
    scatter_flat,
)
from repro_torch.optim.flat import (
    FlatLayout,
    flatten,
    make_layout,
    tree_from_leaves,
    tree_leaves,
    unflatten,
)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    num_slices: int = 1          # paper §5.1 automated input slicing
    remat: Any = True            # False | True | "dots" (see common.remat_wrap)
    faithful: bool = False       # paper-faithful replicated-DP mode
    accum_dtype: str = "float32" # microbatch gradient accumulator dtype
    # Flat-gradient bucket engine:
    #   "auto" — faithful mode uses the bucketed flat program whenever the
    #            rule is adam/adamw; non-faithful mode keeps the
    #            per-parameter path.
    #   "zero" — non-faithful mode ALSO goes flat: bucketed reduce-scatter,
    #            sharded flat-Adam state, bucketed all-gather (ZeRO).
    #   "off"  — never use the flat engine.
    flat_engine: str = "auto"
    # None: the flat_adam CUDA kernel on a card, its plain version on the
    # CPU; False: the plain version everywhere.
    flat_kernel: bool | None = None
    # Flat-engine non-finite gradient guard: when the reduced flat
    # gradient holds any NaN/Inf, the step becomes a bitwise no-op on
    # params AND optimizer state (step counter included).  The verdict is
    # taken on the post-reduction buffer (faithful) or from an all-reduced
    # count (ZeRO), so every worker skips or applies in lockstep.
    # Surfaced as metrics["skipped"]; the loop counts skipped_steps.
    skip_nonfinite: bool = True


def flat_engine_mode(cfg: ArchConfig, group, opt: OptConfig,
                     settings: TrainSettings) -> str | None:
    """Which flat-engine program this (cfg, group, opt, settings) runs:
    ``"faithful"`` | ``"zero"`` | ``None`` (per-parameter path).

    ``flat_engine="auto"`` degrades silently, but an EXPLICIT
    ``flat_engine="zero"`` request raises when it cannot engage.  A mesh
    with a live model axis refuses both, and ZeRO a mesh with more than
    one data axis, as the reference's; a flat program on a mesh runs over
    its data group.
    """
    if settings.flat_engine not in ("auto", "zero", "off"):
        raise ValueError(f"flat_engine {settings.flat_engine!r}")
    if settings.flat_engine == "off":
        return None
    want_zero = settings.flat_engine == "zero"

    def unavailable(reason: str):
        if want_zero:
            raise ValueError(f"flat_engine='zero' unavailable: {reason}")
        return None

    if opt.kind not in ("adam", "adamw"):
        return unavailable(f"requires adam/adamw, got {opt.kind!r}")
    mesh = isinstance(group, MeshGroup)
    if mesh and not group.data_axes:
        return unavailable("mesh has no data-parallel axes")
    # pure data-parallel only: with a live model axis the per-parameter
    # shardings carry tensor-parallel structure a flat buffer would destroy
    if mesh and any(n > 1 for a, n in zip(group.axes, group.shape)
                    if a not in group.data_axes):
        return unavailable("mesh has a live model axis")
    if cfg.family == "moe":
        return unavailable("the moe family trains on the per-parameter path")
    if settings.faithful:
        if want_zero:
            raise ValueError(
                "flat_engine='zero' conflicts with faithful=True "
                "(faithful replicates optimizer state by definition)"
            )
        return "faithful"
    if want_zero and mesh and len(group.data_axes) != 1:
        return unavailable(f"needs exactly one data axis, mesh has {group.data_axes}")
    return "zero" if want_zero else None


# ---------------------------------------------------------------------------
# Loss and gradients (§5.1 slicing)
# ---------------------------------------------------------------------------


def _split_batch(batch: dict, k: int) -> list[dict]:
    def sp(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"num_slices={k} must divide the batch {b}")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))

    split = {n: sp(v) for n, v in batch.items()}
    return [{n: v[i] for n, v in split.items()} for i in range(k)]


def _make_compute_grads(cfg: ArchConfig, settings: TrainSettings, group=None,
                        shards: ShardLayout | None = None, model: ModelAxis | None = None):
    """``compute_grads(params, batch, layout=None) -> (loss, metrics,
    grads)``.  With ``k = num_slices > 1`` the batch is split into ``k``
    slices and ``grad / k`` accumulated in ``accum_dtype`` in slice order;
    loss and metrics are averaged the same way.  With a ``layout`` the
    accumulator is one flat buffer and ``grads`` its views.  With
    ``shards`` (FSDP) or ``model`` (a mesh program's model axis) the loss
    and its backward run inside the program, so the sharded leaves'
    gradients come back as this rank's shards of the mean over ``group``
    (the FSDP axis) and the models shard over ``model``."""
    mod = registry.get_module(cfg)

    def grad_fn(params, mb):
        pairs = list(tree_leaves(params))
        xs = [l.detach().requires_grad_() for _, l in pairs]
        with fsdp_program(group, shards.gather_dims, model) if shards else \
                contextlib.nullcontext():
            loss, metrics = mod.loss_fn(cfg, tree_from_leaves([p for p, _ in pairs], xs),
                                        mb, remat=settings.remat)
            grads = torch.autograd.grad(loss, xs)
        return loss.detach(), {n: m.detach() for n, m in metrics.items()}, grads

    def compute_grads(params, batch, layout: FlatLayout | None = None):
        paths = [p for p, _ in tree_leaves(params)]
        k = settings.num_slices
        if k == 1:
            loss, metrics, grads = grad_fn(params, batch)
            return loss, metrics, tree_from_leaves(paths, grads)

        adt = getattr(torch, settings.accum_dtype)
        leaves = [l for _, l in tree_leaves(params)]
        dev = leaves[0].device
        if layout is not None:
            acc = [g for _, g in tree_leaves(
                unflatten(layout, torch.zeros(layout.total, dtype=adt, device=dev), dtype=adt))]
        else:
            acc = [torch.zeros(l.shape, dtype=adt, device=dev) for l in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        m_acc = None
        for mb in _split_batch(batch, k):
            loss, metrics, grads = grad_fn(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(adt) / k)
            m_acc = {n: (0 if m_acc is None else m_acc[n]) + m / k
                     for n, m in metrics.items()}
            loss_acc = loss_acc + loss / k
        grads = [a.to(l.dtype) for a, l in zip(acc, leaves)]
        return loss_acc, m_acc, tree_from_leaves(paths, grads)

    return compute_grads


def to_device(batch: dict, device) -> dict:
    """Host batches go to the device through pinned memory, asynchronously
    (a pageable copy would wait for the card)."""
    out = {}
    for n, x in batch.items():
        t = torch.as_tensor(x)
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[n] = t
    return out


def _pmean_metrics(loss, metrics: dict, group):
    """Mean of the loss and each metric over the group, in one collective."""
    if group.pg is None:
        return loss, metrics
    names = sorted(metrics)
    vals = torch.stack([loss.float()] + [metrics[n].float() for n in names])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group.pg)
    vals = vals / group.world
    return vals[0], {n: vals[i + 1] for i, n in enumerate(names)}


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


def resolve_program(cfg: ArchConfig, group, settings: TrainSettings,
                    rules: ShardRules | None = None):
    """``(group, rules)`` of the per-parameter path: a ``DataGroup`` with
    ``rules`` or ``ShardRules.for_group(group, faithful=settings.faithful)``
    (FSDP unless faithful); a ``MeshGroup`` with ``rules`` or
    ``ShardRules.for_mesh`` for the families of
    ``registry.MESH_TRAIN_FAMILIES`` (the mesh program; ``sp`` off where
    the family has none, as the reference's launcher turns it off for the
    hybrid family), while the other families run on the mesh's data group
    without a model axis, which they raise for where it is live."""
    if not isinstance(group, MeshGroup):
        return group, rules or ShardRules.for_group(group, faithful=settings.faithful)
    rules = rules or ShardRules.for_mesh(group, faithful=settings.faithful)
    if rules.tp is not None and cfg.family in registry.MESH_TRAIN_FAMILIES:
        if not registry.sequence_parallel(cfg):
            rules = dataclasses.replace(rules, sp=False)
        return group, rules
    if rules.tp is not None and group.size(rules.tp) > 1:
        raise NotImplementedError(
            f"{cfg.name}: the model axis is ported for the lm family (dense, gemma2, "
            f"moe) and the hybrid family (zamba2), not the {cfg.family!r} family; the mesh "
            f"{group.describe()} has a live model axis (ROADMAP.md "
            f"{registry.MESH_FAMILY_ITEM})")
    return group.data, ShardRules.for_group(group.data, faithful=settings.faithful)


def shard_layout_for(cfg: ArchConfig, group, settings: TrainSettings,
                     rules: ShardRules | None = None) -> ShardLayout:
    """The per-parameter path's shard layout on this rank, under the rules
    :func:`resolve_program` picks (``rules`` where given)."""
    group, rules = resolve_program(cfg, group, settings, rules)
    if isinstance(group, MeshGroup):
        return make_shard_layout(cfg, rules, group.size("data"), group.coord("data"),
                                 model=group.size("model"), model_rank=group.coord("model"))
    return make_shard_layout(cfg, rules, group.world, group.rank)


def model_partial_paths(shards: ShardLayout, rules: ShardRules,
                        region: frozenset) -> frozenset:
    """The leaves replicated over the model axis whose gradient each model
    rank holds a partial sum of (they take an ``all_reduce`` SUM over
    ``model``): under ``sp`` every one (the norms act on sequence shards,
    the rest on per-rank work); without it the leaves read inside the
    tensor-parallel region (``region``, ``registry.tp_region_leaves``: the
    lm family's q/k norms, on local or every head, and its router, whose
    gradient flows through the rank's experts; zamba2's per-head Mamba2
    leaves), the residual stream's norms then holding the whole gradient on
    every rank.  A leaf split over ``model`` takes none."""
    if rules.tp is None:
        return frozenset()
    return frozenset(p for p in shards.paths if p not in shards.model_sharded
                     and (rules.sp or p[-1] in region))


def build_train_step(cfg: ArchConfig, group, opt: OptConfig,
                     settings: TrainSettings = TrainSettings(),
                     rules: ShardRules | None = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` for this worker's rows of the batch.

    The returned callable carries ``_flat_engine`` (None | "faithful" |
    "zero") and, when flat, ``_flat_layout`` / ``_flat_buckets``; on the
    per-parameter path ``_shard_layout`` (what this rank's ``params`` and
    ``opt_state`` leaves are: shards of the leaves it lists as sharded).
    ``rules`` matter on the per-parameter path only.
    """
    mode = flat_engine_mode(cfg, group, opt, settings)
    if mode is not None:
        return _build_flat_train_step(cfg, _data_group(group), opt, settings, mode)
    group, rules = resolve_program(cfg, group, settings, rules)
    if isinstance(group, MeshGroup):
        return _build_mesh_train_step(cfg, group, opt, settings, rules)

    shards = shard_layout_for(cfg, group, settings, rules)
    sharded = shards.sharded
    compute_grads = _make_compute_grads(cfg, settings, group, shards if sharded else None)
    masks = _norm_masks(shards, group.device, [(group, sharded)])

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, to_device(batch, group.device))
        loss, metrics = _pmean_metrics(loss, metrics, group)
        _reduce_grads(grads, sharded, group)
        params, opt_state, opt_metrics = apply_update(opt, params, grads, opt_state,
                                                      sharded=masks)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    train_step._flat_engine = None
    train_step._shard_layout = shards
    train_step._gather_groups = (group, None)
    return train_step


def _norm_masks(shards: ShardLayout, device, axes) -> list:
    """The global norm's ``(group, mask)`` pairs for ``axes``, ``(group,
    paths split over it)`` (an axis that splits nothing is left out), made
    once: a step copies nothing from the host."""
    return [(g, torch.tensor([p in split for p in shards.paths], device=device))
            for g, split in axes if split]


def _reduce_grads(grads, sharded, data, others=(), partial=frozenset(), model=None):
    """The gradient rule, a leaf at a time.  A leaf each model rank holds a
    partial sum of (``partial``, :func:`model_partial_paths`) is summed over
    ``model``.  A leaf split over the FSDP axis (``sharded``) arrives
    averaged over it (the gather's backward reduce-scatters it) and takes
    the mean over ``others``, the remaining data axes; every other leaf
    takes the mean over ``data``."""
    for path, g in tree_leaves(grads):
        if path in partial and model.pg is not None:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=model.pg)
        for group in (others if path in sharded else (data,)):
            if group.pg is not None:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group.pg)
                g.div_(group.world)


def _data_group(group):
    """The group the batch splits over: a mesh's data axes, or the group."""
    return group.data if isinstance(group, MeshGroup) else group


def _build_mesh_train_step(cfg, mesh: MeshGroup, opt, settings, rules: ShardRules):
    """The per-parameter path on a mesh (the module docstring): FSDP over
    ``rules.fsdp``, tensor, sequence and expert parallelism over
    ``model``."""
    shards = shard_layout_for(cfg, mesh, settings, rules)
    fsdp_g = mesh.axis(rules.fsdp) if rules.fsdp else None
    data, model_g = mesh.data, mesh.model
    # FSDP leaves arrive averaged over the FSDP axis: the other data axes
    # (a multipod's pod) still take a mean
    others = [mesh.axis(a) for a in rules.dp if a != rules.fsdp]
    sharded = shards.sharded
    partial = model_partial_paths(shards, rules, registry.tp_region_leaves(cfg))
    compute_grads = _make_compute_grads(cfg, settings, fsdp_g, shards,
                                        ModelAxis(model_g, rules.sp))
    dev = mesh.device
    masks = _norm_masks(shards, dev, [(fsdp_g, sharded), (model_g, shards.model_sharded)])

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, to_device(batch, dev))
        loss, metrics = _pmean_metrics(loss, metrics, data)
        _reduce_grads(grads, sharded, data, others, partial, model_g)
        params, opt_state, opt_metrics = apply_update(opt, params, grads, opt_state,
                                                      sharded=masks)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    train_step._flat_engine = None
    train_step._shard_layout = shards
    train_step._gather_groups = (fsdp_g, model_g)
    train_step._model_partial = partial
    train_step._rules = rules
    return train_step


def flat_layout_for(cfg: ArchConfig) -> FlatLayout:
    return make_layout(registry.abstract_params(cfg))


def buckets_for(cfg: ArchConfig, opt: OptConfig, *, n_shards: int = 1) -> BucketLayout:
    return make_buckets(
        flat_layout_for(cfg),
        bucket_bytes=resolve_bucket_bytes(opt.bucket_mb, group_size=n_shards),
        n_shards=n_shards,
    )


def _build_flat_train_step(cfg, group, opt, settings, mode: str):
    compute_grads = _make_compute_grads(cfg, settings)
    layout = flat_layout_for(cfg)
    buckets = buckets_for(cfg, opt, n_shards=group.world if mode == "zero" else 1)
    wd = opt.weight_decay if opt.kind == "adamw" else 0.0
    adam_kw = dict(lr=opt.lr, beta1=opt.beta1, beta2=opt.beta2, eps=opt.eps,
                   weight_decay=wd, use_kernel=settings.flat_kernel)

    def _clip(sq_sum, g):
        norm = torch.sqrt(sq_sum)
        scale = torch.clamp(opt.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
        return g * scale, norm

    def _psum(x):
        if group.pg is not None:
            x = x.reshape(1)
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group.pg)
            x = x[0]
        return x

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, to_device(batch, group.device), layout)
        loss, metrics = _pmean_metrics(loss, metrics, group)
        gflat = flatten(layout, grads)
        del grads
        step = opt_state["step"] + 1

        if mode == "faithful":
            # Appendix A, bucketed: every worker ends with the full mean
            # gradient; update replicated flat p/m/v buffers in one pass.
            gflat = bucketed_all_reduce(gflat, buckets, group, op="mean")
            # skip verdict AFTER the all-reduce: one worker's NaN poisons
            # every worker's mean, so it is consistent with no collective
            ok = torch.isfinite(gflat).all() if settings.skip_nonfinite else None
            if opt.grad_clip:
                gflat, gnorm = _clip(gflat.square().sum(), gflat)
                metrics = {**metrics, "grad_norm": gnorm}
            pflat = flatten(layout, params)
            mflat = flatten(layout, opt_state["m"])
            vflat = flatten(layout, opt_state["v"])
            p2, m2, v2 = flat_adam_apply(pflat, gflat, mflat, vflat, step, **adam_kw)
            del gflat
            if ok is not None:
                # bitwise no-op on skip: keep the pre-update buffers and
                # don't advance the Adam step counter
                p2 = torch.where(ok, p2, pflat)
                m2 = torch.where(ok, m2, mflat)
                v2 = torch.where(ok, v2, vflat)
                step = opt_state["step"] + ok.to(step.dtype)
                metrics = {**metrics, "skipped": 1.0 - ok.float()}
            new_state = {"step": step, "m": unflatten(layout, m2, dtype=torch.float32),
                         "v": unflatten(layout, v2, dtype=torch.float32)}
            return unflatten(layout, p2), new_state, {"loss": loss, **metrics}

        # ZeRO: own 1/N of every bucket; m/v live scattered (flat, sharded)
        g_loc = bucketed_reduce_scatter(gflat, buckets, group, op="mean")
        del gflat
        # the scatter localizes a NaN to whichever shard owns it, so the
        # verdict needs an all-reduced count to stay in lockstep
        ok = None
        if settings.skip_nonfinite:
            ok = _psum((~torch.isfinite(g_loc)).sum(dtype=torch.int32)) == 0
        if opt.grad_clip:
            g_loc, gnorm = _clip(_psum(g_loc.square().sum()), g_loc)
            metrics = {**metrics, "grad_norm": gnorm}
        p_loc = scatter_flat(flatten(layout, params), buckets, group.rank)
        p2, m2, v2 = flat_adam_apply(p_loc, g_loc, opt_state["m"], opt_state["v"],
                                     step, **adam_kw)
        del g_loc
        if ok is not None:
            # params reassemble through the all-gather of the unchanged
            # shard, pure data movement, so the round trip is bitwise
            p2 = torch.where(ok, p2, p_loc)
            m2 = torch.where(ok, m2, opt_state["m"])
            v2 = torch.where(ok, v2, opt_state["v"])
            step = opt_state["step"] + ok.to(step.dtype)
            metrics = {**metrics, "skipped": 1.0 - ok.float()}
        new_params = unflatten(layout, bucketed_all_gather(p2, buckets, group))
        return new_params, {"step": step, "m": m2, "v": v2}, {"loss": loss, **metrics}

    train_step._flat_engine = mode
    train_step._flat_layout = layout
    train_step._flat_buckets = buckets
    return train_step


# ---------------------------------------------------------------------------
# Optimizer-state construction (mode-aware: ZeRO flat state is scattered)
# ---------------------------------------------------------------------------


def opt_state_template(cfg: ArchConfig, group, opt: OptConfig,
                       settings: TrainSettings = TrainSettings(),
                       rules: ShardRules | None = None):
    """Returns ``init_fn(params) -> opt_state`` consistent with what
    :func:`build_train_step` expects: ZeRO's ``m``/``v`` are this worker's
    flat scattered shards (``local_total`` long), faithful's are trees of
    views of one flat buffer each, the per-parameter path's trees of the
    parameters' shapes (under FSDP this rank's shards, which ``params``
    must already be)."""
    mode = flat_engine_mode(cfg, group, opt, settings)
    if mode is not None:
        group = _data_group(group)

    def step0():
        return torch.zeros((), dtype=torch.int32, device=group.device)

    if mode == "zero":
        n = buckets_for(cfg, opt, n_shards=group.world).local_total

        def init_fn(params):
            del params
            z = lambda: torch.zeros(n, dtype=torch.float32, device=group.device)
            return {"step": step0(), "m": z(), "v": z()}

        return init_fn
    if mode == "faithful":
        layout = flat_layout_for(cfg)

        def init_fn(params):
            del params
            z = lambda: unflatten(layout, torch.zeros(layout.total, dtype=torch.float32,
                                                      device=group.device), dtype=torch.float32)
            return {"step": step0(), "m": z(), "v": z()}

        return init_fn
    shards = shard_layout_for(cfg, group, settings, rules)

    def init_fn(params):
        check_shards(shards, params)
        return init_state(opt, params)

    return init_fn
