"""Train-step builder: loss -> grads -> update, with the paper's §5.1 input
slicing (gradient accumulation), remat, and the flat bucketed gradient
engine over a :class:`~repro_torch.launch.mesh.DataGroup`.

Each worker runs the returned ``train_step(params, opt_state, batch)`` on
ITS rows of the global batch (the loop hands rank ``r`` rows
``[r B/N, (r+1) B/N)``), as the reference's ``shard_map`` hands each worker
its block.  Three programs:

* **faithful** (``faithful=True``) — the paper's Appendix-A program:
  gradients flattened into ONE fp32 buffer (§3.3), one
  ``all_reduce(SUM) / N`` per ~4 MiB parameter-aligned bucket, clipping
  from the flat sum of squares, and the fused flat-Adam kernel on the
  replicated flat ``p/m/v``.
* **zero** (``flat_engine="zero"``) — per-bucket reduce-scatter, the
  flat-Adam kernel on the owned 1/N shard (ZeRO optimizer-state sharding:
  ``m``/``v`` are flat scattered buffers), per-bucket all-gather of the
  updated parameters.
* **per-parameter** (``flat_engine="off"``, or a non-adam rule) — one
  ``all_reduce`` of the mean per parameter, then ``optim.apply_update``.
  The reference shards parameters FSDP-style on this path; the port
  replicates them until the FSDP slice.

Both flat programs keep the fp32 parameters and the Adam moments as views
of flat buffers (``optim.flat``), so flattening them costs no copy; a step
copies the gradient once into its flat buffer (none with §5.1 slicing,
which accumulates into one), and the skip guard's ``torch.where`` makes
one more copy of p, m and v.  The step counter and the ``skipped`` flag
stay device tensors: a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.optim import OptConfig, apply_update, init_state
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
    ``flat_engine="zero"`` request raises when it cannot engage.  (The
    reference's "mesh has a live model axis" and "more than one data axis"
    cannot arise: a DataGroup is pure data parallelism over one axis.)
    """
    del group
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
    if cfg.family == "moe":
        return unavailable("MoE loss paths shard_map internally")
    if settings.faithful:
        if want_zero:
            raise ValueError(
                "flat_engine='zero' conflicts with faithful=True "
                "(faithful replicates optimizer state by definition)"
            )
        return "faithful"
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


def _make_compute_grads(cfg: ArchConfig, settings: TrainSettings):
    """``compute_grads(params, batch, layout=None) -> (loss, metrics,
    grads)``.  With ``k = num_slices > 1`` the batch is split into ``k``
    slices and ``grad / k`` accumulated in ``accum_dtype`` in slice order;
    loss and metrics are averaged the same way.  With a ``layout`` the
    accumulator is one flat buffer and ``grads`` its views."""
    mod = registry.get_module(cfg)

    def grad_fn(params, mb):
        pairs = list(tree_leaves(params))
        xs = [l.detach().requires_grad_() for _, l in pairs]
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


def _to_device(batch: dict, device) -> dict:
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


def build_train_step(cfg: ArchConfig, group, opt: OptConfig,
                     settings: TrainSettings = TrainSettings()) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` for this worker's rows of the batch.

    The returned callable carries ``_flat_engine`` (None | "faithful" |
    "zero") and, when flat, ``_flat_layout`` / ``_flat_buckets``.
    """
    mode = flat_engine_mode(cfg, group, opt, settings)
    if mode is not None:
        return _build_flat_train_step(cfg, group, opt, settings, mode)

    compute_grads = _make_compute_grads(cfg, settings)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, _to_device(batch, group.device))
        loss, metrics = _pmean_metrics(loss, metrics, group)
        if group.pg is not None:
            for _, g in tree_leaves(grads):
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group.pg)
                g.div_(group.world)
        params, opt_state, opt_metrics = apply_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    train_step._flat_engine = None
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
        loss, metrics, grads = compute_grads(params, _to_device(batch, group.device), layout)
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
                       settings: TrainSettings = TrainSettings()):
    """Returns ``init_fn(params) -> opt_state`` consistent with what
    :func:`build_train_step` expects: ZeRO's ``m``/``v`` are this worker's
    flat scattered shards (``local_total`` long), faithful's are trees of
    views of one flat buffer each, the per-parameter path's trees."""
    mode = flat_engine_mode(cfg, group, opt, settings)

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
    return lambda params: init_state(opt, params)
