"""Training loop with fault tolerance: checkpoint/restart, deterministic
data replay, and the elastic reshard across data-parallel sizes.

Every worker of the :class:`~repro_torch.launch.mesh.DataGroup` (or of a
:class:`~repro_torch.launch.mesh.MeshGroup`'s data axes: the ranks of one
data column take the same rows) runs this loop on its ``global_batch /
N_data`` rows of each deterministic batch.
Batches are staged through pinned memory and copied asynchronously, the
step program makes no host sync, and checkpoint writes run on a
background thread, so the host waits for the card only where it reads a
logged loss.  Rank 0 writes the checkpoints; ZeRO's scattered ``m``/``v``
are gathered into the reference's global scattered layout first, and the
per-parameter path's shards (FSDP, and the model axis' slices on a mesh)
into full leaves, one leaf at a time on the host (the reference stores
full host arrays).  A restore re-shards for the group or mesh it runs on,
so a checkpoint of any data-parallel size, mesh and rules (FSDP or
replicated) restores on any other: a ``(2, 1)`` checkpoint continues on
``(1, 2)``, the reference's ``check_elastic``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data import make_batch_fn
from repro_torch.launch.mesh import MeshGroup
from repro_torch.models import registry
from repro_torch.models.common import map_tree
from repro_torch.obs import Observer
from repro_torch.models.common import ShardRules
from repro_torch.optim import OptConfig, init_state
from repro_torch.optim.buckets import make_buckets, reshard_scattered
from repro_torch.optim.flat import flatten, tree_leaves, unflatten
from repro_torch.optim.fsdp import full_tree, init_shards, shard_tree
from repro_torch.train.step import (
    TrainSettings,
    to_device,
    build_train_step,
    flat_engine_mode,
    flat_layout_for,
    opt_state_template,
    shard_layout_for,
)


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep_k: int = 3
    log_every: int = 10
    seed: int = 0


def init_replicated(cfg: ArchConfig, group, opt: OptConfig, seed: int,
                    settings: TrainSettings = TrainSettings()):
    """Parameters from the family's ``init`` on the group's device,
    broadcast from rank 0, and the optimizer state for ``settings``' flat
    program (:func:`init_sharded` takes the per-parameter path)."""
    params = registry.get_module(cfg).init(cfg, seed=seed, device=group.device)
    if group.pg is not None:
        for _, leaf in tree_leaves(params):
            dist.broadcast(leaf, src=0, group=group.pg)
    if flat_engine_mode(cfg, group, opt, settings) is not None:
        # the flat programs keep p as views of one flat buffer, so their
        # per-step flatten is free
        layout = flat_layout_for(cfg)
        params = unflatten(layout, flatten(layout, params))
    return params, opt_state_template(cfg, group, opt, settings)(params)


def init_sharded(cfg: ArchConfig, group, opt: OptConfig, seed: int,
                 settings: TrainSettings = TrainSettings(),
                 rules: ShardRules | None = None):
    """Parameters and optimizer state for the program ``settings`` and
    ``rules`` select (the counterpart of the reference's ``init_sharded``).
    The flat programs replicate (:func:`init_replicated`).  The
    per-parameter path holds this rank's shards of the leaves ``rules``
    shard (``optim.fsdp.init_shards``: the values of the unsharded ``init``
    for ``seed``, whatever the world, with no sharded leaf ever whole on a
    rank) and the rest whole, broadcast from rank 0; the state is zeros of
    the same shards."""
    if flat_engine_mode(cfg, group, opt, settings) is not None:
        data = group.data if isinstance(group, MeshGroup) else group
        return init_replicated(cfg, data, opt, seed, settings)
    shards = shard_layout_for(cfg, group, settings, rules)
    params = init_shards(cfg, shards, seed, group.device)
    if group.pg is not None:
        split = shards.sharded | shards.model_sharded
        for path, leaf in tree_leaves(params):
            if path not in split:
                dist.broadcast(leaf, src=0, group=group.pg)
    return params, opt_state_template(cfg, group, opt, settings, rules)(params)


def _full_state(shards, params, opt_state, groups):
    """Full leaves of the per-parameter path's params and optimizer state
    on the host, gathered one leaf at a time over ``groups`` (the FSDP
    axis' and the model axis', every rank taking part)."""
    opt_host = {k: full_tree(shards, v, *groups) if isinstance(v, dict) else v
                for k, v in opt_state.items()}
    return full_tree(shards, params, *groups), opt_host


def _opt_template(cfg, opt, mode, scattered_total):
    """Meta-tensor template of the checkpointed optimizer state: ZeRO's
    m/v are the GLOBAL scattered buffers, the others mirror the params."""
    step = torch.empty((), dtype=torch.int32, device="meta")
    if mode == "zero":
        z = torch.empty(scattered_total, dtype=torch.float32, device="meta")
        return {"step": step, "m": z, "v": z}
    tmpl = init_state(opt, registry.abstract_params(cfg))
    tmpl["step"] = step
    return tmpl


def _gather_scattered(x, group):
    """This worker's scattered shard -> the global (worker-major) buffer."""
    if group.pg is None:
        return x
    out = torch.empty(x.numel() * group.world, dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group.pg)
    return out


def train(
    cfg: ArchConfig,
    shape: ShapeConfig,
    group,
    opt: OptConfig,
    settings: TrainSettings = TrainSettings(),
    loop: LoopConfig = LoopConfig(),
    *,
    resume: bool = True,
    on_step: Callable[[int, dict], None] | None = None,
    obs: Observer | None = None,
    rules: ShardRules | None = None,
) -> dict:
    """Runs the loop on this worker; returns the final metrics summary.
    ``rules`` select the per-parameter path's sharding (default
    ``ShardRules.for_group(group, faithful=settings.faithful)``: FSDP unless
    faithful); the returned ``params`` and ``opt_state`` are this rank's
    (shards where the rules shard).

    With an :class:`~repro_torch.obs.Observer` every step records a
    ``step_ms`` histogram, and the summary embeds the metrics snapshot
    (``out["metrics"]``).  With a tracer too, each step emits the phase
    spans ``stage_batch`` / ``h2d`` / ``dispatch`` / ``device_wait`` (and
    ``ckpt_save``).  ``device_wait`` synchronizes the device: traced, the
    loop adds that one host sync a step (it separates host staging and
    dispatch from device compute); untraced, it makes none."""
    step_fn = build_train_step(cfg, group, opt, settings, rules)
    mode = step_fn._flat_engine
    shards = step_fn._shard_layout if mode is None else None
    batch_fn = make_batch_fn(cfg, shape, loop.seed)
    B = shape.global_batch
    data = group.data if isinstance(group, MeshGroup) else group
    if B % data.world:
        raise ValueError(f"global batch {B} does not split over {data.world} workers")
    lo, hi = data.rank * B // data.world, (data.rank + 1) * B // data.world

    mgr = CheckpointManager(loop.ckpt_dir, loop.keep_k, obs=obs) if loop.ckpt_dir else None
    # flat-engine provenance rides the checkpoint meta: a ZeRO
    # checkpoint's scattered m/v bake in (n_shards, bucket boundaries),
    # which a restore onto a different dp size must know to undo
    ckpt_meta = {"flat_engine": mode}
    if mode == "zero":
        ckpt_meta["zero_n_shards"] = step_fn._flat_buckets.n_shards
        ckpt_meta["zero_bucket_bytes"] = step_fn._flat_buckets.bucket_bytes

    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        start, params, opt_state = _restore(cfg, data, opt, mgr, step_fn)
        if group.rank == 0:
            print(f"[train] resumed from step {start}")
    else:
        params, opt_state = init_sharded(cfg, group, opt, loop.seed, settings, rules)

    def save(step: int, blocking: bool):
        params_host, opt_host = params, opt_state
        if mode == "zero":
            opt_host = {**opt_state, "m": _gather_scattered(opt_state["m"], data),
                        "v": _gather_scattered(opt_state["v"], data)}
        elif shards is not None:
            params_host, opt_host = _full_state(shards, params, opt_state,
                                                step_fn._gather_groups)
        if group.rank == 0:
            mgr.save(step, {"params": params_host, "opt": opt_host}, blocking=blocking,
                     extra_meta=ckpt_meta)

    losses, t0 = [], time.perf_counter()
    metrics: dict = {}
    skipped = []   # per-step device scalars; summed once at the end
    traced = obs is not None and obs.tracer is not None
    step_hist = obs.metrics.histogram("step_ms") if obs is not None else None
    for step in range(start, loop.steps):
        ts = time.perf_counter()
        if traced:
            with obs.span("stage_batch", cat="train", track="train", step=step):
                host = batch_fn(step)
                batch = {k: v[lo:hi] for k, v in host.items()}
            with obs.span("h2d", cat="train", track="train"):
                batch = to_device(batch, group.device)
            with obs.span("dispatch", cat="train", track="train"):
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            # traced only: wait for the device, so the span boundary
            # separates staging and dispatch from compute
            with obs.span("device_wait", cat="train", track="train"):
                if group.device.type == "cuda":
                    torch.cuda.synchronize(group.device)
        else:
            host = batch_fn(step)
            batch = {k: v[lo:hi] for k, v in host.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if "skipped" in metrics:
            skipped.append(metrics["skipped"])
        if loop.log_every and (step + 1) % loop.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            if group.rank == 0:
                print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if mgr and loop.ckpt_every and (step + 1) % loop.ckpt_every == 0:
            if traced:
                with obs.span("ckpt_save", cat="train", track="train", step=step + 1):
                    save(step + 1, blocking=False)
            else:
                save(step + 1, blocking=False)
        if on_step:
            on_step(step, metrics)
        if step_hist is not None:
            step_hist.observe((time.perf_counter() - ts) * 1e3)
    if mgr:
        save(loop.steps, blocking=True)
        mgr.wait()
    out = {
        "final_loss": float(metrics["loss"]) if metrics else float("nan"),
        "losses": losses,
        # non-finite-gradient steps the flat engine turned into bitwise
        # no-ops (train/step.py skip_nonfinite); 0 off the flat paths
        "skipped_steps": int(torch.stack(skipped).sum().item()) if skipped else 0,
        "params": params,
        "opt_state": opt_state,
    }
    if obs is not None:
        out["metrics"] = obs.metrics.snapshot()
    return out


def _restore(cfg, group, opt, mgr, step_fn):
    """(step, params, opt_state) from the newest checkpoint, placed on the
    group's device; a ZeRO checkpoint from another dp size or bucket size
    is resharded on the host first (elastic restore), and the per-parameter
    path takes this rank's shards of the full leaves (``restore``'s
    ``shard_fn``)."""
    mode = step_fn._flat_engine
    to_dev = lambda a: torch.as_tensor(np.asarray(a), device=group.device)
    if mode is None:
        shards = step_fn._shard_layout
        _, state = mgr.restore({"params": registry.abstract_params(cfg)},
                               shard_fn=lambda tree: shard_tree(shards, tree))
        params = map_tree(to_dev, state["params"])
        start, state = mgr.restore(
            {"opt": _opt_template(cfg, opt, None, 0)},
            shard_fn=lambda st: {k: shard_tree(shards, v) if isinstance(v, dict) else v
                                 for k, v in st.items()})
        return start, params, map_tree(to_dev, state["opt"])
    _, meta = mgr.load_meta()
    new_b = step_fn._flat_buckets
    old_b = None
    if mode == "zero" and meta.get("flat_engine") == "zero":
        old_n = int(meta.get("zero_n_shards", new_b.n_shards))
        old_bb = int(meta.get("zero_bucket_bytes", new_b.bucket_bytes))
        if (old_n, old_bb) != (new_b.n_shards, new_b.bucket_bytes):
            old_b = make_buckets(flat_layout_for(cfg), bucket_bytes=old_bb, n_shards=old_n)
            if group.rank == 0:
                print(f"[train] resharding ZeRO state dp={old_n} -> dp={new_b.n_shards}")
    scattered = (old_b or new_b).scattered_total if mode == "zero" else 0
    template = {"params": registry.abstract_params(cfg),
                "opt": _opt_template(cfg, opt, mode, scattered)}
    start, state = mgr.restore(template)
    params = map_tree(to_dev, state["params"])
    opt_state = map_tree(to_dev, state["opt"])
    if mode == "zero":
        for k in ("m", "v"):
            buf = state["opt"][k]
            if old_b is not None:
                buf = reshard_scattered(buf, old_b, new_b)
            n = new_b.local_total
            opt_state[k] = to_dev(buf[group.rank * n: (group.rank + 1) * n])
    # the flat programs keep p (and faithful's m/v) as views of one flat
    # buffer each, so their per-step flatten is free
    layout = step_fn._flat_layout
    params = unflatten(layout, flatten(layout, params))
    if mode == "faithful":
        for k in ("m", "v"):
            opt_state[k] = unflatten(layout, flatten(layout, opt_state[k]))
    return start, params, opt_state
