"""Training loop with fault tolerance: checkpoint/restart, deterministic
data replay, and the elastic ZeRO reshard across data-parallel sizes.

Every worker of the :class:`~repro_torch.launch.mesh.DataGroup` runs this
loop on its ``global_batch / world`` rows of each deterministic batch.
Batches are staged through pinned memory and copied asynchronously, the
step program makes no host sync, and checkpoint writes run on a
background thread, so the host waits for the card only where it reads a
logged loss.  Rank 0 writes the checkpoints; ZeRO's scattered ``m``/``v``
are gathered into the reference's global scattered layout first.
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
from repro_torch.models import registry
from repro_torch.models.common import map_tree
from repro_torch.optim import OptConfig, init_state
from repro_torch.optim.buckets import make_buckets, reshard_scattered
from repro_torch.optim.flat import flatten, tree_leaves, unflatten
from repro_torch.train.step import (
    TrainSettings,
    build_train_step,
    flat_engine_mode,
    flat_layout_for,
    opt_state_template,
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
    broadcast from rank 0, and the optimizer state for ``settings``' program
    (the counterpart of the reference's ``init_sharded``)."""
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
) -> dict:
    """Runs the loop on this worker; returns the final metrics summary.
    (The reference's ``obs`` hook arrives with the observability slice.)"""
    step_fn = build_train_step(cfg, group, opt, settings)
    mode = step_fn._flat_engine
    batch_fn = make_batch_fn(cfg, shape, loop.seed)
    B = shape.global_batch
    if B % group.world:
        raise ValueError(f"global batch {B} does not split over {group.world} workers")
    lo, hi = group.rank * B // group.world, (group.rank + 1) * B // group.world

    mgr = CheckpointManager(loop.ckpt_dir, loop.keep_k) if loop.ckpt_dir else None
    # flat-engine provenance rides the checkpoint meta: a ZeRO
    # checkpoint's scattered m/v bake in (n_shards, bucket boundaries),
    # which a restore onto a different dp size must know to undo
    ckpt_meta = {"flat_engine": mode}
    if mode == "zero":
        ckpt_meta["zero_n_shards"] = step_fn._flat_buckets.n_shards
        ckpt_meta["zero_bucket_bytes"] = step_fn._flat_buckets.bucket_bytes

    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        start, params, opt_state = _restore(cfg, group, opt, mgr, step_fn)
        if group.rank == 0:
            print(f"[train] resumed from step {start}")
    else:
        params, opt_state = init_replicated(cfg, group, opt, loop.seed, settings)

    def save(step: int, blocking: bool):
        opt_host = opt_state
        if mode == "zero":
            opt_host = {**opt_state, "m": _gather_scattered(opt_state["m"], group),
                        "v": _gather_scattered(opt_state["v"], group)}
        if group.rank == 0:
            mgr.save(step, {"params": params, "opt": opt_host}, blocking=blocking,
                     extra_meta=ckpt_meta)

    losses, t0 = [], time.perf_counter()
    metrics: dict = {}
    skipped = []   # per-step device scalars; summed once at the end
    for step in range(start, loop.steps):
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
            save(step + 1, blocking=False)
        if on_step:
            on_step(step, metrics)
    if mgr:
        save(loop.steps, blocking=True)
        mgr.wait()
    return {
        "final_loss": float(metrics["loss"]) if metrics else float("nan"),
        "losses": losses,
        # non-finite-gradient steps the flat engine turned into bitwise
        # no-ops (train/step.py skip_nonfinite); 0 off the flat paths
        "skipped_steps": int(torch.stack(skipped).sum().item()) if skipped else 0,
        "params": params,
        "opt_state": opt_state,
    }


def _restore(cfg, group, opt, mgr, step_fn):
    """(step, params, opt_state) from the newest checkpoint, placed on the
    group's device; a ZeRO checkpoint from another dp size or bucket size
    is resharded on the host first (elastic restore)."""
    mode = step_fn._flat_engine
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
    to_dev = lambda a: torch.as_tensor(np.asarray(a), device=group.device)
    params = map_tree(to_dev, state["params"])
    opt_state = map_tree(to_dev, state["opt"])
    if mode == "zero":
        for k in ("m", "v"):
            buf = state["opt"][k]
            if old_b is not None:
                buf = reshard_scattered(buf, old_b, new_b)
            n = new_b.local_total
            opt_state[k] = to_dev(buf[group.rank * n: (group.rank + 1) * n])
    if mode is not None:
        # the flat programs keep p (and faithful's m/v) as views of one
        # flat buffer each, so their per-step flatten is free
        layout = step_fn._flat_layout
        params = unflatten(layout, flatten(layout, params))
        if mode == "faithful":
            for k in ("m", "v"):
                opt_state[k] = unflatten(layout, flatten(layout, opt_state[k]))
    return start, params, opt_state
