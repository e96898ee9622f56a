"""The port's data-parallel programs across two real workers.

ONE spawn of 2 gloo ranks (``torch.distributed`` at a free port on
127.0.0.1) runs every check in turn and writes its results; the tests
below read them, and run the one-worker counterparts in this process:

* per-bucket all-reduce == one all-reduce of the whole buffer, bitwise.
  The claim is held at two ranks, where each element's sum is ``a + b``
  and addition commutes exactly; with more ranks a ring can add a large
  and a small collective in different orders;
* reduce-scatter then all-gather round-trips the summed buffer, bitwise;
* the faithful step on 2 ranks equals the 1-rank step on the full batch,
  and ZeRO on 2 ranks equals faithful;
* a NaN on one rank only makes both ranks skip, bitwise;
* a ZeRO checkpoint written at dp 2 restores at dp 1 (elastic reshard).

Steps run in fp32 compute at lr 1e-3; parameters are held to ``3 lr`` with
at most 0.1% of elements more than 5e-5 apart, for the reason given in
``test_torch_train_step.py`` (Adam's first step turns last-bit gradient
differences near zero into moves of up to ±lr); losses within 1e-5.
"""
import dataclasses
import multiprocessing
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import init_group, single_device_group
from repro_torch.models import lm
from repro_torch.optim import OptConfig
from repro_torch.optim.buckets import (
    bucketed_all_gather, bucketed_all_reduce, bucketed_reduce_scatter, make_buckets,
    unscatter_flat,
)
from repro_torch.optim.flat import flatten, unflatten
from repro_torch.train import LoopConfig, TrainSettings, build_train_step, train
from repro_torch.train.loop import init_replicated
from repro_torch.train.step import flat_layout_for, opt_state_template

WORLD = 2
LR = 1e-3
CFG = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
OPT = OptConfig(kind="adam", lr=LR, bucket_mb=0.01)
SHAPE = ShapeConfig("t", "train", 16, 8)
MODES = {"faithful": TrainSettings(faithful=True), "zero": TrainSettings(flat_engine="zero")}


def _batch(i):
    return np.random.default_rng(50 + i).integers(0, CFG.vocab, (8, 17)).astype(np.int32)


def _run_steps(group, mode, steps=2, rows=slice(None)):
    """``steps`` steps of ``mode`` from seed-0 weights; returns the losses,
    grad norms and the final flat parameters."""
    params, state = init_replicated(CFG, group, OPT, 0, MODES[mode])
    step = build_train_step(CFG, group, OPT, MODES[mode])
    losses, norms = [], []
    for i in range(steps):
        params, state, m = step(params, state, {"tokens": _batch(i)[rows]})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=norms,
                params=flatten(flat_layout_for(CFG), params).clone(), state=state)


def _times_nan(loss, metrics):
    return loss * float("nan"), metrics


def _worker(rank, address, out_dir):
    torch.set_num_threads(1)
    group = init_group("gloo", rank, WORLD, address, device="cpu", timeout_s=120)
    res = {}
    try:
        layout = flat_layout_for(CFG)
        buf = torch.tensor(np.random.default_rng(100 + rank)
                           .normal(size=layout.total).astype(np.float32))
        buckets = make_buckets(layout, bucket_bytes=2048)
        mono = buf.clone()
        dist.all_reduce(mono)
        res["mono_sum"] = mono.clone()
        res["mono_mean"] = mono / WORLD
        res["bucketed_mean"] = bucketed_all_reduce(buf.clone(), buckets, group, op="mean")
        scattered = make_buckets(layout, bucket_bytes=2048, n_shards=WORLD)
        res["rs_local"] = bucketed_reduce_scatter(buf.clone(), scattered, group, op="sum")
        res["ag_full"] = bucketed_all_gather(res["rs_local"], scattered, group)

        rows = slice(rank * 4, (rank + 1) * 4)
        for mode in MODES:
            run = _run_steps(group, mode, rows=rows)
            # a NaN in rank 1's gradient only: its loss times NaN, the
            # weights still the same on both ranks
            state = run.pop("state")
            before = {k: (flatten(layout, v).clone() if isinstance(v, dict) else v.clone())
                      for k, v in state.items()}
            params = unflatten(layout, run["params"].clone())
            step = build_train_step(CFG, group, OPT, MODES[mode])
            real = lm.loss_fn
            if rank == 1:
                lm.loss_fn = lambda *a, **k: _times_nan(*real(*a, **k))
            try:
                p2, s2, m2 = step(params, state, {"tokens": _batch(9)[rows]})
            finally:
                lm.loss_fn = real
            after = {k: (flatten(layout, v) if isinstance(v, dict) else v)
                     for k, v in s2.items()}
            run["skip"] = dict(skipped=float(m2["skipped"]),
                               params_bitwise=torch.equal(flatten(layout, p2), run["params"]),
                               state_bitwise=all(torch.equal(after[k], before[k])
                                                 for k in before))
            res[mode] = run

        # elastic: a ZeRO run at dp 2 that checkpoints at its end
        out = train(CFG, SHAPE, group, OPT, MODES["zero"],
                    LoopConfig(steps=2, ckpt_every=0, ckpt_dir=str(out_dir / "ckpt"),
                               log_every=0))
        res["elastic_m_local"] = out["opt_state"]["m"]
        res["elastic_v_local"] = out["opt_state"]["v"]
    finally:
        group.close()
    torch.save(res, out_dir / f"rank{rank}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns their result dicts."""
    out_dir = tmp_path_factory.mktemp("dist")
    address = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, address, out_dir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0] * WORLD
    res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return res, out_dir


def assert_params_close(got, want):
    diff = (got - want).abs()
    assert diff.max().item() <= 3 * LR, diff.max().item()
    assert (diff > 5e-5).float().mean().item() <= 1e-3


def test_bucketed_all_reduce_equals_monolithic_bitwise(ranks):
    res, _ = ranks
    for r in res:
        assert torch.equal(r["bucketed_mean"], r["mono_mean"])
    assert torch.equal(res[0]["bucketed_mean"], res[1]["bucketed_mean"])


def test_reduce_scatter_then_all_gather_round_trips(ranks):
    res, _ = ranks
    layout = flat_layout_for(CFG)
    scattered = make_buckets(layout, bucket_bytes=2048, n_shards=WORLD)
    glob = torch.cat([r["rs_local"] for r in res])
    assert torch.equal(torch.tensor(unscatter_flat(glob.numpy(), scattered)), res[0]["mono_sum"])
    for r in res:
        assert torch.equal(r["ag_full"], r["mono_sum"])


def test_faithful_two_ranks_equal_one_rank_full_batch(ranks):
    res, _ = ranks
    one = _run_steps(single_device_group("cpu"), "faithful")
    for r in res:
        np.testing.assert_allclose(r["faithful"]["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["faithful"]["grad_norms"], one["grad_norms"], rtol=1e-4)
        assert_params_close(r["faithful"]["params"], one["params"])
    assert torch.equal(res[0]["faithful"]["params"], res[1]["faithful"]["params"])


def test_zero_equals_faithful(ranks):
    res, _ = ranks
    for r in res:
        np.testing.assert_allclose(r["zero"]["losses"], r["faithful"]["losses"], rtol=1e-6)
        assert_params_close(r["zero"]["params"], r["faithful"]["params"])
    assert torch.equal(res[0]["zero"]["params"], res[1]["zero"]["params"])


@pytest.mark.parametrize("mode", list(MODES))
def test_nan_on_one_rank_skips_both(ranks, mode):
    res, _ = ranks
    for r in res:
        assert r[mode]["skip"] == dict(skipped=1.0, params_bitwise=True, state_bitwise=True)


def test_elastic_zero_restore_dp2_to_dp1(ranks):
    res, out_dir = ranks
    ckpt = out_dir / "ckpt"
    meta = CheckpointManager(str(ckpt)).load_meta()[1]
    assert meta["flat_engine"] == "zero" and meta["zero_n_shards"] == WORLD
    old = make_buckets(flat_layout_for(CFG), bucket_bytes=meta["zero_bucket_bytes"],
                       n_shards=WORLD)
    one = single_device_group("cpu")
    new = make_buckets(flat_layout_for(CFG), bucket_bytes=meta["zero_bucket_bytes"], n_shards=1)
    out = train(CFG, SHAPE, one, OPT, MODES["zero"],
                LoopConfig(steps=2, ckpt_every=0, ckpt_dir=str(ckpt), log_every=0))
    for k in ("m", "v"):
        glob = torch.cat([r[f"elastic_{k}_local"] for r in res]).numpy()
        assert np.array_equal(unscatter_flat(out["opt_state"][k].numpy(), new),
                              unscatter_flat(glob, old))
    # and training goes on from the resharded state at dp 1
    more = train(CFG, SHAPE, one, OPT, MODES["zero"],
                 LoopConfig(steps=3, ckpt_every=0, ckpt_dir=str(ckpt), log_every=0))
    assert np.isfinite(more["final_loss"]) and int(more["opt_state"]["step"]) == 3
    assert opt_state_template(CFG, one, OPT, MODES["zero"])(None)["m"].shape == \
        out["opt_state"]["m"].shape
