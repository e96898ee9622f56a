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
  and ZeRO on 2 ranks equals faithful; the same faithful check on the
  hybrid family (``zamba2-1.2b``: the SSD scan under a gradient);
* a NaN on one rank only makes both ranks skip, bitwise;
* a ZeRO checkpoint written at dp 2 restores at dp 1 (elastic reshard);
* FSDP on the per-parameter path (``optim/fsdp.py``): the weight gather's
  forward gives the full leaf and its backward the mean of the ranks'
  cotangents on the rank's shard; each rank holds exactly half of every
  sharded leaf's p, m and v; the sharded init holds the unsharded init's
  values; three FSDP steps of ``smollm-360m``, ``qwen3-moe-30b-a3b`` and
  ``zamba2-1.2b`` (smoke, fp32, the kernel path's plain versions), with and
  without 2 slices, each held against the reference's per-parameter
  program (``build_train_step`` with ``flat_engine="off"`` on
  ``single_device_mesh()``) taking the same step on the whole batch from
  the port's own state; and an FSDP checkpoint written at 2 ranks
  restores at 1 rank under both rules and continues as the 2-rank run.

The reference runs on the whole batch in ``2 k`` slices where each of the
2 ranks runs ``k``: rank ``r``'s rows are then exactly the reference's
slices ``r k .. r k + k - 1``, so the MoE family routes the same rows
together (its capacity and load-balance term depend on them) and every
family averages the same slice means.

Steps run in fp32 compute at lr 1e-3; parameters are held to ``3 lr`` with
at most 0.1% of elements more than 5e-5 apart, for the reason given in
``test_torch_train_step.py`` (Adam's first step turns last-bit gradient
differences near zero into moves of up to ±lr); losses within 1e-5, grad
norms 1e-4 relative, MoE's ``lb_loss`` 1e-5 and ``drop_frac`` 1e-6 (the
slices' means are summed in another order).  The reference is imported in
the tests alone, never in the ranks.
"""
import dataclasses
import gc
import multiprocessing
import shutil
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import init_group, single_device_group
from repro_torch.models import common, lm
from repro_torch.models.common import ShardRules
from repro_torch.optim import OptConfig
from repro_torch.optim.flat import tree_leaves
from repro_torch.optim.fsdp import full_tree, shard_tree
from repro_torch.optim.buckets import (
    bucketed_all_gather, bucketed_all_reduce, bucketed_reduce_scatter, make_buckets,
    unscatter_flat,
)
from repro_torch.optim.flat import flatten, unflatten
from repro_torch.train import LoopConfig, TrainSettings, build_train_step, train
from repro_torch.train.loop import init_replicated, init_sharded
from repro_torch.train.step import flat_layout_for, opt_state_template, shard_layout_for

WORLD = 2
LR = 1e-3
CFG = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
OPT = OptConfig(kind="adam", lr=LR, bucket_mb=0.01)
SHAPE = ShapeConfig("t", "train", 16, 8)
MODES = {"faithful": TrainSettings(faithful=True), "zero": TrainSettings(flat_engine="zero")}
ZAMBA = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32",
                            attn_impl="kernel")
FSDP_ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b", "zamba2-1.2b")
FSDP_B, FSDP_S, FSDP_STEPS = 4, 16, 3
FSDP_OPT = OptConfig(kind="adam", lr=LR)


def _fsdp_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl="kernel")


def _fsdp_tokens(cfg, i):
    rng = np.random.default_rng(10 + i)
    return rng.integers(0, cfg.vocab, (FSDP_B, FSDP_S + 1)).astype(np.int32)


def _batch(i):
    return np.random.default_rng(50 + i).integers(0, CFG.vocab, (8, 17)).astype(np.int32)


def _run_steps(group, mode, steps=2, rows=slice(None), cfg=CFG):
    """``steps`` steps of ``mode`` from seed-0 weights; returns the losses,
    grad norms and the final flat parameters."""
    params, state = init_replicated(cfg, group, OPT, 0, MODES[mode])
    step = build_train_step(cfg, group, OPT, MODES[mode])
    losses, norms = [], []
    for i in range(steps):
        params, state, m = step(params, state, {"tokens": _batch(i)[rows]})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=norms,
                params=flatten(flat_layout_for(cfg), params).clone(), state=state)


def _times_nan(loss, metrics):
    return loss * float("nan"), metrics


def _fsdp_checks(group, rank, out_dir) -> dict:
    """The FSDP checks of one rank (see the module docstring)."""
    out = {}
    w = torch.tensor(np.random.default_rng(7).standard_normal((6, 8)).astype(np.float32))
    cot = torch.tensor(np.random.default_rng(200 + rank).standard_normal((6, 8))
                       .astype(np.float32))
    for dim in (0, 1):
        for dtype in (torch.float32, torch.bfloat16):
            k = w.shape[dim] // WORLD
            shard = w.narrow(dim, rank * k, k).clone().requires_grad_()
            full = common.wuse(shard, dim, dtype, group)
            full.backward(cot.to(dtype))
            out[("gather", dim, str(dtype))] = dict(full=full.detach(), grad=shard.grad)

    params, state = init_sharded(CFG, group, OPT, 0, TrainSettings())
    shards = shard_layout_for(CFG, group, TrainSettings())
    out["init_full"] = full_tree(shards, params, group)

    rows = slice(rank * FSDP_B // WORLD, (rank + 1) * FSDP_B // WORLD)
    for arch in FSDP_ARCHS:
        cfg = _fsdp_cfg(arch)
        init = torch.load(out_dir / f"{arch}_init.pt", weights_only=False)
        shards = shard_layout_for(cfg, group, TrainSettings())
        for k in (1, 2):
            settings = TrainSettings(num_slices=k)
            step = build_train_step(cfg, group, FSDP_OPT, settings)
            assert step._flat_engine is None and step._shard_layout.sharded
            params = shard_tree(shards, init)
            state = opt_state_template(cfg, group, FSDP_OPT, settings)(params)
            run = {"metrics": [], "states": []}
            for i in range(FSDP_STEPS):
                params, state, m = step(params, state, {"tokens": _fsdp_tokens(cfg, i)[rows]})
                run["metrics"].append({n: float(v) for n, v in m.items()})
                run["states"].append({"params": full_tree(shards, params, group),
                                      **{n: full_tree(shards, state[n], group)
                                         for n in ("m", "v")},
                                      "step": int(state["step"])})
            run["local_shapes"] = {n: {"/".join(p): tuple(x.shape) for p, x in tree_leaves(t)}
                                   for n, t in (("p", params), ("m", state["m"]),
                                                ("v", state["v"]))}
            out[(arch, k)] = run

    # an FSDP run that checkpoints after 2 of its 3 steps and at its end
    res = train(CFG, SHAPE, group, OPT, TrainSettings(),
                LoopConfig(steps=3, ckpt_every=2, ckpt_dir=str(out_dir / "fsdp_ckpt"),
                           log_every=0))
    out["ckpt_final_loss"] = res["final_loss"]
    return out


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

        res["zamba"] = _run_steps(group, "faithful", rows=rows, cfg=ZAMBA)
        del res["zamba"]["state"]

        # elastic: a ZeRO run at dp 2 that checkpoints at its end
        out = train(CFG, SHAPE, group, OPT, MODES["zero"],
                    LoopConfig(steps=2, ckpt_every=0, ckpt_dir=str(out_dir / "ckpt"),
                               log_every=0))
        res["elastic_m_local"] = out["opt_state"]["m"]
        res["elastic_v_local"] = out["opt_state"]["v"]
        res["fsdp"] = _fsdp_checks(group, rank, out_dir)
        torch.save(res, out_dir / f"rank{rank}.pt")
        # both ranks are past their last collective before either tears
        # the group down (rank 0 hosts its store)
        dist.barrier()
    finally:
        group.close()
        # nothing else holds the group: its store and gloo threads are
        # freed here, not during the interpreter's teardown
        del group
        gc.collect()


def _jax_cfg(arch):
    from repro.configs import get_smoke_config as jax_smoke

    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32")


def _write_reference_inits(out_dir):
    """The reference's ``init`` of each FSDP family, converted, for the
    ranks to start from."""
    import jax

    from repro.models import registry as jreg
    from repro_torch.models.convert import params_from_numpy

    for arch in FSDP_ARCHS:
        jcfg = _jax_cfg(arch)
        jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
        torch.save(params_from_numpy(_fsdp_cfg(arch), jax.tree.map(np.asarray, jp),
                                     device="cpu"), out_dir / f"{arch}_init.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns their result dicts."""
    out_dir = tmp_path_factory.mktemp("dist")
    _write_reference_inits(out_dir)
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


def test_zamba_faithful_two_ranks_equal_one_rank(ranks):
    """The paper's program on the hybrid family: 2 ranks of half the batch
    each equal one worker on the whole batch."""
    res, _ = ranks
    one = _run_steps(single_device_group("cpu"), "faithful", cfg=ZAMBA)
    for r in res:
        np.testing.assert_allclose(r["zamba"]["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["zamba"]["grad_norms"], one["grad_norms"], rtol=1e-4)
        assert_params_close(r["zamba"]["params"], one["params"])
    assert torch.equal(res[0]["zamba"]["params"], res[1]["zamba"]["params"])


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


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("dim", [0, 1])
def test_fsdp_gather_forward_and_backward(ranks, dim, dtype):
    """Forward: the full leaf in the compute dtype (cast before the
    gather).  Backward: the mean of the two ranks' cotangents, restricted
    to the rank's shard, in fp32: ``(a + b) / 2`` is exact to round."""
    res, _ = ranks
    w = torch.tensor(np.random.default_rng(7).standard_normal((6, 8)).astype(np.float32))
    dt = getattr(torch, dtype.split(".")[1])
    cots = [torch.tensor(np.random.default_rng(200 + r).standard_normal((6, 8))
                         .astype(np.float32)).to(dt).float() for r in range(WORLD)]
    mean = (cots[0] + cots[1]) / 2
    k = w.shape[dim] // WORLD
    for r, out in enumerate(res):
        got = out["fsdp"][("gather", dim, dtype)]
        assert got["full"].dtype == dt and torch.equal(got["full"], w.to(dt))
        assert got["grad"].dtype == torch.float32
        assert torch.equal(got["grad"], mean.narrow(dim, r * k, k))


def test_fsdp_sharded_init_equals_init(ranks):
    res, _ = ranks
    want = lm.init(CFG, seed=0, device="cpu")
    for out in res:
        for (path, a), (_, b) in zip(tree_leaves(out["fsdp"]["init_full"]), tree_leaves(want)):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_ranks_hold_half_of_each_sharded_leaf(ranks, arch):
    """p, m and v: each rank's share of every sharded leaf is half its
    elements (a replicated leaf's is all of them), and the two shards tile
    the leaf along its FSDP dimension."""
    res, _ = ranks
    cfg = _fsdp_cfg(arch)
    shards = shard_layout_for(cfg, single_device_group("cpu"), TrainSettings())
    assert len(shards.sharded) >= len(shards.paths) // 3
    for out in res:
        local = out["fsdp"][(arch, 1)]["local_shapes"]
        for i, path in enumerate(shards.paths):
            full, d = shards.shapes[i], shards.dims[i]
            for n in ("p", "m", "v"):
                got = local[n]["/".join(path)]
                if d is None:
                    assert got == full, (n, path)
                else:
                    assert np.prod(got) * WORLD == np.prod(full), (n, path)
                    assert got[:d] + got[d + 1:] == full[:d] + full[d + 1:], (n, path)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_two_ranks_match_reference_per_parameter_program(ranks, arch, k):
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import single_device_mesh
    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JShardRules
    from repro.optim import OptConfig as JOptConfig
    from repro.train.step import TrainSettings as JTrainSettings
    from repro.train.step import build_train_step as j_build_train_step
    from repro.train.step import opt_state_template as j_opt_state_template

    res, out_dir = ranks
    cfg, jcfg = _fsdp_cfg(arch), _jax_cfg(arch)
    mesh = single_device_mesh()
    jset = JTrainSettings(num_slices=WORLD * k, flat_engine="off")
    jopt = JOptConfig(kind="adam", lr=LR)
    rules = JShardRules.for_mesh(mesh)
    jstep = jax.jit(j_build_train_step(jcfg, mesh, rules, jopt, jset))
    jinit, _ = j_opt_state_template(jcfg, mesh, rules, jopt, jset)
    jp0 = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    jo0 = jinit(jp0)
    init = torch.load(out_dir / f"{arch}_init.pt", weights_only=False)

    def to_jax(like, tree):
        return jax.tree.unflatten(jax.tree.structure(like),
                                  [jnp.asarray(np.asarray(t)) for _, t in tree_leaves(tree)])

    runs = [out["fsdp"][(arch, k)] for out in res]
    for a, b in zip(runs[0]["states"], runs[1]["states"]):
        for n in ("params", "m", "v"):
            for (path, x), (_, y) in zip(tree_leaves(a[n]), tree_leaves(b[n])):
                assert torch.equal(x, y), (n, path)
    run = runs[0]
    prev = {"params": init, "m": common.map_tree(torch.zeros_like, init),
            "v": common.map_tree(torch.zeros_like, init), "step": 0}
    for i in range(FSDP_STEPS):
        where = f"{arch} k={k} step {i + 1}"
        jstate = to_jax(jo0, {"m": prev["m"], "step": torch.tensor(prev["step"],
                                                                    dtype=torch.int32),
                              "v": prev["v"]})
        jp, jo, jm = jstep(to_jax(jp0, prev["params"]), jstate,
                           {"tokens": jnp.asarray(_fsdp_tokens(cfg, i))})
        tm, now = run["metrics"][i], run["states"][i]
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-5, err_msg=where)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=where)
        if cfg.family == "moe":
            np.testing.assert_allclose(tm["lb_loss"], float(jm["lb_loss"]), rtol=1e-5,
                                       err_msg=where)
            np.testing.assert_allclose(tm["drop_frac"], float(jm["drop_frac"]), atol=1e-6,
                                       err_msg=where)
        assert now["step"] == int(jo["step"]) == i + 1
        for a, (path, b) in zip(jax.tree.leaves(jp), tree_leaves(now["params"])):
            diff = np.abs(b.numpy() - np.asarray(a))
            assert diff.max() <= 3 * LR, (where, path, float(diff.max()))
            assert np.mean(diff > 5e-5) <= 1e-3, (where, path)
        prev = now


@pytest.mark.parametrize("faithful", [False, True])
def test_fsdp_checkpoint_two_ranks_restores_at_one(ranks, tmp_path, faithful):
    """The 2-rank FSDP run's step-2 checkpoint (full leaves) resumed at one
    rank, under FSDP or the replicated rules: its third step equals the
    2-rank run's, whose step-3 checkpoint holds its parameters."""
    res, out_dir = ranks
    src = out_dir / "fsdp_ckpt"
    mgr = CheckpointManager(str(src))
    assert mgr.all_steps() == [2, 3] and mgr.load_meta()[1]["flat_engine"] is None
    shutil.copytree(src / "step_0000000002", tmp_path / "step_0000000002")
    one = single_device_group("cpu")
    rules = ShardRules.for_group(one, faithful=faithful)
    out = train(CFG, SHAPE, one, OPT, TrainSettings(),
                LoopConfig(steps=3, ckpt_every=0, ckpt_dir=str(tmp_path), log_every=0),
                rules=rules)
    assert int(out["opt_state"]["step"]) == 3
    for r in res:
        np.testing.assert_allclose(out["final_loss"], r["fsdp"]["ckpt_final_loss"], rtol=1e-5)
    _, want = mgr.restore({"params": lm.param_specs(CFG)})
    for (path, a), (_, b) in zip(tree_leaves(out["params"]), tree_leaves(want["params"])):
        assert_params_close(a, torch.as_tensor(b))
