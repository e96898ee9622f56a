"""The trainer's model axis: tensor, sequence and expert parallelism of the
``lm`` family on a ``(data, model)`` mesh (``launch.mesh.MeshGroup``,
``ShardRules.for_mesh``), against the reference.

One spawn of 2 gloo ranks, one of 4 and one process of the reference over
2 forced JAX host devices start together, the ranks waiting for the inits
the reference process writes first (a file of its own, so that ``--dist
loadfile`` gives it a worker of its own; one torch thread a rank; only the
reference's process imports JAX); the tests read what they wrote.  The 2
ranks lay ``(1, 2)`` (and ``(2, 1)``) over themselves:

* each tensor-parallel Function's forward and backward against the plain
  ops, fp32 and bf16, and the vocab-parallel loss and its gradient;
* three steps of the smoke configs of ``smollm-360m`` (15/5 heads at full
  width, 3/1 here: the heads do not divide, q/k/v are gathered),
  ``gemma2-27b`` and ``qwen3-moe-30b-a3b``, with and without 2 slices,
  each held against the reference's per-parameter program on the whole
  batch (``flat_engine="off"`` on ``single_device_mesh()``) taking the same
  step from the port's own state: loss 1e-5, grad norm 1e-4, parameters
  ``3 lr`` with at most 0.1% of elements beyond 5e-5, as
  ``test_torch_dist.py``; ``smollm-360m`` also under the faithful rules
  (no FSDP, no sequence sharding);
* every leaf replicated over the model axis bitwise equal on the two model
  ranks after every step (the gradient-reduction rule); each rank's p, m
  and v exactly its model slice's share;
* a ``(2, 1)`` checkpoint resumed on ``(1, 2)`` continues as the
  uninterrupted ``(2, 1)`` run;
* MoE's ``lb_loss`` and ``drop_frac`` at model size 2 equal the
  reference's on a 2-device mesh (``moe_ffn`` alone and the loss);
* ``zamba2-1.2b`` (the hybrid family, ``sp`` off: the Mamba2 blocks split
  their heads, the gated out-norm sums its row over ``model``) at ``(1,
  2)`` with and without 2 slices, and at ``(2, 1)``, held as the others
  (the mesh-less port's own gradient norm is 1.6e-5 from the reference's
  on batch 0, relative, fp32 summation order over gradients of norm ~56,
  so the norm keeps the 1e-4 of every family) and, beyond them, each
  leaf's gradient through Adam's first moment.

The 4 ranks lay ``(2, 2)``: two steps of the MoE smoke config against the
reference's program in 2 slices (each data column routes its own rows),
and of zamba2's against its program on the whole batch.
In this process: the rank-to-coordinate map, ``param_shard_dims`` against
the reference's ``param_pspecs``, ``(1, 1)`` over a one-rank gloo group
bitwise equal to the FSDP rules, and the families and programs that raise
at a live model axis.
"""
import dataclasses
import gc
import multiprocessing
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch_fn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DataGroup, MeshGroup, init_group, mesh_from_group
from repro_torch.models import common, lm, moe, registry, zamba
from repro_torch.models.common import ModelAxis, ShardRules
from repro_torch.optim import OptConfig
from repro_torch.optim.flat import tree_leaves
from repro_torch.optim.fsdp import full_tree, make_shard_layout, shard_tree
from repro_torch.train import LoopConfig, TrainSettings, build_train_step, init_sharded, train
from repro_torch.train.step import flat_engine_mode, model_partial_paths, opt_state_template

LR = 1e-3
OPT = OptConfig(kind="adam", lr=LR)
ARCHS = ("smollm-360m", "gemma2-27b", "qwen3-moe-30b-a3b", "zamba2-1.2b")
MOE = "qwen3-moe-30b-a3b"
ZAMBA = "zamba2-1.2b"
B, S, STEPS = 4, 16, 3
SHAPE = ShapeConfig("t", "train", S, B)
LM_IDS = [a for a in ARCH_IDS if get_smoke_config(a).family in ("dense", "moe", "vlm")]


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl="kernel")


def _jax_cfg(arch):
    from repro.configs import get_smoke_config as jax_smoke

    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32")


def _tokens(cfg, i):
    return np.random.default_rng(10 + i).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)


def _moe_inputs():
    """x (2, 16, D), the router and 8 experts' weights of the MoE smoke
    config, for ``moe_ffn`` alone."""
    cfg = _cfg(MOE)
    rng = np.random.default_rng(3)
    D, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(x=f(2, 16, D), rw=f(D, E), wg=f(E, D, F, sc=0.1), wu=f(E, D, F, sc=0.1),
                wd=f(E, F, D, sc=0.1))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _function_checks(mesh) -> dict:
    """Each tensor-parallel Function on this rank, fp32 and bf16: its
    output and its input's gradient for this rank's cotangent."""
    g, r, n = mesh.model, mesh.model.rank, mesh.model.world
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(np.random.default_rng(7 + r).standard_normal((4, 6, 8)),
                         dtype=torch.float32).to(dt)
        cot = torch.tensor(np.random.default_rng(20 + r).standard_normal((4, 6, 8)),
                           dtype=torch.float32).to(dt)
        half = lambda t: t.narrow(1, r * 3, 3)
        for name, fn, inp, c in (
                ("copy", lambda t: common.copy_to_model(t, g), x, cot),
                ("reduce", lambda t: common.reduce_from_model(t, g), x, cot),
                ("gather", lambda t: common.model_all_gather(t, 1, g), half(x), cot),
                ("scatter", lambda t: common.model_reduce_scatter(t, 1, g), x, half(cot))):
            t = inp.clone().requires_grad_()
            y = fn(t)
            y.backward(c)
            out[(name, str(dt))] = dict(y=y.detach(), grad=t.grad)
        logits = torch.tensor(np.random.default_rng(5).standard_normal((2, 5, 16)) * 3,
                              dtype=torch.float32).to(dt)
        labels = torch.tensor(np.random.default_rng(6).integers(0, 16, (2, 5)))
        t = logits.narrow(-1, r * 16 // n, 16 // n).clone().requires_grad_()
        loss = common.vocab_parallel_cross_entropy(t, labels, g)
        loss.backward()
        out[("ce", str(dt))] = dict(y=loss.detach(), grad=t.grad)
    return out


def _run(mesh, cfg, init, k=1, steps=STEPS, settings=None):
    """``steps`` steps of the mesh program from ``init`` (full leaves) on
    batches 0, 1, ...; this data rank's rows.  Returns the metrics, the
    full states after each step, the local leaves and what the rules
    split."""
    settings = settings or TrainSettings(num_slices=k)
    step = build_train_step(cfg, mesh, OPT, settings)
    shards = step._shard_layout
    params = shard_tree(shards, init)
    state = opt_state_template(cfg, mesh, OPT, settings)(params)
    groups = step._gather_groups
    d = mesh.data
    rows = slice(d.rank * B // d.world, (d.rank + 1) * B // d.world)
    run = {"metrics": [], "states": [], "replicated": [],
           "counts": dict.fromkeys(common.COUNTS, 0)}
    for i in range(steps):
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        params, state, m = step(params, state, {"tokens": _tokens(cfg, i)[rows]})
        for n, c in common.COUNTS.items():
            run["counts"][n] += c
        run["metrics"].append({n: float(v) for n, v in m.items()})
        run["states"].append({"params": full_tree(shards, params, *groups),
                              **{n: full_tree(shards, state[n], *groups) for n in ("m", "v")},
                              "step": int(state["step"])})
        run["replicated"].append({p: x.clone() for p, x in tree_leaves(params)
                                  if p not in shards.model_sharded})
    run["local"] = {n: {p: x.clone() for p, x in tree_leaves(t)}
                    for n, t in (("p", params), ("m", state["m"]), ("v", state["v"]))}
    run["partial"] = sorted(step._model_partial)
    run["rules"] = step._rules
    return run


def _moe_direct(mesh) -> dict:
    """``moe_ffn`` alone on this model rank's sequence shard and experts."""
    inp = {k: torch.tensor(v) for k, v in _moe_inputs().items()}
    g = mesh.model
    e = inp["wg"].shape[0] // g.world
    loc = lambda w: w[g.rank * e:(g.rank + 1) * e]
    x = inp["x"].narrow(1, g.rank * 8, 8)
    with common.fsdp_program(None, {}, ModelAxis(g, True)):
        out, aux = moe.moe_ffn(x, inp["rw"], loc(inp["wg"]), loc(inp["wu"]), loc(inp["wd"]),
                               cfg=_cfg(MOE))
    return dict(out=common._gather(out, 1, g), lb_loss=float(aux["lb_loss"]),
                drop_frac=float(aux["drop_frac"]))


def _checkpoint(group, out_dir) -> dict:
    """smollm at (2, 1): 3 steps uninterrupted, checkpointed after the
    second; that checkpoint (the last one dropped, as if the run had
    stopped there) resumed on (1, 2) for the third."""
    cfg = _cfg("smollm-360m")
    m21, m12 = mesh_from_group(group, (2, 1)), mesh_from_group(group, (1, 2))
    ckpt = out_dir / "ckpt21"
    ref = train(cfg, SHAPE, m21, OPT, TrainSettings(),
                LoopConfig(steps=3, ckpt_every=2, ckpt_dir=str(ckpt), log_every=0))
    if group.rank == 0:
        assert CheckpointManager(str(ckpt)).all_steps() == [2, 3]
        shutil.rmtree(ckpt / "step_0000000003")
    dist.barrier()
    step = build_train_step(cfg, m21, OPT, TrainSettings())
    ref_full = full_tree(step._shard_layout, ref["params"], *step._gather_groups)
    res = train(cfg, SHAPE, m12, OPT, TrainSettings(),
                LoopConfig(steps=3, ckpt_every=0, ckpt_dir=str(ckpt), log_every=0))
    step = build_train_step(cfg, m12, OPT, TrainSettings())
    return dict(ref_loss=ref["final_loss"], ref_params=ref_full, loss=res["final_loss"],
                step=int(res["opt_state"]["step"]),
                params=full_tree(step._shard_layout, res["params"], *step._gather_groups))


def _worker(rank, world, shape, address, out_dir):
    torch.set_num_threads(1)
    group = init_group("gloo", rank, world, address, device="cpu", timeout_s=240)
    res = {}
    try:
        mesh = mesh_from_group(group, shape)
        res["coords"] = mesh.coords
        _wait_for(out_dir / "inits.done")
        inits = {a: torch.load(out_dir / f"{a}_init.pt", weights_only=False) for a in ARCHS}
        if world == 2:
            res["functions"] = _function_checks(mesh)
            for arch in ARCHS:
                for k in (1, 2):
                    res[(arch, k)] = _run(mesh, _cfg(arch), inits[arch], k)
            res["faithful"] = _run(mesh, _cfg("smollm-360m"), inits["smollm-360m"],
                                   settings=TrainSettings(faithful=True, flat_engine="off"))
            res["moe_direct"] = _moe_direct(mesh)
            res["checkpoint"] = _checkpoint(group, out_dir)
            res[(ZAMBA, 1, (2, 1))] = _run(mesh_from_group(group, (2, 1)), _cfg(ZAMBA),
                                           inits[ZAMBA], 1)
        else:
            res[(MOE, 1)] = _run(mesh, _cfg(MOE), inits[MOE], 1, steps=2)
            res[(ZAMBA, 1)] = _run(mesh, _cfg(ZAMBA), inits[ZAMBA], 1, steps=2)
        torch.save(res, out_dir / f"w{world}_rank{rank}.pt")
        dist.barrier()
    finally:
        group.close()
        del group
        gc.collect()


def _wait_for(path, timeout_s=240.0):
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)


def _reference(out_dir):
    """The inits the ranks start from, then the reference on a (1, 2) mesh
    of 2 forced host devices: ``moe_ffn`` alone and the MoE smoke config's
    loss aux on batch 0."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import local_mesh
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    from repro.models.common import ShardRules as JRules

    _write_inits(out_dir)
    assert jax.device_count() == 2
    mesh = local_mesh(data=1, model=2)
    rules = JRules.for_mesh(mesh)
    jcfg = _jax_cfg(MOE)
    inp = {k: jnp.asarray(v) for k, v in _moe_inputs().items()}
    out = {}
    with mesh:
        y, aux = jax.jit(lambda *a: jmoe.moe_ffn(*a, cfg=jcfg, mesh=mesh, rules=rules))(
            inp["x"], inp["rw"], inp["wg"], inp["wu"], inp["wd"])
        out["moe_direct"] = dict(out=np.asarray(y), lb_loss=float(aux["lb_loss"]),
                                 drop_frac=float(aux["drop_frac"]))
        params = jlm.init(jcfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(_tokens(jcfg, 0))}
        _, aux = jax.jit(lambda p, b: jlm.loss_fn(jcfg, mesh, rules, p, b))(params, batch)
        out["loss_aux"] = {k: float(v) for k, v in aux.items()}
    torch.save(out, out_dir / "reference.pt")


def _write_inits(out_dir):
    """The reference's ``init`` of each family, converted, for the ranks
    (``inits.done`` marks them all written)."""
    import jax

    from repro.models import registry as jreg
    from repro_torch.models.convert import params_from_numpy

    for arch in ARCHS:
        jcfg = _jax_cfg(arch)
        jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
        torch.save(params_from_numpy(_cfg(arch), jax.tree.map(np.asarray, jp), device="cpu"),
                   out_dir / f"{arch}_init.pt")
    (out_dir / "inits.done").touch()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the 2 ranks, the 4 ranks and the reference together (the
    reference process writes the inits the ranks wait for); returns
    ({world: [rank results]}, the reference's, out_dir)."""
    out_dir = tmp_path_factory.mktemp("tp")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, shape in ((2, (1, 2)), (4, (2, 2))):
        address = f"tcp://127.0.0.1:{_free_port()}"
        procs += [ctx.Process(target=_worker, args=(r, world, shape, address, out_dir))
                  for r in range(world)]
    old = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    try:
        procs.append(ctx.Process(target=_reference, args=(out_dir,)))
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS")
        else:
            os.environ["XLA_FLAGS"] = old
    # the reference's steps compile while the ranks run
    for arch in ARCHS:
        for k in (1, 2):
            _jax_step(arch, k)
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a process hung"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    load = lambda name: torch.load(out_dir / name, weights_only=False)
    ranks = {w: [load(f"w{w}_rank{r}.pt") for r in range(w)] for w in (2, 4)}
    return ranks, load("reference.pt"), out_dir


# ---------------------------------------------------------------------------
# The reference's per-parameter program, step by step
# ---------------------------------------------------------------------------

_JSTEPS: dict = {}


def _jax_step(arch, k):
    import jax
    import jax.numpy as jnp

    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JShardRules
    from repro.launch.mesh import single_device_mesh
    from repro.optim import OptConfig as JOptConfig
    from repro.train.step import TrainSettings as JTrainSettings
    from repro.train.step import build_train_step as j_build
    from repro.train.step import opt_state_template as j_template

    if (arch, k) not in _JSTEPS:
        jcfg, mesh = _jax_cfg(arch), single_device_mesh()
        rules, jopt = JShardRules.for_mesh(mesh), JOptConfig(kind="adam", lr=LR)
        jset = JTrainSettings(num_slices=k, flat_engine="off")
        jinit, _ = j_template(jcfg, mesh, rules, jopt, jset)
        jp0 = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
        jstep = jax.jit(j_build(jcfg, mesh, rules, jopt, jset))
        jax.block_until_ready(jstep(jp0, jinit(jp0), {"tokens": jnp.asarray(_tokens(jcfg, 0))}))
        _JSTEPS[(arch, k)] = (jstep, jp0, jinit(jp0))
    return _JSTEPS[(arch, k)]


def _hold_against_reference(arch, k_ref, run, init, where):
    """Each of ``run``'s steps against the reference's step from the
    port's state before it."""
    import jax
    import jax.numpy as jnp

    jstep, jp0, jo0 = _jax_step(arch, k_ref)
    cfg = _cfg(arch)

    def to_jax(like, tree):
        return jax.tree.unflatten(jax.tree.structure(like),
                                  [jnp.asarray(np.asarray(t)) for _, t in tree_leaves(tree)])

    prev = {"params": init, "m": common.map_tree(torch.zeros_like, init),
            "v": common.map_tree(torch.zeros_like, init), "step": 0}
    for i, (tm, now) in enumerate(zip(run["metrics"], run["states"])):
        at = f"{where} step {i + 1}"
        jstate = to_jax(jo0, {"m": prev["m"], "step": torch.tensor(prev["step"],
                                                                    dtype=torch.int32),
                              "v": prev["v"]})
        jp, jo, jm = jstep(to_jax(jp0, prev["params"]), jstate,
                           {"tokens": jnp.asarray(_tokens(cfg, i))})
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-5, err_msg=at)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=at)
        if cfg.family == "moe":
            np.testing.assert_allclose(tm["lb_loss"], float(jm["lb_loss"]), rtol=1e-5,
                                       err_msg=at)
        assert now["step"] == int(jo["step"]) == i + 1
        if cfg.family == "hybrid":
            # both sides' first moments come from the same m: they differ by
            # (1 - beta1) times the clipped gradients' difference, so each
            # leaf's gradient (in_proj's and conv's column slices, the
            # per-head leaves summed over model) is held to 1e-3 of its
            # largest entry: the mesh-less port's own gradients differ from
            # the reference's by up to 8.5e-5 of it and these meshes' by up
            # to 1.9e-4 (fp32 summation order over the depth), an unsummed
            # partial or a rank's missing share of the norm's row sum by a
            # factor
            errs = {path: float(np.abs(b.numpy() - np.asarray(a)).max()
                                / np.abs(np.asarray(a)).max())
                    for a, (path, b) in zip(jax.tree.leaves(jo["m"]), tree_leaves(now["m"]))}
            assert max(errs.values()) <= 1e-3, (at, errs)
        for a, (path, b) in zip(jax.tree.leaves(jp), tree_leaves(now["params"])):
            diff = np.abs(b.numpy() - np.asarray(a))
            assert diff.max() <= 3 * LR, (at, path, float(diff.max()))
            assert np.mean(diff > 5e-5) <= 1e-3, (at, path)
        prev = now


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_of_two_matches_reference(spawned, arch, k):
    ranks, _, out_dir = spawned
    runs = [r[(arch, k)] for r in ranks[2]]
    assert [r["coords"] for r in ranks[2]] == [(0, 0), (0, 1)]
    for a, b in zip(runs[0]["states"], runs[1]["states"]):
        for n in ("params", "m", "v"):
            for (path, x), (_, y) in zip(tree_leaves(a[n]), tree_leaves(b[n])):
                assert torch.equal(x, y), (n, path)
    init = torch.load(out_dir / f"{arch}_init.pt", weights_only=False)
    _hold_against_reference(arch, k, runs[0], init, f"{arch} (1, 2) k={k}")


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_zamba_on_the_data_axis_matches_reference(spawned, shape):
    """zamba2 at (2, 1) (3 steps) and (2, 2) (2 steps), each data rank its
    half of the batch: the reference's step on the whole batch, the rules
    the reference's launcher gives the hybrid family (``sp`` off), every
    rank's parameters the same full tree."""
    ranks, _, out_dir = spawned
    world = shape[0] * shape[1]
    key = (ZAMBA, 1, shape) if world == 2 else (ZAMBA, 1)
    runs = [r[key] for r in ranks[world]]
    assert runs[0]["rules"] == ShardRules(dp=("data",), tp="model", fsdp="data", sp=False)
    assert runs[0]["partial"] == [("mamba", n) for n in ("A_log", "D_skip", "dt_bias",
                                                         "out_ln")]
    for run in runs[1:]:
        for a, b in zip(runs[0]["states"], run["states"]):
            for (path, x), (_, y) in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
                assert torch.equal(x, y), path
    counts = runs[0]["counts"]
    assert counts["norm_sum"] > 0 and counts["model_reduce_scatter"] == 0
    init = torch.load(out_dir / f"{ZAMBA}_init.pt", weights_only=False)
    _hold_against_reference(ZAMBA, 1, runs[0], init, f"zamba2 {shape}")


def test_faithful_rules_on_the_model_axis_match_reference(spawned):
    """``for_mesh(faithful=True)``: no FSDP, no sequence sharding
    (copy-to-model and reduce-from-model), the q/k norms and the router
    the only leaves summed over ``model``."""
    ranks, _, out_dir = spawned
    run = ranks[2][0]["faithful"]
    assert run["rules"] == ShardRules(dp=("data",), tp="model", fsdp=None, sp=False)
    assert run["counts"]["copy_to_model"] > 0 and run["counts"]["reduce_from_model"] > 0
    assert run["counts"]["all_gather"] == run["counts"]["model_reduce_scatter"] == 0
    init = torch.load(out_dir / "smollm-360m_init.pt", weights_only=False)
    _hold_against_reference("smollm-360m", 1, run, init, "smollm faithful (1, 2)")


def test_moe_of_two_by_two_matches_reference(spawned):
    """(2, 2): each data column's 2 rows are one of the reference's 2
    slices (MoE routes by column)."""
    ranks, _, out_dir = spawned
    assert [r["coords"] for r in ranks[4]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    runs = [r[(MOE, 1)] for r in ranks[4]]
    for run in runs[1:]:
        for a, b in zip(runs[0]["states"], run["states"]):
            for (path, x), (_, y) in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
                assert torch.equal(x, y), path
    init = torch.load(out_dir / f"{MOE}_init.pt", weights_only=False)
    _hold_against_reference(MOE, 2, runs[0], init, "qwen3-moe (2, 2)")


# ---------------------------------------------------------------------------
# What a rank holds, and the gradient-reduction rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_their_model_slices_share(spawned, world):
    """p, m and v: each rank's leaf is exactly its box (model slice, data
    shard within it) of the full leaf, a (1/N_model) x (1/N_data) share of
    every leaf split on both axes."""
    ranks, _, _ = spawned
    archs = ARCHS if world == 2 else (MOE, ZAMBA)
    shape = (1, 2) if world == 2 else (2, 2)
    for arch in archs:
        cfg = _cfg(arch)
        for r, res in enumerate(ranks[world]):
            run = res[(arch, 1)]
            d, m = tmesh.mesh_coords(shape, r)
            lay = make_shard_layout(cfg, run["rules"], shape[0], d, model=shape[1],
                                    model_rank=m)
            assert len(lay.model_sharded) >= len(lay.paths) // 3
            final = run["states"][-1]
            for i, path in enumerate(lay.paths):
                box = tuple(slice(lo, hi) for lo, hi in lay.box(i))
                split = (shape[0] if lay.dims[i] is not None else 1) * \
                    (shape[1] if lay.tp_dims[i] is not None else 1)
                for n, full in (("p", final["params"]), ("m", final["m"]), ("v", final["v"])):
                    got = run["local"][n][path]
                    want = dict(tree_leaves(full))[path][box]
                    assert torch.equal(got, want), (arch, r, n, path)
                    assert got.numel() * split == np.prod(lay.shapes[i]), (arch, r, n, path)


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_leaves_equal_across_model_ranks(spawned, world):
    """The gradient-reduction rule, leaf by leaf: after every step each
    leaf the model axis does not split is bitwise the same on the ranks of
    a data column (an unsummed partial gradient would differ)."""
    ranks, _, _ = spawned
    keys = [(a, k) for a in ARCHS for k in (1, 2)] if world == 2 else [(MOE, 1), (ZAMBA, 1)]
    for key in keys:
        runs = [r[key] for r in ranks[world]]
        pairs = [(0, 1)] if world == 2 else [(0, 1), (2, 3)]
        for a, b in pairs:
            for sa, sb in zip(runs[a]["replicated"], runs[b]["replicated"]):
                assert sa.keys() == sb.keys() and sa
                for path in sa:
                    assert torch.equal(sa[path], sb[path]), (key, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_reduction_rule(arch):
    """Under ``sp`` every leaf the model axis does not split is summed over
    it; without it (the faithful rules; zamba2's, which have no ``sp``)
    only the leaves read inside the tensor-parallel region: the q/k norms
    and the router, zamba2's per-head Mamba2 leaves; a leaf it splits
    never."""
    cfg = _cfg(arch)
    region = registry.tp_region_leaves(cfg)
    want = {MOE: {"qnorm", "knorm", "router"},
            ZAMBA: {"dt_bias", "A_log", "D_skip", "out_ln"}}.get(arch, set())
    for rules in (ShardRules(dp=("data",), tp="model", fsdp="data", sp=True),
                  ShardRules.faithful(dp=("data",), tp="model")):
        lay = make_shard_layout(cfg, rules, 1, model=2)
        got = model_partial_paths(lay, rules, region)
        replicated = {p for p in lay.paths if p not in lay.model_sharded}
        assert not got & lay.model_sharded
        if rules.sp:
            assert got == replicated
        else:
            assert got == {p for p in replicated if p[-1] in region}
    assert {p[-1] for p in got} == want


# ---------------------------------------------------------------------------
# The Functions, MoE's aux, the checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("name", ["copy", "reduce", "gather", "scatter", "ce"])
def test_tensor_parallel_function(spawned, name, dtype):
    ranks, _, _ = spawned
    dt = getattr(torch, dtype.split(".")[1])
    res = [r["functions"][(name, dtype)] for r in ranks[2]]
    xs = [torch.tensor(np.random.default_rng(7 + r).standard_normal((4, 6, 8)),
                       dtype=torch.float32).to(dt) for r in range(2)]
    cots = [torch.tensor(np.random.default_rng(20 + r).standard_normal((4, 6, 8)),
                         dtype=torch.float32).to(dt) for r in range(2)]
    total = lambda ts: ts[0] + ts[1]
    for r, got in enumerate(res):
        half = lambda t: t.narrow(1, r * 3, 3)
        if name == "copy":
            want_y, want_g = xs[r], total(cots)
        elif name == "reduce":
            want_y, want_g = total(xs), cots[r]
        elif name == "gather":
            want_y = torch.cat([x.narrow(1, q * 3, 3) for q, x in enumerate(xs)], 1)
            want_g = half(total(cots))
        elif name == "scatter":
            want_y = half(total(xs))
            want_g = torch.cat([c.narrow(1, q * 3, 3) for q, c in enumerate(cots)], 1)
        else:
            logits = torch.tensor(np.random.default_rng(5).standard_normal((2, 5, 16)) * 3,
                                  dtype=torch.float32).to(dt).requires_grad_()
            labels = torch.tensor(np.random.default_rng(6).integers(0, 16, (2, 5)))
            want_y = common.cross_entropy_loss(logits, labels)
            want_y.backward()
            want_g = logits.grad.narrow(-1, r * 8, 8)
            tol = dict(rtol=1e-6, atol=1e-6) if dt == torch.float32 else dict(rtol=1e-2,
                                                                               atol=1e-3)
            torch.testing.assert_close(got["y"], want_y.detach(), **tol)
            torch.testing.assert_close(got["grad"], want_g, **tol)
            continue
        assert got["y"].dtype == got["grad"].dtype == dt
        assert torch.equal(got["y"], want_y) and torch.equal(got["grad"], want_g), (name, r)


def test_moe_aux_at_model_two_equals_reference_mesh(spawned):
    """``lb_loss`` and ``drop_frac`` at model size 2 are what the reference
    reports on a 2-device mesh: ``drop_frac`` model rank 0's share of
    choices not kept on its own experts (``out_specs=P()``), not the share
    dropped by capacity; the layer's output is the reference's."""
    ranks, ref, _ = spawned
    for r in ranks[2]:
        got, want = r["moe_direct"], ref["moe_direct"]
        np.testing.assert_allclose(got["lb_loss"], want["lb_loss"], rtol=1e-5)
        assert got["drop_frac"] == want["drop_frac"]
        np.testing.assert_allclose(got["out"].numpy(), want["out"], rtol=1e-5, atol=1e-5)
        step1 = r[(MOE, 1)]["metrics"][0]
        np.testing.assert_allclose(step1["lb_loss"], ref["loss_aux"]["lb_loss"], rtol=1e-5)
        np.testing.assert_allclose(step1["drop_frac"], ref["loss_aux"]["drop_frac"], atol=1e-6)
    # at model size 1 the port reports the share dropped by capacity alone
    cfg = _cfg(MOE)
    inp = {k: torch.tensor(v) for k, v in _moe_inputs().items()}
    _, aux = moe.moe_ffn(inp["x"], inp["rw"], inp["wg"], inp["wu"], inp["wd"], cfg=cfg)
    assert float(aux["drop_frac"]) < ref["moe_direct"]["drop_frac"]


def test_checkpoint_of_two_by_one_continues_on_one_by_two(spawned):
    ranks, _, _ = spawned
    for r in ranks[2]:
        c = r["checkpoint"]
        assert c["step"] == 3
        np.testing.assert_allclose(c["loss"], c["ref_loss"], rtol=1e-5)
        for (path, a), (_, b) in zip(tree_leaves(c["params"]), tree_leaves(c["ref_params"])):
            diff = (a - b).abs()
            assert diff.max() <= 3 * LR, path
            assert (diff > 5e-5).float().mean() <= 1e-3, path


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


def test_mesh_coordinates_are_row_major():
    assert [tmesh.mesh_coords((2, 2), r) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert tmesh.axis_members((2, 3), (1,)) == [[0, 1, 2], [3, 4, 5]]
    assert tmesh.axis_members((2, 3), (0,)) == [[0, 3], [1, 4], [2, 5]]
    assert tmesh.axis_members((2, 2, 2), (0, 1)) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    for shape in ((16, 16), (2, 16, 16), (4, 2)):
        n = int(np.prod(shape))
        coords = [tmesh.mesh_coords(shape, r) for r in range(n)]
        assert len(set(coords)) == n
        assert [tmesh.mesh_rank(shape, c) for c in coords] == list(range(n))
    # the model axis is the fastest: a model group's ranks are consecutive
    assert tmesh.axis_members((16, 16), (1,))[3] == list(range(48, 64))
    assert tmesh.production_layout() == (16, 16)
    assert tmesh.production_layout(True) == (2, 16, 16)
    assert tmesh.default_axes(2) == ("data", "model")
    assert tmesh.default_axes(3) == ("pod", "data", "model")
    with pytest.raises(ValueError):
        tmesh.mesh_coords((2, 2), 4)


def test_local_and_production_meshes(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    m = tmesh.local_mesh(device="cpu")
    assert (m.axes, m.shape, m.coords, m.pg) == (("data", "model"), (1, 1), (0, 0), None)
    assert m.data.world == m.model.world == 1
    assert ShardRules.for_mesh(m) == ShardRules(dp=("data",), tp="model", fsdp="data", sp=True)
    assert ShardRules.for_mesh(m, faithful=True) == ShardRules(dp=("data",), tp="model",
                                                               fsdp=None, sp=False)
    with pytest.raises(ValueError, match="needs 256 ranks; the world is 1"):
        tmesh.make_production_mesh(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="needs 512 ranks; the world is 8"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_param_shard_dims_match_reference_pspecs(arch, size):
    """Both axes where the reference's ``param_pspecs(cfg,
    ShardRules.for_mesh(...))`` names ``"model"`` and ``"data"``."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import local_mesh as jax_local_mesh
    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JShardRules

    jcfg, tcfg = ((jax_config(arch), get_config(arch)) if size == "full"
                  else (jax_smoke(arch), get_smoke_config(arch)))
    jm = jax_local_mesh(data=1, model=1)
    for faithful in (False, True):
        pspecs = jreg.param_pspecs(jcfg, JShardRules.for_mesh(jm, faithful=faithful))
        flat = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
        pick = lambda spec, axis: next((i for i, a in enumerate(spec) if a == axis), None)
        want = {tuple(k.key for k in path): (pick(spec, "model"), pick(spec, "data"))
                for path, spec in flat}
        mesh = tmesh.single_mesh("cpu")
        got = registry.param_shard_dims(tcfg, ShardRules.for_mesh(mesh, faithful=faithful))
        assert got == want


# configs a model axis of 2, 4, 8 or 16 does not divide (every one else does)
UNEVEN = {("qwen3-moe-30b-a3b", "smoke"): {16}, ("qwen3-moe-235b-a22b", "smoke"): {8, 16}}


@pytest.mark.parametrize("arch", LM_IDS)
def test_model_sizes_that_do_not_divide(arch):
    """Where a model axis of 2, 4, 8 or 16 does not divide a leaf's
    tensor-parallel dimension (the smoke MoE configs' experts) the layout
    raises, as the reference's placement does; every full config divides
    (heads that do not divide are gathered, not refused)."""
    rules = ShardRules(dp=("data",), tp="model", fsdp="data", sp=True)
    for size, cfg in (("full", get_config(arch)), ("smoke", get_smoke_config(arch))):
        for m in (2, 4, 8, 16):
            if m in UNEVEN.get((arch, size), ()):
                with pytest.raises(ValueError, match=f"does not divide over {m} ranks"):
                    make_shard_layout(cfg, rules, 1, model=m)
            else:
                make_shard_layout(cfg, rules, 1, model=m)


@pytest.fixture(scope="module")
def gloo1():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    group = init_group("gloo", 0, 1, f"tcp://127.0.0.1:{_free_port()}", device="cpu",
                       timeout_s=60)
    yield group
    group.close()
    torch.set_num_threads(torch_threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_equals_fsdp_bitwise(gloo1, arch):
    """(1, 1) over a one-rank gloo group (every model-axis collective runs)
    against the FSDP rules on the same group: losses, gradient norms,
    parameters and Adam moments after two steps in two slices, bitwise; the
    collectives by formula."""
    mesh = mesh_from_group(gloo1, (1, 1))
    cfg = dataclasses.replace(_cfg(arch), compute_dtype="bfloat16")
    runs = {}
    for name, group, rules in (("fsdp", gloo1, ShardRules.for_group(gloo1)),
                               ("mesh", mesh, None)):
        settings = TrainSettings(num_slices=2)
        params, state = init_sharded(cfg, group, OPT, 0, settings, rules)
        step = build_train_step(cfg, group, OPT, settings, rules)
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        metrics = []
        for i in range(2):
            params, state, m = step(params, state, make_batch_fn(cfg, SHAPE, 0)(i))
            metrics.append({n: float(v) for n, v in m.items()})
        runs[name] = (metrics, params, state, dict(common.COUNTS))
    (fm, fp, fs, fc), (mm, mp, ms, mc) = runs["fsdp"], runs["mesh"]
    assert mm == fm
    for a, b in ((mp, fp), (ms["m"], fs["m"]), (ms["v"], fs["v"])):
        for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), path
    L, per = cfg.n_layers, 2 * 2
    if cfg.family == "hybrid":
        # no sp: copy-to-model into and reduce-from-model out of each
        # shared block's attention and MLP, each Mamba2 block and the
        # embedding (the loss's copy too); each Mamba2 block's projection
        # and conv weights gathered (forward, remat's recompute, backward)
        # and its out-norm's row sums (the same three, and the backward's
        # recomputed sum)
        sh = zamba.n_shared_invocations(cfg)
        assert mc == {**fc, "copy_to_model": (2 * sh + L + 1) * per,
                      "reduce_from_model": (2 * sh + L + 1) * per,
                      "model_all_gather": 9 * L * per, "norm_sum": 4 * L * per,
                      "vocab_ce": 2 * per}
        return
    rs = 6 * L + 2 if (cfg.moe.num_experts or cfg.alt_local_global) else 5 * L + 2
    assert mc == {**fc, "model_all_gather": (6 * L + 2) * per,
                  "model_reduce_scatter": rs * per, "vocab_ce": 2 * per}


def _fake_mesh(shape):
    """A mesh's coordinates without process groups (rank 0): enough for
    what is decided before a collective runs."""
    cpu = torch.device("cpu")
    groups = {a: DataGroup(None, 0, n, cpu) for a, n in zip(("data", "model"), shape)}
    groups["dp"] = groups["data"]
    return MeshGroup(("data", "model"), tuple(shape), (0, 0), 0, cpu, None, groups)


def test_live_model_axis_refusals():
    live = _fake_mesh((1, 2))
    adam = OptConfig(kind="adam")
    zcfg = get_smoke_config("zamba2-1.2b")
    # the hybrid family runs: its mesh program, sp off (the reference's
    # launcher turns it off for the family), its Mamba2 leaves summed
    step = build_train_step(zcfg, live, adam)
    assert step._rules == ShardRules(dp=("data",), tp="model", fsdp="data", sp=False)
    assert {p[-1] for p in step._model_partial} == {"dt_bias", "A_log", "D_skip", "out_ln"}
    for arch in ("xlstm-1.3b", "whisper-tiny", "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="not the .*queue 1, item 1"):
            build_train_step(get_smoke_config(arch), live, adam)
    dense = _cfg("smollm-360m")
    with pytest.raises(ValueError, match="mesh has a live model axis"):
        flat_engine_mode(dense, live, adam, TrainSettings(flat_engine="zero"))
    assert flat_engine_mode(dense, live, adam, TrainSettings(faithful=True)) is None
    one = _fake_mesh((2, 1))
    assert flat_engine_mode(dense, one, adam, TrainSettings(faithful=True)) == "faithful"
    # at a model axis of 1 the other families run on the data group
    xl = get_smoke_config("xlstm-1.3b")
    assert build_train_step(xl, _fake_mesh((1, 1)), adam)._shard_layout.sharded
    from repro_torch.core import context
    with pytest.raises(NotImplementedError, match="model axes"):
        context._check_axes((1, 2), ("data", "model"), None)
    with pytest.raises(ValueError, match="does not divide over 2 model ranks"):
        common.model_reduce_scatter(torch.zeros(1, 3, 4), 1, DataGroup(None, 0, 2, None))


@pytest.mark.parametrize("heads,kv,world", [(32, 4, 8), (64, 4, 16), (12, 6, 4), (6, 3, 2)])
def test_local_kv_heads_keep_each_q_heads_kv(heads, kv, world):
    """Where the q heads divide over the model axis and the kv heads do
    not, each rank passes attention the kv heads its own q heads read:
    local q head ``j`` meets global kv head ``h // rep`` under the
    kernel's mapping ``j // (local q / local kv)``; a run with one rep
    where the reads are even (qwen3-moe-30b-a3b at 8, -235b at 16), else
    one kv head a q head."""
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), n_heads=heads, n_kv=kv,
                              d_model=heads * 4, d_head=4)
    k = torch.arange(kv, dtype=torch.float32).view(1, 1, kv, 1).expand(1, 2, kv, 4)
    hl, rep = heads // world, heads // kv
    for r in range(world):
        axis = ModelAxis(DataGroup(None, r, world, torch.device("cpu")), True)
        with common.fsdp_program(None, {}, axis):
            kl, vl = lm._local_kv(cfg, k, k + 100)
        assert hl % kl.shape[2] == 0 and torch.equal(vl, kl + 100)
        rep_loc = hl // kl.shape[2]
        for j in range(hl):
            assert kl[0, 0, j // rep_loc, 0] == (r * hl + j) // rep, (r, j)
        if world > kv and hl <= rep:
            assert kl.shape[2] == 1


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_sharded_init_on_a_mesh_holds_init_values(monkeypatch, shape):
    """Every rank's box of every leaf, put back together, is ``init``'s
    leaf bitwise, so a ``(2, 2)`` run starts where a ``(1, 1)`` run does;
    997-value draw chunks cut the leaves' rows and boxes anywhere."""
    from repro_torch.optim import fsdp

    monkeypatch.setattr(common, "INIT_CHUNK", 997)
    rules = ShardRules(dp=("data",), tp="model", fsdp="data", sp=True)
    for arch in ("gemma2-27b", MOE):
        cfg = get_smoke_config(arch)
        full = dict(tree_leaves(lm.init(cfg, seed=3, device="cpu")))
        got = {p: torch.full_like(x, float("nan")) for p, x in full.items()}
        for r in range(int(np.prod(shape))):
            d, m = tmesh.mesh_coords(shape, r)
            lay = make_shard_layout(cfg, rules, shape[0], d, model=shape[1], model_rank=m)
            local = dict(tree_leaves(fsdp.init_shards(cfg, lay, 3, "cpu")))
            for i, path in enumerate(lay.paths):
                box = tuple(slice(lo, hi) for lo, hi in lay.box(i))
                assert tuple(local[path].shape) == lay.local_shape(i)
                got[path][box] = local[path]
        for path in full:
            assert torch.equal(got[path], full[path]), (arch, shape, path)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_zamba_shard_layout_at_model_sizes(size, model):
    """zamba2's layout at a model axis of 2 and 4 against the reference's
    ``param_pspecs`` (``sp`` off, as its launcher sets it): the dimensions
    on ``model`` and ``data``, and each rank's local shape that slice of the
    leaf (``in_proj`` 296 columns to 148 or 74 a rank at smoke width, 8,384
    to 4,192 or 2,096 at full width; ``conv`` 160 to 80 or 40, 4,224 to
    2,112 or 1,056; ``out_proj`` its ``d_inner`` rows)."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import local_mesh as jax_local_mesh
    from repro.models import registry as jreg
    from repro.models.common import ShardRules as JShardRules

    jcfg, tcfg = ((jax_config(ZAMBA), get_config(ZAMBA)) if size == "full"
                  else (jax_smoke(ZAMBA), get_smoke_config(ZAMBA)))
    jrules = dataclasses.replace(JShardRules.for_mesh(jax_local_mesh(data=1, model=1)),
                                 sp=False)
    pspecs = jreg.param_pspecs(jcfg, jrules)
    flat = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    pick = lambda spec, axis: next((i for i, a in enumerate(spec) if a == axis), None)
    want = {tuple(k.key for k in path): (pick(spec, "model"), pick(spec, "data"))
            for path, spec in flat}
    step = build_train_step(tcfg, _fake_mesh((1, model)), OptConfig(kind="adam"))
    rules = step._rules
    assert registry.param_shard_dims(tcfg, rules, data=1, model=model) == want
    proj = (tcfg.ssm.expand * tcfg.d_model * 2 + 2 * tcfg.ssm.state
            + tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.head_dim)
    assert proj == (296 if size == "smoke" else 8384)
    for m in range(model):
        lay = make_shard_layout(tcfg, rules, 1, model=model, model_rank=m)
        local = {p: lay.local_shape(i) for i, p in enumerate(lay.paths)}
        for i, path in enumerate(lay.paths):
            shape = list(lay.shapes[i])
            if want[path][0] is not None:
                shape[want[path][0]] //= model
            assert local[path] == tuple(shape), (path, m)
        assert local[("mamba", "in_proj")][-1] == proj // model
        conv = 160 if size == "smoke" else 4224
        assert local[("mamba", "conv_w")][-1] == local[("mamba", "conv_b")][-1] == conv // model
