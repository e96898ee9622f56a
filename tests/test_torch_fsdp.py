"""FSDP on the port's per-parameter path, in one process (the two-rank
checks ride ``test_torch_dist.py``'s spawn):

* every leaf of every ``ARCH_IDS`` config, full and smoke, carries the
  reference's ``ParamSpec.logical``, and ``param_shard_dims`` names the
  dimension where the reference's ``param_pspecs`` names ``"data"``;
* a world that does not divide a leaf's FSDP dimension raises, as the
  reference's placement does; no config hits it at 2, 4 or 8 ranks;
* ``init_shards`` at 1, 2 and 4 ranks holds exactly ``init``'s values,
  also with draw chunks that cut the leaves' rows;
* ``bytes_per_rank`` of the 48-layer ``qwen3-moe-30b-a3b``;
* at world 1 over a one-rank gloo group (every weight gathered and every
  gradient reduce-scattered) FSDP equals the replicated rules bitwise:
  losses, gradient norms, parameters and Adam moments after two steps with
  two §5.1 slices, and the collectives counted by formula;
* a gathered weight saved for the backward outside a rematted body is
  kept as its shard and gathered again;
* ``full_tree`` / ``shard_tree`` round trips, and a checkpoint written
  under one set of rules resumes under the other, bitwise;
* the launcher trains under FSDP without ``--faithful``.
"""
import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.mesh import local_mesh
from repro.models import registry as jreg
from repro.models.common import ParamSpec as JParamSpec
from repro.models.common import ShardRules as JShardRules
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch_fn
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import init_group, single_device_group
from repro_torch.models import common, registry
from repro_torch.models.common import ShardRules
from repro_torch.optim import OptConfig, fsdp
from repro_torch.optim.flat import tree_leaves
from repro_torch.train import LoopConfig, TrainSettings, build_train_step, init_sharded, train

CPU = single_device_group("cpu")
FSDP = ShardRules.for_group(CPU)
REPLICATED = ShardRules.for_group(CPU, faithful=True)
SHAPE = ShapeConfig("t", "train", 16, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo1():
    """A one-rank gloo group: every gather and reduce-scatter runs."""
    group = init_group("gloo", 0, 1, f"tcp://127.0.0.1:{_free_port()}", device="cpu",
                       timeout_s=60)
    yield group
    group.close()


# ---------------------------------------------------------------------------
# The rules and the logical axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch, size):
    jcfg, tcfg = ((jax_config(arch), get_config(arch)) if size == "full"
                  else (jax_smoke(arch), get_smoke_config(arch)))
    want = jax.tree.map(lambda s: (s.shape, s.logical), jreg.get_module(jcfg).param_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, JParamSpec))
    got = common.map_tree(lambda s: (s.shape, s.logical),
                          registry.get_module(tcfg).param_specs(tcfg))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shard_dims_match_reference_pspecs(arch):
    """The dimension ``param_shard_dims`` shards is where the reference's
    ``param_pspecs(cfg, ShardRules.for_mesh(local_mesh()))`` names "data"
    (and the faithful rules shard nothing, as the reference's)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    for faithful in (False, True):
        pspecs = jreg.param_pspecs(jcfg, JShardRules.for_mesh(local_mesh(), faithful=faithful))
        flat = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
        want = {tuple(k.key for k in path): next((i for i, a in enumerate(spec) if a == "data"),
                                                 None)
                for path, spec in flat}
        got = registry.param_shard_dims(tcfg, ShardRules.for_group(CPU, faithful=faithful))
        assert {p: fs for p, (_, fs) in got.items()} == want
        assert all(tp is None for tp, _ in got.values())


def test_rules_for_group():
    assert FSDP == ShardRules(dp=("data",), tp=None, fsdp="data", sp=False)
    assert REPLICATED == ShardRules(dp=("data",), tp=None, fsdp=None, sp=False)
    assert [FSDP.axis(l) for l in ("dp", "tp", "fsdp", "sp", None)] == [
        ("data",), None, "data", None, None]
    with pytest.raises(ValueError, match="unknown logical axis"):
        FSDP.axis("pp")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_config_hits_an_uneven_world(arch):
    for cfg in (get_config(arch), get_smoke_config(arch)):
        for world in (2, 4, 8):
            fsdp.make_shard_layout(cfg, FSDP, world)


def test_uneven_world_raises():
    """The reference's ``jax.device_put`` of a sharding whose dimension the
    data axis does not divide raises ValueError; so does the layout."""
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="does not divide over 7 ranks"):
        fsdp.make_shard_layout(cfg, FSDP, 7)
    fsdp.make_shard_layout(cfg, REPLICATED, 7)          # nothing sharded


# ---------------------------------------------------------------------------
# The sharded init and the state bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1 << 26, 997])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_init_shards_hold_init_values(monkeypatch, arch, chunk):
    """The ranks' shards, put together, are ``init``'s leaves bitwise, at 1,
    2 and 4 ranks; with 997-value draw chunks every leaf's rows are cut
    by chunk boundaries, and ``init`` itself draws the same chunks."""
    monkeypatch.setattr(common, "INIT_CHUNK", chunk)
    cfg = get_smoke_config(arch)
    full = dict(tree_leaves(registry.get_module(cfg).init(cfg, seed=3, device="cpu")))
    for world in (1, 2, 4):
        layouts = [fsdp.make_shard_layout(cfg, FSDP, world, r) for r in range(world)]
        parts = [dict(tree_leaves(fsdp.init_shards(cfg, lay, 3, "cpu"))) for lay in layouts]
        for i, path in enumerate(layouts[0].paths):
            d = layouts[0].dims[i]
            assert tuple(parts[0][path].shape) == layouts[0].local_shape(i)
            got = torch.cat([p[path] for p in parts], d) if d is not None else parts[0][path]
            assert torch.equal(got, full[path]), (world, path)


def test_bytes_per_rank_qwen3_moe_48_layers():
    """Parameters, gradients and Adam moments a rank holds for the full
    48-layer qwen3-moe-30b-a3b: 16 bytes a parameter replicated (488 GB);
    every leaf but the norms and the router is sharded, so a rank holds
    1/N of nearly all (61 GB at 8 ranks)."""
    cfg = get_config("qwen3-moe-30b-a3b")
    assert cfg.n_layers == 48
    n = sum(t.numel() for _, t in tree_leaves(registry.abstract_params(cfg)))
    opt = OptConfig(kind="adam")
    rows = {w: fsdp.bytes_per_rank(cfg, opt, w) for w in (1, 4, 8)}
    assert rows[1]["total"] == 16 * n and rows[1]["params"] == 4 * n
    D, E = cfg.d_model, cfg.moe.num_experts
    replicated = cfg.n_layers * (2 * D + D * E + 2 * cfg.head_dim) + D
    for w in (4, 8):
        assert rows[w]["params"] == 4 * (replicated + (n - replicated) // w), w
        assert rows[w]["opt_state"] == 2 * rows[w]["params"] == 2 * rows[w]["grads"]
    assert rows[8]["total"] < 62e9 < rows[4]["total"]


# ---------------------------------------------------------------------------
# World 1 through the collectives: FSDP == replicated, bitwise
# ---------------------------------------------------------------------------


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl="kernel")


def _sharded_per_slice(cfg) -> tuple[int, int]:
    """(all-gathers, reduce-scatters) of one slice's loss and backward.
    Gathers: each rematted layer's sharded leaves twice (the forward and
    remat's recompute); outside the remat, the embedding lookup once, the
    unembedding (a tied table's second read) and each of zamba's
    shared-block invocations twice (the forward, and the backward's gather
    of the weight its product saved).  Every gather of the forward has one
    reduce-scatter."""
    shards = fsdp.make_shard_layout(cfg, FSDP, 1)
    per = {top: sum(1 for p in shards.sharded if p[0] == top)
           for top in {p[0] for p in shards.sharded}}
    remat, plain = cfg.n_layers * per.get("blocks", 0), 2
    if cfg.family == "hybrid":
        from repro_torch.models import zamba
        remat = cfg.n_layers * per["mamba"]
        plain += zamba.n_shared_invocations(cfg) * per["shared"]
    return 2 * plain - 1 + 2 * remat, plain + remat


def _steps(cfg, group, rules, steps=2, k=2):
    params, state = init_sharded(cfg, group, OptConfig(kind="adam", lr=1e-3), 0,
                                 TrainSettings(num_slices=k), rules)
    step = build_train_step(cfg, group, OptConfig(kind="adam", lr=1e-3),
                            TrainSettings(num_slices=k), rules)
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    metrics = []
    for i in range(steps):
        params, state, m = step(params, state, make_batch_fn(cfg, SHAPE, 0)(i))
        metrics.append({n: float(v) for n, v in m.items()})
    return metrics, params, state, dict(common.COUNTS)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_world1_fsdp_equals_replicated_bitwise(gloo1, arch):
    cfg = _cfg(arch)
    rm, rp, rs, rc = _steps(cfg, gloo1, ShardRules.for_group(gloo1, faithful=True))
    assert rc == dict.fromkeys(common.COUNTS, 0)
    fm, fp, fs, fc = _steps(cfg, gloo1, None)
    assert fm == rm
    for a, b in ((fp, rp), (fs["m"], rs["m"]), (fs["v"], rs["v"])):
        for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), path
    ag, rsc = _sharded_per_slice(cfg)
    assert fc == {**dict.fromkeys(common.COUNTS, 0), "all_gather": 2 * 2 * ag,
                  "reduce_scatter": 2 * 2 * rsc}


@pytest.mark.parametrize("dim", [0, 1])
def test_saved_gathered_weight_is_its_shard_until_the_backward(gloo1, dim, monkeypatch):
    """Outside a rematted body, a product that saves a gathered weight (or
    a view of it) keeps only the shard: nothing the autograd graph keeps
    shares the full tensor's memory, the backward gathers it again, and
    the gradients are the plain product's."""
    kept = []
    pack = common._pack
    monkeypatch.setattr(common, "_pack", lambda t: kept.append(pack(t)) or kept[-1])
    gen = torch.Generator().manual_seed(0)
    shard = torch.randn(6, 4, generator=gen).requires_grad_()
    x = torch.randn(3, 4, generator=gen).requires_grad_()
    f = lambda x, w: ((x @ w.t()) if dim == 1 else (x @ w.t()).tanh()).square().sum()
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
    none = dict.fromkeys(common.COUNTS, 0)
    with common.fsdp_program(gloo1, {}):
        w = common.wuse(shard, dim, torch.float32, gloo1)
        full = w.untyped_storage().data_ptr()
        y = f(x, w)
        del w
        assert common.COUNTS == {**none, "all_gather": 1, "reduce_scatter": 0}
        assert not [k for k in kept if isinstance(k, torch.Tensor)
                    and k.untyped_storage().data_ptr() == full]
        assert sum(1 for k in kept if not isinstance(k, torch.Tensor)) == 1
        gs, gx = torch.autograd.grad(y, (shard, x))
    assert common.COUNTS == {**none, "all_gather": 2, "reduce_scatter": 1}
    ws, xs = shard.detach().requires_grad_(), x.detach().requires_grad_()
    ref = f(xs, ws)
    assert torch.equal(y, ref)
    for a, b in zip((gs, gx), torch.autograd.grad(ref, (ws, xs))):
        assert torch.equal(a, b)


def test_shard_and_full_tree_round_trip(gloo1):
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    full = registry.get_module(cfg).init(cfg, seed=1, device="cpu")
    lay = fsdp.make_shard_layout(cfg, FSDP, 1)
    back = fsdp.full_tree(lay, fsdp.shard_tree(lay, full), gloo1)
    for (path, a), (_, b) in zip(tree_leaves(full), tree_leaves(back)):
        assert torch.equal(a, b), path
    fsdp.check_shards(lay, full)
    with pytest.raises(ValueError, match="is not this rank's shard"):
        fsdp.check_shards(fsdp.make_shard_layout(cfg, FSDP, 2), full)


@pytest.mark.parametrize("first,then", [("fsdp", "replicated"), ("replicated", "fsdp")])
def test_checkpoint_resumes_under_the_other_rules(tmp_path, first, then):
    """A checkpoint of full leaves: written after 2 steps under one set of
    rules, resumed for a third under the other, equal to 3 uninterrupted
    steps bitwise (one worker: the shards are the whole leaves)."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    rules = {"fsdp": FSDP, "replicated": REPLICATED}
    opt = OptConfig(kind="adam", lr=1e-3)
    ref = train(cfg, SHAPE, CPU, opt, TrainSettings(), LoopConfig(steps=3, ckpt_every=0,
                                                                  log_every=0),
                rules=rules[then])
    loop = LoopConfig(steps=2, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=0)
    train(cfg, SHAPE, CPU, opt, TrainSettings(), loop, rules=rules[first])
    res = train(cfg, SHAPE, CPU, opt, TrainSettings(),
                dataclasses.replace(loop, steps=3, ckpt_every=0), rules=rules[then])
    assert res["final_loss"] == ref["final_loss"]
    assert int(res["opt_state"]["step"]) == 3
    for a, b in ((res["params"], ref["params"]), (res["opt_state"]["v"], ref["opt_state"]["v"])):
        for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_launcher_runs_fsdp_without_faithful(arch, capsys):
    res = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                             "--ckpt-every", "0"])
    assert np.isfinite(res["final_loss"])
    assert "per-parameter path under FSDP" in res["program"]
    assert res["program"] in capsys.readouterr().out
    res = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                             "--ckpt-every", "0", "--faithful", "--flat-engine", "off"])
    assert res["program"] == "the per-parameter path, replicated"
