"""The port's Zamba2 hybrid model and its serving (``repro_torch.models.
zamba``, the hybrid state kind of ``repro_torch.serve``) against the JAX
reference.

Both packages run the ``zamba2-1.2b`` smoke config on parameters from the
JAX family's ``init`` (converted through numpy) and the same numpy inputs:
``prefill`` logits and every cache leaf, then ``decode_step`` logits and
caches, on both of the port's paths (``attn_impl`` "chunked": plain
PyTorch; "kernel": the flash, SSD and RMSNorm wrappers, which run their
plain versions on CPU tensors).  The port's engine, fp32 and greedy, gives
the JAX engine's token streams for a staggered trace, and the recurrent
lifecycle (admit-time reset, evict-time zeroing) holds.

Tolerances.  fp32: 1e-4 absolute plus 1e-5 of each entry (the SSM state's
entries reach ~10) — the same fp32 arithmetic in another order (measured
~2e-5).  bf16: the whole model cannot be held at a fixed bf16 tolerance,
because at this width and random init the reference's own bf16 run is
9-15% of each tensor's largest entry away from its fp32 run (rounding
compounds through 5 Mamba2 and 3 shared blocks).  So the port's bf16
error against the reference's bf16 is held to at most twice the
reference's own bf16 error against fp32 (measured 0.28-1.17 times), and
the bf16 gate at 5e-2 of the largest entry is held where rounding has not
compounded yet: single blocks (``test_torch_ssm.py`` and
:func:`test_shared_block_matches_reference`) and the first shared block
with the first Mamba2 layer (:func:`test_first_layers_bf16_match_reference`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.attention import DecodeSharding
from repro.models import zamba as jzamba
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import registry as treg
from repro_torch.models import zamba as tzamba
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its smoke-width ops are too
    small to split, and beside the suite's other workers more threads only
    contend (the chip_smoke rehearsals ran many times slower with 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "zamba2-1.2b"
IMPLS = ["chunked", "kernel"]
LENS = [5, 11, 8]
BUDGETS = [7, 3, 5]
FP32_TOL = dict(atol=1e-4, rtol=1e-5)


def _np(x):
    """A float32 numpy copy (the port updates its caches in place)."""
    return np.array(x.float() if torch.is_tensor(x) else x, np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _jax_params():
    return jzamba.init(jax_smoke(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jp():
    return _jax_params()


def _port(dt, impl, jp, device="cpu"):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dt, attn_impl=impl)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=device)
    return cfg, params


@pytest.fixture(scope="module")
def jax_runs(jp, mesh, rules):
    """The reference's prefill (B=2, S=13, max_len 32) and one decode step,
    in fp32 and bf16 compute: {dtype: {name: numpy}}."""
    toks, nxt = _tokens((2, 13), 0), np.array([3, 7], np.int32)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype=dt)
        cache, logits = jzamba.prefill(cfg, mesh, rules, jp, jnp.asarray(toks), max_len=32)
        run = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
        logits, cache = jzamba.decode_step(cfg, mesh, rules, jp, cache, jnp.asarray(nxt), 13)
        run.update({"decode": _np(logits), **{f"decode/{k}": _np(v) for k, v in cache.items()}})
        out[dt] = run
    return toks, nxt, out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(jp, jax_runs, dt, impl):
    toks, nxt, want = jax_runs
    cfg, params = _port(dt, impl, jp)
    p = tzamba.cast_for_compute(cfg, params)
    cache, logits = tzamba.prefill(cfg, p, torch.tensor(toks), max_len=32)
    got = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
    logits, cache = tzamba.decode_step(cfg, p, cache, torch.tensor(nxt), 13)
    got.update({"decode": _np(logits), **{f"decode/{k}": _np(v) for k, v in cache.items()}})
    assert set(got) == set(want[dt])
    for name, w in want[dt].items():
        assert got[name].shape == w.shape, name
        if dt == "float32":
            np.testing.assert_allclose(got[name], w, **FP32_TOL, err_msg=name)
        else:
            noise = np.abs(w - want["float32"][name]).max()
            err = np.abs(got[name] - w).max()
            assert np.isfinite(got[name]).all() and err <= 2 * noise, (name, err, noise)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_shared_block_matches_reference(jp, mesh, rules, dt, impl):
    """The shared transformer block alone, prefill and decode, from the
    same inputs (bf16: 5e-2 of the output's largest entry)."""
    cfg, params = _port(dt, impl, jp)
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype=dt)
    sp = tzamba.cast_for_compute(cfg, params)["shared"]
    rng = np.random.default_rng(2)
    x, x0 = (rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32) for _ in range(2))
    tdt = getattr(torch, dt)
    jo, (jk, jv) = jzamba._shared_fwd(jcfg, mesh, rules, jnp.asarray(x, dt),
                                      jnp.asarray(x0, dt), jp["shared"], collect_kv=True)
    to, (tk, tv) = tzamba._shared_fwd(cfg, torch.tensor(x).to(tdt),
                                      torch.tensor(x0).to(tdt), sp)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        tol = FP32_TOL if dt == "float32" else dict(
            atol=5e-2 * np.abs(_np(want)).max(), rtol=0.0)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    # decode: one token per lane at positions (12, 5) against the prefilled KV
    kc = np.zeros((2, 16, cfg.n_kv, cfg.head_dim), np.float32)
    kc[:, :12], vc = _np(jk), np.zeros_like(kc)
    vc[:, :12] = _np(jv)
    pos = np.array([12, 5], np.int32)
    jo, _, _ = jzamba._shared_decode(jcfg, mesh, rules, jnp.asarray(x[:, 0], dt),
                                     jnp.asarray(x0[:, 0], dt), jp["shared"],
                                     jnp.asarray(kc, dt), jnp.asarray(vc, dt),
                                     jnp.asarray(pos), DecodeSharding.choose(mesh, 2))
    to = tzamba._shared_decode(cfg, torch.tensor(x[:, 0]).to(tdt),
                               torch.tensor(x0[:, 0]).to(tdt), sp,
                               torch.tensor(kc).to(tdt), torch.tensor(vc).to(tdt),
                               torch.tensor(pos))
    tol = FP32_TOL if dt == "float32" else dict(atol=5e-2 * np.abs(_np(jo)).max(), rtol=0.0)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)


@pytest.mark.parametrize("impl", IMPLS)
def test_first_layers_bf16_match_reference(jp, mesh, rules, impl):
    """bf16 at the depth where its rounding has not yet compounded: the
    first shared block and the first Mamba2 layer, then ``ln_f``, from the
    same tokens.  The hidden state and every cache leaf within 5e-2 of the
    reference's largest entry (measured at most 3.7e-2; the reference's own
    bf16 run is 2.5e-2 from its fp32 run here).  One layer, not the whole
    first segment of ``attn_every = 2``: after the second Mamba2 layer the
    reference's own bf16 hidden state is already 6.3e-2 from its fp32 one,
    so no implementation could be held at 5e-2 there."""
    n = 1
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="bfloat16", n_layers=n)
    jtrunc = {**jp, "mamba": jax.tree.map(lambda a: a[:n], jp["mamba"])}
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="bfloat16",
                              attn_impl=impl, n_layers=n)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jtrunc), device="cpu")
    toks = _tokens((2, 13), 3)
    jx, jc = jzamba.forward(jcfg, mesh, rules, jtrunc, jnp.asarray(toks), remat=False,
                            collect=True)
    tx, tc = tzamba.forward(cfg, tzamba.cast_for_compute(cfg, params), torch.tensor(toks),
                            collect=True)
    assert set(tc) == set(jc)
    for name, got, want in [("hidden", tx, jx)] + [(k, tc[k], jc[k]) for k in jc]:
        want = _np(want)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(_np(got), want, rtol=0.0,
                                   atol=5e-2 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_slot_padded_equals_exact(jp, dt, impl):
    """A prompt right-padded to its bucket and prefilled into lane 1
    equals the exact-length prefill: logits at plen - 1, the lane's KV at
    positions < plen, and its SSM and conv states (dt = 0 padding and the
    conv state sliced at plen).  Within 1e-5 of each tensor's largest
    entry: the bucket's matmuls have more rows, so fp32 sums may round
    differently."""
    cfg, params = _port(dt, impl, jp)
    p = tzamba.cast_for_compute(cfg, params)
    toks = _tokens((1, 11), 1)
    cache = {k: torch.zeros_like(s, device="cpu")
             for k, s in tzamba.make_cache_specs(cfg, 3, 32).items()}
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = toks[0]
    cache, logits = tzamba.prefill_slot(cfg, p, cache, torch.tensor(padded), 1, 11)
    exact, want = tzamba.prefill(cfg, p, torch.tensor(toks), max_len=32)
    pairs = [(logits, want)]
    pairs += [(cache[k][:, 1, :11], exact[k][:, 0, :11]) for k in ("k", "v")]
    pairs += [(cache[k][:, 1], exact[k][:, 0]) for k in ("ssm", "conv")]
    for got, w in pairs:
        np.testing.assert_allclose(_np(got), _np(w), rtol=0.0,
                                   atol=1e-5 * np.abs(_np(w)).max())
    for k in cache:                 # the other lanes are untouched
        assert not cache[k][:, 0].any() and not cache[k][:, 2].any()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(jp, mesh, rules):
    """The reference engine's fp32 greedy streams for the staggered trace
    (3 requests through 2 lanes: the third admitted when a lane frees)."""
    cfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    eng = JServeEngine(cfg, mesh, rules, jp, JEngineConfig(max_slots=2, max_len=32))
    prompts = _prompts()
    rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, BUDGETS)]
    eng.drain()
    assert eng.kind == "hybrid"
    return [list(eng.completions[r].tokens) for r in rids]


def _prompts(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_matches_reference(jp, jax_streams, impl):
    """The counterpart of ``test_serve_engine.py``'s staggered hybrid
    test: the port's engine gives the reference engine's streams token for
    token, with the invariants (recurrent zeroing included) swept after
    every step."""
    cfg, params = _port("float32", impl, jp)
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_len=32), device="cpu")
    rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(_prompts(), BUDGETS)]
    while eng.step():
        eng.check_invariants()
    got = [list(eng.completions[r].tokens) for r in rids]
    assert got == jax_streams
    assert [len(t) for t in got] == BUDGETS
    assert eng.kind == "hybrid" and eng.stats["state_kind"] == "hybrid"
    assert set(eng.rec.leaf_axes) == {"ssm", "conv"}
    assert {"k", "v"} <= set(eng.state["cache"])


def test_recurrent_cache_admit_evict_zeroing(jp):
    """The counterpart of ``test_serve_engine.py::test_recurrent_cache_
    admit_evict_zeroing`` for the hybrid kind: lanes start zero; a short
    request's lane reads exactly zero after it evicts while its neighbour
    keeps decoding (and is non-zero); a new request on the freed lane
    streams as it does alone (admit-time reset); a drained engine holds
    all-zero recurrent state."""
    cfg, params = _port("float32", "chunked", jp)
    ec = EngineConfig(max_slots=2, max_len=32)
    eng = ServeEngine(cfg, params, ec, device="cpu")
    assert eng.rec and set(eng.rec.leaf_axes) == set(treg.recurrent_leaf_axes(cfg))
    for i in range(2):
        assert eng.rec.lane_is_zero(eng.state["cache"], i)
    p_long, p_short, p_new = _prompts([6, 4, 7], seed=2)
    rid_long = eng.submit(p_long, max_new_tokens=10)
    rid_short = eng.submit(p_short, max_new_tokens=2)
    steps = 0
    while rid_short not in eng.completions:
        assert eng.step()
        eng.check_invariants()
        steps += 1
        assert steps < 50
    assert rid_long in eng.live
    short_slot = next(i for i, s in enumerate(eng.slots) if s is None)
    assert eng.rec.lane_is_zero(eng.state["cache"], short_slot)
    assert not eng.rec.lane_is_zero(eng.state["cache"], 1 - short_slot)

    solo = ServeEngine(cfg, params, ec, device="cpu")
    want = solo.run([p_new], max_new_tokens=4)[0]
    rid_new = eng.submit(p_new, max_new_tokens=4)
    eng.drain()
    np.testing.assert_array_equal(np.asarray(eng.completions[rid_new].tokens), want)
    assert eng.rec.lanes_are_zero(eng.state["cache"], [0, 1])
    assert eng.counters["evicted"] == 3


def test_paged_layout_is_refused(jp):
    """A hybrid lane's recurrent state has no sequence axis to page: the
    engine refuses ``kv_layout="paged"`` with the reference's message, and
    so does the launcher."""
    from repro_torch.launch.serve import main

    cfg, params = _port("float32", "chunked", jp)
    assert treg.state_kind(cfg) == "hybrid" and treg.supports_slot_serving(cfg)
    assert not treg.supports_paged_serving(cfg)
    assert treg.lane_leaf_axes(cfg) == {"k": 1, "v": 1, "ssm": 1, "conv": 1}
    with pytest.raises(ValueError, match="no seq axis to page; use kv_layout='slotted'"):
        ServeEngine(cfg, params, EngineConfig(kv_layout="paged"), device="cpu")
    with pytest.raises(ValueError, match="no seq axis to page"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kv-layout", "paged"])


def test_launcher_serves_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main

    eng = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "6"])
    assert len(eng.completions) == 6
    assert all(c.status == "ok" and len(c.tokens) == c.max_new_tokens
               for c in eng.completions.values())
    assert "-- status: ok 6 timeout 0 cancelled 0 failed 0" in capsys.readouterr().out


def test_launcher_without_card_raises(monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", ARCH, "--smoke"])
