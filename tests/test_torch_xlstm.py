"""The port's xLSTM family (``repro_torch.models.xlstm``/``xlstm_lm``, the
recurrent state kind of ``repro_torch.serve``) against the JAX reference.

Both packages run the ``xlstm-1.3b`` smoke config (4 layers: mLSTM, sLSTM,
mLSTM, sLSTM; d_model 64, 2 heads) on parameters from the JAX family's
``init`` (converted through numpy) and the same numpy inputs: the cells
(``mlstm_chunked`` at chunks 4 and 8 with ragged T, its decode
continuation, ``slstm_scan`` with and without ``valid``), ``forward``
(with ``plen`` too), ``loss_fn`` and its gradients, ``prefill``,
``decode_step`` and ``prefill_slot`` with every cache leaf, on both of the
port's paths (``attn_impl`` "chunked": plain PyTorch; "kernel": the RMSNorm
wrappers, which run their plain versions on CPU tensors).  The port's
engine, fp32 and greedy, gives the JAX engine's streams and counters on the
reference's recurrent scenarios: staggered admission, admit/evict zeroing,
preempt and resume, the paged options refused, the ``generate`` wrapper,
hold with and without a host tier, and a speculating engine with an xLSTM
target; plus the snapshot/rollback of the xLSTM leaves and the launcher.

Tolerances.  fp32: 1e-4 absolute plus 1e-5 of each entry: the same fp32
arithmetic in another order (measured at most 5.6e-5, on the sLSTM ``n``
state, whose entries reach ~9).  bf16: the whole model cannot be held at a
fixed bf16 tolerance: at this width and random init the reference's own
bf16 run is 2-15% of each tensor's largest entry away from its fp32 run
(the sLSTM's exponential gates compound the roundings).  So the port's
bf16 error against the reference's bf16 is held to twice the reference's
own bf16 error (measured 0.6-1.0 times), and each block alone, from the
same inputs, to 5e-2 of its output's largest entry (a few bf16 roundings,
2**-8 each, where the two packages round in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.models import xlstm as jcell
from repro.models import xlstm_lm as jxl
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import generate_static as jgenerate_static
from repro.serve.cache import RecurrentCache as JRecurrentCache
from repro_torch.configs import get_smoke_config
from repro_torch.models import registry as treg
from repro_torch.models import xlstm as tcell
from repro_torch.models import xlstm_lm as txl
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, ServeConfig, ServeEngine, generate, generate_static
from repro_torch.serve.cache import RecurrentCache


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its smoke-width ops are too
    small to split, and beside the suite's other workers more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "xlstm-1.3b"
IMPLS = ["chunked", "kernel"]
FP32_TOL = dict(atol=1e-4, rtol=1e-5)
BLOCK_TOL = 5e-2
LENS = [5, 11, 8]
BUDGETS = [7, 3, 5]


def _np(x):
    """A float32 numpy copy (the port updates its caches in place)."""
    return np.array(x.float() if torch.is_tensor(x) else x, np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _prompts(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def jp():
    return jxl.init(jax_smoke(ARCH), jax.random.PRNGKey(0))


def _jcfg(dt="float32"):
    return dataclasses.replace(jax_smoke(ARCH), compute_dtype=dt)


def _port(jp, dt="float32", impl="chunked"):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dt, attn_impl=impl)
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, name=""):
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------


def _cell_inputs(B=2, T=13, H=2, Dh=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, Dh)).astype(np.float32) for _ in range(3))
    i_pre = rng.normal(size=(B, T, H)).astype(np.float32)
    f_pre = (rng.normal(size=(B, T, H)) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunked_matches_reference(chunk):
    """T = 13 is not a multiple of either chunk (the identity padding);
    the outputs and the final (C, n, m) against the reference's chunked
    form, and the outputs against the per-step oracle of both packages."""
    ins = _cell_inputs()
    jy, jst = jcell.mlstm_chunked(*map(jnp.asarray, ins), chunk=chunk, return_state=True)
    ty, tst = tcell.mlstm_chunked(*map(torch.tensor, ins), chunk=chunk, return_state=True)
    _close(ty, jy, "y")
    for name, got, want in zip("Cnm", tst, jst):
        _close(got, want, name)
    _close(tcell.mlstm_reference(*map(torch.tensor, ins)),
           jcell.mlstm_reference(*map(jnp.asarray, ins)), "oracle")
    _close(ty, tcell.mlstm_reference(*map(torch.tensor, ins)), "chunked vs oracle")


def test_mlstm_decode_continues_chunked_prefill():
    """A chunked prefill's final state, then 4 decode steps: each step's
    output and state against the reference's; the state is updated in the
    tensors given (the serving path's cache views)."""
    q, k, v, i_pre, f_pre = _cell_inputs(T=17, seed=1)
    P = 13
    _, jst = jcell.mlstm_chunked(*(jnp.asarray(a[:, :P]) for a in (q, k, v, i_pre, f_pre)),
                                 chunk=4, return_state=True)
    _, tst = tcell.mlstm_chunked(*(torch.tensor(a[:, :P]) for a in (q, k, v, i_pre, f_pre)),
                                 chunk=4, return_state=True)
    for t in range(P, 17):
        step = [a[:, t] for a in (q, k, v, i_pre, f_pre)]
        jst, jy = jcell.mlstm_decode_step(jst, *map(jnp.asarray, step))
        ptrs = [s.data_ptr() for s in tst]
        tst, ty = tcell.mlstm_decode_step(tst, *map(torch.tensor, step))
        assert [s.data_ptr() for s in tst] == ptrs
        _close(ty, jy, f"y{t}")
        for name, a, b in zip("Cnm", tst, jst):
            _close(a, b, f"{name}{t}")


@pytest.mark.parametrize("masked", [False, True], ids=["no-valid", "valid"])
def test_slstm_scan_matches_reference(masked):
    """The sLSTM scan from a random carry, with and without ``valid``:
    hidden states and the final (h, c, n, m); under ``valid`` the steps
    past a row's length leave its carry bitwise the carry at its end."""
    rng = np.random.default_rng(3)
    B, T, H, Dh = 2, 9, 2, 8
    xs = [rng.normal(size=(B, T, H, Dh)).astype(np.float32) for _ in range(4)]
    rs = [(rng.normal(size=(H, Dh, Dh)) * 0.3).astype(np.float32) for _ in range(4)]
    st = [rng.normal(size=(B, H, Dh)).astype(np.float32) for _ in range(3)] + [
        np.zeros((B, H, Dh), np.float32)]
    valid = (np.arange(T)[None, :] < np.array([[6], [9]])) if masked else None
    jh, jfin = jcell.slstm_scan(*map(jnp.asarray, xs + rs + st),
                                valid=None if valid is None else jnp.asarray(valid))
    th, tfin = tcell.slstm_scan(*map(torch.tensor, xs + rs + st),
                                valid=None if valid is None else torch.tensor(valid))
    _close(th, jh, "h")
    for name, a, b in zip("hcnm", tfin, jfin):
        _close(a, b, name)
    if masked:
        # row 0 (length 6) against the same batch scanned for 6 steps only
        short = tcell.slstm_scan(*(torch.tensor(x[:, :6]) for x in xs),
                                 *map(torch.tensor, rs + st))[1]
        for name, a, b in zip("hcnm", tfin, short):
            assert torch.equal(a[0], b[0]), name


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_block_matches_reference(jp, mesh, rules, kind, dt, impl):
    """One block alone from the same inputs, prefill and a decode token
    from its state: fp32 within ``FP32_TOL``, bf16 within 5e-2 of each
    output's largest entry."""
    cfg, params = _port(jp, dt, impl)
    jcfg = _jcfg(dt)
    tree = "mlstm" if kind == "mlstm" else "slstm"
    jbp = jax.tree.map(lambda a: a[0], jp[tree])
    tbp = {n: p[0] for n, p in txl.cast_for_compute(cfg, params)[tree].items()}
    jfwd = jcell.mlstm_block_fwd if kind == "mlstm" else jcell.slstm_block_fwd
    tfwd = tcell.mlstm_block_fwd if kind == "mlstm" else tcell.slstm_block_fwd
    x = np.random.default_rng(4).normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dt)
    jo, (jconv, jcellst) = jfwd(jcfg, rules, jnp.asarray(x, dt), jbp)
    to, (tconv, tcellst) = tfwd(cfg, torch.tensor(x).to(tdt), tbp)
    outs = [(to, jo), (tconv, jconv)] + list(zip(tcellst, jcellst))
    x1 = np.random.default_rng(5).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jd, (_, jdcell) = jfwd(jcfg, rules, jnp.asarray(x1, dt), jbp, conv_state=jconv,
                           cell_state=jcellst, decode=True)
    td, (_, tdcell) = tfwd(cfg, torch.tensor(x1).to(tdt), tbp, conv_state=tconv.clone(),
                           cell_state=tuple(s.clone() for s in tcellst), decode=True)
    outs += [(td, jd)] + list(zip(tdcell, jdcell))
    for i, (got, want) in enumerate(outs):
        if dt == "float32":
            _close(got, want, str(i))
        else:
            w = _np(want)
            np.testing.assert_allclose(_np(got), w, rtol=0.0,
                                       atol=BLOCK_TOL * np.abs(w).max(), err_msg=str(i))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_loss(jp, mesh, rules):
    """The reference's loss and gradient on one token batch."""
    batch = {"tokens": _tokens((2, 12), 1)}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jxl.loss_fn(_jcfg(), mesh, rules, p, {"tokens": jnp.asarray(batch["tokens"])},
                              remat=True), has_aux=True)(jp)
    return batch, float(loss), grads


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_loss_and_grads_match_reference(jp, jax_loss, mesh, rules, impl):
    """fp32 forward hidden states (with and without ``plen``, whose
    collected states snapshot the real prompt end), ``loss_fn`` and its
    gradient leaf by leaf against the reference's ``jax.grad``."""
    cfg, params = _port(jp, "float32", impl)
    jcfg = _jcfg()
    toks = _tokens((2, 13), 0)
    jh, _ = jxl.forward(jcfg, mesh, rules, jp, jnp.asarray(toks), remat=False)
    th, _ = txl.forward(cfg, params, torch.tensor(toks))
    _close(th, jh, "hidden")
    jh, (jm, js) = jxl.forward(jcfg, mesh, rules, jp, jnp.asarray(toks[:1]), remat=False,
                               collect=True, plen=9)
    th, tc = txl.forward(cfg, params, torch.tensor(toks[:1]), collect=True, plen=9)
    _close(th[:, :9], np.asarray(jh)[:, :9], "plen hidden")
    want = jxl._pack_cache(jm, js)
    assert set(tc) == set(want)
    for name in want:
        _close(tc[name], want[name], f"plen {name}")

    batch, jloss, jgrads = jax_loss
    for leaf in _leaves(params):
        leaf.requires_grad_()
    tloss, taux = txl.loss_fn(cfg, params, {"tokens": torch.tensor(batch["tokens"])})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    assert float(taux["lb_loss"]) == 0.0 == float(taux["drop_frac"])
    assert len(_leaves(params)) == len(_leaves(jgrads))
    for (name, got), want in zip(_named(params), _leaves(jgrads)):
        _close(got.grad, want, f"grad {name}")


def _named(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _leaves(tree):
    return [v for _, v in _named(tree)]


@pytest.fixture(scope="module")
def jax_runs(jp, mesh, rules):
    """The reference's prefill (B = 2, S = 13) and two decode steps, fp32
    and bf16: {dtype: {name: numpy}}."""
    toks, nxt = _tokens((2, 13), 0), np.array([[3, 7], [250, 1]], np.int32)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = _jcfg(dt)
        cache, logits = jxl.prefill(cfg, mesh, rules, jp, jnp.asarray(toks), max_len=32)
        run = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
        for i, tok in enumerate(nxt):
            logits, cache = jxl.decode_step(cfg, mesh, rules, jp, cache, jnp.asarray(tok), 13 + i)
            run.update({f"decode{i}": _np(logits),
                        **{f"decode{i}/{k}": _np(v) for k, v in cache.items()}})
        out[dt] = run
    return toks, nxt, out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(jp, jax_runs, dt, impl):
    """Logits and all nine cache leaves after the prefill and after each of
    two decode steps (the decode writes every leaf in place)."""
    toks, nxt, want = jax_runs
    cfg, params = _port(jp, dt, impl)
    p = txl.cast_for_compute(cfg, params)
    cache, logits = txl.prefill(cfg, p, torch.tensor(toks), max_len=32)
    got = {"prefill": _np(logits), **{f"prefill/{k}": _np(v) for k, v in cache.items()}}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for i, tok in enumerate(nxt):
        logits, cache = txl.decode_step(cfg, p, cache, torch.tensor(tok), 13 + i)
        got.update({f"decode{i}": _np(logits),
                    **{f"decode{i}/{k}": _np(v) for k, v in cache.items()}})
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
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
def test_prefill_slot_padded_bucket_is_bitwise_exact(jp, dt, impl):
    """A prompt right-padded to its bucket and prefilled into lane 1 writes
    bit for bit the state an exact-length prefill writes, and the same
    logits; the other lanes are untouched.  (``prefill_slot`` runs the
    prompt's own length, so this holds on any device.)"""
    cfg, params = _port(jp, dt, impl)
    p = txl.cast_for_compute(cfg, params)
    toks = _tokens((1, 11), 1)
    cache = {k: torch.zeros_like(s, device="cpu")
             for k, s in txl.make_cache_specs(cfg, 3, 32).items()}
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = toks[0]
    padded[0, 11:] = 7
    cache, logits = txl.prefill_slot(cfg, p, cache, torch.tensor(padded), 1, 11)
    exact, want = txl.prefill(cfg, p, torch.tensor(toks))
    assert torch.equal(logits, want)
    for k in cache:
        assert cache[k].dtype == exact[k].dtype, k
        assert torch.equal(cache[k][:, 1], exact[k][:, 0]), k
        assert not cache[k][:, 0].any() and not cache[k][:, 2].any(), k


def test_prefill_slot_matches_reference(jp, mesh, rules):
    """The port's lane write against the reference's ``prefill_slot`` on
    the same padded bucket (its identity steps over the padding): logits
    and every leaf of the lane, fp32."""
    cfg, params = _port(jp)
    p = txl.cast_for_compute(cfg, params)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = _tokens((1, 11), 2)[0]
    jcache = {k: jnp.zeros(s.shape, s.dtype)
              for k, s in jxl.make_cache_specs(_jcfg(), 3, 32).items()}
    jcache, jlogits = jxl.prefill_slot(_jcfg(), mesh, rules, jp, jcache, jnp.asarray(padded),
                                       jnp.int32(2), jnp.int32(11))
    cache = {k: torch.zeros_like(s, device="cpu")
             for k, s in txl.make_cache_specs(cfg, 3, 32).items()}
    cache, logits = txl.prefill_slot(cfg, p, cache, torch.tensor(padded), 2, 11)
    _close(logits, jlogits, "logits")
    for k in cache:
        _close(cache[k], jcache[k], k)


def test_registry_and_cache_specs(jp):
    """The recurrent kind's registry answers and the nine leaves' shapes
    and dtypes equal the reference's."""
    cfg, _ = _port(jp)
    jcfg = _jcfg()
    assert treg.get_module(cfg) is txl and treg.state_kind(cfg) == "recurrent"
    assert treg.supports_slot_serving(cfg) and not treg.supports_paged_serving(cfg)
    assert treg.recurrent_leaf_axes(cfg) == jreg.recurrent_leaf_axes(jcfg)
    assert treg.lane_leaf_axes(cfg) == jreg.lane_leaf_axes(jcfg)
    want = jxl.make_cache_specs(jcfg, 3, 32)
    got = txl.make_cache_specs(cfg, 3, 32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# Serving: the engine against the reference's
# ---------------------------------------------------------------------------


COUNTERS = ("prefills", "decode_steps", "admitted", "evicted", "preemptions", "resumed",
            "replayed_tokens", "spills", "restores", "holds", "releases")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(eng, stream, hook=None):
    """Replay (tick, prompt, budget) arrivals through one engine (either
    package's); ``hook(eng, tick)`` before each step; invariants (the
    recurrent-zero sweep included) after every step."""
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        if hook is not None:
            hook(eng, tick)
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0
        tick += 1
        assert tick < 500, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


@pytest.fixture(scope="module")
def both(jp):
    cfg, params = _port(jp)
    return dict(jcfg=_jcfg(), jp=jp, tcfg=cfg, tp=params, jaot=JAotCache("xlstm-tests"))


def port_engine(m, **fields):
    kw = fields.pop("kw", {})
    return ServeEngine(m["tcfg"], m["tp"], EngineConfig(
        max_slots=fields.pop("max_slots", 2), max_len=fields.pop("max_len", 32), **fields),
        device="cpu", clock=FakeClock(), **kw)


def ref_engine(m, mesh, rules, **fields):
    kw = fields.pop("kw", {})
    return JServeEngine(m["jcfg"], mesh, rules, m["jp"], JEngineConfig(
        max_slots=fields.pop("max_slots", 2), max_len=fields.pop("max_len", 32), **fields),
        aot=m["jaot"], clock=FakeClock(), **kw)


def _same_run(m, mesh, rules, stream, hook=None, **fields):
    """The port's engine and the reference's on the same traffic and hook:
    equal streams and counters.  Returns (streams, the port engine)."""
    eng = port_engine(m, **fields)
    got = drive(eng, stream, hook)
    jeng = ref_engine(m, mesh, rules, **fields)
    assert got == drive(jeng, stream, hook)
    assert {k: eng.counters[k] for k in COUNTERS} == {k: jeng.counters[k] for k in COUNTERS}
    assert eng.kind == jeng.kind == "recurrent"
    return got, eng


def test_staggered_matches_solo_static_and_reference(both, mesh, rules):
    """``test_serve_engine.py::test_recurrent_staggered_matches_solo_static``:
    3 requests through 2 lanes (the third admitted when a lane frees) give
    each request's solo ``generate_static`` stream, and the reference
    engine's streams and counters."""
    m = both
    stream = [(0, p, b) for p, b in zip(_prompts(), BUDGETS)]
    got, eng = _same_run(m, mesh, rules, stream)
    solo = [generate_static(m["tcfg"], m["tp"], p[None], ServeConfig(max_new_tokens=b),
                            device="cpu")[0].tolist() for _, p, b in stream]
    assert got == solo and [len(t) for t in got] == BUDGETS
    assert eng.stats["state_kind"] == "recurrent"
    assert set(eng.rec.leaf_axes) == set(txl.M_LEAVES + txl.S_LEAVES) == set(eng.state["cache"])


def test_recurrent_cache_admit_evict_zeroing(both):
    """``test_serve_engine.py::test_recurrent_cache_admit_evict_zeroing``
    for the recurrent kind: lanes start zero; a short request's lane reads
    exactly zero after it evicts while its neighbour keeps decoding (and
    is non-zero); a new request on the freed lane streams as solo static
    (admit-time reset); a drained engine holds all-zero state."""
    m = both
    eng = port_engine(m)
    assert set(eng.rec.leaf_axes) == set(treg.recurrent_leaf_axes(m["tcfg"]))
    assert eng.rec.lanes_are_zero(eng.state["cache"], [0, 1])
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
    want = generate_static(m["tcfg"], m["tp"], p_new[None], ServeConfig(max_new_tokens=4),
                           device="cpu")[0]
    rid_new = eng.submit(p_new, max_new_tokens=4)
    eng.drain()
    np.testing.assert_array_equal(np.asarray(eng.completions[rid_new].tokens), want)
    assert eng.rec.lanes_are_zero(eng.state["cache"], [0, 1])
    assert eng.counters["evicted"] == 3


def test_preempt_resume_matches_reference(both, mesh, rules):
    """``test_serve_engine.py::test_recurrent_preempt_resume_parity``: a lane
    preempted mid-decode re-prefills its prompt and replays its tokens;
    the stream equals the unpreempted one and the reference's, with the
    same counters."""
    m = both
    prompts = _prompts([6, 9], seed=3)
    stream = [(0, prompts[0], 8), (0, prompts[1], 5)]

    def hook(eng, tick):
        if tick == 3 and eng.slots[0] is not None:
            eng.preempt(0)

    plain = drive(port_engine(m), stream)
    got, eng = _same_run(m, mesh, rules, stream, hook)
    assert got == plain and len(got[0]) == 8
    c = eng.counters
    assert c["preemptions"] == 1 == c["resumed"] and c["replayed_tokens"] > 0


def test_paged_options_refused(both):
    """``test_serve_engine.py::test_recurrent_rejects_paged_options``, with
    the reference's messages; the launcher refuses the paged layout too."""
    from repro_torch.launch.serve import main

    m = both
    with pytest.raises(ValueError, match="no seq axis to page; use kv_layout='slotted'"):
        port_engine(m, max_slots=1, kv_layout="paged")
    for bad in (dict(prefill_chunk=8), dict(prefix_cache=True), dict(admission="preempt")):
        with pytest.raises(ValueError, match="paged"):
            port_engine(m, max_slots=1, **bad)
    with pytest.raises(ValueError, match="no seq axis to page"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kv-layout", "paged"])


def test_generate_wrapper_and_bucket_reuse(both, mesh, rules):
    """``test_serve_engine.py::test_recurrent_generate_wrapper_and_bucket_
    reuse``: ``generate`` (the engine) equals ``generate_static`` and the
    reference's; repeat admissions in one bucket build nothing new."""
    m = both
    rng = np.random.default_rng(4)
    prompts = np.stack([rng.integers(0, 256, 8).astype(np.int32) for _ in range(3)])
    a = generate(m["tcfg"], m["tp"], prompts, ServeConfig(max_new_tokens=5), device="cpu")
    b = generate_static(m["tcfg"], m["tp"], prompts, ServeConfig(max_new_tokens=5),
                        device="cpu")
    want = np.asarray(jgenerate_static(m["jcfg"], mesh, rules, m["jp"], prompts,
                                       serve=JServeConfig(max_new_tokens=5)))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, want)
    eng = port_engine(m, max_len=64)
    eng.run([rng.integers(0, 256, n).astype(np.int32) for n in (3, 9, 14)], max_new_tokens=2)
    builds = eng.stats["builds"]
    assert builds == 2                          # decode + prefill at bucket 16
    eng.run([rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 7, 2)],
            max_new_tokens=3)
    assert eng.stats["builds"] == builds


def test_hold_spills_immediately(both, mesh, rules):
    """``test_host_tier.py::test_hold_recurrent_spills_immediately``: a held
    recurrent lane spills at ``hold()`` (the next decode's freeze zeroes
    its device copy) and its release restores it: streams and counters the
    reference tiered engine's, the stream the untiered one's."""
    m = both
    stream = [(0, np.arange(1, 10, dtype=np.int32), 6),
              (1, np.arange(3, 14, dtype=np.int32), 5)]
    fields = dict(max_slots=3, max_len=48, host_tier=True, park_idle_s=4.0)

    def hook(eng, tick):
        if tick == 2 and eng.slots[0] is not None:
            eng.hold(eng.slots[0].rid)
            assert eng.counters["spills"] == 1
        if tick == 4 and eng.slots[0] is not None and eng.slots[0].held:
            eng.release(eng.slots[0].rid)

    plain = drive(port_engine(m, max_slots=3, max_len=48), stream)
    got, eng = _same_run(m, mesh, rules, stream, hook, **fields)
    assert got == plain
    c = eng.counters
    assert c["holds"] == 1 == c["releases"] and c["restores"] >= 1
    assert c["replayed_tokens"] == 0


def test_hold_without_tier_raises(both):
    """``test_host_tier.py::test_hold_recurrent_without_tier_raises``."""
    eng = port_engine(both, max_slots=3, max_len=48)
    eng.submit(np.arange(1, 8, dtype=np.int32), max_new_tokens=4)
    eng.step()
    with pytest.raises(ValueError, match="host tier"):
        eng.hold(0)
    eng.drain()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_rollback_bitwise_over_xlstm_leaves(seed):
    """``test_spec_decode.py``'s snapshot/rollback over the nine xLSTM
    leaves: advance the live leaves in place, roll back with a random keep
    mask; kept lanes are the advanced state, the others the snapshot, and
    the result is bitwise the reference's ``rollback``."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    rec = RecurrentCache(cfg)
    rng = np.random.default_rng(seed)
    specs = txl.make_cache_specs(cfg, 3, 32)
    base = {n: rng.standard_normal(tuple(specs[n].shape)).astype(np.float32)
            for n in rec.leaf_axes}
    cache = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    bufs = {n: torch.empty_like(c) for n, c in cache.items()}
    snap = rec.snapshot(cache, bufs)
    for n, c in cache.items():
        c.mul_(1.25).add_(torch.from_numpy(rng.standard_normal(c.shape).astype(np.float32)))
    advanced = {n: c.clone() for n, c in cache.items()}
    keep = rng.integers(0, 2, 3).astype(bool)
    rec.rollback(cache, snap, torch.from_numpy(keep))
    jrec = JRecurrentCache(_jcfg())
    jout = jrec.rollback({n: jnp.asarray(a.numpy()) for n, a in advanced.items()},
                         {n: jnp.asarray(a) for n, a in base.items()}, jnp.asarray(keep))
    for name, axis in rec.leaf_axes.items():
        got = cache[name].numpy()
        np.testing.assert_array_equal(got, np.asarray(jout[name]))
        for lane in range(3):
            want = advanced[name].numpy() if keep[lane] else base[name]
            np.testing.assert_array_equal(np.take(got, lane, axis=axis),
                                          np.take(want, lane, axis=axis))


def test_spec_engine_with_xlstm_target_matches_reference(both, mesh, rules):
    """A speculating engine with an xLSTM target and draft (the target's
    weights moved 0.02 toward a fresh init, the reference fuzzer's mix for
    recurrent state) and a host preemption mid-speculation: streams equal
    the plain engine's and the reference spec engine's, and so do the
    counters; the draft's dead lanes are zero after every round."""
    m = both
    noise = jreg.get_module(m["jcfg"]).init(m["jcfg"], jax.random.PRNGKey(1))
    jd = jax.tree.map(lambda a, b: 0.98 * a + 0.02 * b, m["jp"], noise)
    td = params_from_numpy(m["tcfg"], jax.tree.map(np.asarray, jd), device="cpu")
    rng = np.random.default_rng(7)
    stream = [(t, rng.integers(0, 256, int(n)).astype(np.int32), int(b))
              for t, n, b in zip([0, 0, 1, 3, 4], rng.integers(2, 20, 5), rng.integers(2, 9, 5))]

    def preempt_once():
        """Preempt the first decoding lane at the first tick from 2 on
        that has one (the same schedule on either engine)."""
        done = []

        def hook(eng, tick):
            busy = [i for i, s in enumerate(eng.slots) if s is not None and s.generated]
            if tick >= 2 and busy and not done:
                eng.preempt(busy[0])
                done.append(tick)

        return hook

    fields = dict(max_slots=3, max_len=48)
    plain = drive(port_engine(m, **fields), stream)
    eng = port_engine(m, spec_draft=m["tcfg"], spec_k=3, kw=dict(draft_params=td), **fields)
    got = drive(eng, stream, preempt_once())
    jeng = ref_engine(m, mesh, rules, spec_draft=m["jcfg"], spec_k=3,
                      kw=dict(draft_params=jd), **fields)
    assert got == plain == drive(jeng, stream, preempt_once())
    keys = COUNTERS + ("spec_steps", "spec_drafted", "spec_accepted", "spec_rejected",
                       "spec_committed")
    assert {k: eng.counters[k] for k in keys} == {k: jeng.counters[k] for k in keys}
    assert eng.counters["spec_accepted"] > 0 and eng.counters["preemptions"] == 1
    assert eng._draft_rec.lanes_are_zero(eng.state["draft"], range(3))


def test_launcher_serves_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main

    router = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "6"])
    assert len(router.completions) == 6
    assert all(c.status == "ok" and len(c.tokens) == c.max_new_tokens
               for c in router.completions.values())
    out = capsys.readouterr().out
    assert "-- status: ok 6 timeout 0 cancelled 0 failed 0" in out
    assert "state[recurrent/slotted]" in out
