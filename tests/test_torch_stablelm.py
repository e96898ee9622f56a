"""The port's stablelm-12b (a plain llama-shaped dense stack) against the
JAX reference, and head dim 160 outside the kernels.

Both packages run the same converted smoke parameters on the same numpy
inputs.  In fp32 the norm scales are drawn nonzero so that every norm
counts; in bf16 they are the reference's init (zeros), as
``tests/test_torch_lm.py`` runs it:

* the config and parameter trees, full width and smoke;
* ``forward`` and every prefill and decode entry (slotted, paged, a
  chunked-prefill continuation) under both attention impls (the kernel
  wrappers run their plain versions on CPU tensors): logits and every
  cache leaf;
* the serve engine's greedy streams and counters against the reference
  engine's on the slotted and paged layouts;
* head dim 160 on the plain path: a tiny config of 2 heads over d_model
  320 through every entry, so that no code outside the kernels assumes
  D <= 128;
* the launcher, and ``chip_smoke.py``'s phase 8 rehearsed at smoke width.

Tolerances are ``tests/test_torch_lm.py``'s: fp32 1e-4 absolute (the same
fp32 arithmetic in another reduction order); bf16 5e-2 absolute plus 2e-2
relative (XLA keeps fused elementwise chains in fp32 where eager PyTorch
rounds each op's output to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import ArchConfig as JArchConfig
from repro.core.aot import AotCache as JAotCache
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config, get_smoke_config
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "stablelm-12b"
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=5e-2, rtol=2e-2)}
MAX_SLOTS, MAX_LEN, BS = 3, 48, 8
ENGINE_COUNTERS = ("prefills", "prefill_chunks", "prefill_tokens", "prefix_lookup_tokens",
                   "prefix_hit_tokens", "cow_copies", "decode_steps")
# head dim 160 at smoke size: 2 heads over d_model 320, one KV head
D160 = dict(name="d160-smoke", family="dense", n_layers=2, d_model=320, n_heads=2, n_kv=1,
            d_ff=192, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke-width ops are too small to split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, dt):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), **TOL[dt])


def _models(jcfg, tcfg, dt):
    """(jax cfg, jax params, port cfg, port compute params), nonzero norm
    scales in fp32."""
    jcfg = dataclasses.replace(jcfg, compute_dtype=dt)
    tcfg = dataclasses.replace(tcfg, compute_dtype=dt)
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    if dt == "float32":
        rng = np.random.default_rng(7)
        for name in ("ln1", "ln2"):
            tree["blocks"][name] = (rng.normal(size=tree["blocks"][name].shape)
                                    * 0.3).astype(np.float32)
        tree["ln_f"] = (rng.normal(size=tree["ln_f"].shape) * 0.3).astype(np.float32)
    tp = params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tlm.cast_for_compute(tcfg, tp)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return (request.param,) + _models(jax_smoke(ARCH), get_smoke_config(ARCH), request.param)


@pytest.fixture(scope="module")
def fp32():
    return _models(jax_smoke(ARCH), get_smoke_config(ARCH), "float32")


@pytest.fixture(scope="module")
def d160():
    return _models(JArchConfig(**D160), ArchConfig(**D160), "float32")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _impl(cfg, impl):
    return dataclasses.replace(cfg, attn_impl=impl)


# ---------------------------------------------------------------------------
# Config and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_specs_match_reference(smoke):
    jcfg = (jax_smoke if smoke else jax_config)(ARCH)
    tcfg = (get_smoke_config if smoke else get_config)(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jspecs = jax.tree.map(lambda s: (s.shape, str(s.dtype), s.init_scale),
                          jlm.param_specs(jcfg),
                          is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    tspecs = tcommon.map_tree(lambda s: (s.shape, str(s.dtype).split(".")[-1], s.init_scale),
                              tlm.param_specs(tcfg))
    assert jspecs == tspecs
    assert ARCH in ARCH_IDS and treg.supports_paged_serving(tcfg)
    if not smoke:
        assert tcfg.head_dim == 160 and tcfg.n_heads // tcfg.n_kv == 4
        assert "unembed" in tspecs and not tcfg.tie_embeddings


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _entries(jcfg, jp, tcfg, tp, mesh, rules, dt, impl, seed=0):
    """``forward``, a slotted prefill into lane 1 and three decode steps,
    a paged first chunk [0, 24) and continuation [24, 40) (plen 37), and a
    paged decode step of 4 ragged lanes (one stale), both packages."""
    cfg = _impl(tcfg, impl)
    toks = _tokens(jcfg, (2, 40), 1 + seed)
    jh, _, (jk, jv) = jlm.forward(jcfg, mesh, rules, jp, jnp.asarray(toks), remat=False,
                                  collect_kv=True)
    th, (tk, tv) = tlm.forward(cfg, tp, torch.tensor(toks), remat=False, collect_kv=True)
    for a, b in ((jh, th), (jk, tk), (jv, tv)):
        _close(a, b, dt)

    toks = _tokens(jcfg, (1, 32), 4 + seed)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in jlm.make_cache_specs(jcfg, 2, 48).items()}
    jc, jl = jlm.prefill_slot(jcfg, mesh, rules, jp, jc, jnp.asarray(toks), 1, 30)
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_cache_specs(cfg, 2, 48).items()}
    tc, tl = tlm.prefill_slot(cfg, tp, tc, torch.tensor(toks), 1, 30)
    _close(jl, tl, dt)
    idx = np.array([5, 30], np.int32)
    for step in range(3):
        tkn = _tokens(jcfg, (2,), 10 + step)
        jl, jc = jlm.decode_step(jcfg, mesh, rules, jp, jc, jnp.asarray(tkn), jnp.asarray(idx))
        tl, tc = tlm.decode_step(cfg, tp, tc, torch.tensor(tkn), torch.tensor(idx))
        _close(jl, tl, dt)
        idx = idx + 1
    for name in ("k", "v"):
        _close(jc[name], tc[name], dt)

    prompt = _tokens(jcfg, (37,), 5 + seed)
    table = np.array([4, 2, 7, 1, 5, 0], np.int32)
    first, cont = np.zeros((1, 24), np.int32), np.zeros((1, 16), np.int32)
    first[0], cont[0, :13] = prompt[:24], prompt[24:]
    NB = 16
    jc = {k: jnp.zeros(s.shape, s.dtype)
          for k, s in jlm.make_paged_cache_specs(jcfg, NB, BS).items()}
    jc, jl0 = jlm.prefill_slot_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(first),
                                     jnp.asarray(table), 37)
    jc, jl1 = jlm.prefill_chunk_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(cont),
                                      jnp.asarray(table), jnp.int32(24), jnp.int32(37))
    tc = {k: torch.zeros_like(s, device="cpu")
          for k, s in tlm.make_paged_cache_specs(cfg, NB, BS).items()}
    tt = torch.tensor(table)
    tc, tl0 = tlm.prefill_slot_paged(cfg, tp, tc, torch.tensor(first), tt, 37)
    tc, tl1 = tlm.prefill_chunk_paged(cfg, tp, tc, torch.tensor(cont), tt, 24, 37)
    _close(jl0, tl0, dt)
    _close(jl1, tl1, dt)
    tables = np.array([[4, 2, 7, 1, 5, 0], [8, 9, 0, 0, 0, 0], [10, 11, 12, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    lengths = np.array([37, 9, 20, 3], np.int32)
    tkn = _tokens(jcfg, (4,), 7 + seed)
    jl, jc = jlm.decode_step_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(tkn),
                                   jnp.asarray(lengths), jnp.asarray(tables), impl="ref")
    tl, tc = tlm.decode_step_paged(cfg, tp, tc, torch.tensor(tkn), torch.tensor(lengths),
                                   torch.tensor(tables),
                                   impl="kernel" if impl == "kernel" else "ref")
    _close(jl[:3], tl[:3], dt)                         # lane 3 is stale
    for name in ("k", "v"):
        _close(jc[name][:, 1:], tc[name][:, 1:], dt)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_entries_parity(pair, mesh, rules, impl):
    dt, jcfg, jp, tcfg, tp = pair
    _entries(jcfg, jp, tcfg, tp, mesh, rules, dt, impl)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_head_dim_160_entries_parity(d160, mesh, rules, impl):
    """Head dim 160 (stablelm-12b's) on the plain path: RoPE over 80
    frequency pairs, caches and pools of 160 columns, rep 2."""
    jcfg, jp, tcfg, tp = d160
    assert tcfg.head_dim == 160
    _entries(jcfg, jp, tcfg, tp, mesh, rules, "float32", impl, seed=3)


# ---------------------------------------------------------------------------
# The serve engine
# ---------------------------------------------------------------------------


def _stream(vocab, seed=5):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 2 * BS).astype(np.int32)
    out, tick = [], 0
    for i in range(7):
        tick += int(rng.integers(0, 3))
        if i % 3 == 0:
            tail = rng.integers(0, vocab, int(rng.integers(1, 12))).astype(np.int32)
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(3, 30))).astype(np.int32)
        out.append((tick, prompt, int(rng.integers(3, 12))))
    return out


def _drive(eng, stream):
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < 500, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_engine_matches_reference(fp32, mesh, rules, layout):
    """Greedy streams and counters equal the reference engine's; the paged
    layout with chunked prefill and the prefix cache."""
    jcfg, jp, tcfg, tp = fp32
    fields = {} if layout == "slotted" else dict(kv_layout="paged", page_size=BS,
                                                 prefill_chunk=BS, prefix_cache=True)
    stream = _stream(tcfg.vocab)
    ec = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN, **fields)
    ref = JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(**ec), aot=JAotCache("stablelm"))
    want = _drive(ref, stream)
    eng = ServeEngine(_impl(tcfg, "kernel"), tp, EngineConfig(**ec, paged_attn="kernel"),
                      device="cpu")
    assert _drive(eng, stream) == want
    assert {k: eng.counters[k] for k in ENGINE_COUNTERS} == \
        {k: ref.counters[k] for k in ENGINE_COUNTERS}
    assert all(c.status == "ok" for c in eng.completions.values())


def test_launcher_serves_stablelm_smoke(capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "4",
                 "--kv-layout", "paged"])
    assert "status: ok 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 8, rehearsed at smoke width
# ---------------------------------------------------------------------------


def card_stand_ins(monkeypatch, configs_for):
    """``chip_smoke`` on the CPU for its full-width serving phases:
    ``get_config`` gives ``configs_for(arch)``, the four kernel wrappers of
    the dense paths count their calls (their plain versions run), the
    engines register their eager decode programs as graphs, the card's
    synchronize and memory calls are no-ops and nothing is profiled.
    Returns the module, its phase-7 traffic cut to prompts of 100-120
    tokens."""
    from test_torch_router_rehearsal import _chip_smoke, _counting, _EagerGraph

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops

    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs_for)
    monkeypatch.setattr(cs, "GEMMA_LONG", (100, 121))
    for mod, name in ((fops, "flash_attention"), (pops, "paged_attention"), (rops, "rmsnorm"),
                      (rops, "rmsnorm_add")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "profile_decode", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: (None, {}))

    def decode_entry(self, *, stochastic, masked):
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        return self.graphs.get(key, lambda: _EagerGraph(fn, (self.params, self.state)))

    monkeypatch.setattr(ServeEngine, "_decode_entry", decode_entry)
    return cs


def test_chip_smoke_stablelm_phase(monkeypatch):
    """``chip_smoke.py``'s phase 8 whole at smoke width in bf16, at head
    dim 160 (the 2-head tiny config), with the card's engine settings: 8
    lanes, 16-position pages, phase 7's traffic (18 requests, the two long
    prompts of 100-120 tokens here) in lanes of 1,024.  Every gate runs:
    full budgets, the graph check, builds after ``prebuild``, the launch
    formulas at 2 layers, the logits in both dtypes and a second run's
    streams."""
    tiny = ArchConfig(**D160)
    cs = card_stand_ins(monkeypatch, lambda arch: tiny if arch == ARCH else get_config(arch))
    for name, value in (("STABLELM_LAYERS", tiny.n_layers), ("STABLELM_MAX_LEN", 1024),
                        ("STABLELM_BLOCKS", 8 * 64 + 1), ("STABLELM_FP32_LAYERS", 2)):
        monkeypatch.setattr(cs, name, value)
    results = {"nvidia_smi": "a CPU rehearsal"}
    launches = cs.stablelm_path(torch, torch.device("cpu"), results)
    e2e = results["stablelm"]
    assert e2e["requests"] == 18 and e2e["prefills"] == 18
    assert launches == cs.stablelm_launches(e2e["prefills"], e2e["decode_steps"])
    assert launches["rmsnorm"] == (tiny.n_layers + 1) * (18 + e2e["decode_steps"])
    assert results["stablelm_graph_check"]["replays"] == 8
    assert e2e["programs"]["builds"] == 3 + len(e2e["programs"]["buckets"])
    assert e2e["second_run_streams_equal"]
    assert set(results["stablelm_logits"]) == {"bfloat16", "float32"}
