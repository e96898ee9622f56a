"""``repro_torch.core.aot``: the program cache, and CUDA graphs of the
serve engine's decode step.

On the CPU:

* ``AotCache``'s invariants (``builds == len``, ``builds + cache_hits``
  == gets, a present key never rebuilds), as the reference's docstring
  states them;
* the engine's build counts, the reference's contract
  (``tests/test_serve_engine.py::test_prefill_bucket_reuse``): one decode
  program plus one prefill per prompt bucket, flat in steady state, for
  both layouts and the hybrid family; a shared cache builds nothing new
  for a second engine (on the CPU the entries are eager programs);
* the engine never rebinds a state tensor (the captured graph's buffers);
* RoPE's tables, hoisted out of the layer loop: dense and zamba prefill
  and decode logits are bitwise the parent's formula (``rope`` recomputing
  its tables in every call), patched back in.

Marked ``cuda`` (they skip without a card; run them on the card with
``python -m pytest -m cuda --noconftest tests/test_torch_aot.py``), at
smoke width with head dim 64 so the paged kernel takes it:

* a graph replay equals the eager program bitwise over 8 steps (tokens and
  every state leaf), dense slotted and paged (kernels), zamba slotted,
  greedy and sampled (temperature, top-k and top-p: the stochastic,
  masked graph with its registered generator);
* engines sharing an ``AotCache`` each capture their own graph, which
  stays with the engine: the shared cache holds no graph;
* the ``data_ptr`` guard raises when a state leaf is rebound;
* two stochastic replays draw different uniforms;
* the kernel wrappers' launch counters advance on every replay.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache, CudaGraphProgram, device_program
from repro_torch.models import lm, registry, zamba
from repro_torch.serve import EngineConfig, ServeEngine, prompt_buckets

ARCHS = {"dense": "smollm-360m", "zamba": "zamba2-1.2b"}


# ---------------------------------------------------------------------------
# AotCache
# ---------------------------------------------------------------------------


def test_aot_cache_invariants():
    cache = AotCache("t")
    built = []

    def build(k):
        built.append(k)
        return ("entry", k)

    keys = [1, 2, 1, 3, 2, 1, 1]
    got = [cache.get(k, lambda k=k: build(k)) for k in keys]
    assert got == [("entry", k) for k in keys]
    assert built == [1, 2, 3]                               # never rebuilt
    assert cache.stats == {"builds": 3, "cache_hits": 4}
    assert cache.stats["builds"] == len(cache)
    assert cache.stats["builds"] + cache.stats["cache_hits"] == len(keys)
    assert 2 in cache and 4 not in cache and list(cache.keys()) == [1, 2, 3]
    assert set(cache.build_seconds) == {1, 2, 3} and cache.build_s_total >= 0
    assert [k for k, _ in cache.top_builds(2)] and len(cache.top_builds(2)) == 2


def test_device_program_is_the_eager_program_on_cpu():
    fn = lambda x: x + 1
    assert device_program(fn, (torch.zeros(2),)) is fn


# ---------------------------------------------------------------------------
# The engine's programs on the CPU
# ---------------------------------------------------------------------------


def _init(arch, **over):
    cfg = dataclasses.replace(get_smoke_config(ARCHS[arch]), **over)
    return cfg, registry.get_module(cfg).init(cfg, seed=0, device="cpu")


def _prompts(cfg, rng, lens):
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch,layout", [("dense", "slotted"), ("dense", "paged"),
                                         ("zamba", "slotted")])
def test_prefill_bucket_reuse(arch, layout):
    """Build count = one decode + one prefill per distinct *bucket*; more
    requests in the same buckets must not build anything new."""
    cfg, params = _init(arch)
    rng = np.random.default_rng(4)
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_len=64, kv_layout=layout),
                      device="cpu")
    assert eng.buckets == prompt_buckets(64) == (16, 32, 64)
    eng.run(_prompts(cfg, rng, [3, 9, 14]), max_new_tokens=2)   # bucket 16
    assert eng.stats["builds"] == 2                 # decode + prefill@16
    eng.run(_prompts(cfg, rng, [20, 17]), max_new_tokens=2)     # bucket 32
    assert eng.stats["builds"] == 3
    hits_before = eng.stats["cache_hits"]
    eng.run(_prompts(cfg, rng, [5, 21, 8, 30]), max_new_tokens=3)
    assert eng.stats["builds"] == 3                 # steady state: no builds
    assert eng.stats["cache_hits"] > hits_before
    assert eng.stats["executables"] == 3


def test_sampling_flags_key_the_decode_program_and_cache_is_shared():
    cfg, params = _init("dense")
    rng = np.random.default_rng(5)
    aot = AotCache("shared")
    ec = EngineConfig(max_slots=2, max_len=64)
    eng = ServeEngine(cfg, params, ec, device="cpu", aot=aot)
    eng.run(_prompts(cfg, rng, [4, 6]), max_new_tokens=3)
    assert eng.stats["builds"] == 2
    eng.run(_prompts(cfg, rng, [4]), max_new_tokens=3, temperature=0.7)
    assert eng.stats["builds"] == 3                 # the stochastic decode program
    eng.run(_prompts(cfg, rng, [4]), max_new_tokens=3, temperature=0.7, top_k=5)
    assert eng.stats["builds"] == 4                 # ... and its masked form
    other = ServeEngine(cfg, params, ec, device="cpu", aot=aot)
    other.run(_prompts(cfg, rng, [5, 7]), max_new_tokens=3, temperature=0.7)
    assert other.stats["builds"] == 4 and other.stats["executables"] == 4


@pytest.mark.parametrize("arch,layout", [("dense", "paged"), ("zamba", "slotted")])
def test_engine_never_rebinds_a_state_tensor(arch, layout):
    cfg, params = _init(arch)
    rng = np.random.default_rng(6)
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_len=64, kv_layout=layout),
                      device="cpu")
    before = _addresses(eng.state)
    eng.run(_prompts(cfg, rng, [3, 20, 9, 14, 5]), max_new_tokens=4)
    eng.submit(_prompts(cfg, rng, [6])[0], max_new_tokens=30)
    eng.step()
    eng._fail_nonfinite(next(i for i, s in enumerate(eng.slots) if s is not None), "test")
    eng.drain()                                     # pushes tables and active
    assert _addresses(eng.state) == before


def _addresses(state):
    return {k: (_addresses(v) if isinstance(v, dict) else
                v.data_ptr() if torch.is_tensor(v) else id(v)) for k, v in state.items()}


# ---------------------------------------------------------------------------
# RoPE's tables, hoisted: bitwise the parent's per-call formula
# ---------------------------------------------------------------------------


def _parent_rope(x, positions, theta):
    """``models/attention.rope`` before the tables were hoisted: every call
    builds its own cos and sin."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _prefill_and_decode(cfg, params, mod):
    rng = np.random.default_rng(7)
    p = mod.cast_for_compute(cfg, params, "cpu")
    cache = {k: torch.zeros_like(s, device="cpu")
             for k, s in mod.make_cache_specs(cfg, 3, 32).items()}
    outs = []
    for slot, plen in enumerate((5, 11, 16)):
        tokens = torch.zeros(1, 16, dtype=torch.int32)
        tokens[0, :plen] = torch.from_numpy(rng.integers(0, cfg.vocab, plen).astype(np.int32))
        outs.append(mod.prefill_slot(cfg, p, cache, tokens, slot, plen)[1])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3).astype(np.int32))
    lengths = torch.tensor([5, 11, 16], dtype=torch.int32)
    for _ in range(2):
        logits, _ = mod.decode_step(cfg, p, cache, toks, lengths)
        outs.append(logits)
        toks, lengths = logits.argmax(-1).to(torch.int32), lengths + 1
    return outs, cache


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dense", "zamba"])
def test_hoisted_rope_is_bitwise_the_parent_formula(monkeypatch, arch, dt, impl):
    cfg, params = _init(arch, compute_dtype=dt, attn_impl=impl)
    mod = lm if arch == "dense" else zamba
    outs, cache = _prefill_and_decode(cfg, params, mod)
    monkeypatch.setattr(mod, "rope_tables", lambda positions, head_dim, theta: (positions, theta))
    monkeypatch.setattr(mod, "apply_rope", _parent_rope)
    outs_parent, cache_parent = _prefill_and_decode(cfg, params, mod)
    for a, b in zip(outs, outs_parent):
        assert torch.equal(a, b)
    for k in cache:
        assert torch.equal(cache[k], cache_parent[k]), k


# ---------------------------------------------------------------------------
# CUDA graphs of the decode step (on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(arch, layout, dev, *, impl="kernel", slots=4):
    """A smoke-width engine on the card, head dim 64 (the kernels' width)."""
    over = dict(d_head=64, attn_impl=impl)
    if arch == "dense":
        over["compute_dtype"] = "bfloat16"
    cfg = dataclasses.replace(get_smoke_config(ARCHS[arch]), **over)
    params = registry.get_module(cfg).init(cfg, seed=0, device=dev)
    ec = EngineConfig(max_slots=slots, max_len=64, kv_layout=layout,
                      paged_attn="kernel" if layout == "paged" else "ref")
    return cfg, ServeEngine(cfg, params, ec, device=dev)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Generator):
        g = torch.Generator(device=tree.device)
        g.set_state(tree.get_state())
        return g
    return tree.clone()


def _busy(cfg, eng, budget=40, **sampling):
    rng = np.random.default_rng(8)
    for p in _prompts(cfg, rng, [5, 12, 20, 9][: eng.econ.max_slots]):
        eng.submit(p, max_new_tokens=budget, **sampling)
    while eng.counters["decode_steps"] < 1:         # admit all, then build the graph
        eng.step()


CARD_CASES = [("dense", "slotted", "kernel"), ("dense", "paged", "kernel"),
              ("zamba", "slotted", "chunked")]
# (submit's sampling arguments, the decode program's flags they select)
SAMPLINGS = {"greedy": ({}, dict(stochastic=False, masked=False)),
             "sampled": (dict(temperature=0.8, top_k=20, top_p=0.9),
                         dict(stochastic=True, masked=True))}


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("arch,layout,impl", CARD_CASES)
def test_graph_replay_equals_eager_bitwise(cuda, arch, layout, impl, sampling):
    """Each of 8 engine steps (blocks mapped and mirrors pushed by the
    engine) runs the eager program on a deep clone of the state (the
    sampling generator's state copied) and replays the graph on the state
    itself."""
    submit, flags = SAMPLINGS[sampling]
    cfg, eng = _card_engine(arch, layout, cuda, impl=impl)
    _busy(cfg, eng, **submit)
    graph = eng._decode_entry(**flags)
    assert isinstance(graph, CudaGraphProgram)
    eager = eng.decode_program(**flags)
    checked = []

    def check(params, state):
        clone = _clone(state)
        want = eager(params, clone).clone()
        got = graph(params, state)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for k, v in clone["cache"].items():
            assert torch.equal(state["cache"][k], v), k
        for k, v in clone.items():
            if torch.is_tensor(v):
                assert torch.equal(state[k], v), k
        checked.append(1)
        return got

    eng._decode_entry = lambda **flags: check
    for _ in range(8):
        eng.step()
    assert len(checked) == graph.replays == 8


@pytest.mark.cuda
def test_shared_cache_holds_no_graph(cuda):
    cfg, eng = _card_engine("dense", "slotted", cuda)
    other = ServeEngine(cfg, eng.params, eng.econ, device=cuda, aot=eng.aot)
    _busy(cfg, eng)
    builds = eng.stats["builds"]
    _busy(cfg, other)
    assert other.stats["builds"] == builds == len(eng.aot)     # nothing rebuilt
    assert eng.stats["graphs"] == other.stats["graphs"] == 1   # each its own capture
    graph = other._decode_entry(stochastic=False, masked=False)
    assert isinstance(graph, CudaGraphProgram)
    assert graph is not eng._decode_entry(stochastic=False, masked=False)
    entries = [eng.aot.get(k, None) for k in list(eng.aot.keys())]
    assert not any(isinstance(e, CudaGraphProgram) for e in entries)


@pytest.mark.cuda
def test_graph_guard_raises_on_a_rebound_leaf(cuda):
    cfg, eng = _card_engine("dense", "slotted", cuda)
    _busy(cfg, eng)
    eng.state["lengths"] = eng.state["lengths"].clone()
    with pytest.raises(RuntimeError, match="moved since capture"):
        eng.step()


@pytest.mark.cuda
def test_stochastic_replays_draw_new_uniforms(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"u": torch.zeros(4096, device=cuda), "gen": gen}

    def draw(state):
        state["u"].copy_(torch.rand(state["u"].shape, generator=state["gen"], device=cuda))
        return state["u"]

    prog = device_program(draw, (state,), generators=(gen,))
    draws = [prog(state).clone() for _ in range(3)]          # eager, replay, replay
    torch.cuda.synchronize()
    assert not torch.equal(draws[1], draws[2]) and not torch.equal(draws[0], draws[1])
    assert all(0 <= float(d.min()) and float(d.max()) < 1 for d in draws)


@pytest.mark.cuda
def test_launch_counters_advance_per_replay(cuda):
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add

    cfg, eng = _card_engine("dense", "paged", cuda)
    _busy(cfg, eng)
    L = cfg.n_layers
    for _ in range(3):
        before = (paged_attention.launches, rmsnorm.launches, rmsnorm_add.launches)
        eng.step()
        after = (paged_attention.launches, rmsnorm.launches, rmsnorm_add.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (L, L + 1, L)
