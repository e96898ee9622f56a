"""The port's paged-engine scheduling features against the JAX reference.

Chunked prefill, the prefix cache with copy-on-write, preempt admission
and replay, and the engine-level helpers under them (``prefix_keys``,
``copy_paged_block``, ``prefill_chunk_paged``), run at smoke width in fp32
on the CPU:

* the model pieces agree with the reference's on the same parameters
  (logits and pool leaves within 1e-4, the block copy bitwise, the chain
  keys byte for byte);
* every feature engine's greedy streams equal the reference engine's on
  the same staggered traffic, and so do the counters the features move
  (chunks, prefix hits, copies, preemptions, resumes, replays);
* inside the port, each feature's streams equal the plain slotted
  engine's (the reference's own parity properties, ``tests/test_paged.py``
  and ``tests/test_serve_engine.py``), builds stay flat, and zamba's
  host-initiated preemption resumes its stream exactly;
* ``generate``/``generate_static`` match the reference's greedy output.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import generate as jgenerate
from repro.serve import generate_static as jgenerate_static
from repro.serve.paged import prefix_keys as jprefix_keys
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    EngineConfig,
    ServeConfig,
    ServeEngine,
    generate,
    generate_static,
    prefix_keys,
)

MAX_SLOTS, MAX_LEN, BS = 3, 48, 8

# the reference fuzzer's engine modes (tests/test_engine_fuzz.py) that this
# slice ports; "slotted" is the parity reference
MODES = {
    "slotted": dict(),
    "paged": dict(kv_layout="paged", page_size=BS),
    "paged_chunked": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS),
    "prefix": dict(kv_layout="paged", page_size=BS, prefix_cache=True),
    "prefix_chunked": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS,
                           prefix_cache=True),
    "preempt": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                    admission="preempt"),
    "prefix_preempt": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                           prefix_cache=True, admission="preempt"),
    "preempt_chunked": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                            prefill_chunk=BS, prefix_cache=True, admission="preempt"),
}
FEATURE_COUNTERS = ("prefills", "prefill_chunks", "prefill_tokens",
                    "prefix_lookup_tokens", "prefix_hit_tokens", "cow_copies",
                    "preemptions", "resumed", "replayed_tokens", "decode_steps")


@pytest.fixture(scope="module")
def models():
    """fp32-compute smoke configs and parameters for both packages."""
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(vocab, rng, lens):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def make_stream(rng, vocab):
    """(arrival tick, prompt, budget) triples, the reference fuzzer's
    recipe: block-aligned shared prefixes (some whole: the COW tail),
    shared prefixes with their own tails, disjoint prompts, bursts."""
    prefixes = [rng.integers(0, vocab, int(rng.integers(1, 3)) * BS).astype(np.int32)
                for _ in range(int(rng.integers(1, 3)))]
    out, tick = [], 0
    for _ in range(int(rng.integers(3, 9))):
        tick += int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.25:
            prompt = prefixes[int(rng.integers(len(prefixes)))].copy()
        elif r < 0.7:
            pre = prefixes[int(rng.integers(len(prefixes)))]
            tail = rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32)
            prompt = np.concatenate([pre, tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(1, 25))).astype(np.int32)
        budget = int(rng.integers(1, 9))
        out.append((tick, prompt[: MAX_LEN - budget - BS], budget))
    return out


def drive(eng, stream, *, check=True):
    """Replay a stream through one engine (either package's); invariants
    swept after every step."""
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        eng.step()
        if check:
            eng.check_invariants()
        tick += 1
        assert tick < 2000, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


VOCAB = 256                      # the smoke configs' vocabulary
STREAMS = [make_stream(np.random.default_rng(seed), VOCAB) for seed in (11, 12, 13)]


@pytest.fixture(scope="module")
def jax_runs(models, mesh, rules):
    """The reference engine's streams and counters, one run per (mode,
    stream), on one shared program cache."""
    jcfg, jp, _, _ = models
    aot, runs = JAotCache("features"), {}

    def get(mode, k):
        if (mode, k) not in runs:
            eng = JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, **MODES[mode]), aot=aot)
            runs[mode, k] = drive(eng, STREAMS[k]), {c: eng.counters[c]
                                                      for c in FEATURE_COUNTERS}
        return runs[mode, k]

    return get


def _engine(models, mode="slotted", **kw):
    _, _, tcfg, tp = models
    fields = {**MODES[mode], **kw}
    return ServeEngine(tcfg, tp, EngineConfig(max_slots=fields.pop("max_slots", MAX_SLOTS),
                                              max_len=fields.pop("max_len", MAX_LEN),
                                              **fields), device="cpu")


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


def test_prefix_keys_match_reference():
    rng = np.random.default_rng(0)
    for n, bs in ((0, 8), (7, 8), (8, 8), (45, 8), (320, 16), (513, 16)):
        t = rng.integers(0, 49152, n).astype(np.int32)
        assert prefix_keys(t, bs) == jprefix_keys(t, bs)
        assert prefix_keys(list(t), bs) == jprefix_keys(t, bs)
    a = rng.integers(0, 100, 24).astype(np.int32)
    b = a.copy()
    b[20] += 1
    ka, kb = prefix_keys(a, 8), prefix_keys(b, 8)
    assert ka[:2] == kb[:2] and ka[2] != kb[2]


def _paged_case(models, plen, chunk, start):
    """The same lane through both packages: the first chunk at 0, then a
    continuation of ``chunk`` tokens at ``start``; returns logits and
    pools of each."""
    jcfg, jp, tcfg, tp = models
    import jax.numpy as jnp

    nb, NB = MAX_LEN // BS, 12
    rng = np.random.default_rng(plen + start)
    prompt = rng.integers(0, jcfg.vocab, plen).astype(np.int32)
    table = np.zeros(nb, np.int32)
    used = -(-plen // BS)
    table[:used] = rng.permutation(np.arange(1, NB))[:used]
    first = np.zeros((1, start), np.int32)
    first[0] = prompt[:start]
    cont = np.zeros((1, chunk), np.int32)
    end = min(start + chunk, plen)
    cont[0, : end - start] = prompt[start:end]
    from repro.launch.mesh import single_device_mesh
    from repro.models.common import ShardRules
    mesh = single_device_mesh()
    rules = ShardRules.for_mesh(mesh)
    spec = jlm.make_paged_cache_specs(jcfg, NB, BS)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    jc, _ = jlm.prefill_slot_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(first),
                                   jnp.asarray(table), plen)
    jc, jlog = jlm.prefill_chunk_paged(jcfg, mesh, rules, jp, jc, jnp.asarray(cont),
                                       jnp.asarray(table), jnp.int32(start),
                                       jnp.int32(plen))
    out = {}
    for impl in ("chunked", "kernel"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        p = tlm.cast_for_compute(cfg, tp, "cpu")
        tc = {k: torch.zeros_like(s, device="cpu")
              for k, s in tlm.make_paged_cache_specs(cfg, NB, BS).items()}
        tt = torch.tensor(table)
        tlm.prefill_slot_paged(cfg, p, tc, torch.tensor(first), tt, plen)
        _, tlog = tlm.prefill_chunk_paged(cfg, p, tc, torch.tensor(cont), tt, start, plen)
        out[impl] = tlog, tc
    return (np.asarray(jlog), {k: np.asarray(v) for k, v in jc.items()}), out


@pytest.mark.parametrize("plen,chunk,start", [(30, 8, 16), (30, 16, 24), (21, 8, 20),
                                              (40, 16, 8)])
def test_prefill_chunk_paged_matches_reference(models, plen, chunk, start):
    """A continuation chunk (the last one, or one in the middle) against
    the reference's on the same lane: logits and every pool leaf within
    1e-4, on the plain path and the kernel settings (plain versions on
    the CPU)."""
    (jlog, jc), out = _paged_case(models, plen, chunk, start)
    for impl, (tlog, tc) in out.items():
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=1e-4, rtol=1e-4, err_msg=impl)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), jc[k], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{impl} {k}")


def test_chunks_equal_whole_prefill(models):
    """Inside the port: a prompt prefilled in chunks gives the whole
    bucket's logits (1e-5) and KV (1e-5) at every prompt position."""
    _, _, tcfg, tp = models
    p = tlm.cast_for_compute(tcfg, tp, "cpu")
    rng = np.random.default_rng(5)
    plen, C, NB = 29, 8, 9
    prompt = torch.tensor(rng.integers(0, tcfg.vocab, plen).astype(np.int32))
    table = torch.tensor(np.r_[np.arange(1, 5), np.zeros(2)].astype(np.int32))
    spec = tlm.make_paged_cache_specs(tcfg, NB, BS)
    whole = {k: torch.zeros_like(s, device="cpu") for k, s in spec.items()}
    padded = torch.zeros(1, 32, dtype=torch.int32)
    padded[0, :plen] = prompt
    _, want = tlm.prefill_slot_paged(tcfg, p, whole, padded, table, plen)
    chunked = {k: torch.zeros_like(s, device="cpu") for k, s in spec.items()}
    for start in range(0, plen, C):
        c = torch.zeros(1, C, dtype=torch.int32)
        n = min(C, plen - start)
        c[0, :n] = prompt[start:start + n]
        if start == 0:
            _, got = tlm.prefill_slot_paged(tcfg, p, chunked, c, table, plen)
        else:
            _, got = tlm.prefill_chunk_paged(tcfg, p, chunked, c, table, start, plen)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for k in ("k", "v"):
        torch.testing.assert_close(chunked[k][:, 1:5].reshape(tcfg.n_layers, -1)[:, :plen],
                                   whole[k][:, 1:5].reshape(tcfg.n_layers, -1)[:, :plen],
                                   atol=1e-5, rtol=1e-5)


def test_copy_paged_block_bitwise(models):
    _, _, tcfg, _ = models
    spec = tlm.make_paged_cache_specs(tcfg, 6, BS)
    g = torch.Generator().manual_seed(0)
    cache = {k: torch.randn(s.shape, generator=g) for k, s in spec.items()}
    before = {k: v.clone() for k, v in cache.items()}
    out = tlm.copy_paged_block(tcfg, cache, 4, 2)
    assert out is cache
    for k, v in cache.items():
        assert torch.equal(v[:, 2], before[k][:, 4])
        keep = [b for b in range(6) if b != 2]
        assert torch.equal(v[:, keep], before[k][:, keep])
    import jax.numpy as jnp
    jc = jlm.copy_paged_block(None, {k: jnp.asarray(v.numpy()) for k, v in before.items()},
                              4, 2)
    for k in cache:
        np.testing.assert_array_equal(np.asarray(jc[k]), cache[k].numpy())


# ---------------------------------------------------------------------------
# Engine parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(len(STREAMS)))
@pytest.mark.parametrize("mode", [m for m in MODES if m != "slotted"])
def test_feature_engine_matches_reference(models, jax_runs, mode, k):
    """Each feature engine on a staggered stream: the greedy streams and
    the feature counters equal the reference engine's, and the streams
    equal the reference's plain slotted engine's."""
    want, want_counters = jax_runs(mode, k)
    eng = _engine(models, mode)
    got = drive(eng, STREAMS[k])
    assert got == want
    assert got == jax_runs("slotted", k)[0]
    assert {c: eng.counters[c] for c in FEATURE_COUNTERS} == want_counters
    assert all(c.status == "ok" for c in eng.completions.values())
    if eng.paged:
        assert eng.alloc.in_use == 0


def test_features_fire_on_the_streams(jax_runs):
    """The parity cases above are not vacuous: over the streams, chunking,
    prefix hits, COW copies, preemptions and replays all happen."""
    total = {c: sum(jax_runs(m, k)[1][c] for m in MODES for k in range(len(STREAMS)))
             for c in FEATURE_COUNTERS}
    chunked = sum(jax_runs("paged_chunked", k)[1]["prefill_chunks"]
                  - jax_runs("paged_chunked", k)[1]["prefills"] for k in range(len(STREAMS)))
    assert chunked > 0
    for c in ("prefix_hit_tokens", "cow_copies", "preemptions", "resumed",
              "replayed_tokens"):
        assert total[c] > 0, c


# ---------------------------------------------------------------------------
# The reference's feature properties, inside the port
# (tests/test_paged.py and tests/test_serve_engine.py)
# ---------------------------------------------------------------------------


def _staggered(models, mode, **kw):
    rng = np.random.default_rng(3)
    prompts = _prompts(VOCAB, rng, [5, 11, 8, 14, 4])
    eng = _engine(models, mode, max_slots=2, max_len=32, **kw)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, [7, 3, 5, 2, 6])]
    eng.drain()
    return [list(eng.completions[r].tokens) for r in rids], eng


def test_chunked_prefill_matches_slotted(models):
    """Chunked prefill (4 tokens a step, interleaved with decode) keeps the
    slotted engine's greedy tokens, and really chunks."""
    want, _ = _staggered(models, "slotted")
    got, eng = _staggered(models, "paged", num_blocks=7, prefill_chunk=4)
    assert got == want
    assert eng.counters["prefill_chunks"] > eng.counters["prefills"]
    assert eng.alloc.in_use == 0


def test_prefix_cache_skips_shared_prefill(models):
    """Two requests sharing a 16-token system prompt on one lane: the
    second prefills only its suffix and emits the no-cache tokens."""
    rng = np.random.default_rng(10)
    sysp = rng.integers(0, VOCAB, 16).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.integers(0, VOCAB, n).astype(np.int32)])
               for n in (5, 7)]

    def run(prefix):
        eng = _engine(models, "paged", max_slots=1, max_len=32, prefix_cache=prefix)
        return [t.tolist() for t in eng.run(prompts, max_new_tokens=4)], eng

    want, plain = run(False)
    got, cached = run(True)
    assert got == want
    assert cached.counters["prefix_hit_tokens"] == 16
    assert cached.counters["prefill_tokens"] == plain.counters["prefill_tokens"] - 16
    assert cached.stats["prefix_hit_rate"] > 0.3
    assert cached.alloc.in_use == 0 and cached.alloc.num_cached > 0
    cached.check_invariants()


def test_prefix_cache_cow_tail(models):
    """A prompt that is exactly a published chain copies its tail block and
    recomputes the last position in the private copy."""
    prompt = np.random.default_rng(11).integers(0, VOCAB, 16).astype(np.int32)

    def run(prefix):
        eng = _engine(models, "paged", max_slots=1, max_len=32, prefix_cache=prefix)
        return [t.tolist() for t in eng.run([prompt, prompt.copy()], max_new_tokens=4)], eng

    want, _ = run(False)
    got, eng = run(True)
    assert got == want and got[0] == got[1]
    assert eng.counters["cow_copies"] == 1
    assert eng.counters["prefix_hit_tokens"] == 15
    eng.check_invariants()


def _preempt_run(models, ec_kw, temperature=0.0, seed=0):
    prompts = _prompts(VOCAB, np.random.default_rng(12), [9, 12, 7])
    eng = _engine(models, "slotted", max_len=32, seed=seed, **ec_kw)
    rids = [eng.submit(p, max_new_tokens=b, temperature=temperature)
            for p, b in zip(prompts, [8, 6, 7])]
    while eng.has_work():
        eng.step()
        eng.check_invariants()
    return [list(eng.completions[r].tokens) for r in rids], eng


PREEMPT = dict(kv_layout="paged", page_size=8, num_blocks=7, admission="preempt")


def test_preempt_requeue_completes_with_parity(models):
    """Lanes admitted on immediate need into 6 usable blocks: growth
    preempts the lowest-priority lane, and every request still ends with
    the slotted engine's tokens."""
    want, _ = _preempt_run(models, {})
    got, eng = _preempt_run(models, PREEMPT)
    assert got == want
    assert eng.counters["preemptions"] > 0
    assert eng.counters["resumed"] == eng.counters["preemptions"]
    assert eng.counters["admitted"] == eng.counters["evicted"] == 3
    assert eng.alloc.in_use == 0


def test_preempt_stochastic_resume_is_coherent(models):
    """A temperature > 0 lane preempted and replayed keeps its recorded
    stream (the recorded tokens are forced), its full budget, and the run
    is seed-deterministic."""
    a, eng = _preempt_run(models, PREEMPT, temperature=1.5, seed=11)
    assert eng.counters["preemptions"] > 0 and eng.counters["replayed_tokens"] > 0
    assert [len(t) for t in a] == [8, 6, 7]
    assert _preempt_run(models, PREEMPT, temperature=1.5, seed=11)[0] == a


def test_preempt_single_lane_never_livelocks(models):
    prompt = _prompts(VOCAB, np.random.default_rng(13), [9])[0]
    eng = _engine(models, "slotted", max_slots=2, max_len=16, kv_layout="paged",
                  page_size=4, num_blocks=5, admission="preempt")
    rid = eng.submit(prompt, max_new_tokens=8)      # needs all 4 usable blocks
    for _ in range(200):
        if not eng.step():
            break
        eng.check_invariants()
    assert len(eng.completions[rid].tokens) == 8


def test_paged_block_budget_gates_admission(models):
    """Deficit admission: the second request waits until the first frees
    its blocks; a request larger than the pool is refused at submit."""
    prompts = _prompts(VOCAB, np.random.default_rng(4), [8, 8])
    eng = _engine(models, "slotted", max_slots=2, max_len=16, kv_layout="paged",
                  page_size=4, num_blocks=5)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.step()
    assert sum(s is not None for s in eng.slots) == 1 and len(eng.queue) == 1
    eng.drain()
    assert all(len(eng.completions[r].tokens) == 6 for r in rids)
    assert eng.alloc.in_use == 0
    tiny = _engine(models, "slotted", max_slots=2, max_len=16, kv_layout="paged",
                   page_size=4, num_blocks=4)
    with pytest.raises(ValueError, match="KV blocks"):
        tiny.submit(np.arange(8), max_new_tokens=6)


def test_paged_engine_steady_builds_flat(models):
    """Chunked prefill builds one decode, one first-chunk and one
    continuation program, and nothing more in steady state."""
    rng = np.random.default_rng(5)
    eng = _engine(models, "paged", max_slots=2, max_len=32, prefill_chunk=4)
    eng.run(_prompts(VOCAB, rng, [3, 9, 14]), max_new_tokens=3)
    assert eng.stats["builds"] == 3
    eng.run(_prompts(VOCAB, rng, [5, 13, 7, 2]), max_new_tokens=4)
    assert eng.stats["builds"] == 3


def test_prebuild_covers_prefix_and_preempt_dispatch(models):
    """After ``prebuild()`` no schedule (hits, misses, COW, preemption
    resumes, sampled lanes) builds another program."""
    rng = np.random.default_rng(14)
    eng = _engine(models, "paged", max_slots=2, max_len=32, num_blocks=6,
                  prefix_cache=True, admission="preempt")
    eng.prebuild()
    builds = eng.stats["builds"]
    sysp = rng.integers(0, VOCAB, 16).astype(np.int32)
    prompts = [np.concatenate([sysp, t]) for t in _prompts(VOCAB, rng, [4, 6])]
    prompts += [sysp.copy()] + _prompts(VOCAB, rng, [11, 3])
    eng.run(prompts, max_new_tokens=9)
    eng.run(prompts[:2], max_new_tokens=3, temperature=0.7, top_k=5)
    assert eng.counters["prefix_hit_tokens"] > 0 and eng.counters["cow_copies"] > 0
    assert eng.counters["preemptions"] > 0
    assert eng.stats["builds"] == builds


def test_paged_engine_validation(models):
    for bad in (dict(kv_layout="bogus"), dict(prefill_chunk=8), dict(prefix_cache=True),
                dict(admission="preempt"), dict(kv_layout="paged", admission="bogus"),
                dict(kv_layout="paged", max_len=30, page_size=8)):
        with pytest.raises(ValueError):
            _engine(models, "slotted", **bad)
    eng = _engine(models, "slotted")
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(np.arange(4), deadline_s=0.0)
    with pytest.raises(ValueError, match="not serving"):
        eng.preempt(0)


# ---------------------------------------------------------------------------
# The hybrid family (zamba): host-initiated preemption
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid():
    from repro.models import zamba as jzamba

    jcfg = dataclasses.replace(jax_smoke("zamba2-1.2b"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32")
    jp = jzamba.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                             device="cpu")


@pytest.mark.parametrize("attn_impl", ["chunked", "kernel"])
def test_hybrid_preempt_resume_parity(hybrid, mesh, rules, attn_impl):
    """zamba lanes preempted mid-decode by the host resume by re-prefilling
    their prompt and replaying their tokens: the streams equal the
    unpreempted run's, which equal the reference engine's; recurrent
    zeroing holds after every step."""
    jcfg, jp, tcfg, tp = hybrid
    cfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    prompts = _prompts(VOCAB, np.random.default_rng(3), [6, 9, 12])
    budgets = [8, 5, 7]

    def run(preempt_at):
        eng = ServeEngine(cfg, tp, EngineConfig(max_slots=2, max_len=32), device="cpu")
        rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        steps = 0
        while eng.has_work():
            eng.step()
            eng.check_invariants()
            steps += 1
            for slot in preempt_at.get(steps, ()):
                if eng.slots[slot] is not None:
                    eng.preempt(slot)
                    eng.check_invariants()
        return [list(eng.completions[r].tokens) for r in rids], eng

    want, _ = run({})
    got, eng = run({3: (0,), 5: (0, 1)})
    assert got == want and [len(t) for t in got] == budgets
    assert eng.counters["preemptions"] == 3 == eng.counters["resumed"]
    assert eng.counters["replayed_tokens"] > 0
    ref = JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(max_slots=2, max_len=32))
    rids = [ref.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    ref.drain()
    assert want == [list(ref.completions[r].tokens) for r in rids]


def test_recurrent_rejects_paged_options(hybrid):
    _, _, tcfg, tp = hybrid
    with pytest.raises(ValueError, match="no seq axis"):
        ServeEngine(tcfg, tp, EngineConfig(max_slots=1, max_len=32, kv_layout="paged"),
                    device="cpu")
    for bad in (dict(prefill_chunk=8), dict(prefix_cache=True), dict(admission="preempt")):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(tcfg, tp, EngineConfig(max_slots=1, max_len=32, **bad),
                        device="cpu")


# ---------------------------------------------------------------------------
# generate / generate_static
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_generate_matches_reference(models, hybrid, mesh, rules, family):
    """Greedy: the port's ``generate`` (the engine) and ``generate_static``
    (the fixed-batch loop) equal each other and the reference's."""
    jcfg, jp, tcfg, tp = models if family == "dense" else hybrid
    prompts = np.stack(_prompts(VOCAB, np.random.default_rng(4), [8, 8, 8]))
    serve = ServeConfig(max_new_tokens=5)
    want = np.asarray(jgenerate_static(jcfg, mesh, rules, jp, prompts,
                                       serve=JServeConfig(max_new_tokens=5)))
    np.testing.assert_array_equal(
        np.asarray(jgenerate(jcfg, mesh, rules, jp, prompts,
                             serve=JServeConfig(max_new_tokens=5))), want)
    for fn in (generate, generate_static):
        got = fn(tcfg, tp, prompts, serve, device="cpu")
        assert got.shape == (3, 5) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_generate_static_sampled_is_seeded(models):
    _, _, tcfg, tp = models
    prompts = np.stack(_prompts(VOCAB, np.random.default_rng(6), [6, 6]))
    run = lambda seed: generate_static(tcfg, tp, prompts, ServeConfig(
        max_new_tokens=6, temperature=0.9, seed=seed), device="cpu")
    a = run(1)
    np.testing.assert_array_equal(a, run(1))
    assert ((a >= 0) & (a < VOCAB)).all()
