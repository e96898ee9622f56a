"""Speculative decoding in the port against the JAX reference.

At smoke width in fp32 on the CPU, with the reference's parameters
converted through ``params_from_numpy`` and the reference fuzzer's draft
mix (``tests/test_engine_fuzz.py``: the target's weights moved 0.15, or
0.02 for zamba, toward a fresh init) fed to both packages:

* the config validation raises what the reference's raises;
* ``RecurrentCache.snapshot``/``rollback`` are a bitwise per-lane select
  into buffers allocated once, after ``j <= k + 1`` in-place rewrites of
  the live leaves (the reference's results on the same arrays too), and
  compose with ``freeze``;
* KV truncate-on-reject conserves the block pool under a junk draft;
* on each of the reference fuzzer's spec modes (slotted, prefix, preempt,
  tiered) and on zamba with host preemptions, the greedy streams equal
  the port's sequential slotted engine's and the reference spec engine's
  bitwise, and so do the spec counters and stats;
* the reference's cross-feature rows (``tests/test_spec_decode.py``):
  cancel and deadline between rounds, preempt mid-speculation, a tier
  spill and restore by copy, chaos, ``prebuild`` keeping builds flat;
* snapshots, export and import of a spec engine, across both packages;
* the launcher's ``--spec-k``;
* ``chip_smoke.py``'s zamba spec phase (5d) rehearsed at smoke width
  (the dense spec phases 3j-3l are rehearsed in
  ``tests/test_torch_spec_rehearsal.py``, a file of their own so that the
  suite's workers share the two).

The card-only checks (a spec round's graph replay bitwise the eager
program, the ``data_ptr`` guard) are marked ``cuda`` and skip without one.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import ServeEngine as JServeEngine
from repro.serve.cache import RecurrentCache as JRecurrentCache
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache, CudaGraphProgram
from repro_torch.models import registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, FaultPlan, ServeEngine
from repro_torch.serve.cache import RecurrentCache
from test_torch_spec_rehearsal import rehearsal  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its smoke-width ops are too
    small to split, and beside the suite's other workers more threads only
    contend (the chip_smoke rehearsals ran many times slower with 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_SLOTS, MAX_LEN, BS, SPEC_K = 3, 48, 8, 3

# the reference fuzzer's spec modes (tests/test_engine_fuzz.py:spec_modes)
SPEC_MODES = {
    "spec_slotted": dict(),
    "spec_prefix": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS, prefix_cache=True),
    "spec_preempt": dict(kv_layout="paged", page_size=BS, num_blocks=6, admission="preempt"),
    "spec_tiered": dict(kv_layout="paged", page_size=BS, num_blocks=6, admission="preempt",
                        host_tier=True),
}
SPEC_COUNTERS = ("spec_steps", "spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_rejected", "spec_committed")
ENGINE_COUNTERS = SPEC_COUNTERS + (
    "prefills", "prefill_chunks", "decode_steps", "prefix_hit_tokens", "cow_copies",
    "preemptions", "resumed", "replayed_tokens", "spills", "restores", "admitted",
    "evicted")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _mix(jcfg, jp, alpha):
    """The reference fuzzer's draft: ``jp`` moved ``alpha`` toward a fresh
    init from key 1 (``test_engine_fuzz._draft_mix``)."""
    noise = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(1))
    return jax.tree.map(lambda a, b: (1 - alpha) * a + alpha * b, jp, noise)


def _both(arch, alpha):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    jd = _mix(jcfg, jp, alpha)
    conv = lambda t: params_from_numpy(tcfg, jax.tree.map(np.asarray, t), device="cpu")
    return dict(jcfg=jcfg, jp=jp, jd=jd, tcfg=tcfg, tp=conv(jp), td=conv(jd),
                jaot=JAotCache(f"spec-{arch}"), aot=AotCache(f"spec-{arch}"))


@pytest.fixture(scope="module")
def dense():
    return _both("smollm-360m", 0.15)


@pytest.fixture(scope="module")
def hybrid():
    return _both("zamba2-1.2b", 0.02)


def port(m, mode=None, *, spec=True, draft=None, **kw):
    """A port engine: ``mode``'s layout fields, speculating with the
    converted draft unless ``spec=False``."""
    fields = dict(SPEC_MODES[mode] if isinstance(mode, str) else (mode or {}))
    if spec:
        fields.update(spec_draft=m["tcfg"], spec_k=SPEC_K)
        kw.setdefault("draft_params", m["td"] if draft is None else draft)
    return ServeEngine(m["tcfg"], m["tp"], EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                        **fields),
                       device="cpu", aot=kw.pop("aot", m["aot"]),
                       clock=kw.pop("clock", FakeClock()), **kw)


def ref(m, mesh, rules, mode=None, *, spec=True, **kw):
    fields = dict(SPEC_MODES[mode] if isinstance(mode, str) else (mode or {}))
    if spec:
        fields.update(spec_draft=m["jcfg"], spec_k=SPEC_K)
        kw.setdefault("draft_params", m["jd"])
    return JServeEngine(m["jcfg"], mesh, rules, m["jp"],
                        JEngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, **fields),
                        aot=m["jaot"], clock=kw.pop("clock", FakeClock()), **kw)


def make_stream(rng, vocab):
    """(arrival tick, prompt, budget) triples, the reference fuzzer's
    recipe (``test_engine_fuzz.make_stream``)."""
    prefixes = [rng.integers(0, vocab, int(rng.integers(1, 3)) * BS).astype(np.int32)
                for _ in range(int(rng.integers(1, 3)))]
    out, tick = [], 0
    for _ in range(int(rng.integers(3, 9))):
        tick += int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.25:
            prompt = prefixes[int(rng.integers(len(prefixes)))].copy()
        elif r < 0.7:
            tail = rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32)
            prompt = np.concatenate([prefixes[int(rng.integers(len(prefixes)))], tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(1, 25))).astype(np.int32)
        budget = int(rng.integers(1, 9))
        out.append((tick, prompt[: MAX_LEN - budget - BS], budget))
    return out


def drive(eng, stream, hook=None):
    """Replay a stream through one engine (either package's); ``hook(eng,
    tick)`` runs after each step; invariants swept after every step."""
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        eng.step()
        eng.check_invariants()
        if hook is not None:
            hook(eng, tick)
        eng.clock.t += 1.0
        tick += 1
        assert tick < 2000, "engine failed to drain"
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


def sequential(m, stream):
    """The parity reference: the port's plain slotted engine."""
    return drive(port(m, spec=False), stream)


STREAMS = {seed: make_stream(np.random.default_rng(seed), 256) for seed in (42, 43)}


# ---------------------------------------------------------------------------
# Config validation
# ---------------------------------------------------------------------------


def _bad_configs(tcfg):
    return {
        "spec_k": dict(spec_draft=tcfg),
        "spec_draft": dict(spec_k=3),
        "fused_sampling": dict(spec_draft=tcfg, spec_k=3, fused_sampling=False),
        "vocab": dict(spec_draft=dataclasses.replace(tcfg, vocab=tcfg.vocab + 64), spec_k=3),
        "slot serving": dict(spec_draft=dataclasses.replace(tcfg, family="vlm"), spec_k=3),
        "draft_params": dict(),
    }


@pytest.mark.parametrize("case", ["spec_k", "spec_draft", "fused_sampling", "vocab",
                                  "slot serving", "draft_params"])
def test_spec_config_validation(dense, mesh, rules, case):
    """Each raise of the reference's ``test_spec_config_validation`` (and the
    draft family's slot-serving check): the port raises ``ValueError``
    where the reference does, on the same fields."""
    m = dense
    kw = dict(draft_params=m["td"]) if case == "draft_params" else {}
    with pytest.raises(ValueError, match=case):
        ServeEngine(m["tcfg"], m["tp"], EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                     **_bad_configs(m["tcfg"])[case]),
                    device="cpu", **kw)
    jfields = dict(_bad_configs(m["jcfg"])[case])
    jkw = dict(draft_params=m["jd"]) if case == "draft_params" else {}
    with pytest.raises(ValueError, match=case):
        JServeEngine(m["jcfg"], mesh, rules, m["jp"], JEngineConfig(
            max_slots=MAX_SLOTS, max_len=MAX_LEN, **jfields), aot=m["jaot"], **jkw)


# ---------------------------------------------------------------------------
# RecurrentCache snapshot/rollback: a bitwise per-lane select, in place
# ---------------------------------------------------------------------------


def _leaves(tcfg, rec, rng):
    """Random numpy arrays in each recurrent leaf's real shape and dtype."""
    specs = registry.get_module(tcfg).make_cache_specs(tcfg, MAX_SLOTS, 32)
    return {n: rng.standard_normal(tuple(specs[n].shape)).astype(
        str(specs[n].dtype).replace("torch.", "")) for n in rec.leaf_axes}


@settings(max_examples=15, deadline=None)
@given(j=st.integers(min_value=0, max_value=SPEC_K + 1),
       seed=st.integers(min_value=0, max_value=10_000))
def test_snapshot_rollback_bitwise(j, seed):
    """Snapshot into buffers allocated once, rewrite the live leaves in
    place ``j <= k + 1`` times (as the decode step does), roll back with a
    random keep mask: kept lanes are bitwise the advanced state, the others
    bitwise the snapshot, and the whole result bitwise the reference's
    ``rollback`` on the same arrays.  ``j == 0``: rollback is an identity."""
    tcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32")
    rec = RecurrentCache(tcfg)
    rng = np.random.default_rng(seed)
    base = _leaves(tcfg, rec, rng)
    cache = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    bufs = {n: torch.empty_like(c) for n, c in cache.items()}
    addr = {n: b.data_ptr() for n, b in bufs.items()}
    snap = rec.snapshot(cache, bufs)
    assert snap is bufs and all(b.data_ptr() == addr[n] for n, b in bufs.items())
    noise = [{n: torch.from_numpy(rng.standard_normal(a.shape).astype(a.dtype))
              for n, a in base.items()} for _ in range(j)]
    for step in noise:
        for n, c in cache.items():
            c.mul_(1.25).add_(step[n])
    advanced = {n: c.clone() for n, c in cache.items()}
    keep = rng.integers(0, 2, MAX_SLOTS).astype(bool)
    out = rec.rollback(cache, snap, torch.from_numpy(keep))
    assert out is cache
    jrec = JRecurrentCache(dataclasses.replace(jax_smoke("zamba2-1.2b"),
                                               compute_dtype="float32"))
    jout = jrec.rollback({n: jnp.asarray(a.numpy()) for n, a in advanced.items()},
                         {n: jnp.asarray(a) for n, a in base.items()}, jnp.asarray(keep))
    for name, axis in rec.leaf_axes.items():
        got = cache[name].numpy()
        np.testing.assert_array_equal(got, np.asarray(jout[name]))
        for lane in range(MAX_SLOTS):
            want = advanced[name].numpy() if keep[lane] else base[name]
            np.testing.assert_array_equal(np.take(got, lane, axis=axis),
                                          np.take(want, lane, axis=axis),
                                          err_msg=f"{name} lane {lane} j={j}")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_rollback_composes_with_freeze(seed):
    """The verify ladder's composition: frozen (inactive) lanes stay zero
    through a rollback that keeps them, and an active kept lane is
    untouched by both; a fresh snapshot never aliases the live leaves."""
    tcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32")
    rec = RecurrentCache(tcfg)
    rng = np.random.default_rng(seed)
    base = _leaves(tcfg, rec, rng)
    cache = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    active = rng.integers(0, 2, MAX_SLOTS).astype(bool)
    keep = rng.integers(0, 2, MAX_SLOTS).astype(bool)
    snap = rec.snapshot(cache)
    assert all(snap[n].data_ptr() != cache[n].data_ptr() for n in snap)
    rec.freeze(cache, torch.from_numpy(active))
    rec.rollback(cache, snap, torch.from_numpy(keep))
    assert rec.lanes_are_zero(cache, [i for i in range(MAX_SLOTS)
                                      if not active[i] and keep[i]])
    for name, axis in rec.leaf_axes.items():
        for lane in range(MAX_SLOTS):
            if active[lane] or not keep[lane]:
                np.testing.assert_array_equal(np.take(cache[name].numpy(), lane, axis=axis),
                                              np.take(base[name], lane, axis=axis))


# ---------------------------------------------------------------------------
# KV truncate-on-reject, streams and counters against both references
# ---------------------------------------------------------------------------


def test_kv_truncate_on_reject_conserves_pool(dense):
    """A junk draft (a fresh init) rejects nearly every round on a paged,
    prefix-cached engine: the sweep after every step holds pool
    conservation and "no write past a lane's KV in a shared block"; the
    pool drains to empty and the stream is the sequential engine's."""
    m = dense
    junk = params_from_numpy(m["tcfg"], jax.tree.map(np.asarray, _mix(m["jcfg"], m["jp"], 1.0)),
                             device="cpu")
    stream = STREAMS[42]
    eng = port(m, "spec_prefix", draft=junk)
    assert drive(eng, stream) == sequential(m, stream)
    assert eng.counters["spec_rejected"] > 0
    assert eng.alloc.in_use == 0
    assert eng.alloc.num_free + eng.alloc.num_cached == eng.alloc.capacity
    assert eng.stats["tokens_per_decode_dispatch"] >= 1.0


@pytest.mark.parametrize("seed", sorted(STREAMS))
@pytest.mark.parametrize("mode", sorted(SPEC_MODES))
def test_streams_and_counters_match_reference(dense, mesh, rules, mode, seed):
    """Greedy streams bitwise the port's sequential slotted engine's and the
    reference spec engine's on the same traffic, draft and layout; every
    spec and scheduling counter and both spec stats equal the reference's
    (the draft's argmax agrees across the packages on these streams)."""
    m = dense
    stream = STREAMS[seed]
    eng = port(m, mode)
    got = drive(eng, stream)
    jeng = ref(m, mesh, rules, mode)
    assert got == sequential(m, stream)
    assert got == drive(jeng, stream)
    assert {k: eng.counters[k] for k in ENGINE_COUNTERS} == \
        {k: jeng.counters[k] for k in ENGINE_COUNTERS}
    for k in ("spec_acceptance_rate", "tokens_per_decode_dispatch"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.counters["spec_accepted"] > 0 and eng.counters["spec_rejected"] > 0
    if eng.paged:
        assert eng.alloc.in_use == 0
    if eng.tier is not None:
        eng.tier.check()
        assert eng.tier.spilled_lanes == 0


def test_zamba_spec_with_preempts_matches_reference(hybrid, mesh, rules):
    """Zamba (recurrent rollback on both sides) with host preemptions landing
    mid-speculation: bitwise the port's sequential engine (no preemptions)
    and the reference spec engine under the same preemptions, with the
    same counters; the draft's dead lanes are zero after every round."""
    m = hybrid
    stream = make_stream(np.random.default_rng(7000), 256)
    preempts = {2: 1, 5: 0, 9: 2}

    def hook(eng, tick):
        slot = preempts.get(tick)
        if slot is not None and eng.slots[slot] is not None:
            eng.preempt(slot)
            eng.check_invariants()

    eng = port(m)
    got = drive(eng, stream, hook)
    jeng = ref(m, mesh, rules)
    assert got == sequential(m, stream)
    assert got == drive(jeng, stream, hook)
    assert {k: eng.counters[k] for k in ENGINE_COUNTERS} == \
        {k: jeng.counters[k] for k in ENGINE_COUNTERS}
    assert eng.counters["preemptions"] > 0 and eng.counters["spec_rejected"] > 0
    assert eng._draft_rec.lanes_are_zero(eng.state["draft"], range(MAX_SLOTS))


def test_spec_counters_and_stats(dense):
    """Every non-replay round commits at least the target's own token;
    the acceptance rate is a ratio of the counters; a plain engine
    reports no spec stats."""
    m = dense
    eng = port(m, "spec_slotted")
    drive(eng, STREAMS[43])
    st_ = eng.stats
    assert eng.counters["spec_rounds"] > 0
    assert st_["tokens_per_decode_dispatch"] >= 1.0
    assert 0.0 <= st_["spec_acceptance_rate"] <= 1.0
    assert st_["spec_acceptance_rate"] == pytest.approx(
        eng.counters["spec_accepted"] / max(1, eng.counters["spec_drafted"]))
    plain = port(m, spec=False)
    drive(plain, STREAMS[43])
    assert plain.counters["spec_rounds"] == 0
    assert "tokens_per_decode_dispatch" not in plain.stats
    assert "spec_acceptance_rate" not in plain.stats


# ---------------------------------------------------------------------------
# Cross-feature races (the reference's tests/test_spec_decode.py rows)
# ---------------------------------------------------------------------------


def _until_drained(eng, guard=100):
    n = 0
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0
        n += 1
        assert n < guard


def test_cancel_between_verify_rounds_refunds(dense):
    m = dense
    prompts = [np.arange(1, 10, dtype=np.int32), np.arange(3, 15, dtype=np.int32)]
    stream = [(0, p, 12) for p in prompts]
    want = sequential(m, stream)
    eng = port(m, "spec_prefix")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=12, rid=i)
    eng.step()
    eng.step()
    emitted = len(eng.live[0].tokens)
    assert emitted >= 1
    assert eng.cancel(0)
    eng.check_invariants()
    _until_drained(eng)
    c0, c1 = eng.completions[0], eng.completions[1]
    assert c0.status == "cancelled" and list(c0.tokens) == want[0][: len(c0.tokens)]
    assert len(c0.tokens) >= emitted
    assert c1.status == "ok" and list(c1.tokens) == want[1]
    assert eng.alloc.in_use == 0


def test_deadline_expiry_mid_speculation(dense):
    m = dense
    prompt = np.arange(2, 11, dtype=np.int32)
    want = sequential(m, [(0, prompt, 30)])
    eng = port(m, "spec_slotted")
    eng.submit(prompt, max_new_tokens=30, rid=0, deadline_s=2.5)
    _until_drained(eng)
    c = eng.completions[0]
    assert c.status == "timeout" and 0 < len(c.tokens) < 30
    assert list(c.tokens) == want[0][: len(c.tokens)]


def test_preempt_during_speculation_requeues_committed_only(dense):
    m = dense
    prompt = np.arange(5, 14, dtype=np.int32)
    want = sequential(m, [(0, prompt, 10)])
    eng = port(m, "spec_slotted")
    eng.submit(prompt, max_new_tokens=10, rid=0)
    eng.step()
    committed = len(eng.live[0].tokens)
    assert 1 <= committed <= SPEC_K + 1
    eng.preempt(0)
    eng.check_invariants()
    _until_drained(eng)
    assert eng.counters["preemptions"] == 1
    assert eng.counters["replayed_tokens"] == committed
    c = eng.completions[0]
    assert c.status == "ok" and list(c.tokens) == want[0]


def test_spec_lane_spills_and_restores_o_copy(dense):
    m = dense
    prompt = np.arange(7, 19, dtype=np.int32)
    want = sequential(m, [(0, prompt, 10)])
    eng = port(m, "spec_tiered")
    eng.submit(prompt, max_new_tokens=10, rid=0)
    eng.step()
    assert len(eng.live[0].tokens) >= 1
    eng.preempt(0)
    eng.check_invariants()
    _until_drained(eng)
    assert eng.counters["spills"] >= 1 and eng.counters["restores"] >= 1
    assert eng.counters["replayed_tokens"] == 0
    eng.tier.check()
    assert eng.tier.spilled_lanes == 0
    c = eng.completions[0]
    assert c.status == "ok" and list(c.tokens) == want[0]


def _chaos(eng, stream, cancel_tick):
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            kw = {"deadline_s": 40.0} if i % 4 == 0 else {}
            eng.submit(prompt, max_new_tokens=budget, rid=i, **kw)
            i += 1
        if tick == cancel_tick and eng.live:
            resumes = sorted(r.rid for r in eng.queue if r.resume)
            replaying = sorted(s.rid for s in eng.slots
                               if s is not None and s.generated < s.emit_from)
            pool = resumes or replaying or sorted(eng.live)
            eng.cancel(pool[len(pool) // 2])
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0
        tick += 1
        assert tick < 3000
    return eng


@pytest.mark.parametrize("seed", range(3))
def test_spec_chaos_matches_reference(dense, mesh, rules, seed):
    """A seeded fault schedule (corrupted verify fetches, failed prefills
    and allocs, lost pushes) with deadlines and a cancel over a preempting
    spec engine: ``step()`` never raises, invariants hold every step,
    every ``ok`` stream is the fault-free sequential one and the others a
    prefix of it, and statuses, streams and counters equal the reference
    engine's under the same schedule."""
    m = dense
    rates = {"decode_logits": 0.1, "prefill": 0.1, "alloc": 0.05, "sched_push": 0.1}
    rng = np.random.default_rng(8800 + seed)
    stream = make_stream(rng, 256)
    cancel_tick = int(rng.integers(1, 20))
    want = sequential(m, stream)
    eng = _chaos(port(m, "spec_preempt", faults=FaultPlan(seed, rates)), stream, cancel_tick)
    jeng = _chaos(ref(m, mesh, rules, "spec_preempt", faults=JFaultPlan(seed, rates)),
                  stream, cancel_tick)
    for rid in range(len(stream)):
        c, jc = eng.completions[rid], jeng.completions[rid]
        assert (c.status, list(c.tokens)) == (jc.status, list(jc.tokens)), rid
        got = list(c.tokens)
        assert got == want[rid] if c.status == "ok" else got == want[rid][: len(got)]
    assert {k: eng.counters[k] for k in ENGINE_COUNTERS + ("faults_injected",
                                                           "faults_detected")} == \
        {k: jeng.counters[k] for k in ENGINE_COUNTERS + ("faults_injected", "faults_detected")}
    assert eng.alloc.in_use == 0


def test_spec_prebuild_keeps_builds_flat(dense):
    """After ``prebuild`` a spec drive (admissions, rounds, draft rebuilds,
    preemptions) builds nothing: the spec program of each sampling form
    and the draft prefill of every history bucket are there."""
    m = dense
    aot = AotCache("spec-prebuild")
    port(m, "spec_preempt", aot=aot).prebuild()
    builds = aot.stats["builds"]
    keys = list(aot.keys())
    assert sum(k[0] == "spec_decode" for k in keys) == 3
    assert not any(k[0] == "slot_decode" for k in keys)
    assert sum(k[0] == "spec_draft_prefill" for k in keys) == len(
        port(m, "spec_preempt", aot=aot)._spec_buckets)
    eng = port(m, "spec_preempt", aot=aot)
    drive(eng, STREAMS[42])
    assert eng.counters["preemptions"] > 0
    assert aot.stats["builds"] == builds


# ---------------------------------------------------------------------------
# Snapshots and migration of a spec engine, across both packages
# ---------------------------------------------------------------------------


def _submit_all(eng, stream):
    for i, (_, p, b) in enumerate(stream):
        eng.submit(p, max_new_tokens=b, rid=i)


def _advance(eng, steps):
    for _ in range(steps):
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0


def test_spec_snapshot_matches_reference_and_restores(dense, mesh, rules, tmp_path):
    """After the same rounds the two packages' snapshots agree (the engine
    config nests the draft's ``ArchConfig``); each, through a JSON file,
    restores into a fresh port spec engine, which finishes every stream as
    the uninterrupted sequential engine does.  (The port's counters hold
    ``prefill_first_chunks``, which the reference's restore refuses, so a
    whole snapshot crosses one way; a request crosses both ways below.)"""
    m = dense
    stream = [(0, p, b) for _, p, b in STREAMS[43]]
    want = sequential(m, stream)
    snaps = []
    for eng in (port(m, "spec_preempt"), ref(m, mesh, rules, "spec_preempt")):
        _submit_all(eng, stream)
        _advance(eng, 4)
        snaps.append(json.loads(json.dumps(eng.snapshot())))
    got, jwant = snaps
    assert got["engine"]["spec_draft"]["name"] == m["tcfg"].name
    for k in ("format", "arch", "engine", "queue", "live", "completions", "next_rid"):
        assert got[k] == jwant[k], k
    for name, snap in (("port", got), ("reference", jwant)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(snap))
        fresh = port(m, "spec_preempt")
        fresh.restore(json.loads(path.read_text()))
        _until_drained(fresh, 400)
        assert [list(fresh.completions[r].tokens) for r in range(len(stream))] == want, name
    with pytest.raises(ValueError, match="EngineConfig"):
        port(m, "spec_slotted").restore(got)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_spec_cross_package_migration(dense, mesh, rules, direction):
    """A request exported mid-speculation by one package's spec engine
    imports into the other's and finishes with the uninterrupted stream."""
    m = dense
    stream = [(0, p, b) for _, p, b in STREAMS[42]]
    want = sequential(m, stream)
    make = [lambda: ref(m, mesh, rules, "spec_prefix"), lambda: port(m, "spec_prefix")]
    if direction == "port_to_reference":
        make.reverse()
    src, dst = make[0](), make[1]()
    _submit_all(src, stream)
    _advance(src, 3)
    rid = next(s.rid for s in src.slots if s is not None and s.generated >= 2)
    snap = json.loads(json.dumps(src.export_request(rid)))
    dst.import_request(snap, front=True)
    _until_drained(dst, 400)
    assert list(dst.completions[rid].tokens) == want[rid]
    assert dst.completions[rid].status == "ok"


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_spec_on_cpu(capsys):
    from repro_torch.launch.serve import main

    router = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--requests", "4",
                   "--rate", "1000", "--new-tokens", "8", "--kv-layout", "paged",
                   "--spec-k", "3", "--spec-draft-alpha", "0.15"])
    out = capsys.readouterr().out
    assert "spec k=3" in out and "accept" in out and "tok/round" in out
    eng = router.replicas[0].engine
    assert eng.spec and eng.econ.spec_k == 3 and eng.counters["spec_steps"] > 0
    assert router.stats["status_ok"] == 4


# ---------------------------------------------------------------------------
# chip_smoke.py's zamba spec phase, rehearsed at smoke width (the dense spec
# phases' rehearsal and the ``rehearsal`` fixture are in
# ``tests/test_torch_spec_rehearsal.py``)
# ---------------------------------------------------------------------------


def test_chip_smoke_zamba_spec_phase(rehearsal):
    """Phase 5d at smoke width: spec on phase 5's zamba engine with two host
    preemptions mid-speculation, every stream bitwise phase 5's, the
    draft's dead recurrent lanes zero after every round, builds flat, the
    launches the counters predict."""
    cs = rehearsal
    from repro_torch.models import zamba

    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), compute_dtype="float32",
                              attn_impl="kernel")
    params = zamba.init(cfg, seed=0, device=dev)
    reqs = cs.requests(cfg.vocab)
    ec = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="slotted")
    eng, rids, _, _, _ = cs.serve(torch, cfg, params, reqs, ec, dev)
    want = [list(eng.completions[r].tokens) for r in rids]
    out = cs.zamba_spec(torch, cfg, params, reqs, ec, dev, want, 1.0)
    assert out["identical_to_phase5"] == len(reqs)
    assert out["spec_accepted"] > 0 and out["spec_rejected"] > 0
    assert out["snapshot_buffer_bytes"] > 0


# ---------------------------------------------------------------------------
# On the card: the spec round's graph
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_spec_engine(arch, layout, dev):
    """A smoke-width spec engine on the card (head dim 64, the kernels'
    width), the draft the target moved 0.15 toward an init from seed 1."""
    from repro_torch.launch.serve import draft_mix

    over = dict(d_head=64, attn_impl="kernel" if arch == "smollm-360m" else "chunked")
    if arch == "smollm-360m":
        over["compute_dtype"] = "bfloat16"
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params = registry.get_module(cfg).init(cfg, seed=0, device=dev)
    ec = EngineConfig(max_slots=4, max_len=64, kv_layout=layout, spec_draft=cfg,
                      spec_k=SPEC_K, paged_attn="kernel" if layout == "paged" else "ref")
    return ServeEngine(cfg, params, ec, device=dev,
                       draft_params=draft_mix(cfg, params, 0.15, 1, dev))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Generator):
        g = torch.Generator(device=tree.device)
        g.set_state(tree.get_state())
        return g
    return tree.clone()


def _tensor_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tensor_leaves(v, f"{prefix}{k}/")
        elif torch.is_tensor(v):
            yield prefix + k, v


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layout", [("smollm-360m", "paged"), ("smollm-360m", "slotted"),
                                         ("zamba2-1.2b", "slotted")])
def test_spec_graph_replay_equals_eager_bitwise(cuda, arch, layout):
    """Each of 8 rounds runs the eager spec program on a deep clone of the
    state and replays the graph on the state itself: the rows and every
    leaf (the draft's, the snapshots and ``keep`` included) bitwise equal."""
    eng = _card_spec_engine(arch, layout, cuda)
    rng = np.random.default_rng(8)
    for n in (5, 12, 20, 9):
        eng.submit(rng.integers(0, eng.cfg.vocab, n).astype(np.int32), max_new_tokens=30)
    while eng.counters["decode_steps"] < 1:
        eng.step()
    flags = dict(stochastic=False, masked=False)
    graph = eng._spec_entry(**flags)
    assert isinstance(graph, CudaGraphProgram) and eng.stats["graphs"] == 1
    eager = eng.spec_program(**flags)
    checked = []

    def check(params, dparams, state):
        clone = _clone(state)
        want = eager(params, dparams, clone).clone()
        got = graph(params, dparams, state)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for (name, a), (_, b) in zip(_tensor_leaves(state), _tensor_leaves(clone)):
            assert torch.equal(a, b), name
        checked.append(1)
        return got

    eng._spec_entry = lambda **flags: check
    for _ in range(8):
        eng.step()
    assert len(checked) == graph.replays == 8


@pytest.mark.cuda
def test_spec_graph_guard_raises_on_a_rebound_leaf(cuda):
    """Rebinding any buffer the spec graph was captured on (here the
    draft's cache) makes the next replay raise instead of touching freed
    memory."""
    eng = _card_spec_engine("smollm-360m", "slotted", cuda)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=20)
    while eng.counters["decode_steps"] < 2:
        eng.step()
    eng.state["draft"]["k"] = eng.state["draft"]["k"].clone()
    with pytest.raises(RuntimeError, match="moved since capture"):
        eng.step()
