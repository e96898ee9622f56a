"""The port's request lifecycle and fault tolerance against the reference.

* ``FaultPlan``: the same seed, rates and consults give the reference's
  fire/skip schedule, victims and stats.
* Deadlines and ``cancel()`` (``tests/test_fault_tolerance.py``): queued,
  mid-decode, mid-chunked-prefill, in the preempt-requeue window and
  mid-replay, each with the full block and deficit refund; on the same
  ``FakeClock`` script the port's statuses and tokens equal the
  reference engine's.
* Chaos (``tests/test_engine_fuzz.py``): seeded faults at the four engine
  sites over every feature mode; ``step()`` never raises, invariants hold
  after every step, every request ends in a status, and an ``ok`` request
  is the fault-free slotted stream (a non-ok one a prefix of it), with no
  program built after ``prebuild``.  Retry exhaustion is a structured
  ``failed``; genuine non-finite logits from poisoned weights are caught.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    ENGINE_FAULT_SITES,
    FAULT_SITES,
    STATUSES,
    EngineConfig,
    FaultPlan,
    ServeEngine,
)

MAX_SLOTS, MAX_LEN, BS = 3, 48, 8
VOCAB = 256                      # the smoke configs' vocabulary


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


PAGED_PREFIX = dict(max_slots=2, max_len=48, kv_layout="paged", page_size=8,
                    prefix_cache=True)
CHUNKED = dict(PAGED_PREFIX, prefill_chunk=8)


def _engine(models, ec: dict, **kw):
    _, _, tcfg, tp = models
    return ServeEngine(tcfg, tp, EngineConfig(**ec), device="cpu", **kw)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,max_fires", [(0, None), (7, None), (3, 5)])
def test_fault_plan_schedule_matches_reference(seed, max_fires):
    rates = {"decode_logits": 0.3, "prefill": 0.5, "alloc": 0.1, "sched_push": 0.2,
             "replica_crash": 0.05}
    ours = FaultPlan(seed, rates, max_fires=max_fires)
    theirs = JFaultPlan(seed, rates, max_fires=max_fires)
    rng = np.random.default_rng(seed)
    for _ in range(400):
        site = FAULT_SITES[int(rng.integers(len(FAULT_SITES)))]
        if rng.random() < 0.5:
            cands = list(range(int(rng.integers(0, 5))))
            assert ours.pick(site, cands) == theirs.pick(site, cands)
        else:
            assert ours.fire(site) == theirs.fire(site)
    assert ours.stats() == theirs.stats()
    assert ours.total_fired > 0
    if max_fires is not None:
        assert ours.total_fired == max_fires
    with pytest.raises(ValueError, match="unknown fault sites"):
        FaultPlan(0, {"bogus": 1.0})
    assert ENGINE_FAULT_SITES == ("decode_logits", "prefill", "alloc", "sched_push")


# ---------------------------------------------------------------------------
# Deadlines and cancel
# ---------------------------------------------------------------------------


def test_deadline_expiry_queued_vs_mid_decode(models, mesh, rules):
    """A queued request expires with no tokens, a decoding one mid-stream
    with what it emitted; both as the reference engine on the same clock
    script."""
    jcfg, jp, _, _ = models

    def run(eng, clock):
        r0 = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=20, deadline_s=4.0)
        r1 = eng.submit(np.arange(3, 9, dtype=np.int32), max_new_tokens=20, deadline_s=2.0)
        while eng.has_work():
            eng.step()
            eng.check_invariants()
            clock.t += 1.0
            assert clock.t < 100
        return [(eng.completions[r].status, list(eng.completions[r].tokens))
                for r in (r0, r1)]

    clock = FakeClock()
    eng = _engine(models, dict(max_slots=1, max_len=48), clock=clock)
    got = run(eng, clock)
    jclock = FakeClock()
    want = run(JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(max_slots=1, max_len=48),
                            clock=jclock), jclock)
    assert got == want
    (s0, t0), (s1, t1) = got
    assert s1 == "timeout" and t1 == []
    assert s0 == "timeout" and 0 < len(t0) < 20
    assert eng.counters["status_timeout"] == 2
    r2 = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2, deadline_s=50.0)
    eng.drain()
    assert eng.completions[r2].status == "ok" and len(eng.completions[r2].tokens) == 2


def test_cancel_refunds_blocks_and_deficit(models):
    """Under paged + prefix + deficit: a mid-decode cancel drops the lane's
    refs and refunds its commitment, a queued cancel touches nothing, the
    neighbour's stream is untouched."""
    pre = np.arange(1, 9, dtype=np.int32)
    p0 = np.concatenate([pre, [11, 12]]).astype(np.int32)
    p1 = np.concatenate([pre, [21, 22, 23]]).astype(np.int32)
    p2 = np.arange(31, 38, dtype=np.int32)
    want1 = list(_engine(models, PAGED_PREFIX).run([p1], max_new_tokens=6)[0])
    eng = _engine(models, PAGED_PREFIX)
    r0 = eng.submit(p0, max_new_tokens=20)
    r1 = eng.submit(p1, max_new_tokens=6)
    r2 = eng.submit(p2, max_new_tokens=6)
    for _ in range(3):
        eng.step()
    assert any(s is not None and s.rid == r0 for s in eng.slots)
    before = eng._deficit
    assert before > 0
    assert eng.cancel(r0) is True
    assert eng._deficit < before
    eng.check_invariants()
    assert eng.cancel(r2) is True
    eng.check_invariants()
    eng.drain()
    c = eng.completions
    assert (c[r0].status, c[r2].status, c[r1].status) == ("cancelled", "cancelled", "ok")
    assert c[r2].tokens == [] and list(c[r1].tokens) == want1
    assert eng.counters["status_cancelled"] == 2 and eng.alloc.in_use == 0
    eng.check_invariants()
    assert eng.cancel(r1) is False
    with pytest.raises(KeyError):
        eng.cancel(12345)


def _until(eng, cond, clock=None):
    for _ in range(50):
        if cond():
            return
        eng.step()
        eng.check_invariants()
        if clock is not None:
            clock.t += 1.0
    raise AssertionError("condition never reached")


def _lane_of(eng, rid):
    return next(i for i, s in enumerate(eng.slots) if s is not None and s.rid == rid)


def test_cancel_in_preempt_requeue_window(models):
    """Cancel between requeue and re-admission: the completion keeps the
    pre-preemption tokens, everything refunds, the neighbour is untouched."""
    p0, p1 = np.arange(1, 9, dtype=np.int32), np.arange(21, 27, dtype=np.int32)
    solo = _engine(models, PAGED_PREFIX)
    want0 = list(solo.run([p0], max_new_tokens=12)[0])
    want1 = list(solo.run([p1], max_new_tokens=6)[0])
    eng = _engine(models, PAGED_PREFIX)
    r0 = eng.submit(p0, max_new_tokens=12)
    r1 = eng.submit(p1, max_new_tokens=6)
    _until(eng, lambda: r0 in eng.live and len(eng.live[r0].tokens) >= 2)
    n_pre = len(eng.live[r0].tokens)
    eng.preempt(_lane_of(eng, r0))
    eng.check_invariants()
    assert eng.queue[0].rid == r0 and eng.queue[0].resume
    assert eng.cancel(r0) is True
    eng.check_invariants()
    eng.drain()
    assert eng.completions[r0].status == "cancelled"
    assert list(eng.completions[r0].tokens) == want0[:n_pre]
    assert list(eng.completions[r1].tokens) == want1
    assert eng.alloc.in_use == 0 and eng._deficit == 0
    eng.check_invariants()


def test_deadline_expires_in_preempt_requeue_window(models):
    clock = FakeClock()
    eng = _engine(models, PAGED_PREFIX, clock=clock)
    r0 = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=12, deadline_s=100.0)
    _until(eng, lambda: r0 in eng.live and len(eng.live[r0].tokens) >= 2, clock)
    n_pre = len(eng.live[r0].tokens)
    eng.preempt(_lane_of(eng, r0))
    eng.check_invariants()
    assert eng.queue[0].resume
    clock.t += 200.0
    eng.drain()
    c0 = eng.completions[r0]
    assert c0.status == "timeout" and len(c0.tokens) == n_pre
    assert eng.counters["status_timeout"] == 1
    assert eng.alloc.in_use == 0 and eng._deficit == 0
    eng.check_invariants()


def test_cancel_mid_replay(models):
    """Cancel a resumed lane while it still replays its recorded tokens:
    the completion holds exactly the tokens it had emitted."""
    p0 = np.arange(1, 9, dtype=np.int32)
    want0 = list(_engine(models, PAGED_PREFIX).run([p0], max_new_tokens=12)[0])
    eng = _engine(models, PAGED_PREFIX)
    r0 = eng.submit(p0, max_new_tokens=12)
    _until(eng, lambda: r0 in eng.live and len(eng.live[r0].tokens) >= 3)
    n_pre = len(eng.live[r0].tokens)
    eng.preempt(_lane_of(eng, r0))

    def replaying():
        s = next((s for s in eng.slots if s is not None and s.rid == r0), None)
        return s is not None and 0 < s.generated < s.emit_from

    _until(eng, replaying)
    assert eng.cancel(r0) is True
    eng.check_invariants()
    eng.drain()
    c0 = eng.completions[r0]
    assert c0.status == "cancelled" and list(c0.tokens) == want0[:n_pre]
    assert eng.alloc.in_use == 0 and eng._deficit == 0
    eng.check_invariants()


def test_cancel_and_expiry_mid_chunked_prefill(models):
    """Cancel one request and expire another while their prompts are only
    partly prefilled: no tokens, every mapped block refunded, and the
    engine serves on."""
    clock = FakeClock()
    eng = _engine(models, CHUNKED, clock=clock)
    r0 = eng.submit(np.arange(1, 21, dtype=np.int32), max_new_tokens=4)
    r1 = eng.submit(np.arange(5, 25, dtype=np.int32), max_new_tokens=4, deadline_s=0.5)
    eng.step()
    eng.check_invariants()
    mid = {s.rid for s in eng.slots if s is not None and s.prefilled < s.plen}
    assert mid == {r0, r1}
    assert eng.cancel(r0) is True
    eng.check_invariants()
    clock.t += 1.0
    eng.drain()
    c = eng.completions
    assert (c[r0].status, c[r1].status) == ("cancelled", "timeout")
    assert c[r0].tokens == [] and c[r1].tokens == []
    assert eng.alloc.in_use == 0 and eng._deficit == 0
    eng.check_invariants()
    assert len(eng.run([np.arange(1, 6, dtype=np.int32)], max_new_tokens=3)[0]) == 3


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------

CHAOS_RATES = {"decode_logits": 0.05, "prefill": 0.05, "alloc": 0.03, "sched_push": 0.05}
CHAOS_MODES = {
    "slotted": dict(),
    "paged_chunked": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS),
    "prefix_chunked": dict(kv_layout="paged", page_size=BS, prefill_chunk=BS,
                           prefix_cache=True),
    "prefix_preempt": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                           prefix_cache=True, admission="preempt"),
    "preempt_chunked": dict(kv_layout="paged", page_size=BS, num_blocks=6,
                            prefill_chunk=BS, prefix_cache=True, admission="preempt"),
}


def make_stream(rng):
    """The reference fuzzer's request-stream recipe (shared block-aligned
    prefixes, own tails, disjoint prompts, bursts)."""
    prefixes = [rng.integers(0, VOCAB, int(rng.integers(1, 3)) * BS).astype(np.int32)
                for _ in range(int(rng.integers(1, 3)))]
    out, tick = [], 0
    for _ in range(int(rng.integers(3, 9))):
        tick += int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.25:
            prompt = prefixes[int(rng.integers(len(prefixes)))].copy()
        elif r < 0.7:
            tail = rng.integers(0, VOCAB, int(rng.integers(1, 9))).astype(np.int32)
            prompt = np.concatenate([prefixes[int(rng.integers(len(prefixes)))], tail])
        else:
            prompt = rng.integers(0, VOCAB, int(rng.integers(1, 25))).astype(np.int32)
        budget = int(rng.integers(1, 9))
        out.append((tick, prompt[: MAX_LEN - budget - BS], budget))
    return out


def drive_chaos(eng, stream, clock, *, deadline_every=0, cancel_ticks=frozenset()):
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            kw = {"deadline_s": 40.0} if deadline_every and i % deadline_every == 0 else {}
            eng.submit(prompt, max_new_tokens=budget, rid=i, **kw)
            i += 1
        if tick in cancel_ticks and eng.live:
            # prefer the race windows: queued resumes, lanes mid-replay
            resumes = sorted(r.rid for r in eng.queue if r.resume)
            replaying = sorted(s.rid for s in eng.slots
                               if s is not None and s.generated < s.emit_from)
            pool = resumes or replaying or sorted(eng.live)
            eng.cancel(pool[len(pool) // 2])
        eng.step()
        eng.check_invariants()
        clock.t += 1.0
        tick += 1
        assert tick < 3000, "engine failed to drain under chaos"
    assert not eng.live and not eng.queue
    return eng


@pytest.mark.parametrize("episode", range(3))
def test_chaos_fuzz(models, episode):
    _, _, tcfg, tp = models
    aot = AotCache("chaos")
    for ec in CHAOS_MODES.values():
        ServeEngine(tcfg, tp, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, **ec),
                    device="cpu", aot=aot).prebuild()
    builds = aot.stats["builds"]
    rng = np.random.default_rng(9000 + episode)
    stream = make_stream(rng)
    clean = ServeEngine(tcfg, tp, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN),
                        device="cpu", aot=aot)
    want = [list(t) for t in _replay(clean, stream)]
    agg = dict.fromkeys(("faults_injected", "faults_detected", "retries", "status_ok",
                         "status_cancelled"), 0)
    for mi, (name, ec) in enumerate(CHAOS_MODES.items()):
        clock = FakeClock()
        eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                                 **ec),
                          device="cpu", aot=aot, clock=clock,
                          faults=FaultPlan(episode * len(CHAOS_MODES) + mi, CHAOS_RATES))
        drive_chaos(eng, stream, clock, deadline_every=3,
                    cancel_ticks={int(t) for t in rng.integers(1, 25, size=2)})
        for rid in range(len(stream)):
            c = eng.completions[rid]
            assert c.status in STATUSES
            got = list(c.tokens)
            if c.status == "ok":
                assert got == want[rid], (name, rid)
            else:
                assert got == want[rid][: len(got)], (name, rid, c.status)
        if eng.paged:
            assert eng.alloc.in_use == 0
        for k in agg:
            agg[k] += eng.stats[k]
    assert aot.stats["builds"] == builds, "a retry built a program"
    assert agg["faults_injected"] > 0 and agg["faults_detected"] > 0
    assert agg["retries"] > 0 and agg["status_ok"] > 0


def _replay(eng, stream):
    i = tick = 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            eng.submit(stream[i][1], max_new_tokens=stream[i][2], rid=i)
            i += 1
        eng.step()
        tick += 1
    return [eng.completions[r].tokens for r in range(len(stream))]


def test_chaos_matches_reference_schedule(models, mesh, rules):
    """The same stream and fault plan through both engines: the same
    statuses, tokens, retries and fault counters (the faults fire at the
    same consults)."""
    jcfg, jp, tcfg, tp = models
    stream = make_stream(np.random.default_rng(9101))
    ec = CHAOS_MODES["preempt_chunked"]
    runs = []
    for eng_of in (
            lambda clock, f: ServeEngine(tcfg, tp, EngineConfig(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, **ec), device="cpu", clock=clock,
                faults=f),
            lambda clock, f: JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, **ec), aot=JAotCache("x"),
                clock=clock, faults=f)):
        clock = FakeClock()
        plan = (FaultPlan if not runs else JFaultPlan)(5, CHAOS_RATES)
        eng = drive_chaos(eng_of(clock, plan), stream, clock, deadline_every=3)
        runs.append(([(c.status, list(c.tokens), c.retries, c.error)
                      for c in (eng.completions[r] for r in range(len(stream)))],
                     {k: eng.counters[k] for k in ("faults_injected", "faults_detected",
                                                   "retries", "preemptions", "resumed")},
                     plan.stats()))
    assert runs[0] == runs[1]
    assert runs[0][1]["faults_injected"] > 0


def test_chaos_retry_exhaustion_is_structured_failure(models):
    eng = _engine(models, dict(max_slots=MAX_SLOTS, max_len=MAX_LEN),
                  faults=FaultPlan(1, {"prefill": 1.0}))
    rid = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=4)
    _until(eng, lambda: not eng.has_work())
    c = eng.completions[rid]
    assert c.status == "failed" and c.retries == eng.econ.max_retries + 1
    assert "prefill" in c.error and c.tokens == []
    assert eng.counters["status_failed"] == 1


def _poisoned(models):
    _, _, _, tp = models
    return {k: ({n: torch.full_like(v, float("nan")) for n, v in t.items()}
                if isinstance(t, dict) else torch.full_like(t, float("nan")))
            for k, t in tp.items()}


def test_genuine_nonfinite_logits_detected(models):
    """NaN weights: the device reports the sentinel through the ordinary
    token fetch and the request fails cleanly, its blocks refunded."""
    _, _, tcfg, _ = models
    eng = ServeEngine(tcfg, _poisoned(models), EngineConfig(
        max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=BS),
        device="cpu")
    rid = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    _until(eng, lambda: not eng.has_work())
    c = eng.completions[rid]
    assert c.status == "failed" and "non-finite" in c.error
    assert eng.counters["faults_detected"] > 0 and eng.counters["faults_injected"] == 0
    assert eng.alloc.in_use == 0


def test_genuine_nonfinite_mid_decode(models):
    """Weights poisoned after the first token: decode finds non-finite
    logits mid-stream, and the tokens emitted before survive."""
    eng = _engine(models, dict(max_slots=MAX_SLOTS, max_len=MAX_LEN))
    rid = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=6)
    eng.step()
    emitted = len(eng.live[rid].tokens)
    assert emitted >= 1
    eng.params = {k: ({n: torch.full_like(v, float("nan")) for n, v in t.items()}
                      if isinstance(t, dict) else torch.full_like(t, float("nan")))
                  for k, t in eng.params.items()}
    _until(eng, lambda: not eng.has_work())
    c = eng.completions[rid]
    assert c.status == "failed" and len(c.tokens) >= emitted
    assert eng.counters["faults_detected"] > 0


def test_launcher_features_on_cpu(capsys):
    """The launcher with every feature flag at smoke size on the CPU."""
    from repro_torch.launch.serve import main

    eng = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--requests", "6",
                "--rate", "1000", "--kv-layout", "paged", "--new-tokens", "6",
                "--prefill-chunk", "8", "--prefix-cache", "--admission", "preempt",
                "--num-blocks", "6", "--chaos-rate", "0.05", "--deadline-s", "30"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "chaos" in out
    st = eng.stats
    assert sum(st[f"status_{s}"] for s in STATUSES) == 6
    assert eng.econ.prefill_chunk == 8 and eng.econ.prefix_cache
    assert eng.econ.admission == "preempt"
