"""The port's router front-end against the reference's.

One counterpart for each test of ``tests/test_router.py``.  Where the
reference has a router to hold against, the same scenario runs through
``repro.serve.router.Router`` and ``repro_torch.serve.Router`` side by
side, at smoke width in fp32 on the CPU, with the reference's parameters
converted through ``params_from_numpy``: completions (status, tokens,
error), ``placements`` and every router and replica counter must be
equal, and the reference test's own property must hold on the port.

* Chaos fuzz on the SLOTTED, PREFIX and TIERED engine configs: the
  reference fuzzer's ``make_stream`` traffic, the same router
  ``FaultPlan`` seeds (replica crashes and stalls); every request ``ok``,
  streams the fault-free single engine's, builds flat.
* A zamba (hybrid, slotted) episode with a kill.
* One weight copy across replicas (``data_ptr`` equality).
* The launcher's router flags (``--replicas 2 --drain-at``) and its
  static engine.

``chip_smoke.py``'s phases 3m and 3n are rehearsed at smoke width in
``tests/test_torch_router_rehearsal.py``.

The card-only check (graph captures counted as fleet builds) is in
``tests/test_torch_aot.py``, which imports no JAX.
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
from repro.serve.router import Router as JRouter
from repro.serve.router import RouterConfig as JRouterConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    ENGINE_FAULT_SITES,
    FAULT_SITES,
    REPLICA_FAULT_SITES,
    STATUSES,
    EngineConfig,
    FaultPlan,
    Router,
    RouterConfig,
    ServeEngine,
)

from test_engine_fuzz import make_stream

EPISODES = 3
MAX_SLOTS, MAX_LEN, BS = 3, 48, 8
SLOTTED = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN)
PREFIX = dict(max_slots=2, max_len=MAX_LEN, kv_layout="paged", page_size=BS, prefix_cache=True)
TIERED = dict(max_slots=2, max_len=MAX_LEN, kv_layout="paged", page_size=BS, host_tier=True)
MODES = {"slotted": SLOTTED, "prefix": PREFIX, "tiered": TIERED}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp)


@pytest.fixture(scope="module")
def setup(mesh, rules):
    """Both packages' models, and a program cache each with every engine
    shape prebuilt: every router below serves (fails over, drains)
    without a fresh build."""
    m = _models("smollm-360m")
    m.update(mesh=mesh, rules=rules, jaot=JAotCache("router-test"), aot=AotCache("router-test"))
    for ec in MODES.values():
        JServeEngine(m["jcfg"], mesh, rules, m["jp"], JEngineConfig(**ec),
                     aot=m["jaot"]).prebuild()
        ServeEngine(m["tcfg"], m["tp"], EngineConfig(**ec), device="cpu",
                    aot=m["aot"]).prebuild()
    return m


def port_router(m, ec=SLOTTED, *, replicas=3, shed=10_000, clock=None, faults=None,
                aot=None, **rc):
    kw = {} if clock is None else {"clock": clock}
    return Router(m["tcfg"], m["tp"], EngineConfig(**ec),
                  RouterConfig(replicas=replicas, shed_queue_depth=shed, **rc),
                  device="cpu", aot=m["aot"] if aot is None else aot,
                  faults=None if faults is None else FaultPlan(*faults[0], **faults[1]), **kw)


def ref_router(m, ec=SLOTTED, *, replicas=3, shed=10_000, clock=None, faults=None,
               aot=None, **rc):
    kw = {} if clock is None else {"clock": clock}
    return JRouter(m["jcfg"], m["mesh"], m["rules"], m["jp"], JEngineConfig(**ec),
                   JRouterConfig(replicas=replicas, shed_queue_depth=shed, **rc),
                   aot=m["jaot"] if aot is None else aot,
                   faults=None if faults is None else JFaultPlan(*faults[0], **faults[1]),
                   **kw)


def drive_router(router, stream, *, check=True, max_ticks=3000):
    """Replay a (tick, prompt, budget) stream through the router, one
    router tick per stream tick, sweeping fleet invariants."""
    i, tick = 0, 0
    while i < len(stream) or router.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            router.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        router.step()
        if check:
            router.check_invariants()
        tick += 1
        assert tick < max_ticks, "router failed to drain (livelock?)"
    return [list(router.completions[r].tokens) for r in range(len(stream))]


def drive_engine(m, ec, stream):
    """The fault-free single (port) engine's streams of ``stream``."""
    eng = ServeEngine(m["tcfg"], m["tp"], EngineConfig(**ec), device="cpu", aot=m["aot"])
    i, tick = 0, 0
    while i < len(stream) or eng.has_work():
        while i < len(stream) and stream[i][0] <= tick:
            _, prompt, budget = stream[i]
            eng.submit(prompt, max_new_tokens=budget, rid=i)
            i += 1
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < 2000
    return [list(eng.completions[r].tokens) for r in range(len(stream))]


def summary(router) -> dict:
    """Everything the two routers must agree on: completions, placements,
    the router's counters and each replica's (the reference's keys: the
    port counts two more), replica states."""
    ref_keys = None
    for h in router.replicas:
        ref_keys = [k for k in h.engine.counters
                    if k not in ("prefill_first_chunks", "spec_draft_prefills")]
    return dict(
        completions={r: (c.status, [int(t) for t in c.tokens], c.error, c.retries)
                     for r, c in sorted(router.completions.items())},
        placements=dict(router.placements),
        counters=router.counters.copy(),
        replicas=[{k: h.engine.counters[k] for k in ref_keys} for h in router.replicas],
        states=[h.state for h in router.replicas],
        tick=router.tick)


def both(m, scenario, **kw):
    """Run ``scenario(router)`` on the reference's router and the port's,
    built with the same ``kw`` (a fresh clock each when ``clock=True``);
    assert the summaries and the scenario's returns equal, and return the
    port's router and return value."""
    out = []
    for mk in (ref_router, port_router):
        kw_ = dict(kw)
        if kw_.get("clock") is True:
            kw_["clock"] = FakeClock()
        r = mk(m, **kw_)
        ret = scenario(r)
        out.append((r, ret, summary(r)))
    (_, jret, jsum), (router, ret, tsum) = out
    assert tsum == jsum
    assert ret == jret
    return router, ret


# ---------------------------------------------------------------------------
# The chaos fuzz (the acceptance property)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_fuzz_router_chaos(setup, mode):
    m = setup
    ec = MODES[mode]
    builds0 = (m["aot"].stats["builds"], m["jaot"].stats["builds"])
    fired = failovers = 0
    for seed in range(EPISODES):
        rng = np.random.default_rng(12000 + seed)
        stream = make_stream(rng, m["tcfg"].vocab)
        want = drive_engine(m, SLOTTED, stream)
        # max_fires=2 over 3 replicas: a survivor always remains
        faults = ((seed, {"replica_crash": 0.05, "replica_stall": 0.05}), dict(max_fires=2))
        router, got = both(m, lambda r: drive_router(r, stream), ec=ec, replicas=3,
                           faults=faults)
        assert got == want, f"{mode} seed={seed}: the fleet diverged from one engine"
        assert all(c.status == "ok" for c in router.completions.values())
        assert len(router.completions) == len(stream) == router.counters["submitted"]
        assert not router.records and not router.queue
        fired += router.faults.total_fired
        failovers += router.counters["failovers"]
    assert (m["aot"].stats["builds"], m["jaot"].stats["builds"]) == builds0, \
        "failover replays built programs: survivors must serve from the shared cache"
    assert fired > 0 and failovers > 0, "no replica fault fired: the episodes are vacuous"


def test_router_determinism(setup):
    """Same stream and fault seed: same placements, failovers, tokens."""
    m = setup
    stream = make_stream(np.random.default_rng(4242), m["tcfg"].vocab)
    runs = []
    for _ in range(2):
        router = port_router(m, faults=((7, {"replica_crash": 0.1}), dict(max_fires=1)))
        toks = drive_router(router, stream)
        runs.append((toks, dict(router.placements), router.counters.copy()))
    assert runs[0] == runs[1]
    _, jruns = both(m, lambda r: drive_router(r, stream),
                    faults=((7, {"replica_crash": 0.1}), dict(max_fires=1)))
    assert jruns == runs[0][0]


# ---------------------------------------------------------------------------
# Routing policy
# ---------------------------------------------------------------------------


def test_least_loaded_spreads_burst(setup):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 100, 8).astype(np.int32) for _ in range(6)]

    def scenario(router):
        for i, p in enumerate(prompts):
            router.submit(p, max_new_tokens=4, rid=i)
        router.step()
        first = [router.placements[i] for i in range(3)]
        router.run()
        return first

    router, first = both(setup, scenario, replicas=3)
    assert first == [0, 1, 2]
    assert all(c.status == "ok" for c in router.completions.values())


def test_cache_aware_routing(setup):
    vocab = setup["tcfg"].vocab
    rng = np.random.default_rng(2)
    pa = rng.integers(0, vocab, 2 * BS).astype(np.int32)
    pb = rng.integers(0, vocab, 2 * BS).astype(np.int32)
    pc = np.concatenate([pb, rng.integers(0, vocab, 4).astype(np.int32)])

    def scenario(router):
        ra = router.submit(pa, max_new_tokens=4)
        rb = router.submit(pb, max_new_tokens=4)
        router.run()
        rc = router.submit(pc, max_new_tokens=4)
        router.run()
        router.check_invariants()
        return [router.placements[r] for r in (ra, rb, rc)]

    router, placed = both(setup, scenario, ec=PREFIX, replicas=2)
    # c extends b's prefix: cache-awareness overrides least-loaded's replica 0
    assert placed == [0, 1, 1]
    assert router.counters["cache_routed"] >= 1
    assert all(c.status == "ok" for c in router.completions.values())


# ---------------------------------------------------------------------------
# Graceful degradation: load shedding
# ---------------------------------------------------------------------------


def test_bounded_queue_sheds(setup):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 100, 8).astype(np.int32) for _ in range(6)]

    def scenario(router):
        rids = [router.submit(p, max_new_tokens=4) for p in prompts]
        shed = [r for r in rids if r in router.completions]
        router.run()
        router.check_invariants()
        return rids, shed

    router, (rids, shed) = both(setup, scenario, replicas=1, shed=2)
    assert len(shed) == 4
    for r in shed:
        c = router.completions[r]
        assert c.status == "shed" and "queue full" in c.error and c.tokens == []
    assert router.counters["status_shed"] == 4
    assert all(router.completions[r].status == "ok" for r in rids if r not in shed)


def test_deadline_aware_early_shed(setup):
    p = np.random.default_rng(4).integers(0, 100, 8).astype(np.int32)

    def scenario(router):
        clock = router.clock
        router.submit(p, max_new_tokens=8)
        while router.has_work():
            router.step()
            clock.t += 1.0
        primed = router._ewma_service
        for _ in range(7):
            router.submit(p, max_new_tokens=8)
        tight = router.submit(p, max_new_tokens=8, deadline_s=0.5)
        loose = router.submit(p, max_new_tokens=8, deadline_s=10_000.0)
        queued = loose not in router.completions
        while router.has_work():
            router.step()
            clock.t += 1.0
        router.check_invariants()
        return primed, tight, loose, queued

    router, (primed, tight, loose, queued) = both(setup, scenario, replicas=1, shed=50,
                                                  clock=True)
    assert primed is not None and queued
    c = router.completions[tight]
    assert c.status == "shed" and "deadline unreachable" in c.error
    assert router.completions[loose].status == "ok"


def test_deadline_shed_cold_start_never_false_sheds(setup):
    """A service interval that absorbed a build does not seed the EWMA."""
    m = setup
    p = np.random.default_rng(11).integers(0, 100, 8).astype(np.int32)

    def scenario(router):
        clock = router.clock
        first = router.submit(p, max_new_tokens=4)
        while router.has_work():
            router.step()
            clock.t += 60.0                 # build-inflated wall time
        cold_ewma = router._ewma_service
        built = router.fleet_builds() if hasattr(router, "fleet_builds") \
            else router.aot.stats["builds"]
        rids = [router.submit(p, max_new_tokens=4, deadline_s=30.0) for _ in range(3)]
        early = [r in router.completions for r in rids]
        while router.has_work():
            router.step()
            clock.t += 1.0
        router.check_invariants()
        return first, cold_ewma, built > 0, rids, early, router._ewma_service is not None

    out = []
    for mk, aot in ((ref_router, JAotCache("router-coldstart")),
                    (port_router, AotCache("router-coldstart"))):
        r = mk(m, replicas=1, shed=50, clock=FakeClock(), aot=aot)
        out.append((scenario(r), summary(r), r))
    (jret, jsum, _), (ret, tsum, router) = out
    assert tsum == jsum and ret == jret
    first, cold_ewma, built, rids, early, warm_ewma = ret
    assert router.completions[first].status == "ok" and built
    assert cold_ewma is None, "a build-contaminated sample seeded the EWMA"
    assert not any(early), "a feasible first wave was shed on a warm fleet"
    assert all(router.completions[r].status == "ok" for r in rids)
    assert router.counters["status_shed"] == 0 and warm_ewma


# ---------------------------------------------------------------------------
# Crash failover: budgets and total fleet loss
# ---------------------------------------------------------------------------


def test_failover_budget_exhaustion(setup):
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, 100, 8).astype(np.int32)
    p2 = rng.integers(0, 100, 8).astype(np.int32)

    def scenario(router):
        rid = router.submit(p1, max_new_tokens=12)
        router.step()
        router.kill(router.placements[rid])     # failover 1: within budget
        router.check_invariants()
        router.step()
        pending = rid not in router.completions
        router.kill(router.placements[rid])     # failover 2: budget spent
        router.check_invariants()
        r2 = router.submit(p2, max_new_tokens=4)
        return rid, pending, r2

    router, (rid, pending, r2) = both(setup, scenario, replicas=2, max_failovers=1)
    assert pending
    c = router.completions[rid]
    assert c.status == "failed" and "failover budget" in c.error and len(c.tokens) >= 1
    assert router.completions[r2].status == "shed"
    assert "no live replicas" in router.completions[r2].error


def test_failover_restores_from_shared_host_tier(setup):
    """The fleet's one host tier holds a spill through its replica's crash:
    failover on the survivor restores by copy, with no replayed token."""
    m = setup
    p = np.random.default_rng(14).integers(0, m["tcfg"].vocab, 10).astype(np.int32)
    want = list(ServeEngine(m["tcfg"], m["tp"], EngineConfig(**TIERED), device="cpu",
                            aot=m["aot"]).run([p], max_new_tokens=12)[0])

    def scenario(router):
        rid = router.submit(p, max_new_tokens=12)
        router.step()
        router.step()
        victim = router.placements[rid]
        eng = router.replicas[victim].engine
        mid = len(eng.live[rid].tokens) >= 1
        spilled = eng._spill_lane(eng._find_lane(rid)) and router.tier.has_lane(rid)
        router.kill(victim)
        router.check_invariants()
        router.run()
        surv = router.replicas[1 - victim].engine
        return (rid, mid, spilled, router.tier.lane_restores, surv.counters["restores"],
                surv.counters["replayed_tokens"], router.tier.has_lane(rid))

    router, (rid, mid, spilled, lane_restores, restores, replayed, left) = both(
        setup, scenario, ec=TIERED, replicas=2)
    assert router.tier is not None and mid and spilled
    c = router.completions[rid]
    assert c.status == "ok" and list(c.tokens) == want
    assert router.counters["failovers"] == 1
    assert lane_restores >= 1 and restores >= 1 and replayed == 0 and not left


def test_queued_work_fails_on_total_fleet_loss(setup):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 100, 8).astype(np.int32) for _ in range(5)]

    def scenario(router):
        rids = [router.submit(p, max_new_tokens=4) for p in prompts]
        router.kill(0)
        router.step()
        router.check_invariants()
        return rids, router.has_work()

    router, (rids, busy) = both(setup, scenario, replicas=1, shed=50)
    assert all(router.completions[r].status == "failed" for r in rids) and not busy


def test_stall_detection_budget(setup):
    m = setup
    rng = np.random.default_rng(7)
    stream = [(0, rng.integers(0, 100, 8).astype(np.int32), 6) for _ in range(4)]
    want = drive_engine(m, SLOTTED, stream)

    def scenario(router):
        for i, (_, p, b) in enumerate(stream):
            router.submit(p, max_new_tokens=b, rid=i)
        router.step()
        router.replicas[0].stalled = True       # a hang, not a crash
        ticks = 0
        while router.replicas[0].state != "dead":
            router.step()
            router.check_invariants()
            ticks += 1
            assert ticks < 20
        router.run()
        return ticks, [list(router.completions[i].tokens) for i in range(len(stream))]

    router, (ticks, got) = both(setup, scenario, replicas=2, stall_budget=3)
    assert ticks >= router.rc.stall_budget - 1
    assert router.counters["stalls_detected"] == 1
    assert got == want
    assert all(c.status == "ok" for c in router.completions.values())


# ---------------------------------------------------------------------------
# Zero-downtime drain
# ---------------------------------------------------------------------------


def test_drain_migrates_and_preserves_streams(setup):
    m = setup
    stream = make_stream(np.random.default_rng(8), m["tcfg"].vocab)
    want = drive_engine(m, SLOTTED, stream)
    rng = np.random.default_rng(9)
    pa, pb = (rng.integers(0, 100, 8).astype(np.int32) for _ in range(2))

    def scenario(router):
        for i, (_, p, b) in enumerate(stream):
            router.submit(p, max_new_tokens=b, rid=i)
        for _ in range(3):
            router.step()
        moved = router.drain(0)
        drained = (router.replicas[0].state, router.replicas[0].engine.has_work())
        router.check_invariants()
        router.run()
        got = [list(router.completions[i].tokens) for i in range(len(stream))]
        ra = router.submit(pa, max_new_tokens=4)
        router.run()
        router.reinstate(0)
        rb = router.submit(pb, max_new_tokens=4)
        router.run()
        idle = router.drain(0)
        with pytest.raises(ValueError, match="not live"):
            router.drain(0)
        return moved, drained, got, router.placements[ra], router.placements[rb], idle

    router, (moved, drained, got, pa_at, pb_at, idle) = both(setup, scenario, replicas=2)
    assert moved == router.counters["migrated"] > 0
    assert drained == ("drained", False)
    assert got == want, "the drain perturbed a migrated stream"
    assert all(c.status == "ok" for c in router.completions.values())
    assert (pa_at, pb_at, idle) == (1, 0, 0)


def test_drain_requires_live_replica(setup):
    for router in (ref_router(setup, replicas=2), port_router(setup, replicas=2)):
        router.kill(1)
        with pytest.raises(ValueError, match="dead"):
            router.drain(1)


# ---------------------------------------------------------------------------
# Engine-level migration primitives
# ---------------------------------------------------------------------------


def test_export_import_roundtrip_mid_decode(setup):
    """Export off a mid-decode lane, import into another engine, finish
    there: bitwise the uninterrupted stream; also across the packages (the
    reference's export into the port's engine)."""
    m = setup
    rng = np.random.default_rng(10)
    pa = rng.integers(0, m["tcfg"].vocab, 10).astype(np.int32)
    pb = rng.integers(0, m["tcfg"].vocab, 6).astype(np.int32)
    mk = lambda: ServeEngine(m["tcfg"], m["tp"], EngineConfig(**SLOTTED), device="cpu",
                             aot=m["aot"])
    ref = mk()
    want_a = list(ref.run([pa], max_new_tokens=8)[0])
    want_b = list(ref.run([pb], max_new_tokens=5)[0])
    jsrc = JServeEngine(m["jcfg"], m["mesh"], m["rules"], m["jp"], JEngineConfig(**SLOTTED),
                        aot=m["jaot"])
    for src in (mk(), jsrc):
        dst = mk()
        ra = src.submit(pa, max_new_tokens=8)
        rb = src.submit(pb, max_new_tokens=5, rid=77)
        src.step()
        src.step()
        assert len(src.live[ra].tokens) >= 1
        snap = src.export_request(ra)
        assert snap["pending"]["resume"] is True and snap["completion"] is not None
        src.check_invariants()
        assert ra not in src.live
        dst.import_request(snap)
        dst.check_invariants()
        src.drain()
        dst.drain()
        assert list(dst.completions[ra].tokens) == want_a
        assert dst.completions[ra].status == "ok"
        assert list(src.completions[rb].tokens) == want_b
        assert src.counters["exported"] == 1 and dst.counters["imported"] == 1


def test_export_import_error_cases(setup):
    m = setup
    eng = ServeEngine(m["tcfg"], m["tp"], EngineConfig(**SLOTTED), device="cpu", aot=m["aot"])
    rid = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(KeyError):
        eng.export_request(rid + 999)
    snap = eng.export_request(rid)
    assert snap["pending"]["resume"] is False and snap["completion"] is None
    eng.import_request(snap)
    with pytest.raises(ValueError, match="already known"):
        eng.import_request(snap)
    eng.drain()
    with pytest.raises(ValueError, match="terminal"):
        eng.export_request(rid)
    bad = {"pending": dict(snap["pending"], resume=True), "completion": None}
    with pytest.raises(ValueError, match="without its"):
        eng.import_request(dict(bad, pending=dict(bad["pending"], rid=555)))


# ---------------------------------------------------------------------------
# FaultPlan's replica sites
# ---------------------------------------------------------------------------


def test_pick_victim_substream_does_not_perturb_fire_schedule():
    rates = {"replica_crash": 0.4}
    a, b = FaultPlan(123, rates), FaultPlan(123, rates)
    fired_a = [a.fire("replica_crash") for _ in range(50)]
    fired_b = [b.pick("replica_crash", [0, 1, 2]) is not None for _ in range(50)]
    assert fired_a == fired_b and any(fired_a)
    c, d, j = FaultPlan(123, rates), FaultPlan(123, rates), JFaultPlan(123, rates)
    picks = [c.pick("replica_crash", [0, 1, 2]) for _ in range(50)]
    assert picks == [d.pick("replica_crash", [0, 1, 2]) for _ in range(50)]
    assert picks == [j.pick("replica_crash", [0, 1, 2]) for _ in range(50)]


def test_replica_sites_extend_engine_sites():
    from repro.serve import FAULT_SITES as J_FAULT_SITES

    assert FAULT_SITES == ENGINE_FAULT_SITES + REPLICA_FAULT_SITES == J_FAULT_SITES
    assert FAULT_SITES[:4] == ("decode_logits", "prefill", "alloc", "sched_push")


# ---------------------------------------------------------------------------
# Port-specific: the hybrid family, one weight copy, the launcher, the card
# ---------------------------------------------------------------------------


def test_zamba_router_kill_matches_reference(mesh, rules):
    """A zamba (hybrid, slotted) fleet: replica 1 dies mid-episode; its
    requests re-prefill and replay on the survivor (recurrent state
    included), bitwise one engine's streams, as the reference's router."""
    m = _models("zamba2-1.2b")
    m.update(mesh=mesh, rules=rules, jaot=JAotCache("router-zamba"), aot=AotCache("router-zamba"))
    stream = make_stream(np.random.default_rng(12001), m["tcfg"].vocab)
    want = drive_engine(m, SLOTTED, stream)

    def scenario(router):
        i, tick = 0, 0
        while i < len(stream) or router.has_work():
            while i < len(stream) and stream[i][0] <= tick:
                _, prompt, budget = stream[i]
                router.submit(prompt, max_new_tokens=budget, rid=i)
                i += 1
            router.step()
            router.check_invariants()
            if router.replicas[1].state == "live" and any(
                    rec.replica == 1 and rec.tokens for rec in router.records.values()):
                router.kill(1)              # mid-decode: its lanes fail over
            tick += 1
            assert tick < 3000
        return [list(router.completions[r].tokens) for r in range(len(stream))]

    router, got = both(m, scenario, replicas=2)
    assert got == want
    assert all(c.status == "ok" for c in router.completions.values())
    assert router.counters["failovers"] > 0 and router.counters["replicas_dead"] == 1


def test_replicas_share_one_weight_copy(setup):
    """``cast_for_compute`` hands a leaf already of the compute dtype on
    the device back unchanged, so every replica holds the first one's
    tensors, the draft's too."""
    m = setup
    ec = dict(SLOTTED, spec_draft=m["tcfg"], spec_k=2)
    router = Router(m["tcfg"], m["tp"], EngineConfig(**ec), RouterConfig(replicas=3),
                    device="cpu", aot=AotCache("router-share"))
    first = router.replicas[0].engine
    ptrs = lambda tree: [t.data_ptr() for t in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    for h in router.replicas[1:]:
        assert ptrs(h.engine.params) == ptrs(first.params)
        assert ptrs(h.engine.draft_params) == ptrs(first.draft_params)
    assert len(ptrs(first.params)) > 0


def test_launcher_router_flags_on_cpu(capsys):
    from repro_torch.launch.serve import main

    router = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--requests", "8",
                   "--rate", "1000", "--new-tokens", "6", "--replicas", "2",
                   "--drain-at", "2", "--shed-queue-depth", "32"])
    out = capsys.readouterr().out
    assert "-- drained replica 1: migrated" in out
    assert "across 2 replica(s)" in out and "-- replica 0 [live]" in out
    assert "-- replica 1 [drained]" in out and "latency by status" in out
    st = router.stats
    assert st["status_ok"] == 8 and sum(st[f"status_{s}"] for s in STATUSES) == 8
    assert len(router.replicas) == 2 and router.rc.shed_queue_depth == 32


def test_launcher_static_engine_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--engine", "static",
                "--batch", "3", "--prompt-len", "8", "--new-tokens", "4"])
    assert out.shape == (3, 4)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("seq")]
    assert len(lines) == 3


def test_router_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router(cfg, None)

