"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``).

One counterpart for each test of ``tests/test_obs.py``, driving the
reference and the port side by side where the reference has one:

* metrics: the same samples give equal quantiles, merges and
  ``snapshot()`` JSON (the same float arithmetic in Python); counters are
  monotone behind the ``MetricMap`` facade, kinds never mix;
* tracer and flight recorder: the same calls on the same fake clock give
  the reference's events, exports and dumps;
* the engine under a shared fake clock: a traced drive with a preempt
  gives the reference engine's sequence of ``(name, rid, ph, ts)``; a
  traced drive is bitwise the untraced one with builds flat; an induced
  invariant failure dumps a recorder from which the request's timeline
  rebuilds;
* the router: a kill gives one ``terminal`` per request, as the
  reference's trace does;
* ``AotCache(obs=)`` build timing, a traced 2-step ``train`` (8 balanced
  spans), and the checkpoint manager's dumps on a failed save.

The card-only check (a traced decode replay launches what an untraced one
does) is in ``tests/test_torch_aot.py``, which imports no JAX.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.router import Router as JRouter
from repro.serve.router import RouterConfig as JRouterConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import (
    FlightRecorder,
    MetricMap,
    MetricsRegistry,
    Observer,
    Tracer,
    load_jsonl,
    merged_histogram,
    request_timeline,
    to_chrome_trace,
    to_jsonl,
    validate,
)
from repro_torch.serve import EngineConfig, Router, RouterConfig, ServeEngine

from test_engine_fuzz import make_stream

MAX_SLOTS, MAX_LEN = 3, 48
SLOTTED = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def setup(mesh, rules):
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), compute_dtype="float32")
    jp = jreg.get_module(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jaot, aot = JAotCache("obs-test"), AotCache("obs-test")
    JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(**SLOTTED), aot=jaot).prebuild()
    ServeEngine(tcfg, tp, EngineConfig(**SLOTTED), device="cpu", aot=aot).prebuild()
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp, jaot=jaot, aot=aot, mesh=mesh,
                rules=rules)


def port_engine(m, **kw):
    return ServeEngine(m["tcfg"], m["tp"], EngineConfig(**SLOTTED), device="cpu",
                       aot=m["aot"], **kw)


def ref_engine(m, **kw):
    return JServeEngine(m["jcfg"], m["mesh"], m["rules"], m["jp"], JEngineConfig(**SLOTTED),
                        aot=m["jaot"], **kw)


def shape(events):
    """What two packages' traces must share: each event's name, request
    id, phase and (fake-clock) timestamp, in order."""
    return [(e["name"], e.get("rid"), e["ph"], e["ts"]) for e in events]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def test_counter_monotone_gauge_absolute():
    snaps = []
    for mod in (jobs, None):
        reg = (mod.MetricsRegistry if mod else MetricsRegistry)("t")
        c = reg.counter("hits")
        c.inc()
        c.inc(3)
        assert c.value == 4
        with pytest.raises(ValueError):
            c.set(2)                       # counters never go backwards
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("depth")
        g.set(7)
        g.set(2)                           # gauges do
        assert g.value == 2
        g.set_max(5)
        g.set_max(3)                       # peak semantics
        assert g.value == 5
        reg.check()
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_kind_mixing_rejected():
    reg = MetricsRegistry("t")
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(TypeError):
        reg.histogram("x")
    assert reg.kind("x") == "counter"
    assert reg.kind("nope") is None
    assert reg.names() == jobs.MetricsRegistry("t").names() + ["x"]


def test_histogram_quantiles_match_exact_within_bucket_error():
    """Within ~10% of exact percentiles on a heavy-tailed sample, and
    exactly the reference's quantiles and snapshot on the same samples."""
    xs = np.random.default_rng(0).lognormal(mean=1.0, sigma=1.2, size=5000)
    reg, jreg_ = MetricsRegistry("t"), jobs.MetricsRegistry("t")
    h, jh = reg.histogram("lat"), jreg_.histogram("lat")
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    for q in (0.50, 0.90, 0.99):
        exact = float(np.percentile(xs, 100 * q))
        approx = h.quantile(q)
        assert abs(approx - exact) / exact < 0.10, (q, approx, exact)
    for q in np.linspace(0, 1, 101):
        assert h.quantile(float(q)) == jh.quantile(float(q))
    assert h.min == pytest.approx(xs.min()) and h.max == pytest.approx(xs.max())
    assert h.mean == pytest.approx(xs.mean(), rel=1e-6)
    assert json.dumps(reg.snapshot()) == json.dumps(jreg_.snapshot())
    for bad in (-1.0, float("nan")):
        with pytest.raises(ValueError):
            h.observe(bad)


def test_histogram_merge_equals_pooled_samples():
    rng = np.random.default_rng(1)
    a, b = rng.exponential(5.0, 400), rng.exponential(50.0, 300)
    outs = []
    for mod in (None, jobs):
        regs = [(mod.MetricsRegistry if mod else MetricsRegistry)(f"r{i}") for i in range(3)]
        for x in a:
            regs[0].histogram("lat").observe(float(x))
        for x in b:
            regs[1].histogram("lat").observe(float(x))
        # regs[2] never observed "lat": the merge skips it
        outs.append((mod.merged_histogram if mod else merged_histogram)("lat", regs))
    merged, jmerged = outs
    pooled = MetricsRegistry("p").histogram("lat")
    for x in np.concatenate([a, b]):
        pooled.observe(float(x))
    assert merged.count == pooled.count == 700
    assert merged.buckets == pooled.buckets == jmerged.buckets
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == pooled.quantile(q) == jmerged.quantile(q)
    assert (merged.sum, merged.min, merged.max) == (jmerged.sum, jmerged.min, jmerged.max)


def test_metricmap_facade_over_registry():
    snaps = []
    for mod in (None, jobs):
        reg = (mod.MetricsRegistry if mod else MetricsRegistry)("t")
        m = (mod.MetricMap if mod else MetricMap)(reg, ("a", "b", "peak"), gauges=("peak",))
        m["a"] += 1
        m["a"] += 2
        m["b"] += 5
        m["peak"] = 10
        m["peak"] = 4                      # gauge: absolute set allowed
        assert m["a"] == 3 and m["peak"] == 4
        assert dict(m) == {"a": 3, "b": 5, "peak": 4}
        assert m.copy() == dict(m)
        assert m.get("nope", 0) == 0
        with pytest.raises(ValueError):
            m["b"] = 1                     # counter: decrease rejected
        with pytest.raises(TypeError):
            del m["a"]
        snap = reg.snapshot()
        assert snap["a"] == {"kind": "counter", "value": 3}
        assert snap["peak"] == {"kind": "gauge", "value": 4}
        reg.check()
        snaps.append(snap)
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# Tracer and flight recorder units
# ---------------------------------------------------------------------------


def _trace(tracer_cls, clock):
    tr = tracer_cls(clock)
    tr.mark("submit", 0, plen=4)
    clock.t = 1.0
    with tr.span("decode", track="engine", lanes=2):
        clock.t = 2.0
        tr.mark("first_token", 0)
    tr.mark("terminal", 0, status="ok")
    return tr


def test_tracer_spans_balance_and_export(tmp_path):
    tr = _trace(Tracer, FakeClock())
    jtr = _trace(jobs.Tracer, FakeClock())
    assert tr.events == jtr.events
    info = validate(tr.events)
    assert info == {"events": 5, "spans": 1, "requests": 1, "terminals": 1}
    assert [e["name"] for e in request_timeline(tr.events, 0)] \
        == ["submit", "first_token", "terminal"]
    p = to_jsonl(tr.events, str(tmp_path / "t.jsonl"))
    assert load_jsonl(p) == tr.events
    doc = to_chrome_trace(tr.events, str(tmp_path / "t.json"))
    assert doc == jobs.to_chrome_trace(jtr.events)
    rows = doc["traceEvents"]
    assert json.load(open(tmp_path / "t.json")) == doc
    b = next(r for r in rows if r["ph"] == "B")
    assert b["ts"] == pytest.approx(1e6)
    assert {r["tid"] for r in rows if r["ph"] == "i"} == {1000}
    assert any(r["ph"] == "M" and r["args"]["name"] == "request 0" for r in rows)


def test_validate_rejects_malformed_streams():
    tr = Tracer(FakeClock())
    sid = tr.begin("decode")
    with pytest.raises(AssertionError):
        validate(tr.events)            # span left open
    tr.end(sid)
    validate(tr.events)

    tr2 = Tracer(FakeClock())
    tr2.mark("admit", 3)               # lifecycle not starting at submit
    with pytest.raises(AssertionError):
        validate(tr2.events)

    tr3 = Tracer(FakeClock())
    tr3.mark("submit", 1)
    tr3.mark("terminal", 1, status="ok")
    tr3.mark("decode", 1)              # event after terminal
    with pytest.raises(AssertionError):
        validate(tr3.events)

    clock = FakeClock()
    tr4 = Tracer(clock)
    clock.t = 2.0
    tr4.instant("a")
    clock.t = 1.0
    tr4.instant("b")                   # time went backwards
    with pytest.raises(AssertionError, match="backwards"):
        validate(tr4.events)


def test_flight_recorder_ring_bounds_and_dump(tmp_path):
    docs = []
    for cls, d in ((FlightRecorder, tmp_path / "port"), (jobs.FlightRecorder, tmp_path / "ref")):
        rec = cls(capacity=8, clock=FakeClock(), dump_dir=str(d))
        for i in range(20):
            rec.record("tick", i=i)
        assert len(rec.events()) == 8
        assert rec.recorded == 20 and rec.dropped == 12
        assert [e["args"]["i"] for e in rec.events()] == list(range(12, 20))
        assert all(e["seq"] == 12 + j for j, e in enumerate(rec.events()))
        path = rec.dump("test_reason", context={"k": "v"})
        doc = json.load(open(path))
        assert doc["reason"] == "test_reason" and doc["context"] == {"k": "v"}
        assert doc["recorded"] == 20 and doc["dropped"] == 12 and len(doc["events"]) == 8
        assert rec.dumps == 1 and rec.last_dump == path
        assert path.endswith("flightrec_000.json")
        docs.append(doc)
    assert docs[0] == docs[1]
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_flight_recorder_dump_names_never_collide(tmp_path):
    a = FlightRecorder(capacity=4, clock=FakeClock(), dump_dir=str(tmp_path))
    b = FlightRecorder(capacity=4, clock=FakeClock(), dump_dir=str(tmp_path))
    a.record("from_a")
    b.record("from_b")
    paths = [a.dump("a0"), b.dump("b0"), a.dump("a1")]
    assert len(set(paths)) == 3, f"dump paths collided: {paths}"
    assert {json.load(open(p))["reason"] for p in paths} == {"a0", "b0", "a1"}
    # a fresh recorder resumes after the highest existing index, gaps and all
    (tmp_path / "flightrec_041.json").write_text("{}")
    c = FlightRecorder(capacity=4, clock=FakeClock(), dump_dir=str(tmp_path))
    assert c.dump("c0").endswith("flightrec_042.json")
    # and so does the reference's, in the same directory
    j = jobs.FlightRecorder(capacity=4, clock=FakeClock(), dump_dir=str(tmp_path))
    assert j.dump("j0").endswith("flightrec_043.json")


def test_observer_child_isolates_metrics_shares_timeline():
    obs = Observer.full(clock=FakeClock(), name="router")
    c0, c1 = obs.child("replica0"), obs.child("replica1")
    c0.metrics.counter("decode_steps").inc()
    c1.metrics.counter("decode_steps").inc(5)
    assert c0.metrics.counter("decode_steps").value == 1
    assert c1.metrics.counter("decode_steps").value == 5
    c0.mark("submit", 0, track=c0.name)
    c1.mark("submit", 1, track=c1.name)
    assert len(obs.tracer.events) == 2          # one shared timeline
    assert len(obs.recorder.events()) == 2      # mirrored into the ring
    bare = Observer(name="x")                   # no tracer or recorder: no-ops
    bare.mark("submit", 0)
    bare.instant("i")
    bare.record("r")
    assert bare.begin("s") is None and bare.dump("d") is None
    with bare.span("s"):
        pass
    assert tobs.__all__ == jobs.__all__


# ---------------------------------------------------------------------------
# Engine trace schema (preempt-and-requeue drive), against the reference
# ---------------------------------------------------------------------------


def _preempt_drive(m, mk):
    """Seven requests on three lanes, the lane 0 occupant preempted after
    the second step; returns (observer, engine, rids, preempted rid)."""
    clock = FakeClock()
    obs = (jobs.Observer if mk is ref_engine else Observer).full(clock=clock, name="engine")
    eng = mk(m, obs=obs, clock=clock)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, m["tcfg"].vocab, 6).astype(np.int32),
                       max_new_tokens=4) for _ in range(2 * MAX_SLOTS + 1)]
    tick, preempted = 0, None
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        if tick == 1 and eng.slots[0] is not None:
            preempted = eng.slots[0].rid
            eng.preempt(0)
        clock.t += 1.0
        tick += 1
        assert tick < 200
    return obs, eng, rids, preempted


def test_engine_trace_schema_with_preempt(setup):
    obs, eng, rids, preempted = _preempt_drive(setup, port_engine)
    jobs_, jeng, _, jpreempted = _preempt_drive(setup, ref_engine)
    assert shape(obs.tracer.events) == shape(jobs_.tracer.events)
    assert preempted == jpreempted is not None
    info = validate(obs.tracer.events)
    assert info == jobs.validate(jobs_.tracer.events)
    assert info["requests"] == info["terminals"] == len(rids)
    assert info["spans"] > 0
    for rid in rids:
        names = [e["name"] for e in request_timeline(obs.tracer.events, rid)]
        assert names[0] == "submit" and names[-1] == "terminal"
        assert "admit" in names and "first_token" in names
    assert "preempt" in [e["name"] for e in request_timeline(obs.tracer.events, preempted)]
    assert obs.metrics.histogram("ttft_ms_ok").count == len(rids)
    assert obs.metrics.histogram("tpot_ms_ok").count == len(rids)
    assert eng.counters["preemptions"] >= 1
    # the same fake-clock latencies: the same histograms
    snap, jsnap = obs.metrics.snapshot(), jobs_.metrics.snapshot()
    for k in ("ttft_ms_ok", "tpot_ms_ok", "kv_peak_used_bytes", "decode_steps"):
        assert snap[k] == jsnap[k], k


def test_trace_zero_cost_when_disabled(setup):
    eng = port_engine(setup)
    assert eng.obs.tracer is None and eng.obs.recorder is None
    eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=2)
    while eng.has_work():
        eng.step()
    assert eng.counters["decode_steps"] > 0
    assert eng.obs.metrics.histogram("ttft_ms_ok").count == 1
    assert eng.obs.dump("nothing") is None
    assert eng.obs.metrics.kind("kv_peak_used_bytes") == "gauge"
    assert eng.counters["kv_peak_used_bytes"] > 0
    with pytest.raises(ValueError, match="decrease"):
        eng.counters["decode_steps"] = 0


# ---------------------------------------------------------------------------
# Flight-recorder dump on an induced invariant failure
# ---------------------------------------------------------------------------


def test_invariant_failure_dumps_flight_recorder(setup, tmp_path):
    clock = FakeClock()
    obs = Observer.full(clock=clock, dump_dir=str(tmp_path), name="engine")
    eng = port_engine(setup, obs=obs, clock=clock)
    rid = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        clock.t += 1.0
    # corrupt a status counter upward (the metric layer allows it, the
    # conservation sweep does not)
    eng.counters["status_failed"] += 1
    with pytest.raises(AssertionError, match="status counters"):
        eng.check_invariants()
    assert obs.recorder.dumps == 1
    doc = json.load(open(obs.recorder.last_dump))
    assert doc["reason"] == "engine_invariant_failure"
    assert "status counters" in doc["context"]["error"]
    assert doc["context"]["counters"]["status_failed"] == 1
    names = [e["name"] for e in request_timeline(doc["events"], rid)]
    assert names[0] == "submit" and names[-1] == "terminal"
    assert "admit" in names and "first_token" in names


# ---------------------------------------------------------------------------
# Tracing is behavior-invisible (fuzz stream, fake clock, builds flat)
# ---------------------------------------------------------------------------


def test_traced_drive_is_bitwise_and_builds_flat(setup):
    m = setup

    def drive(obs):
        clock = FakeClock()
        if obs is not None:
            obs.tracer.clock = clock            # one clock, both views
        eng = port_engine(m, obs=obs, clock=clock)
        stream = make_stream(np.random.default_rng(31337), m["tcfg"].vocab)
        i, tick = 0, 0
        while i < len(stream) or eng.has_work():
            while i < len(stream) and stream[i][0] <= tick:
                _, prompt, budget = stream[i]
                eng.submit(prompt, max_new_tokens=budget, rid=i)
                i += 1
            eng.step()
            eng.check_invariants()
            clock.t += 1.0
            tick += 1
            assert tick < 2000
        return [list(eng.completions[r].tokens) for r in range(len(stream))], eng

    builds0 = m["aot"].stats["builds"]
    want, plain = drive(None)
    obs = Observer.full(clock=FakeClock(), name="engine")
    got, traced = drive(obs)
    assert got == want, "arming the observer changed greedy tokens"
    assert m["aot"].stats["builds"] == builds0, "tracing built programs"
    assert traced.counters.copy() == plain.counters.copy()
    info = validate(obs.tracer.events)
    assert info["terminals"] == len(want)


# ---------------------------------------------------------------------------
# Router trace: failover and one terminal per request fleet-wide
# ---------------------------------------------------------------------------


def _router_drive(m, port: bool):
    clock = FakeClock()
    if port:
        obs = Observer.full(clock=clock, name="router")
        router = Router(m["tcfg"], m["tp"], EngineConfig(**SLOTTED),
                        RouterConfig(replicas=2, shed_queue_depth=10_000), device="cpu",
                        aot=m["aot"], clock=clock, obs=obs)
    else:
        obs = jobs.Observer.full(clock=clock, name="router")
        router = JRouter(m["jcfg"], m["mesh"], m["rules"], m["jp"], JEngineConfig(**SLOTTED),
                         JRouterConfig(replicas=2, shed_queue_depth=10_000), aot=m["jaot"],
                         clock=clock, obs=obs)
    rng = np.random.default_rng(2)
    for i in range(6):
        router.submit(rng.integers(0, m["tcfg"].vocab, 6).astype(np.int32),
                      max_new_tokens=4, rid=i)
    tick = 0
    while router.has_work():
        router.step()
        router.check_invariants()
        if tick == 1:
            router.kill(1)             # strand replica 1's in-flight work
        clock.t += 1.0
        tick += 1
        assert tick < 500
    return obs, router


def test_router_trace_failover_single_terminal(setup):
    obs, router = _router_drive(setup, port=True)
    jobs_, _ = _router_drive(setup, port=False)
    assert shape(obs.tracer.events) == shape(jobs_.tracer.events)
    info = validate(obs.tracer.events)
    assert info["requests"] == info["terminals"] == 6
    assert router.counters["failovers"] > 0
    failover_rids = {e["rid"] for e in obs.tracer.events
                     if e.get("cat") == "request" and e["name"] == "failover"}
    assert failover_rids
    for rid in failover_rids:
        names = [e["name"] for e in request_timeline(obs.tracer.events, rid)]
        assert names.index("route") < names.index("failover") < names.index("terminal")
    regs = [router.obs.metrics] + [h.engine.obs.metrics for h in router.replicas]
    merged = merged_histogram("ttft_ms_ok", regs)
    assert merged.count == sum(1 for c in router.completions.values() if c.status == "ok")


# ---------------------------------------------------------------------------
# AotCache build profiling
# ---------------------------------------------------------------------------


def test_aot_build_timing_and_top_builds():
    obs = Observer.full(clock=FakeClock(), name="aot")
    aot = AotCache("t", obs=obs)
    aot.get("slow", lambda: sum(range(200_000)))
    aot.get("fast", lambda: 1)
    aot.get("slow", lambda: 1)                  # hit: no re-time
    assert aot.stats == {"builds": 2, "cache_hits": 1}
    assert set(aot.build_seconds) == {"slow", "fast"}
    assert all(s >= 0.0 for s in aot.build_seconds.values())
    assert aot.build_s_total == pytest.approx(sum(aot.build_seconds.values()))
    top = aot.top_builds(5)
    assert [k for k, _ in top] == sorted(aot.build_seconds, key=aot.build_seconds.get,
                                         reverse=True)
    info = validate(obs.tracer.events)
    assert info["spans"] == 2
    assert all(e["name"] == "aot_build" and e["track"] == "t" for e in obs.tracer.events)
    assert [e["args"]["key"] for e in obs.tracer.events if e["ph"] == "B"] == ["slow", "fast"]
    assert AotCache("bare").obs is None


# ---------------------------------------------------------------------------
# Train loop profiling, checkpoint failures
# ---------------------------------------------------------------------------


def test_train_loop_traced_smoke():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import single_device_group
    from repro_torch.optim import OptConfig
    from repro_torch.train import LoopConfig, TrainSettings, train

    cfg = get_smoke_config("smollm-360m")
    obs = Observer(tracer=Tracer(), name="train")
    res = train(cfg, ShapeConfig("t", "train", 16, 8), single_device_group("cpu"),
                OptConfig(kind="adam", lr=1e-2), TrainSettings(),
                LoopConfig(steps=2, ckpt_every=0, log_every=0), obs=obs)
    snap = res["metrics"]
    assert snap["step_ms"]["count"] == 2 and snap["step_ms"]["p50"] > 0
    info = validate(obs.tracer.events)
    names = [e["name"] for e in obs.tracer.events if e["ph"] == "B"]
    assert info["spans"] == 8                   # four phase spans a step, balanced
    for phase in ("stage_batch", "h2d", "dispatch", "device_wait"):
        assert names.count(phase) == 2
    # metrics without a tracer: the histogram, no spans
    plain = Observer(name="train")
    res = train(cfg, ShapeConfig("t", "train", 16, 8), single_device_group("cpu"),
                OptConfig(kind="adam", lr=1e-2), TrainSettings(),
                LoopConfig(steps=1, ckpt_every=0, log_every=0), obs=plain)
    assert res["metrics"]["step_ms"]["count"] == 1


def test_checkpoint_failures_dump_flight_recorder(tmp_path, monkeypatch):
    from repro_torch.checkpoint import CheckpointManager

    obs = Observer.full(clock=FakeClock(), dump_dir=str(tmp_path / "rec"), name="ckpt")
    mgr = CheckpointManager(str(tmp_path / "ck"), save_retries=2, sleep=lambda s: None,
                            obs=obs)

    def broken(step, host, meta):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write_once", broken)
    with pytest.raises(OSError):
        mgr.save(1, {"p": {"w": np.zeros(2)}})
    doc = json.load(open(obs.recorder.last_dump))
    assert doc["reason"] == "checkpoint_save_retries_exhausted"
    assert doc["context"]["attempts"] == 2 and "disk full" in doc["context"]["error"]
    mgr.save(2, {"p": {"w": np.zeros(2)}}, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    doc = json.load(open(obs.recorder.last_dump))
    assert doc["reason"] == "checkpoint_async_save_failed"
    # the background save exhausted its retries too (a dump of its own)
    assert obs.recorder.dumps == 3
    assert [e["name"] for e in obs.recorder.events()] == [
        "ckpt_retry_exhausted", "ckpt_retry_exhausted", "ckpt_async_failure"]
