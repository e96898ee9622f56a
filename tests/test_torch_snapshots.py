"""Engine snapshots and per-request migration in the port, against the
JAX reference.

At smoke width in fp32 on the CPU:

* ``snapshot()`` after N steps equals the reference engine's on the same
  traffic and clock: the queue (live lanes as resumes, then the queue,
  then the parked), the live and finished Completions, ``next_rid`` and
  the counters both packages have;
* a JSON round trip through ``save_snapshot``/``restore_snapshot`` (the
  port's ``CheckpointManager``) into a fresh engine finishes every stream
  bitwise, and the restored engine's own snapshot equals the saved one;
* the restore guards raise as the reference's do (format, arch, config,
  a non-fresh engine);
* ``export_request``/``import_request`` between two port engines sharing
  an ``AotCache`` (and a ``HostTier``: the migrated lane restores by
  copy) for a mid-decode lane, a queued request and a parked one; the
  reference's migration error cases (``tests/test_router.py``);
* a request exported by the reference engine mid-decode finishes in the
  port's engine with the reference's stream, and the other way round.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.core.aot import AotCache as JAotCache
from repro.models import registry as jreg
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.aot import AotCache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, HostTier, ServeEngine

MAX_SLOTS, MAX_LEN, BS = 3, 48, 8
# paged, prefix cache, preemption on a small pool, a tier with parking: the
# snapshot sees live lanes, queued resumes and parked requests
TIERED = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=BS,
              num_blocks=6, prefix_cache=True, admission="preempt", host_tier=True,
              park_idle_s=3.0)
SLOTTED = dict(max_slots=2, max_len=MAX_LEN)


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
    return jcfg, jp, tcfg, tp, JAotCache("snapshots"), AotCache("snapshots")


def port(models, fields=TIERED, **kw):
    _, _, tcfg, tp, _, aot = models
    return ServeEngine(tcfg, tp, EngineConfig(**fields), device="cpu",
                       clock=kw.pop("clock", FakeClock()), aot=aot, **kw)


def ref(models, mesh, rules, fields=TIERED):
    jcfg, jp, _, _, jaot, _ = models
    return JServeEngine(jcfg, mesh, rules, jp, JEngineConfig(**fields), aot=jaot,
                        clock=FakeClock())


PROMPTS = [np.arange(1, 1 + n, dtype=np.int32) * 7 % 251 for n in (5, 9, 13, 7, 20)]
BUDGETS = [6, 8, 5, 7, 6]


def submit_all(eng):
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(p, max_new_tokens=b, rid=i)


def advance(eng, steps, *, hold_at=None):
    """``steps`` engine steps on the fake clock; at step ``hold_at`` hold
    the first decoding lane (it parks three clock units later)."""
    for k in range(steps):
        if k == hold_at:
            lane = next(i for i, s in enumerate(eng.slots)
                        if s is not None and s.generated >= 1 and not s.held)
            assert eng.hold(eng.slots[lane].rid)
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0


def uninterrupted(models):
    eng = port(models, SLOTTED)
    submit_all(eng)
    eng.drain()
    return [list(eng.completions[r].tokens) for r in range(len(PROMPTS))]


def drain_all(eng):
    while eng.has_work():
        for rid in sorted(eng.parked):
            eng.release(rid)
        for s in list(eng.slots):
            if s is not None and s.held:
                eng.release(s.rid)
        eng.step()
        eng.check_invariants()
        eng.clock.t += 1.0


def test_snapshot_matches_reference(models, mesh, rules):
    """After the same steps on the same traffic and clock, the two
    packages' snapshots agree field by field (the counters on the keys
    both have), with live lanes, queued resumes and a parked request in
    them."""
    snaps = []
    for eng in (port(models), ref(models, mesh, rules)):
        submit_all(eng)
        advance(eng, 9, hold_at=5)
        assert eng.parked and eng.counters["preemptions"] > 0
        snaps.append(json.loads(json.dumps(eng.snapshot())))
    got, want = snaps
    for k in ("format", "arch", "engine", "queue", "live", "completions", "next_rid"):
        assert got[k] == want[k], k
    common = set(got["counters"]) & set(want["counters"])
    assert {"spills", "restores", "parked", "holds", "exported"} <= common
    assert {k: got["counters"][k] for k in common} == {k: want["counters"][k] for k in common}
    assert any(r["resume"] for r in got["queue"]) and got["completions"]


def test_snapshot_json_roundtrip_finishes_bitwise(models, tmp_path):
    want = uninterrupted(models)
    eng = port(models)
    submit_all(eng)
    advance(eng, 9, hold_at=5)
    assert eng.parked and eng.counters["preemptions"] > 0
    mgr = CheckpointManager(str(tmp_path))
    eng.save_snapshot(mgr, 7)
    saved = eng.snapshot()
    del eng
    eng2 = port(models)
    assert eng2.restore_snapshot(mgr) == 7
    again = eng2.snapshot()
    for k in saved:
        if k != "counters":           # snapshot_restores differs
            assert again[k] == saved[k], k
    assert eng2.counters["snapshot_restores"] == 1
    drain_all(eng2)
    assert [list(eng2.completions[r].tokens) for r in range(len(PROMPTS))] == want
    assert all(c.status == "ok" for c in eng2.completions.values())
    with pytest.raises(KeyError, match="no engine snapshot"):
        mgr.save(8, {})
        port(models).restore_snapshot(mgr, 8)


def test_restore_guards(models):
    eng = port(models)
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    snap = eng.snapshot()
    with pytest.raises(ValueError, match="fresh"):
        eng.restore(snap)
    with pytest.raises(ValueError, match="EngineConfig"):
        port(models, {**TIERED, "max_slots": 2}).restore(snap)
    with pytest.raises(ValueError, match="format"):
        port(models).restore(dict(snap, format=99))
    with pytest.raises(ValueError, match="arch"):
        port(models).restore(dict(snap, arch="zamba2-1.2b"))
    fresh = port(models)
    fresh.restore(snap)
    fresh.drain()
    assert fresh.completions[0].status == "ok"


def test_export_import_between_port_engines(models):
    """A mid-decode lane, a queued request and a parked one move from one
    engine to another (a shared program cache and tier): every stream
    finishes bitwise, and the migrated lane restores by copy there."""
    want = uninterrupted(models)
    tier = HostTier()
    fields = {**TIERED, "num_blocks": 13, "max_slots": 2}
    src, dst = port(models, fields, host_tier=tier), port(models, fields, host_tier=tier)
    submit_all(src)
    advance(src, 6, hold_at=2)
    assert src.aot is dst.aot
    parked = sorted(src.parked)[0]
    lane = next(s.rid for s in src.slots if s is not None and s.generated >= 1)
    queued = next(r.rid for r in src.queue if not r.resume)
    for rid, kind in ((lane, "lane"), (queued, "queued"), (parked, "parked")):
        snap = json.loads(json.dumps(src.export_request(rid)))
        assert snap["pending"]["resume"] == (kind != "queued")
        assert (snap["completion"] is None) == (kind == "queued")
        src.check_invariants()
        dst.import_request(snap, front=kind != "queued")
        dst.check_invariants()
    assert tier.has_lane(lane)
    drain_all(src)
    drain_all(dst)
    moved = {lane, queued, parked}
    for r in range(len(PROMPTS)):
        eng = dst if r in moved else src
        assert list(eng.completions[r].tokens) == want[r], r
        assert eng.completions[r].status == "ok"
    assert src.counters["exported"] == 3 == dst.counters["imported"]
    assert dst.counters["restores"] >= 2 and dst.counters["replayed_tokens"] == 0
    assert tier.spilled_lanes == 0


def test_export_import_error_cases(models):
    eng = port(models, SLOTTED)
    rid = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(KeyError):
        eng.export_request(rid + 999)
    snap = eng.export_request(rid)          # still queued: a fresh export
    assert snap["pending"]["resume"] is False and snap["completion"] is None
    eng.import_request(snap)
    with pytest.raises(ValueError, match="already known"):
        eng.import_request(snap)
    eng.drain()
    with pytest.raises(ValueError, match="terminal"):
        eng.export_request(rid)
    bad = {"pending": dict(snap["pending"], resume=True, rid=555), "completion": None}
    with pytest.raises(ValueError, match="without its"):
        eng.import_request(bad)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_cross_package_migration(models, mesh, rules, direction):
    """A request exported mid-decode by one package imports into the
    other's engine and finishes with the uninterrupted stream (the JSON
    carries only host truth)."""
    want = uninterrupted(models)
    make_src, make_dst = ((lambda: ref(models, mesh, rules), lambda: port(models))
                          if direction == "reference_to_port"
                          else (lambda: port(models), lambda: ref(models, mesh, rules)))
    src, dst = make_src(), make_dst()
    submit_all(src)
    advance(src, 4)
    rid = next(s.rid for s in src.slots if s is not None and s.generated >= 2)
    snap = json.loads(json.dumps(src.export_request(rid)))
    assert snap["pending"]["resume"] and snap["completion"]["tokens"]
    dst.import_request(snap, front=True)
    dst.drain()
    dst.check_invariants()
    assert list(dst.completions[rid].tokens) == want[rid]
    assert dst.completions[rid].status == "ok"
    assert dst.counters["imported"] == 1
