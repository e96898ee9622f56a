"""Multi-replica serving front-end: a health-checked router.

The port of the reference's ``serve/router.py``: the same names,
counters, statuses and tick semantics over the port's engines.

The :class:`Router` owns the fleet-level admission queue and drives N
in-process :class:`~repro_torch.serve.engine.ServeEngine` replicas — the
Synkhronos worker abstraction taken fleet-scale: clients keep the serial
``submit / completions`` surface of a single engine while the router
handles placement, failure, and capacity across replicas.  Everything is
deterministic and host-side: an injectable clock, seeded replica faults
(:class:`~repro_torch.serve.faults.FaultPlan`), and a tick loop (:meth:`step`)
whose behaviour is a pure function of (stream, seeds, config) — the same
discipline that makes the engine fuzzers replayable.

Four capabilities:

**Routing policy.**  Least-loaded by default (ties break to the lowest
replica index).  When the engines run a prefix cache, routing is
*cache-aware*: the rolling-hash chain of the prompt (``prefix_keys``,
the prefix cache's index) is probed against every accepting replica's published-block
index, and the replica with the longest matched chain wins — a shared
prefix only pays prefill once per replica instead of once per request.

**Crash failover.**  Replica faults are injected at two plan sites:
``replica_crash`` (the engine process dies — its host state is gone) and
``replica_stall`` (it hangs without dying; a step-budget health check
detects the missing progress).  Either way the router declares the
replica dead and NEVER touches its engine again: every in-flight request
is rebuilt from the router's own stream mirror — prompt, sampling state,
and the tokens observed so far — and requeued at the admission-queue
front as a resume.  Re-admission on a survivor re-prefills the prompt
and replays the mirrored tokens through decode, so the completed stream
is bitwise the fault-free one under greedy decoding (the engine's replay
property).  Failover is bounded per request (``max_failovers``);
exhaustion is a structured ``"failed"`` completion, not an exception.

**Graceful degradation.**  The admission queue is bounded: a submit
beyond ``shed_queue_depth`` terminates immediately with status
``"shed"`` (a first-class terminal status — shed costs nothing, while
an admitted request that times out at 90% completion wasted a lane).
When deadlines are in play the router also sheds *early*: a request
whose TTL cannot cover the estimated queue wait (EWMA of recent service
times over the fleet's live lane capacity) is hopeless at admission time
and dropped before it queues.  As replicas die the fleet degrades in
throughput, never in correctness.

**Zero-downtime drain.**  :meth:`drain` stops admission to one replica
and synchronously migrates everything it holds onto the survivors via
the engine's per-request export (preempt + serialize) / import (requeue
elsewhere) path — no request is lost, no stream perturbed.  This is the
enabling primitive for live weight swap: drain, republish weights,
:meth:`reinstate`.

**Builds the router can see.**  On a CUDA device each replica captures
its decode (or spec) graph at its own first decode step, in its own
``engine.graphs`` cache, not in the shared program cache.  A capture is
a build like any other, so the compile-clean guard of the service-time
EWMA counts the shared cache's builds and every replica's graph builds
(:meth:`Router.fleet_builds`), and :attr:`Router.stats` reports both
(``builds`` and ``graph_builds``, ``executables`` and ``graphs``).  On
the CPU no graph is captured and the two counts are the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.core.aot import AotCache
from repro_torch.device import resolve_device
from repro_torch.obs import MetricMap, Observer
from .engine import STATUSES, Completion, EngineConfig, MeshClock, ServeEngine
from .faults import FaultPlan
from .paged import HostTier, prefix_keys


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    replicas: int = 2
    # bounded admission queue: a submit arriving when the router queue
    # already holds this many requests terminates with status "shed"
    shed_queue_depth: int = 64
    # health check: a replica holding work that makes no progress for
    # this many consecutive router ticks is declared dead and failed over
    stall_budget: int = 3
    # per-request budget of crash/stall migrations before the request
    # terminates "failed" (drain migrations don't count — the source
    # engine is healthy and the export is lossless)
    max_failovers: int = 3
    # extra queued requests a replica may hold beyond its decode lanes
    # before the router stops feeding it (0 = dispatch only into lanes)
    dispatch_depth: int = 0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("need at least one replica")
        if self.shed_queue_depth < 1:
            raise ValueError("shed_queue_depth must be >= 1")
        if self.stall_budget < 1:
            raise ValueError("stall_budget must be >= 1")


@dataclasses.dataclass
class _Record:
    """The router's own durable truth for one in-flight request.

    Mirrors of the placed replica's emitted stream are synced after
    every replica step; crash failover reads ONLY these mirrors — a
    dead engine's host dicts are off-limits, exactly as they would be
    after a real process death."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    submit_time: float
    deadline: float | None
    limit: int
    replica: int | None = None     # current placement (None = router queue)
    dispatch_time: float = 0.0
    # fleet build count (program cache and graphs) at dispatch: if it
    # advanced by collection time,
    # the service interval absorbed a compile and must not feed the
    # shed-policy EWMA (see _collect)
    dispatch_builds: int = 0
    failovers: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    retries: int = 0


class ReplicaHandle:
    """One engine replica plus the router's health view of it."""

    def __init__(self, idx: int, engine: ServeEngine):
        self.idx = idx
        self.engine = engine
        self.state = "live"        # "live" | "drained" | "dead"
        self.stalled = False       # injected hang: step() stops advancing
        self.last_progress = 0     # router tick of the last observed progress

    def load(self) -> int:
        """Distinct in-flight requests this replica owns (lane occupants
        and queued resumes are both in ``live``; fresh queued requests
        are counted from the queue)."""
        e = self.engine
        return len(e.live) + sum(1 for r in e.queue if not r.resume)

    def accepting(self, capacity: int) -> bool:
        return self.state == "live" and self.load() < capacity


class Router:
    """Deterministic host-side front-end over N engine replicas.

    Construction mirrors :class:`ServeEngine` — the same (cfg, params,
    device) plus the per-replica :class:`EngineConfig` and the fleet
    :class:`RouterConfig`; on the card unless ``device="cpu"`` (it raises
    without one).  All replicas share one :class:`AotCache` (identical
    configs -> identical program keys, so the fleet builds each program
    once; each replica still captures its own graph) and the first
    replica's cast params: ``cast_for_compute`` returns a leaf already of
    the compute dtype on the device unchanged, so N replicas hold one
    device copy of the weights (and of the draft's).

    ``faults`` is consulted at the two ``replica_*`` sites once per
    :meth:`step`; engine-level fault plans (the four per-engine sites)
    can be attached per replica via ``engine_faults``.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.MeshGroup` over a process
    group): every replica is an engine on it (``ServeEngine(mesh=)``: one
    shard of the weights a rank, shared by the replicas), every rank runs
    the router, and the router and its replicas read one
    :class:`~repro_torch.serve.engine.MeshClock`, so every rank takes the
    same decisions.  A drain migrates requests through the engines' export
    and import on every rank alike, and a fleet tier is each rank's own,
    holding its share of every payload (``serve.paged.Share``).
    """

    def __init__(
        self,
        cfg,
        params,
        engine: EngineConfig = EngineConfig(),  # noqa: B008 - frozen, never mutated
        router: RouterConfig = RouterConfig(),  # noqa: B008 - frozen, never mutated
        *,
        device=None,
        aot: AotCache | None = None,
        clock: Callable[[], float] = time.perf_counter,
        faults: FaultPlan | None = None,
        engine_faults: list[FaultPlan | None] | None = None,
        obs: Observer | None = None,
        draft_params=None,
        mesh=None,
    ):
        if mesh is not None and mesh.pg is not None:
            device = mesh.device
            clock = MeshClock(clock, mesh)
        device = resolve_device(device)
        if engine_faults is not None and len(engine_faults) != router.replicas:
            raise ValueError("engine_faults must have one entry per replica")
        self.econ = engine
        self.rc = router
        self.clock = clock
        self.faults = faults
        # the router keeps its own metrics registry; each replica engine
        # gets a child Observer (fresh registry so per-replica counters
        # never collide) sharing the router's tracer/recorder so every
        # event lands on one fleet timeline
        self.obs = obs if obs is not None else Observer(name="router")
        self._track = self.obs.name
        # NOT ``aot or ...``: AotCache defines __len__ (see ServeEngine)
        self.aot = aot if aot is not None else AotCache("router", obs=self.obs)
        # one host tier for the FLEET: request ids are router-unique and
        # payloads are host (pinned) tensors, so a crashed replica's lane spills
        # survive it — failover on a survivor restores O(copy) instead
        # of replaying the stream — and any replica can serve another's
        # spilled prefix chains
        self.tier = HostTier(engine.host_tier_blocks) \
            if engine.host_tier else None
        self.replicas: list[ReplicaHandle] = []
        dev_params = params
        dev_draft = draft_params
        for i in range(router.replicas):
            eng = ServeEngine(
                cfg, dev_params, engine, device=device, aot=self.aot,
                clock=clock,
                faults=engine_faults[i] if engine_faults else None,
                obs=self.obs.child(f"replica{i}"),
                host_tier=self.tier,
                draft_params=dev_draft, mesh=mesh)
            dev_params = eng.params     # share the cast copy fleet-wide
            dev_draft = eng.draft_params    # ditto for the draft weights
            self.replicas.append(ReplicaHandle(i, eng))
        self.queue: deque[_Record] = deque()
        self.records: dict[int, _Record] = {}
        self.completions: dict[int, Completion] = {}
        self.placements: dict[int, int] = {}    # rid -> last replica index
        self.counters = MetricMap(self.obs.metrics, (
            "submitted", "dispatched", "cache_routed",
            "migrated", "failovers", "replicas_dead",
            "stalls_injected", "stalls_detected",
            *(f"status_{st}" for st in STATUSES),
        ))
        self.tick = 0
        self._next_rid = 0
        # EWMA of dispatch->finish seconds for "ok" completions; feeds the
        # deadline-aware early shed (None until the first completion)
        self._ewma_service: float | None = None

    # ------------------------------------------------------------------
    # Client surface
    # ------------------------------------------------------------------
    def prebuild(self) -> None:
        """Build the fleet's programs (one build per key — the cache is
        shared, so this costs the same as a single engine).  Each replica
        captures its graph at its own first decode step."""
        for h in self.replicas:
            h.engine.prebuild()

    def fleet_builds(self) -> int:
        """Builds the fleet has done: the shared program cache's and every
        replica's graph captures (the compile-clean guard's count)."""
        return self.aot.stats["builds"] + sum(
            h.engine.graphs.stats["builds"] for h in self.replicas)

    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, rid: int | None = None,
               deadline_s: float | None = None) -> int:
        """Queue a request fleet-wide; returns its request id.  Same
        surface as ``ServeEngine.submit`` — the caller cannot tell it is
        talking to a fleet until it reads ``stats``.  May terminate the
        request immediately with status ``"shed"`` (see the module
        docstring); the rid is always valid in ``completions`` or in
        flight."""
        prompt = self.replicas[0].engine.validate(prompt, max_new_tokens)
        eff_k = int(self.econ.top_k if top_k is None else top_k)
        eff_p = float(self.econ.top_p if top_p is None else top_p)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        now = self.clock()
        rec = _Record(
            rid, prompt, int(max_new_tokens), float(temperature), eff_k,
            eff_p, now,
            None if deadline_s is None else now + float(deadline_s),
            limit=int(prompt.size) + int(max_new_tokens) - 1)
        self.counters["submitted"] += 1
        if self.obs.tracer is not None:
            self.obs.mark("submit", rid, track=self._track,
                          plen=int(prompt.size), max_new=int(max_new_tokens))
        shed_reason = self._shed_reason(rec)
        if shed_reason is not None:
            self._finish_local(rec, "shed", error=shed_reason)
            return rid
        self.records[rid] = rec
        self.queue.append(rec)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it lives: router-queued, placed on
        a replica, or stranded on a dead one (pending failover).  Same
        contract as the engine's ``cancel``."""
        if rid in self.completions:
            return False
        rec = self.records.get(rid)
        if rec is None:
            raise KeyError(f"unknown rid {rid}")
        if rec.replica is None:
            self.queue.remove(rec)
            self._finish_local(rec, "cancelled")
            return True
        h = self.replicas[rec.replica]
        if h.state == "dead":
            # placement died with its replica; the mirror has the tokens
            self._finish_local(rec, "cancelled")
            return True
        h.engine.cancel(rid)
        self._sync(h)
        self._collect(h)
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.records)

    def step(self) -> bool:
        """One router tick: inject replica faults, expire router-queue
        deadlines, dispatch, step the replicas, sync stream mirrors,
        collect completions, health-check.  Returns True iff anything
        progressed (fault detection counts: it unblocks work)."""
        self.tick += 1
        progressed = self._inject_replica_faults()
        progressed |= self._expire_queue_deadlines()
        progressed |= self._dispatch()
        for h in self.replicas:
            if h.state == "dead" or not h.engine.has_work():
                if h.state != "dead":
                    h.last_progress = self.tick     # idle is healthy
                continue
            if h.stalled:
                continue        # injected hang: the engine never steps
            if h.engine.step():
                h.last_progress = self.tick
                progressed = True
            self._sync(h)
            self._collect(h)
        progressed |= self._health_check()
        return progressed

    def run(self, max_ticks: int = 200_000) -> None:
        """Drive :meth:`step` until the fleet is idle."""
        ticks = 0
        while self.has_work():
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError(
                    f"router failed to drain within {max_ticks} ticks "
                    f"(queue={len(self.queue)} inflight={len(self.records)})")

    # ------------------------------------------------------------------
    # Fleet lifecycle: kill / drain / reinstate
    # ------------------------------------------------------------------
    def kill(self, idx: int) -> None:
        """Declare replica ``idx`` dead (crash injection, health-check
        verdict, or an external supervisor).  Its engine is never
        touched again — failover rebuilds every in-flight request from
        the router's own stream mirrors, exactly what survives a real
        process death."""
        h = self.replicas[idx]
        if h.state == "dead":
            return
        h.state = "dead"
        self.counters["replicas_dead"] += 1
        self.obs.instant("replica_dead", track=self._track, replica=idx)
        self.obs.record("replica_dead", replica=idx, tick=self.tick)
        self._failover(idx)

    def drain(self, idx: int) -> int:
        """Zero-downtime drain: stop admission to replica ``idx`` and
        migrate everything it holds back through the admission queue
        (front, rid order — FCFS priority survives the move).  Unlike
        :meth:`kill` the engine is healthy here, so migration rides its
        lossless per-request export (a preempt that resumes elsewhere).
        Returns the number of requests migrated."""
        h = self.replicas[idx]
        if h.state != "live":
            raise ValueError(f"replica {idx} is {h.state!r}, not live")
        h.state = "drained"
        owned = sorted(
            (rec for rec in self.records.values() if rec.replica == idx),
            key=lambda r: r.rid, reverse=True)
        for rec in owned:
            snap = h.engine.export_request(rec.rid)
            comp = snap["completion"]
            if comp is not None:
                # the engine's recorded stream is the authority here
                rec.tokens = [int(t) for t in comp["tokens"]]
                rec.token_times = [float(t) for t in comp["token_times"]]
                rec.retries = int(comp["retries"])
            rec.replica = None
            self.queue.appendleft(rec)
            self.counters["migrated"] += 1
            if self.obs.tracer is not None:
                self.obs.mark("drain", rec.rid, track=self._track,
                              replica=idx)
        assert not h.engine.has_work(), "drained replica still holds work"
        return len(owned)

    def reinstate(self, idx: int) -> None:
        """Return a drained replica to rotation (the tail of the live
        weight-swap cycle: drain -> republish -> reinstate)."""
        h = self.replicas[idx]
        if h.state != "drained":
            raise ValueError(f"replica {idx} is {h.state!r}, not drained")
        h.state = "live"
        h.last_progress = self.tick

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _shed_reason(self, rec: _Record) -> str | None:
        if all(h.state == "dead" for h in self.replicas):
            return "no live replicas"
        if len(self.queue) >= self.rc.shed_queue_depth:
            return (f"admission queue full "
                    f"(depth {len(self.queue)} >= {self.rc.shed_queue_depth})")
        # deadline-aware early shed: the queue drains in waves of the
        # fleet's lane capacity, each wave taking ~one EWMA service time;
        # a TTL that cannot cover even that optimistic estimate is
        # hopeless NOW, and shedding it is free
        if rec.deadline is None or self._ewma_service is None:
            return None
        lanes = sum(self.econ.max_slots
                    for h in self.replicas if h.state == "live")
        if lanes == 0:
            return None     # all drained: no basis for an estimate
        waves = len(self.queue) // lanes + 1
        est_finish = self.clock() + waves * self._ewma_service
        if est_finish > rec.deadline:
            return (f"deadline unreachable at queue depth {len(self.queue)} "
                    f"(est. {waves} waves x {self._ewma_service:.3f}s)")
        return None

    def _finish_local(self, rec: _Record, status: str,
                      error: str | None = None) -> None:
        """Terminate a request the router itself owns (shed / queued
        timeout / queued cancel / failover exhaustion), preserving the
        mirrored token prefix like an engine-side termination would.
        Engine-side terminations observe their own latency histograms and
        terminal marks (``ServeEngine._observe_terminal``); this is the
        matching exit point for router-owned ones, so every rid gets
        exactly one terminal event fleet-wide."""
        comp = Completion(
            rid=rec.rid, prompt_len=int(rec.prompt.size),
            max_new_tokens=rec.max_new_tokens, tokens=list(rec.tokens),
            token_times=list(rec.token_times), submit_time=rec.submit_time,
            finish_time=self.clock(), status=status, error=error,
            retries=rec.retries)
        self.completions[rec.rid] = comp
        self.counters[f"status_{status}"] += 1
        self.records.pop(rec.rid, None)
        if comp.tokens:
            self.obs.metrics.histogram(f"ttft_ms_{status}").observe(
                max(0.0, (comp.token_times[0] - comp.submit_time) * 1e3))
            self.obs.metrics.histogram(f"tpot_ms_{status}").observe(
                max(0.0, (comp.finish_time - comp.submit_time) * 1e3
                    / len(comp.tokens)))
        if self.obs.tracer is not None:
            self.obs.mark("terminal", rec.rid, track=self._track,
                          status=status, tokens=len(comp.tokens),
                          error=error)

    def _expire_queue_deadlines(self) -> bool:
        expired = [rec for rec in self.queue
                   if rec.deadline is not None
                   and self.clock() >= rec.deadline]
        for rec in expired:
            self.queue.remove(rec)
            self._finish_local(rec, "timeout")
        return bool(expired)

    def _inject_replica_faults(self) -> bool:
        if self.faults is None:
            return False
        hit = False
        victim = self.faults.pick(
            "replica_crash",
            [h.idx for h in self.replicas if h.state != "dead"])
        if victim is not None:
            self.kill(victim)
            hit = True
        victim = self.faults.pick(
            "replica_stall",
            [h.idx for h in self.replicas
             if h.state != "dead" and not h.stalled])
        if victim is not None:
            self.replicas[victim].stalled = True
            self.counters["stalls_injected"] += 1
            self.obs.instant("fault", track=self._track,
                             site="replica_stall", replica=victim)
            hit = True
        return hit

    def _dispatch(self) -> bool:
        capacity = self.econ.max_slots + self.rc.dispatch_depth
        progressed = False
        if self.queue and all(h.state == "dead" for h in self.replicas):
            # total fleet loss: nothing will ever serve the queue — fail
            # every queued request now (structured, like everything else)
            # rather than hold them hostage (a drained replica does NOT
            # trigger this: it can be reinstated)
            while self.queue:
                self._finish_local(self.queue.popleft(), "failed",
                                   error="no live replicas")
            return True
        while self.queue:
            accepting = [h for h in self.replicas if h.accepting(capacity)]
            if not accepting:
                break
            rec = self.queue.popleft()
            self._place(rec, self._route(rec, accepting))
            progressed = True
        return progressed

    def _route(self, rec: _Record, accepting: list[ReplicaHandle]
               ) -> ReplicaHandle:
        """Pick a replica for ``rec`` among ``accepting`` (non-empty)."""
        pool = accepting
        if self.econ.prefix_cache:
            keys = prefix_keys(rec.prompt, self.econ.page_size)
            scores = [len(h.engine.alloc.lookup(keys)) for h in accepting]
            if self.tier is not None:
                # the host tier extends every replica's device chain: a
                # replica whose device match continues in host RAM pays
                # only an O(copy) promotion for those blocks, not prefill
                scores = [sc + self.tier.match_chain(keys, start=sc)
                          for sc in scores]
            best = max(scores)
            if best > 0:
                self.counters["cache_routed"] += 1
                pool = [h for h, sc in zip(accepting, scores) if sc == best]
        return min(pool, key=lambda h: (h.load(), h.idx))

    def _place(self, rec: _Record, h: ReplicaHandle) -> None:
        rec.replica = h.idx
        rec.dispatch_time = self.clock()
        rec.dispatch_builds = self.fleet_builds()
        self.placements[rec.rid] = h.idx
        resume = bool(rec.tokens) or rec.failovers > 0
        pending = {
            "rid": rec.rid, "prompt": [int(t) for t in rec.prompt],
            "max_new_tokens": rec.max_new_tokens,
            "temperature": rec.temperature, "top_k": rec.top_k,
            "top_p": rec.top_p, "submit_time": rec.submit_time,
            "deadline": rec.deadline, "resume": resume,
            "limit": rec.limit, "replay": [int(t) for t in rec.tokens],
        }
        completion = None
        if resume:
            completion = {
                "rid": rec.rid, "prompt_len": int(rec.prompt.size),
                "max_new_tokens": rec.max_new_tokens,
                "tokens": [int(t) for t in rec.tokens],
                "token_times": [float(t) for t in rec.token_times],
                "submit_time": rec.submit_time, "finish_time": 0.0,
                "status": "ok", "error": None, "retries": rec.retries,
            }
        if self.obs.tracer is not None:
            self.obs.mark("route", rec.rid, track=self._track,
                          replica=h.idx, resume=resume)
        h.engine.import_request(
            {"pending": pending, "completion": completion},
            front=resume)
        self.counters["dispatched"] += 1

    def _sync(self, h: ReplicaHandle) -> None:
        """Mirror the replica's live streams into the router's records —
        the failover truth, refreshed at every step boundary."""
        for rid, comp in h.engine.live.items():
            rec = self.records.get(rid)
            if rec is not None and rec.replica == h.idx:
                rec.tokens = list(comp.tokens)
                rec.token_times = list(comp.token_times)
                rec.retries = comp.retries

    def _collect(self, h: ReplicaHandle) -> None:
        """Pull newly-terminal completions off a replica."""
        done = [rec for rec in self.records.values()
                if rec.replica == h.idx and rec.rid in h.engine.completions]
        for rec in done:
            comp = h.engine.completions[rec.rid]
            self.completions[rec.rid] = comp
            self.counters[f"status_{comp.status}"] += 1
            if comp.status == "ok" \
                    and self.fleet_builds() == rec.dispatch_builds:
                # compile-clean samples only: a service interval that
                # absorbed a build (cold start, new bucket, a replica's
                # first graph capture)
                # would seed the EWMA orders of magnitude high and make
                # the deadline shed reject every tight-but-feasible
                # request on an otherwise idle fleet
                service = comp.finish_time - rec.dispatch_time
                self._ewma_service = service if self._ewma_service is None \
                    else 0.5 * self._ewma_service + 0.5 * service
            del self.records[rec.rid]

    def _failover(self, idx: int) -> None:
        """Requeue every request placed on dead replica ``idx`` from the
        router's mirrors (front, rid order — FCFS priority survives)."""
        stranded = sorted(
            (rec for rec in self.records.values() if rec.replica == idx),
            key=lambda r: r.rid, reverse=True)
        for rec in stranded:
            rec.replica = None
            rec.failovers += 1
            self.counters["failovers"] += 1
            if self.obs.tracer is not None:
                self.obs.mark("failover", rec.rid, track=self._track,
                              replica=idx, failovers=rec.failovers)
            if rec.failovers > self.rc.max_failovers:
                self._finish_local(
                    rec, "failed",
                    error=f"failover budget exhausted "
                          f"({rec.failovers - 1} migrations; replica {idx} "
                          f"died last)")
            else:
                self.queue.appendleft(rec)

    def _health_check(self) -> bool:
        """Step-budget liveness: a replica holding work that has not
        progressed for ``stall_budget`` ticks is dead to the router —
        whether it hung (injected stall) or is merely wedged, failover
        is the same."""
        detected = False
        for h in self.replicas:
            if h.state == "dead" or not h.engine.has_work():
                continue
            if self.tick - h.last_progress >= self.rc.stall_budget:
                self.counters["stalls_detected"] += 1
                self.obs.instant("stall_detected", track=self._track,
                                 replica=h.idx, tick=self.tick)
                self.kill(h.idx)
                detected = True
        return detected

    # ------------------------------------------------------------------
    # Invariants + stats
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Fleet-level conservation sweep (the router fuzzer runs this
        after every tick), then each non-dead replica's own sweep.  A
        failed sweep dumps the flight recorder (when attached) before
        re-raising — replica sweeps dump their own engine context first,
        then the fleet context lands in a second dump."""
        try:
            self._check_invariants()
        except AssertionError as e:
            self.obs.record("invariant_failure", router=self._track,
                            error=str(e))
            self.obs.dump("router_invariant_failure", context={
                "error": str(e),
                "tick": self.tick,
                "queue_depth": len(self.queue),
                "inflight_rids": sorted(self.records),
                "replica_states": [h.state for h in self.replicas],
                "counters": dict(self.counters),
            })
            raise

    def _check_invariants(self) -> None:
        self.obs.metrics.check()
        queued = {rec.rid for rec in self.queue}
        for rid, rec in self.records.items():
            if rec.replica is None:
                assert rid in queued, f"rid {rid} unplaced but not queued"
            else:
                h = self.replicas[rec.replica]
                assert h.state != "dead", f"rid {rid} placed on dead replica"
                e = h.engine
                assert rid in e.live or any(r.rid == rid for r in e.queue), \
                    f"rid {rid} missing from replica {h.idx}"
        overlap = set(self.completions) & set(self.records)
        assert not overlap, f"rids both terminal and in flight: {overlap}"
        n_status = sum(self.counters[f"status_{st}"] for st in STATUSES)
        assert n_status == len(self.completions), \
            f"status counters {n_status} != completions {len(self.completions)}"
        assert self.counters["submitted"] == \
            len(self.completions) + len(self.records), "requests lost"
        for h in self.replicas:
            if h.state != "dead":
                h.engine.check_invariants()
        if self.tier is not None:
            # the shared tier is checked per-replica against each
            # allocator; this sweeps it once more in case every replica
            # is dead (the spills must still be internally consistent)
            self.tier.check()

    @property
    def stats(self) -> dict:
        out = {
            **self.counters,
            "tick": self.tick,
            "queue_depth": len(self.queue),
            "inflight": len(self.records),
            "replica_states": [h.state for h in self.replicas],
            "replica_loads": [h.load() for h in self.replicas],
            **self.aot.stats,
            "executables": len(self.aot),
            "graph_builds": sum(h.engine.graphs.stats["builds"] for h in self.replicas),
            "graphs": sum(len(h.engine.graphs) for h in self.replicas),
        }
        if self.tier is not None:
            out["host_tier"] = {
                "spilled_lanes": self.tier.spilled_lanes,
                "spilled_blocks": self.tier.spilled_blocks,
                "used_bytes": self.tier.used_bytes,
                "lane_spills": self.tier.lane_spills,
                "lane_restores": self.tier.lane_restores,
                "prefix_spills": self.tier.prefix_spills,
                "prefix_hits": self.tier.prefix_hits,
                "drops": self.tier.drops,
            }
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out
