"""Observability: metrics registry, structured tracing, flight recorder.

The port of the reference's ``obs/`` package (pure Python, no torch): the
same classes, names, event schema and histogram buckets, so the same
samples give the same quantiles and the same ``snapshot()`` JSON.

One :class:`Observer` handle is threaded through engine/router/train;
every emit helper is a guarded no-op when the corresponding component is
absent, so a disabled observer costs one ``is None`` check per site —
no device synchronize, no program-key change (docs/observability.md
describes the reference's taxonomy, which this one keeps).
"""

from __future__ import annotations

import time

from .metrics import (Counter, Gauge, Histogram, MetricMap, MetricsRegistry,
                      merged_histogram)
from .recorder import FlightRecorder
from .trace import (NULL_SPAN, Tracer, load_jsonl, request_timeline,
                    to_chrome_trace, to_jsonl, validate)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricMap", "MetricsRegistry",
    "merged_histogram", "FlightRecorder", "Tracer", "NULL_SPAN",
    "load_jsonl", "request_timeline", "to_chrome_trace", "to_jsonl",
    "validate", "Observer",
]


class Observer:
    """Bundle of (metrics, tracer, recorder) with no-op emit helpers.

    ``metrics`` is always present (auto-created); ``tracer`` and
    ``recorder`` are optional.  ``child(name)`` hands a component (e.g.
    one router replica) its own metrics registry while sharing the
    tracer and recorder, so per-replica counters never collide but all
    events land on one timeline.
    """

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 recorder: FlightRecorder | None = None,
                 name: str = "obs"):
        self.name = name
        self.metrics = metrics if metrics is not None else MetricsRegistry(name)
        self.tracer = tracer
        self.recorder = recorder
        if tracer is not None and recorder is not None and tracer._sink is None:
            tracer._sink = recorder.note

    @classmethod
    def full(cls, *, clock=time.perf_counter, capacity: int = 4096,
             dump_dir: str = ".", name: str = "obs") -> "Observer":
        """Everything on: metrics + tracer + recorder on one clock."""
        rec = FlightRecorder(capacity, clock=clock, dump_dir=dump_dir)
        return cls(tracer=Tracer(clock, sink=rec.note), recorder=rec, name=name)

    def child(self, name: str) -> "Observer":
        return Observer(metrics=MetricsRegistry(name), tracer=self.tracer,
                        recorder=self.recorder, name=name)

    # -- guarded emit helpers (no-ops without a tracer/recorder) --------

    def mark(self, phase: str, rid, **kw):
        if self.tracer is not None:
            self.tracer.mark(phase, rid, **kw)

    def instant(self, name: str, **kw):
        if self.tracer is not None:
            self.tracer.instant(name, **kw)

    def span(self, name: str, **kw):
        if self.tracer is not None:
            return self.tracer.span(name, **kw)
        return NULL_SPAN

    def begin(self, name: str, **kw):
        if self.tracer is not None:
            return self.tracer.begin(name, **kw)
        return None

    def end(self, sid, **kw):
        if self.tracer is not None and sid is not None:
            self.tracer.end(sid, **kw)

    def record(self, kind: str, **fields):
        if self.recorder is not None:
            self.recorder.record(kind, **fields)

    def dump(self, reason: str, *, context=None) -> str | None:
        if self.recorder is not None:
            return self.recorder.dump(reason, context=context)
        return None
