"""Structured tracing: per-request timelines and phase spans.

Every event is a plain dict; the tracer stamps it with the *injectable*
clock it was constructed with, so traces recorded under the fuzzer's
fake clock are bit-for-bit deterministic.  Two export formats:

- JSONL (one event per line) — the durable artifact, schema-validated
  by :func:`validate`.
- Chrome trace / Perfetto JSON — ``to_chrome_trace`` maps tracks to
  tids and request ids to per-request tracks; load the file at
  https://ui.perfetto.dev or chrome://tracing.

Event schema (all events):
  ``ph``    "B" (span begin) | "E" (span end) | "i" (instant)
  ``name``  span/event name ("decode", "prefill_chunk", "submit", ...)
  ``cat``   category: "engine", "router", "train", "aot", "request"
  ``ts``    clock seconds (float, from the injected clock)
  ``track`` logical thread ("engine", "replica0", "train", ...)
  ``rid``   request id (request-lifecycle events only, else absent)
  ``sid``   span id (B/E pairs share one; instants have none)
  ``args``  free-form JSON-able payload

Request lifecycle phases (``cat == "request"``, ``ph == "i"``) follow
the taxonomy in docs/observability.md: submit → queue/route → admit →
prefill_chunk* → first_token → decode* → (preempt | retry | replay |
failover | drain | migrate)* → terminal.  ``validate`` enforces that a
request's first event is ``submit`` and its ``terminal`` event (if any)
is last.
"""

from __future__ import annotations

import json
import time

TERMINAL = "terminal"
SUBMIT = "submit"


class _NullSpan:
    """Reusable no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_sid")

    def __init__(self, tracer, sid):
        self._tracer = tracer
        self._sid = sid

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.end(self._sid)
        return False


class Tracer:
    """Append-only event collector bound to one clock."""

    def __init__(self, clock=time.perf_counter, sink=None):
        self.clock = clock
        self.events: list[dict] = []
        self._sink = sink
        self._next_sid = 0
        self._open: dict[int, dict] = {}

    def _emit(self, ev: dict) -> dict:
        self.events.append(ev)
        if self._sink is not None:
            self._sink(ev)
        return ev

    def begin(self, name: str, *, cat: str = "engine", track: str = "engine",
              rid=None, **args) -> int:
        sid = self._next_sid
        self._next_sid += 1
        ev = {"ph": "B", "name": name, "cat": cat, "ts": self.clock(),
              "track": track, "sid": sid}
        if rid is not None:
            ev["rid"] = rid
        if args:
            ev["args"] = args
        self._open[sid] = ev
        self._emit(ev)
        return sid

    def end(self, sid: int, **args) -> None:
        opened = self._open.pop(sid)
        ev = {"ph": "E", "name": opened["name"], "cat": opened["cat"],
              "ts": self.clock(), "track": opened["track"], "sid": sid}
        if "rid" in opened:
            ev["rid"] = opened["rid"]
        if args:
            ev["args"] = args
        self._emit(ev)

    def span(self, name: str, **kw) -> _Span:
        return _Span(self, self.begin(name, **kw))

    def instant(self, name: str, *, cat: str = "engine", track: str = "engine",
                rid=None, **args) -> dict:
        ev = {"ph": "i", "name": name, "cat": cat, "ts": self.clock(),
              "track": track}
        if rid is not None:
            ev["rid"] = rid
        if args:
            ev["args"] = args
        return self._emit(ev)

    def mark(self, phase: str, rid, *, track: str = "engine", **args) -> dict:
        """Request-lifecycle instant (cat='request')."""
        return self.instant(phase, cat="request", track=track, rid=rid, **args)


def to_jsonl(events, path: str) -> str:
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def to_chrome_trace(events, path: str | None = None) -> dict:
    """Convert to Chrome trace ("traceEvents") JSON.  Phase spans land on
    one tid per logical track; request-lifecycle instants land on a
    per-request tid (1000 + rid) so Perfetto shows one row per request."""
    tracks: dict[str, int] = {}
    out = []

    def tid_for(ev):
        if ev.get("cat") == "request" and "rid" in ev:
            return 1000 + int(ev["rid"])
        track = ev.get("track", "main")
        if track not in tracks:
            tracks[track] = len(tracks) + 1
        return tracks[track]

    for ev in events:
        row = {
            "name": ev["name"],
            "cat": ev.get("cat", "misc"),
            "ph": ev["ph"],
            "ts": ev["ts"] * 1e6,  # chrome trace wants microseconds
            "pid": 1,
            "tid": tid_for(ev),
        }
        if ev["ph"] == "i":
            row["s"] = "t"  # thread-scoped instant
        args = dict(ev.get("args", ()))
        if "rid" in ev:
            args["rid"] = ev["rid"]
        if args:
            row["args"] = args
        out.append(row)

    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": track}} for track, tid in tracks.items()]
    rids = sorted({ev["rid"] for ev in events
                   if ev.get("cat") == "request" and "rid" in ev})
    meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": 1000 + rid,
              "args": {"name": f"request {rid}"}} for rid in rids]
    doc = {"traceEvents": meta + out, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def request_timeline(events, rid) -> list[dict]:
    """All lifecycle events for one request, in emission order."""
    return [ev for ev in events
            if ev.get("rid") == rid and ev.get("cat") == "request"]


def validate(events) -> dict:
    """Schema validation.  Raises AssertionError on the first violation;
    returns summary stats ({'events', 'spans', 'requests', 'terminals'}).

    Checks:
      - every event has ph/name/cat/ts/track and a known ph
      - timestamps are globally non-decreasing
      - B/E spans balance LIFO per track, with non-negative duration,
        and no span is left open
      - per request id: first lifecycle event is 'submit'; at most one
        'terminal' and nothing follows it
    """
    open_stacks: dict[str, list[dict]] = {}
    last_ts = None
    spans = 0
    seen_rid: dict[object, str] = {}  # rid -> last phase
    terminals = 0
    for i, ev in enumerate(events):
        for field in ("ph", "name", "cat", "ts", "track"):
            assert field in ev, f"event {i} missing {field!r}: {ev}"
        assert ev["ph"] in ("B", "E", "i"), f"event {i}: bad ph {ev['ph']!r}"
        if last_ts is not None:
            assert ev["ts"] >= last_ts, \
                f"event {i} ({ev['name']}): ts went backwards " \
                f"({ev['ts']} < {last_ts})"
        last_ts = ev["ts"]
        stack = open_stacks.setdefault(ev["track"], [])
        if ev["ph"] == "B":
            stack.append(ev)
        elif ev["ph"] == "E":
            assert stack, f"event {i}: E {ev['name']!r} with no open span " \
                          f"on track {ev['track']!r}"
            opened = stack.pop()
            assert opened["name"] == ev["name"] and \
                opened.get("sid") == ev.get("sid"), \
                f"event {i}: E {ev['name']!r}/sid={ev.get('sid')} does not " \
                f"match open B {opened['name']!r}/sid={opened.get('sid')}"
            assert ev["ts"] >= opened["ts"], \
                f"event {i}: span {ev['name']!r} has negative duration"
            spans += 1
        if ev.get("cat") == "request" and "rid" in ev:
            rid = ev["rid"]
            if rid not in seen_rid:
                assert ev["name"] == SUBMIT, \
                    f"request {rid}: first lifecycle event is " \
                    f"{ev['name']!r}, expected '{SUBMIT}'"
            else:
                assert seen_rid[rid] != TERMINAL, \
                    f"request {rid}: event {ev['name']!r} after terminal"
            seen_rid[rid] = TERMINAL if ev["name"] == TERMINAL else ev["name"]
            if ev["name"] == TERMINAL:
                terminals += 1
    for track, stack in open_stacks.items():
        assert not stack, \
            f"track {track!r}: {len(stack)} unbalanced open span(s), " \
            f"first: {stack[0]['name']!r}"
    return {"events": len(events), "spans": spans,
            "requests": len(seen_rid), "terminals": terminals}
