"""Flight recorder: bounded ring of recent events, dumped on failure.

The recorder passively mirrors every trace event (it is installed as the
tracer's sink) plus any explicitly ``record``-ed diagnostics.  When an
invariant trips — engine/router ``check_invariants``, a chaos-fuzzer
assertion, a CheckpointManager write failure — ``dump`` writes the ring
to disk as JSON so the moments *before* the failure are replayable.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque


class FlightRecorder:
    def __init__(self, capacity: int = 4096, *, clock=time.perf_counter,
                 dump_dir: str = "."):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=capacity)
        self.recorded = 0  # everything ever offered
        self.dumps = 0
        self.last_dump: str | None = None

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._ring)

    def note(self, ev: dict) -> None:
        """Tracer sink: mirror a trace event into the ring."""
        self._ring.append({"seq": self.recorded, **ev})
        self.recorded += 1

    def record(self, kind: str, **fields) -> None:
        """Record a non-trace diagnostic event."""
        self.note({"ph": "i", "name": kind, "cat": "recorder",
                   "ts": self.clock(), "track": "recorder", "args": fields})

    def events(self) -> list[dict]:
        return list(self._ring)

    def _next_index(self) -> int:
        """Next free ``flightrec_NNN.json`` index in ``dump_dir``.

        Scanned from the directory, not a per-recorder counter: several
        recorders (or several processes) sharing a dump_dir would each
        start their counter at 0 and silently overwrite each other's
        dump 000 — the one artifact written specifically because
        something just went wrong."""
        best = -1
        for name in os.listdir(self.dump_dir):
            m = re.match(r"flightrec_(\d+)\.json$", name)
            if m:
                best = max(best, int(m.group(1)))
        return best + 1

    def dump(self, reason: str, *, context=None, path: str | None = None) -> str:
        """Write the ring to disk; returns the path written."""
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir, f"flightrec_{self._next_index():03d}.json")
        doc = {
            "reason": reason,
            "context": context,
            "ts": self.clock(),
            "recorded": self.recorded,
            "dropped": self.dropped,
            "events": self.events(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        self.dumps += 1
        self.last_dump = path
        return path
