"""Deterministic fault injection for the serve engine, and the sentinel
token values shared by the serve programs and the engine.

The port of the reference's ``serve/faults.py``.  A :class:`FaultPlan` is
a seeded schedule of failures the engine consults at named sites
(``FAULT_SITES``).  The default engine runs with no plan (``faults=None``;
every consult site is behind an ``is not None``), and a given ``(seed,
rates)`` plan replays the same schedule on every run: each site draws
from its own ``numpy`` Generator seeded from ``(seed, site)``, so the
fire/skip sequence depends only on the engine's consult order, and is
the reference's bit for bit for the same consults.

Sites:

``decode_logits``  turn one active lane's fetched token into the
                   :data:`NONFINITE_TOKEN` sentinel, what the device
                   reports when a lane's logits hold NaN/Inf; drives the
                   quarantine and bounded-retry path.
``prefill``        fail a prefill-chunk dispatch before it runs; the lane
                   retries through preempt-and-requeue.
``alloc``          fail a KV block allocation; the requesting lane
                   retries.
``sched_push``     lose a host-to-device scheduling push; the host mirror
                   is the truth, so recovery is the same push again.
``replica_crash``, ``replica_stall``
                   consulted by the router front-end, which arrives with a
                   later slice of the port.

Victim selection (``pick``) draws from a separate ``(seed, site, victim)``
substream, so whether a consult fires perturbs neither later fires at
that site nor any other site's schedule.  Per-site consult and fire counts
are plain dicts here (the reference keeps them in its ``obs`` metrics
registry, which arrives with that slice).
"""
from __future__ import annotations

import numpy as np

ENGINE_FAULT_SITES = ("decode_logits", "prefill", "alloc", "sched_push")
REPLICA_FAULT_SITES = ("replica_crash", "replica_stall")
FAULT_SITES = ENGINE_FAULT_SITES + REPLICA_FAULT_SITES

# Spawn-key tag distinguishing the victim-selection substream from the
# fire/skip stream at the same site.
_VICTIM_STREAM = 1

# Token value the decode/prefill programs report for a lane whose logits
# hold a non-finite value (vocab ids are >= 0, so the sentinel rides the
# existing (max_slots,) int32 token fetch: no extra host sync).
NONFINITE_TOKEN = -1

# Speculative-decode verify rows: entries past a lane's accepted prefix.
UNCOMMITTED = -2


class FaultPlan:
    """Seeded per-site fault schedule.

    ``rates`` maps site name -> per-consult fire probability (sites not
    named never fire).  ``max_fires`` bounds the total number of fires
    across all sites (None = unbounded); the draw stream still advances
    past the budget so truncating it never re-times later consults.

    A plan is mutable (generator positions and counters): use a fresh
    instance per engine run, and the same seed to reproduce a run.
    """

    def __init__(self, seed: int, rates: dict[str, float] | None = None,
                 *, max_fires: int | None = None):
        rates = dict(rates or {})
        unknown = set(rates) - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                             f"valid sites: {FAULT_SITES}")
        self.seed = int(seed)
        self.rates = {s: float(rates.get(s, 0.0)) for s in FAULT_SITES}
        self.max_fires = max_fires
        self._rng = {s: np.random.default_rng([self.seed, i])
                     for i, s in enumerate(FAULT_SITES)}
        # a pick() that fires must not advance the fire/skip stream by a
        # different amount than one that skips
        self._victim_rng = {s: np.random.default_rng([self.seed, i, _VICTIM_STREAM])
                            for i, s in enumerate(FAULT_SITES)}
        self.consults = dict.fromkeys(FAULT_SITES, 0)
        self.fired = dict.fromkeys(FAULT_SITES, 0)

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def fire(self, site: str) -> bool:
        """One consult of ``site``: True iff a fault fires here."""
        rate = self.rates[site]
        self.consults[site] += 1
        if rate <= 0.0:
            return False
        hit = float(self._rng[site].random()) < rate
        if hit and (self.max_fires is None or self.total_fired < self.max_fires):
            self.fired[site] += 1
            return True
        return False

    def pick(self, site: str, candidates):
        """Consult ``site``; on fire, return a deterministically chosen
        element of ``candidates`` (None otherwise / when empty)."""
        if not candidates:
            return None
        if not self.fire(site):
            return None
        return candidates[int(self._victim_rng[site].integers(len(candidates)))]

    def stats(self) -> dict:
        return {"seed": self.seed, "consults": dict(self.consults),
                "fired": dict(self.fired), "total_fired": self.total_fired}
