"""Typed metrics: Counter / Gauge / Histogram behind one registry.

Design constraints (see docs/observability.md):

- **Kinds never mix.**  A name registered as a counter can never be read
  or written as a gauge and vice versa; ``MetricsRegistry.check()`` and
  the engines' ``check_invariants`` assert this.
- **Mergeable percentiles.**  ``Histogram`` uses fixed log-scale buckets
  (growth ``2**(1/4)`` ≈ 1.19, so quantile answers carry ≤ ~9% relative
  error) shared by every instance, which makes ``merge`` a plain
  bucket-wise add — replica histograms fold into fleet histograms
  without resampling.
- **Cheap when idle.**  Metrics are plain python ints/floats on the
  host; nothing here touches a device buffer or forces a sync.
"""

from __future__ import annotations

import math
from collections.abc import MutableMapping

# Shared bucket layout: boundaries lo * GROWTH**i spanning [1e-9, ~1e9).
# All histograms use the same layout so merge() is bucket-wise addition.
_GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(_GROWTH)
_LO = 1e-9
_LOG_LO = math.log(_LO)
_NBUCKETS = int(math.ceil((math.log(1e9) - _LOG_LO) / _LOG_GROWTH)) + 1


def _bucket_index(value: float) -> int:
    """Bucket for a positive value; 0 holds (0, _LO], i holds lo*g**(i-1)..lo*g**i."""
    if value <= _LO:
        return 0
    i = int(math.floor((math.log(value) - _LOG_LO) / _LOG_GROWTH)) + 1
    return min(i, _NBUCKETS - 1)


def _bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket i (representative value for quantiles)."""
    if i == 0:
        return _LO
    lo = _LO * _GROWTH ** (i - 1)
    return lo * math.sqrt(_GROWTH)


class Counter:
    """Monotone non-decreasing integer counter."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative increment {n}")
        self.value += n

    def set(self, value: int) -> None:
        """Absolute set; must not decrease (used by restore/import paths)."""
        if value < self.value:
            raise ValueError(
                f"counter {self.name!r}: set({value}) would decrease from {self.value}")
        self.value = value


class Gauge:
    """Point-in-time value; supports absolute set and peak tracking."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, value) -> None:
        self.value = value

    def set_max(self, value) -> None:
        if value > self.value:
            self.value = value


class Histogram:
    """Fixed-bucket log-scale histogram with mergeable quantiles.

    Buckets are sparse (dict index -> count); exact count/sum/min/max ride
    along so means are exact and quantiles clamp to the observed range.
    """

    kind = "histogram"
    __slots__ = ("name", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v) or v < 0:
            raise ValueError(f"histogram {self.name!r}: bad observation {value!r}")
        i = _bucket_index(v)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (geometric bucket midpoint, clamped to
        the exact observed [min, max])."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen > rank:
                return min(max(_bucket_mid(i), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (same fixed layout ⇒ bucket-wise add)."""
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self


class MetricsRegistry:
    """Named, typed metric store.  Get-or-create per kind; a name can only
    ever hold one kind (TypeError otherwise)."""

    def __init__(self, name: str = "metrics"):
        self.name = name
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"registry {self.name!r}: metric {name!r} is a {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def kind(self, name: str) -> str | None:
        m = self._metrics.get(name)
        return None if m is None else m.kind

    def names(self):
        return sorted(self._metrics)

    def check(self) -> None:
        """Internal consistency: kind fields match classes, counters are
        non-negative, histogram bucket sums equal their counts."""
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                assert m.kind == "counter" and m.value >= 0, \
                    f"counter {name} corrupt: {m.value}"
            elif isinstance(m, Gauge):
                assert m.kind == "gauge", f"gauge {name} kind corrupt"
            elif isinstance(m, Histogram):
                assert m.kind == "histogram", f"histogram {name} kind corrupt"
                assert sum(m.buckets.values()) == m.count, \
                    f"histogram {name}: bucket sum != count"
            else:  # pragma: no cover - registry only creates the three kinds
                raise AssertionError(f"unknown metric type for {name}: {m!r}")

    def snapshot(self) -> dict:
        """Compact JSON-able dump of every metric."""
        out: dict[str, dict] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, (Counter, Gauge)):
                out[name] = {"kind": m.kind, "value": m.value}
            else:
                out[name] = {
                    "kind": "histogram",
                    "count": m.count,
                    "sum": m.sum,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "p50": None if m.count == 0 else m.quantile(0.50),
                    "p90": None if m.count == 0 else m.quantile(0.90),
                    "p99": None if m.count == 0 else m.quantile(0.99),
                    "buckets": {str(i): n for i, n in sorted(m.buckets.items())},
                }
        return out


def merged_histogram(name: str, registries) -> Histogram:
    """Merge the histogram ``name`` across registries (missing ones skipped)."""
    out = Histogram(name)
    for reg in registries:
        if reg is not None and reg.kind(name) == "histogram":
            out.merge(reg.histogram(name))
    return out


class MetricMap(MutableMapping):
    """dict-shaped facade over a registry so legacy ``self.counters[...]``
    call sites keep working while values live in typed metrics.

    Keys listed in ``gauges`` are Gauge-backed (``map[k] = v`` is an
    absolute set); every other key is Counter-backed (``map[k] += 1``
    round-trips through ``__setitem__`` which enforces monotonicity).
    """

    def __init__(self, registry: MetricsRegistry, keys=(), gauges=(), prefix: str = ""):
        self._registry = registry
        gauges = frozenset(gauges)
        # key set is fixed at construction; metric objects are cached so
        # hot-path ``map[k] += 1`` is two dict probes, no registry walk
        self._objs: dict[str, object] = {}
        for k in keys:
            name = prefix + k
            self._objs[k] = registry.gauge(name) if k in gauges \
                else registry.counter(name)

    def __getitem__(self, key: str):
        return self._objs[key].value

    def __setitem__(self, key: str, value) -> None:
        self._objs[key].set(value)

    def __delitem__(self, key: str) -> None:  # pragma: no cover - unused
        raise TypeError("MetricMap keys are fixed")

    def __iter__(self):
        return iter(self._objs)

    def __len__(self) -> int:
        return len(self._objs)

    def __contains__(self, key) -> bool:
        return key in self._objs

    def copy(self) -> dict:
        return {k: m.value for k, m in self._objs.items()}
