"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

The port's copy of ``fairness_llm_tpu/telemetry/registry.py``: the same
instruments, names and percentile arithmetic, so a snapshot of either
package reads alike.

The framework's observability before this module was a set of ad-hoc counter
dataclasses (``SpeculationStats``, ``ServingStats`` in ``utils/profiling.py``)
with no shared registry and no latency *distributions* — a sweep could report
"45 requests completed" but never "p95 TTFT was 180 ms". This registry is the
shared substrate: every component (engine, serving scheduler, pipeline
phases) registers named metrics labeled by ``component=...`` and the
exporters (``telemetry/export.py``) snapshot the whole process at once.

Design constraints, in order:

- **No sample retention.** A serving drain observes one latency per request
  and one occupancy per decode step; a heavy-traffic server cannot keep
  those samples. Histograms use FIXED log-spaced bucket boundaries, so
  p50/p95/p99 are derived from bucket counts alone (plus the tracked
  observed min/max, which bound the estimate so percentiles can never
  leave the observed range — the self-consistency the snapshot schema
  promises: p50 <= p95 <= p99 <= max).
- **Single-threaded by design**, like the serving scheduler that is its
  main writer: plain ints/floats, no locks. Cross-process aggregation is an
  exporter concern (merge snapshots), not a registry one.
- **Label isolation**: ``counter("x", component="engine")`` and
  ``counter("x", component="serving")`` are independent instruments;
  re-requesting the same (name, labels) returns the SAME instrument
  (get-or-create), so call sites never hold registry references.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

# Default histogram bounds: log-spaced, factor 10^(1/4) (~1.78x) per bucket,
# spanning 10 us .. 1000 s. Latencies in this codebase live between a
# sub-millisecond queue pop and a multi-minute sweep, and a <2x bucket ratio
# bounds the worst-case percentile estimate error to <2x — tight enough to
# tell 20 ms TTFT from 200 ms, which is what the histograms exist for.
_LAT_LO, _LAT_HI, _PER_DECADE = 1e-5, 1e3, 4
DEFAULT_LATENCY_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (math.log10(_LAT_LO) + i / _PER_DECADE)
    for i in range(int(round((math.log10(_LAT_HI) - math.log10(_LAT_LO)) * _PER_DECADE)) + 1)
)

# For dimensionless small-integer distributions (queue depth, slot
# occupancy, tokens/step): 1-2-5 per decade up to 100k.
DEFAULT_COUNT_BOUNDS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(6) for m in (1, 2, 5)
)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic event count. ``inc`` only — a counter that can go down is a
    gauge, and letting call sites decrement would silently break rate math
    downstream."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """Last-written value (queue depth right now, pool size). ``set_max``
    exists for high-water marks so call sites don't reimplement the
    read-compare-write."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)

    def set_max(self, v: float) -> None:
        self.value = max(self.value, float(v))


class Histogram:
    """Fixed-bound log-bucket histogram with percentile derivation.

    ``bucket_counts[i]`` counts observations ``<= bounds[i]`` and
    ``> bounds[i-1]`` (Prometheus ``le`` semantics: a value exactly on a
    boundary lands in that boundary's bucket); ``bucket_counts[-1]`` is the
    overflow bucket (``> bounds[-1]``). Observed ``min``/``max`` are tracked
    exactly, so percentile estimates clamp into the observed range — the
    source of the guaranteed ``p50 <= p95 <= p99 <= max`` ordering whatever
    the bucket resolution.
    """

    __slots__ = ("name", "labels", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: Dict[str, str],
                 bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name}: bounds must be sorted, non-empty")
        self.name = name
        self.labels = dict(labels)
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-th percentile (q in [0, 100]) from bucket
        counts. None when empty. The estimate is each bucket's UPPER edge
        clamped into [observed min, observed max]: upper-edge (not midpoint)
        keeps the estimator conservative for latency SLOs, and the clamp
        makes single-sample / single-bucket cases exact."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if q == 0.0:
            return float(self.min)  # p0 is exact: the tracked observed min
        # Nearest-rank: the smallest bucket whose cumulative count covers
        # ceil(q% of N) observations.
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            cum += c
            if cum >= rank:
                upper = self.bounds[i] if i < len(self.bounds) else self.max
                return float(min(max(upper, self.min), self.max))
        return float(self.max)  # unreachable: cum == count >= rank

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def as_dict(self) -> Dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "bounds": list(self.bounds),
            "bucket_counts": list(self.bucket_counts),
        }


class MetricsRegistry:
    """Get-or-create instrument store keyed on (kind, name, sorted labels).

    One registry per process is the intended shape (``get_registry()``);
    fresh instances exist for tests and for merging exported snapshots.
    Asking for an existing name with a different KIND is a hard error —
    a silent counter/histogram collision would corrupt both exports.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelsKey], object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str], factory):
        known = self._kinds.get(name)
        if known is not None and known != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {known}, "
                f"requested as a {kind}"
            )
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
            self._kinds[name] = kind
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels, lambda: Counter(name, labels))

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(name, labels))

    def histogram(self, name: str, bounds: Optional[Tuple[float, ...]] = None,
                  **labels: str) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda: Histogram(name, labels, bounds or DEFAULT_LATENCY_BOUNDS),
        )

    def peek(self, name: str, **labels: str) -> Optional[object]:
        """Read an instrument WITHOUT creating it — for observers (the
        resilience watchdog's ``stalled()``, diagnostics) that must not
        materialize zero-valued instruments just by looking. Returns None
        when no writer has touched that (name, labels) yet."""
        return self._metrics.get((name, _labels_key(labels)))

    def read_value(self, name: str, default: float = 0.0,
                   **labels: str) -> float:
        """Peek an instrument's scalar value without creating it — the
        read path for observers of metrics OTHER components own (the fleet
        router reading a scheduler's ``queue_depth_hwm``, a supervisor
        reading breaker states). Counters and gauges both expose
        ``.value``; histograms have no single scalar and return
        ``default``, as does an untouched (name, labels)."""
        m = self.peek(name, **labels)
        return getattr(m, "value", default) if m is not None else default

    # -- export surface -----------------------------------------------------

    def instruments(self) -> List[object]:
        """All instruments in stable (name, labels) order."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def kind_of(self, name: str) -> Optional[str]:
        return self._kinds.get(name)


# -- the process-wide registry ------------------------------------------------

_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented component writes to.
    Call sites resolve it AT WRITE TIME (never cache it across calls), so
    ``set_registry`` — and the test-scoped ``use_registry`` — swap all
    instrumentation atomically."""
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Replace the process-wide registry; returns the previous one."""
    global _registry
    prev, _registry = _registry, reg
    return prev


class use_registry:
    """Context manager: route all instrumentation to ``reg`` inside the
    block (tests isolate their assertions from whatever the rest of the
    process recorded)."""

    def __init__(self, reg: Optional[MetricsRegistry] = None):
        self.registry = reg if reg is not None else MetricsRegistry()
        self._prev: Optional[MetricsRegistry] = None

    def __enter__(self) -> MetricsRegistry:
        self._prev = set_registry(self.registry)
        return self.registry

    def __exit__(self, *exc) -> None:
        set_registry(self._prev)
