"""Telemetry exporters: JSONL event sink, snapshot dump, terminal renderer.

The port's copy of ``fairness_llm_tpu/telemetry/export.py``: the same
snapshot schema, Prometheus text and report, so the two packages' outputs
for the same registry contents are equal.

Three output formats, all written under ``--telemetry-dir``:

- ``events.jsonl`` — one JSON object per line, streamed as events happen
  (span events from ``RequestTracer``, heartbeats). Structured-log style:
  survives a crashed run up to the last flushed line.
- ``telemetry_snapshot.json`` — the whole registry at end of run:
  counters/gauges by value, histograms with bucket counts AND the derived
  p50/p95/p99/mean (derived fields are included so downstream tooling never
  reimplements the percentile math — ``validate_snapshot`` checks their
  self-consistency).
- ``metrics.prom`` — Prometheus text exposition of the same registry, for
  scraping pipelines; histogram buckets are cumulative ``le`` counts per
  the exposition format.

``render_report`` is the terminal view (``cli telemetry-report <dir>``), in
the spirit of ``utils/profiling.summarize_trace``: grouped by component,
counters first, then latency tables.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from fairness_llm_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

SNAPSHOT_SCHEMA_VERSION = 1
SNAPSHOT_FILENAME = "telemetry_snapshot.json"
PROM_FILENAME = "metrics.prom"
EVENTS_FILENAME = "events.jsonl"


# Size-based rotation defaults for the process sink (telemetry.configure):
# a million-user replay writes every lifecycle event forever, and an
# unbounded events.jsonl eventually fills the disk that also holds the
# journal. Rotation keeps the newest EVENTS_MAX_BYTES per file and
# EVENTS_KEEP rotated generations (events.jsonl.1 newest ... .N oldest);
# everything older is gone — the aggregate truth stays in the registry.
EVENTS_MAX_BYTES = 128 * 1024 * 1024
EVENTS_KEEP = 3


class JsonlSink:
    """Append-only JSONL event writer. Line-buffered-ish: flushed per emit —
    event volume is per-request/per-heartbeat (not per-token), so durability
    beats write batching here.

    ``max_bytes`` arms size-based rotation: when the live file crosses the
    bound after an emit, it rotates to ``<path>.1`` (existing generations
    shift up, the oldest beyond ``keep`` is deleted) and a fresh live file
    opens. Rotation happens BETWEEN emits, so every generation holds whole
    lines except possibly a torn final one from a kill — which the readers
    already tolerate."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 keep: int = EVENTS_KEEP):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.path = path
        self.max_bytes = max_bytes
        self.keep = keep
        self.rotations = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts_unix": time.time(), "kind": kind, **fields}
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        if self.max_bytes is not None and self._f.tell() >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8")
        self.rotations += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> List[Dict]:
    """Load an ``events.jsonl`` back — INCLUDING rotated generations
    (``<path>.N`` oldest-first, then the live file), skipping any torn
    line: the sink flushes per event, but a killed process (or a kill
    mid-rotation) can still leave one, in any generation."""
    # Discover generations by listing, not by counting up from .1: a kill
    # BETWEEN _rotate's two renames leaves .2 present with .1 absent, and
    # a sequential probe would silently drop everything past the gap.
    base = os.path.basename(path)
    parent = os.path.dirname(os.path.abspath(path))
    gens: List[int] = []
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    gens.append(int(suffix))
    # Largest N is oldest — read it first, the live file last.
    paths: List[str] = [f"{path}.{g}" for g in sorted(gens, reverse=True)]
    if os.path.exists(path) or not paths:
        paths.append(path)
    out: List[Dict] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


# -- snapshot -----------------------------------------------------------------


def snapshot(registry: MetricsRegistry) -> Dict:
    """The whole registry as one JSON-ready dict (the exporter contract:
    everything downstream — validation, rendering, regression tests — works
    off this shape, never off live registry objects)."""
    counters, gauges, histograms = [], [], []
    for m in registry.instruments():
        if isinstance(m, Counter):
            counters.append({"name": m.name, "labels": m.labels, "value": m.value})
        elif isinstance(m, Gauge):
            gauges.append({"name": m.name, "labels": m.labels, "value": m.value})
        elif isinstance(m, Histogram):
            histograms.append({"name": m.name, "labels": m.labels, **m.as_dict()})
    return {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "created_at_unix": time.time(),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }


def validate_snapshot(snap: Dict) -> List[str]:
    """Schema + self-consistency check; returns a list of problems (empty =
    valid). Checks shape AND the percentile invariants the ISSUE promises:
    every histogram's p50 <= p95 <= p99 <= max, and bucket counts summing to
    ``count``. Used by the CI smoke step and tests."""
    problems: List[str] = []

    def _need(d, key, types, where):
        if key not in d:
            problems.append(f"{where}: missing key {key!r}")
            return None
        if not isinstance(d[key], types):
            problems.append(f"{where}: {key!r} has type {type(d[key]).__name__}")
            return None
        return d[key]

    if not isinstance(snap, dict):
        return ["snapshot is not an object"]
    _need(snap, "schema_version", int, "snapshot")
    _need(snap, "created_at_unix", (int, float), "snapshot")
    for section, value_types in (("counters", int), ("gauges", (int, float))):
        rows = _need(snap, section, list, "snapshot")
        for i, row in enumerate(rows or []):
            where = f"{section}[{i}]"
            if not isinstance(row, dict):
                problems.append(f"{where}: not an object")
                continue
            _need(row, "name", str, where)
            _need(row, "labels", dict, where)
            _need(row, "value", value_types, where)
    rows = _need(snap, "histograms", list, "snapshot")
    for i, row in enumerate(rows or []):
        where = f"histograms[{i}]"
        if not isinstance(row, dict):
            problems.append(f"{where}: not an object")
            continue
        name = row.get("name", "?")
        _need(row, "name", str, where)
        _need(row, "labels", dict, where)
        count = _need(row, "count", int, where)
        bounds = _need(row, "bounds", list, where)
        buckets = _need(row, "bucket_counts", list, where)
        if bounds is not None and buckets is not None \
                and len(buckets) != len(bounds) + 1:
            problems.append(
                f"{where} ({name}): {len(buckets)} bucket_counts for "
                f"{len(bounds)} bounds (want bounds+1)"
            )
        if buckets is not None and count is not None and sum(buckets) != count:
            problems.append(
                f"{where} ({name}): bucket_counts sum {sum(buckets)} != "
                f"count {count}"
            )
        if count:
            ps = [row.get("p50"), row.get("p95"), row.get("p99"), row.get("max")]
            if any(not isinstance(p, (int, float)) for p in ps):
                problems.append(f"{where} ({name}): non-numeric percentiles "
                                f"on a non-empty histogram")
            elif not (ps[0] <= ps[1] <= ps[2] <= ps[3]):
                problems.append(
                    f"{where} ({name}): percentile ordering violated: "
                    f"p50={ps[0]} p95={ps[1]} p99={ps[2]} max={ps[3]}"
                )
    return problems


# -- prometheus text exposition -----------------------------------------------


def _prom_name(name: str) -> str:
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"fairness_llm_{safe}"


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (histograms as cumulative ``le`` buckets
    plus ``_sum``/``_count``, the format scrapers expect)."""
    lines: List[str] = []
    seen_type: set = set()

    def _type(name: str, kind: str) -> None:
        if name not in seen_type:
            lines.append(f"# TYPE {name} {kind}")
            seen_type.add(name)

    for m in registry.instruments():
        if isinstance(m, Counter):
            n = _prom_name(m.name)
            _type(n, "counter")
            lines.append(f"{n}{_prom_labels(m.labels)} {m.value}")
        elif isinstance(m, Gauge):
            n = _prom_name(m.name)
            _type(n, "gauge")
            lines.append(f"{n}{_prom_labels(m.labels)} {m.value}")
        elif isinstance(m, Histogram):
            n = _prom_name(m.name)
            _type(n, "histogram")
            cum = 0
            for bound, c in zip(m.bounds, m.bucket_counts):
                cum += c
                le = 'le="%g"' % bound
                lines.append(f"{n}_bucket{_prom_labels(m.labels, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(f"{n}_bucket{_prom_labels(m.labels, inf)} {m.count}")
            lines.append(f"{n}_sum{_prom_labels(m.labels)} {m.sum}")
            lines.append(f"{n}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


# -- file outputs -------------------------------------------------------------


def write_snapshot(registry: MetricsRegistry, telemetry_dir: str) -> str:
    """Dump the registry under ``telemetry_dir`` (JSON + Prometheus text);
    returns the snapshot path."""
    os.makedirs(telemetry_dir, exist_ok=True)
    snap = snapshot(registry)
    path = os.path.join(telemetry_dir, SNAPSHOT_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    os.replace(tmp, path)  # atomic: a watcher never reads a torn snapshot
    with open(os.path.join(telemetry_dir, PROM_FILENAME), "w",
              encoding="utf-8") as f:
        f.write(to_prometheus(registry))
    return path


def load_snapshot(path: str) -> Dict:
    """Read a snapshot file (or the canonical file inside a telemetry dir)."""
    if os.path.isdir(path):
        path = os.path.join(path, SNAPSHOT_FILENAME)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


# -- terminal renderer --------------------------------------------------------


def _fmt_val(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.001:
        return f"{v:.3g}"
    return f"{v:.4g}"


# Enum-coded gauges (resilience/breaker.py) rendered by name — "open" reads,
# "2" doesn't. Kept as a local table: export must not import resilience
# (resilience imports telemetry; the reverse edge would cycle).
_STATE_GAUGE_NAMES = {
    "breaker_state": {0: "closed", 1: "half_open", 2: "open"},
    "degradation_level": {0: "normal", 1: "no_speculation",
                          2: "reduced_footprint", 3: "static_fallback"},
}


def _fmt_gauge(row: Dict) -> str:
    names = _STATE_GAUGE_NAMES.get(row.get("name"))
    if names is not None:
        decoded = names.get(int(row["value"])) if row["value"] == int(row["value"]) else None
        if decoded is not None:
            return f"{decoded} ({_fmt_val(row['value'])})"
    return _fmt_val(row["value"])


def render_report(snap: Dict, width: int = 78) -> str:
    """Human-readable snapshot report, grouped by ``component`` label —
    the terminal sibling of ``summarize_trace``'s per-device tables."""
    by_comp: Dict[str, Dict[str, List[Dict]]] = {}
    for section in ("counters", "gauges", "histograms"):
        for row in snap.get(section, []):
            comp = row.get("labels", {}).get("component", "(unlabeled)")
            by_comp.setdefault(comp, {"counters": [], "gauges": [],
                                      "histograms": []})[section].append(row)

    lines: List[str] = []
    ts = snap.get("created_at_unix")
    lines.append("=" * width)
    lines.append(
        "TELEMETRY REPORT"
        + (f"  (snapshot schema v{snap.get('schema_version')}"
           + (f", {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(ts))})"
              if ts else ")"))
    )
    lines.append("=" * width)
    if not by_comp:
        lines.append("(empty snapshot — no metrics recorded)")
        return "\n".join(lines)
    for comp in sorted(by_comp):
        sec = by_comp[comp]
        lines.append(f"\n[{comp}]")
        for row in sec["counters"]:
            extra = {k: v for k, v in row["labels"].items() if k != "component"}
            suffix = f"  {extra}" if extra else ""
            lines.append(f"  {row['name']:<28} {row['value']:>12}{suffix}")
        for row in sec["gauges"]:
            extra = {k: v for k, v in row["labels"].items() if k != "component"}
            suffix = f"  {extra}" if extra else ""
            lines.append(
                f"  {row['name']:<28} {_fmt_gauge(row):>12}  (gauge){suffix}"
            )
        if sec["histograms"]:
            lines.append(
                f"  {'histogram':<28} {'count':>8} {'mean':>9} {'p50':>9} "
                f"{'p95':>9} {'p99':>9} {'max':>9}"
            )
            for row in sec["histograms"]:
                lines.append(
                    f"  {row['name']:<28} {row['count']:>8} "
                    f"{_fmt_val(row.get('mean')):>9} {_fmt_val(row.get('p50')):>9} "
                    f"{_fmt_val(row.get('p95')):>9} {_fmt_val(row.get('p99')):>9} "
                    f"{_fmt_val(row.get('max')):>9}"
                )
    return "\n".join(lines)
