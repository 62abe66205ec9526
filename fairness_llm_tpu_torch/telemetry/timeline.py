"""Device-step timeline: one span for every prefill batch and decode chunk,
scheduler instants, and a Chrome-trace/Perfetto export (counterpart of
``fairness_llm_tpu/telemetry/timeline.py``).

The registry (``telemetry/registry.py``) answers "how much / how fast in
aggregate"; the request tracer answers "what happened to request X". This
module answers where the wall clock goes between device calls: the host
sync between decode chunks, the admission stall while a slot pool sat idle.
It records:

- **spans** — one per device call (prefill batch, decode chunk, phase
  region), with a ``track`` (``"serving"``, ``"engine"``, ``"host"``);
- **instants** — scheduler events pinned to their track;
- **request spans** — one async span per request from ``submitted`` to its
  terminal event (fed by ``RequestTracer.finalize``), rendering as request
  lanes over the device-step lanes;
- **step gaps** — the host-side gap between consecutive decode chunks on a
  track becomes the ``step_gap_s`` registry histogram, and rides on each
  decode span's args, so the trace shows *which* gap.

Export is the Chrome trace-event JSON format (``to_chrome_trace`` /
``export``), openable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``; ``--telemetry-dir`` writes it as ``trace.json``.
Timestamps are ``time.monotonic`` microseconds relative to the first
recorded event, on the host's clock.

Memory is bounded: a ring of ``capacity`` events (oldest dropped, counted in
``dropped``); the aggregate truth stays in the registry either way.

The layer (timeline spans, step gaps, SLO observation, the flight recorder)
gates on one switch: ``set_attribution(False)`` turns it off process-wide.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.telemetry.registry import get_registry

DEFAULT_CAPACITY = 100_000
TRACE_FILENAME = "trace.json"

# How many worst step gaps to keep for the text summary (the full gap
# distribution lives in the step_gap_s histogram).
_TOP_GAPS = 16


class Timeline:
    """Bounded event recorder + Chrome-trace exporter. Single-threaded by
    design, like the scheduler loop that is its main writer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = True
        self.capacity = capacity
        self._events: Deque[Dict] = deque(maxlen=capacity)
        self.dropped = 0
        # Per-track end time of the last decode chunk (the step-gap cursor);
        # cleared at drain end so inter-drain idle never counts as a gap.
        self._last_chunk_end: Dict[str, float] = {}
        # Per-track end of the last KNOWN-BUSY device interval (decode
        # chunks AND prefill batches via note_busy): the cost-ledger host
        # gap measures time the device was actually idle between chunks,
        # while step_gap_s keeps its PR-7 semantics (ALL between-chunk
        # host time, prefill included — that is the fused-multi-step
        # opportunity window).
        self._last_busy_end: Dict[str, float] = {}
        self.top_gaps: List[Tuple[float, float, str]] = []  # (gap_s, t, track)
        self._epoch: Optional[float] = None

    # -- recording -----------------------------------------------------------

    def _push(self, ev: Dict) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        # Epoch = earliest start ever seen (request spans BACKDATE to their
        # submission stamp, which can precede the first device span).
        if self._epoch is None or ev["t0"] < self._epoch:
            self._epoch = ev["t0"]
        self._events.append(ev)

    def record_span(self, name: str, cat: str, track: str, t0: float,
                    dur_s: float, **args) -> None:
        """One complete span (a device call, a phase region). ``t0`` is a ``time.monotonic`` stamp; ``dur_s`` its wall."""
        if not self.enabled:
            return
        self._push({"type": "span", "name": name, "cat": cat, "track": track,
                    "t0": float(t0), "dur_s": max(float(dur_s), 0.0),
                    "args": args})

    def record_instant(self, name: str, track: str, t: Optional[float] = None,
                       cat: str = "scheduler", **args) -> None:
        """A zero-duration event pinned to its track (fence, migrate,
        request lifecycle edge)."""
        if not self.enabled:
            return
        self._push({"type": "instant", "name": name, "cat": cat,
                    "track": track,
                    "t0": time.monotonic() if t is None else float(t),
                    "args": args})

    def record_request(self, request_id: str, track: str, t0: float,
                       t1: float, outcome: str, **args) -> None:
        """One request's whole lifetime as an async span on the track's
        request lane — concurrent requests stack instead of colliding."""
        if not self.enabled:
            return
        self._push({"type": "request", "name": request_id, "cat": "request",
                    "track": track, "t0": float(t0),
                    "dur_s": max(float(t1) - float(t0), 0.0),
                    "args": {"outcome": outcome, **args}})

    def decode_chunk(self, track: str, t0: float, dur_s: float, steps: int,
                     labels: Optional[Dict[str, str]] = None,
                     program: Optional[str] = None,
                     **args) -> Optional[float]:
        """A decode-chunk span, plus the step-gap accounting: the time from
        the previous chunk's end (same track) to this chunk's start is
        host-side sync/admission work the device spent idle — observed into
        the ``step_gap_s`` histogram and stamped onto the span. With
        ``program`` set, the gap ALSO accumulates into the per-program
        ``cost_host_gap_s_total`` gauge — the MEASURED host-gap term of the
        cost-ledger gap decomposition (telemetry/costmodel.py). Returns the
        gap (None for the track's first chunk, or when gated off) so the
        caller can stamp it onto its flight-recorder ring entry."""
        if not self.enabled:
            return None
        gap = None
        last_end = self._last_chunk_end.get(track)
        if last_end is not None:
            gap = max(t0 - last_end, 0.0)
            get_registry().histogram(
                "step_gap_s", component="serving", **(labels or {})
            ).observe(gap)
            if program is not None:
                # Unlabeled by replica, like the other cost_* accumulators:
                # the decomposition is per program, replicas fold together.
                # Measured against the BUSY cursor, not the chunk cursor —
                # a prefill between two chunks is attributed to its own
                # program by note_invocation, so counting it here too
                # would double-attribute it as "host gap".
                busy_end = max(last_end,
                               self._last_busy_end.get(track, last_end))
                get_registry().gauge(
                    "cost_host_gap_s_total", component="costmodel",
                    program=program,
                ).add(max(t0 - busy_end, 0.0))
            self.top_gaps.append((gap, t0, track))
            self.top_gaps.sort(reverse=True)
            del self.top_gaps[_TOP_GAPS:]
        self._last_chunk_end[track] = t0 + dur_s
        self.note_busy(track, t0, dur_s)
        if gap is not None:
            args = {**args, "gap_s": round(gap, 6)}
        if program is not None:
            args = {**args, "program": program}
        self.record_span(f"decode_chunk[{steps}]", "decode", track, t0,
                         dur_s, steps=steps, **args)
        return gap

    def note_busy(self, track: str, t0: float, dur_s: float) -> None:
        """Mark ``[t0, t0+dur_s)`` as device-busy on ``track`` (a prefill
        batch, a decode chunk) — consumed by the cost-ledger host-gap
        measurement above. No event is recorded; the caller's own span
        does that."""
        if not self.enabled:
            return
        end = float(t0) + max(float(dur_s), 0.0)
        cur = self._last_busy_end.get(track)
        if cur is None or end > cur:
            self._last_busy_end[track] = end

    def clear_track_cursor(self, track: str) -> None:
        """Forget the last chunk end for ``track`` — called at drain end so
        the idle stretch before the next drain's first chunk is not a
        step gap."""
        self._last_chunk_end.pop(track, None)
        self._last_busy_end.pop(track, None)

    # -- export --------------------------------------------------------------

    def events(self) -> List[Dict]:
        return list(self._events)

    def to_chrome_trace(self) -> Dict:
        """The Chrome trace-event JSON ("JSON Object Format"): complete
        ``X`` events for spans, ``i`` instants, nestable-async ``b``/``e``
        pairs for request spans (each request id its own async lane), plus
        thread-name/sort metadata so request lanes render ABOVE their
        track's device-step lane."""
        epoch = self._epoch if self._epoch is not None else 0.0

        def us(t: float) -> float:
            return round((t - epoch) * 1e6, 3)

        # Lane assignment: per base track, the request lane sorts just above
        # the device-step lane.
        tracks = sorted({ev["track"] for ev in self._events})
        tids: Dict[str, int] = {}
        meta: List[Dict] = [{
            "ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": "fairness_llm_tpu_torch"},
        }]
        for i, track in enumerate(tracks):
            req_tid, dev_tid = 2 * i + 1, 2 * i + 2
            tids[track] = dev_tid
            tids[track + "/requests"] = req_tid
            for tid, label in ((req_tid, f"{track} · requests"),
                               (dev_tid, f"{track} · device steps")):
                meta.append({"ph": "M", "pid": 1, "tid": tid,
                             "name": "thread_name", "args": {"name": label}})
                meta.append({"ph": "M", "pid": 1, "tid": tid,
                             "name": "thread_sort_index",
                             "args": {"sort_index": tid}})
        events: List[Dict] = list(meta)
        for ev in self._events:
            if ev["type"] == "span":
                events.append({
                    "ph": "X", "pid": 1, "tid": tids[ev["track"]],
                    "name": ev["name"], "cat": ev["cat"],
                    "ts": us(ev["t0"]), "dur": round(ev["dur_s"] * 1e6, 3),
                    "args": ev["args"],
                })
            elif ev["type"] == "instant":
                events.append({
                    "ph": "i", "pid": 1, "tid": tids[ev["track"]],
                    "name": ev["name"], "cat": ev["cat"],
                    "ts": us(ev["t0"]), "s": "t", "args": ev["args"],
                })
            else:  # request: async pair on the track's request lane
                tid = tids[ev["track"] + "/requests"]
                common = {"pid": 1, "tid": tid, "cat": "request",
                          "id": ev["name"], "name": ev["name"]}
                events.append({**common, "ph": "b", "ts": us(ev["t0"]),
                               "args": ev["args"]})
                events.append({**common, "ph": "e",
                               "ts": us(ev["t0"] + ev["dur_s"])})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "fairness_llm_tpu_torch.telemetry.timeline",
                "dropped_events": self.dropped,
            },
        }

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON (atomic rename, like the snapshot)."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


# -- schema validation / summary ----------------------------------------------


def validate_chrome_trace(trace) -> List[str]:
    """Schema check of an exported trace (the shape Perfetto/chrome://tracing
    accept); returns a list of problems, empty = valid. Used by tests and
    ``tools/validate_telemetry.py --require-profile``."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not an object"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    open_async: Dict[tuple, int] = {}
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"{where}: missing ph")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"{where}: missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event with bad dur {dur!r}")
        elif ph in ("b", "e"):
            if "id" not in ev:
                problems.append(f"{where}: async {ph} event without id")
            else:
                key = (ev.get("cat"), ev["id"])
                open_async[key] = open_async.get(key, 0) + (
                    1 if ph == "b" else -1
                )
                if open_async[key] < 0:
                    problems.append(f"{where}: async e before its b "
                                    f"(id={ev['id']!r})")
        elif ph == "i":
            pass
        else:
            problems.append(f"{where}: unknown ph {ph!r}")
    for (cat, rid), depth in open_async.items():
        if depth != 0:
            problems.append(f"async span id={rid!r} unbalanced "
                            f"(b/e depth {depth})")
    return problems


def summarize_chrome_trace(trace: Dict, top_n: int = 10) -> str:
    """Terminal summary of an exported trace: top programs by accumulated
    wall (the ``summarize_trace`` of the host-side world) and the largest
    step gaps — the ``telemetry-report --timeline`` section."""
    by_prog: Dict[Tuple[str, str], List[float]] = {}
    gaps: List[Tuple[float, float]] = []  # (gap_ms, ts_ms)
    outcomes: Dict[str, int] = {}
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "X":
            key = (ev.get("cat", "?"), ev.get("name", "?"))
            by_prog.setdefault(key, []).append(ev.get("dur", 0.0) / 1e3)
            gap = (ev.get("args") or {}).get("gap_s")
            if gap is not None:
                gaps.append((float(gap) * 1e3, ev.get("ts", 0.0) / 1e3))
        elif ph == "b":
            out = (ev.get("args") or {}).get("outcome")
            if out:
                outcomes[out] = outcomes.get(out, 0) + 1
    lines = ["TIMELINE SUMMARY"]
    if not by_prog and not outcomes:
        lines.append("  (no spans recorded)")
        return "\n".join(lines)
    rows = sorted(
        ((sum(ms), len(ms), cat, name) for (cat, name), ms in by_prog.items()),
        reverse=True,
    )
    lines.append(f"  {'span':<34} {'cat':<10} {'count':>7} "
                 f"{'total ms':>10} {'mean ms':>9}")
    for total, cnt, cat, name in rows[:top_n]:
        lines.append(f"  {name[:34]:<34} {cat:<10} {cnt:>7} "
                     f"{total:>10.2f} {total / cnt:>9.3f}")
    if gaps:
        gaps.sort(reverse=True)
        lines.append(f"  largest step gaps (host-side, between decode "
                     f"chunks; {len(gaps)} recorded):")
        for gap_ms, ts_ms in gaps[:min(top_n, 5)]:
            lines.append(f"    {gap_ms:9.3f} ms at t+{ts_ms:.1f} ms")
    if outcomes:
        lines.append("  requests: " + ", ".join(
            f"{k}={v}" for k, v in sorted(outcomes.items())
        ))
    return "\n".join(lines)


# -- the process-wide timeline -------------------------------------------------

_timeline = Timeline()


def get_timeline() -> Timeline:
    """The process-wide timeline every instrumented call site writes to —
    resolved at write time (never cached), same contract as
    ``get_registry``."""
    return _timeline


def set_timeline(tl: Timeline) -> Timeline:
    global _timeline
    prev, _timeline = _timeline, tl
    return prev


class use_timeline:
    """Context manager: route timeline recording to a fresh (or given)
    Timeline inside the block — test isolation, like ``use_registry``."""

    def __init__(self, tl: Optional[Timeline] = None):
        self.timeline = tl if tl is not None else Timeline()
        self._prev: Optional[Timeline] = None

    def __enter__(self) -> Timeline:
        self._prev = set_timeline(self.timeline)
        return self.timeline

    def __exit__(self, *exc) -> None:
        set_timeline(self._prev)


def attribution_on() -> bool:
    """Whether the performance-attribution layer records anything: the one
    switch timeline spans, step gaps, the flight recorder and SLO
    observation all gate on."""
    return _timeline.enabled


def set_attribution(on: bool) -> bool:
    """Flip the attribution layer process-wide; returns the previous state
    (the bench ``profiling_overhead`` A/B's off switch)."""
    prev = _timeline.enabled
    _timeline.enabled = bool(on)
    return prev
