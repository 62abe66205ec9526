"""Request-lifecycle tracing: timestamped span events per serving request.

The port's copy of ``fairness_llm_tpu/telemetry/tracing.py``.

The continuous-batching scheduler (``serving/scheduler.py``) owns a request
from submission to its terminal outcome; this module records that lifecycle
as an ordered list of span events —

    submitted -> admitted -> prefill_start -> first_token
              -> completed | failed | expired   (plus requeued, mid-life)

— and derives the latency decomposition every serving paper reports
(SPEED, arxiv 2310.12072; the accelerated-generation survey, 2405.13019):

- ``queue_wait_s``  = admitted - submitted (admission backpressure cost)
- ``ttft_s``        = first_token - submitted (time to first token)
- ``per_output_token_s`` = (terminal - first_token) / (tokens - 1)
  (steady-state decode cadence; requests emitting < 2 tokens have no
  steady state and observe nothing)
- ``e2e_s``         = terminal - submitted

Each derived quantity feeds a registry histogram (labeled
``component="serving"``) at finalize time, and every raw event is emitted to
the JSONL sink when one is installed (``--telemetry-dir``), so the
per-request timeline survives the process for offline analysis.

Timestamp granularity: the scheduler decodes ``decode_chunk`` steps per
compiled call, so the earliest HOST-visible time for a request's first token
is the end of the chunk that produced it — ``first_token`` is stamped there.
TTFT is therefore measured at chunk granularity (within ``decode_chunk - 1``
steps of the true device time), which is the honest number a host-side
client would observe anyway.

Memory: events for live requests only, plus a bounded ring of finished
traces (``keep_finished``) for tests/debugging — a heavy-traffic server must
not accumulate per-request state forever.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.telemetry.registry import (
    DEFAULT_COUNT_BOUNDS,
    MetricsRegistry,
    get_registry,
)
from fairness_llm_tpu_torch.telemetry.slo import SLOEvaluator
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline

# Canonical event names, in lifecycle order. ``requeued`` may appear between
# admitted and a later (second) admitted; terminal events appear exactly once.
# ``preempted`` is terminal FOR THIS PROCESS only: the request was drained to
# the serving journal (resilience/drain.py) and a resume-serving run gives it
# a fresh lifecycle under the same id. ``shed`` is overload control's
# explicit refusal (serving/overload.py) — terminal with a retry-after
# hint, so the client owns the retry.
LIFECYCLE_EVENTS = (
    "submitted", "admitted", "prefill_start", "first_token",
    "requeued", "completed", "failed", "expired", "preempted", "shed",
)
TERMINAL_EVENTS = ("completed", "failed", "expired", "preempted", "shed")


@dataclasses.dataclass
class SpanEvent:
    request_id: str
    event: str
    t: float  # monotonic clock — durations only, never wall-clock math


@dataclasses.dataclass
class TraceSummaryRow:
    """Derived per-request latency decomposition (None where the lifecycle
    never reached the corresponding event — e.g. no ``ttft_s`` for a request
    that expired in the queue)."""

    request_id: str
    outcome: str
    tokens: int
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    per_output_token_s: Optional[float] = None
    e2e_s: Optional[float] = None


class RequestTracer:
    """Span recorder + histogram feeder for one scheduler's requests.

    ``registry=None`` resolves ``get_registry()`` at write time, so swapping
    the process registry (tests, ``use_registry``) redirects a live
    scheduler's tracer too.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 component: str = "serving", keep_finished: int = 256,
                 labels: Optional[Dict[str, str]] = None):
        self._registry = registry
        self.component = component
        # Extra instrument labels (the fleet's per-replica schedulers pass
        # {"replica": name} so two replicas' histograms never share an
        # instrument); empty for the single-engine path — metric keys are
        # byte-identical to before.
        self.labels = dict(labels or {})
        self._events: Dict[str, List[SpanEvent]] = {}
        self.finished: Deque[Tuple[TraceSummaryRow, List[SpanEvent]]] = \
            collections.deque(maxlen=keep_finished)
        # SLO burn-rate evaluator (telemetry/slo.py), fed once per terminal
        # request from finalize — same labels as every other instrument this
        # tracer writes, so a fleet's replicas burn independently.
        self.slo = SLOEvaluator(component=component, labels=self.labels)

    def _track(self) -> str:
        """Timeline lane for this tracer's scheduler: the replica name in
        fleet mode, else the component (``"serving"``)."""
        return self.labels.get("replica") or self.component

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def record(self, request_id: str, event: str,
               t: Optional[float] = None) -> SpanEvent:
        """Append one lifecycle event (now, unless ``t`` backdates it — the
        scheduler backdates ``submitted`` to the request's own
        ``submitted_at`` stamp so queue-wait starts at intake)."""
        ev = SpanEvent(request_id, event,
                       time.monotonic() if t is None else float(t))
        self._events.setdefault(request_id, []).append(ev)
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        emit_event("span", request_id=request_id, event=event, t=ev.t,
                   component=self.component, **self.labels)
        # Flight-recorder lifecycle ring (telemetry/flightrecorder.py): the
        # recent request edges an incident bundle snapshots — which
        # requests were in flight, and where, when the trigger fired.
        from fairness_llm_tpu_torch.telemetry.flightrecorder import (  # lazy: cycle
            get_flight_recorder,
        )

        get_flight_recorder().record(
            "lifecycle", request_id=request_id, event=event, t=ev.t,
            replica=self.labels.get("replica"),
        )
        # Timeline bridge: every lifecycle edge is an instant on this
        # scheduler's request lane — admissions/evictions/requeues/fences
        # read directly off the Perfetto timeline, on the right replica
        # track (telemetry/timeline.py; no-op when attribution is off).
        get_timeline().record_instant(event, self._track(), t=ev.t,
                                      cat="lifecycle", request_id=request_id)
        return ev

    def events(self, request_id: str) -> List[SpanEvent]:
        return list(self._events.get(request_id, []))

    @staticmethod
    def _last_in(evs: List[SpanEvent], event: str) -> Optional[float]:
        for ev in reversed(evs):
            if ev.event == event:
                return ev.t
        return None

    def finalize(self, request_id: str, outcome: str,
                 tokens: int) -> TraceSummaryRow:
        """Record the terminal event, derive the latency decomposition,
        observe the histograms, and retire the request's live state."""
        if outcome not in TERMINAL_EVENTS:
            raise ValueError(f"outcome must be one of {TERMINAL_EVENTS}, "
                             f"got {outcome!r}")
        end = self.record(request_id, outcome).t
        evs = self._events.pop(request_id, [])
        submitted = next((e.t for e in evs if e.event == "submitted"), None)
        # queue_wait: the FIRST admission (initial backpressure cost).
        # first_token: the LAST occurrence — a fault-requeued request's
        # first attempt's tokens were discarded and never delivered, so TTFT
        # and cadence must describe the stream the client actually received.
        admitted = next((e.t for e in evs if e.event == "admitted"), None)
        first_tok = self._last_in(evs, "first_token")
        row = TraceSummaryRow(request_id=request_id, outcome=outcome,
                              tokens=tokens)
        reg = self._reg()
        c, lbl = self.component, self.labels
        if submitted is not None and admitted is not None:
            row.queue_wait_s = max(admitted - submitted, 0.0)
            reg.histogram("queue_wait_s", component=c,
                          **lbl).observe(row.queue_wait_s)
        if submitted is not None and first_tok is not None:
            row.ttft_s = max(first_tok - submitted, 0.0)
            reg.histogram("ttft_s", component=c, **lbl).observe(row.ttft_s)
        if submitted is not None:
            row.e2e_s = max(end - submitted, 0.0)
            reg.histogram("e2e_latency_s", component=c,
                          **lbl).observe(row.e2e_s)
        if first_tok is not None and tokens >= 2:
            row.per_output_token_s = max(end - first_tok, 0.0) / (tokens - 1)
            reg.histogram("per_output_token_s", component=c, **lbl).observe(
                row.per_output_token_s
            )
        reg.counter("requests_finished_total", component=c,
                    outcome=outcome, **lbl).inc()
        if tokens:
            reg.counter("output_tokens_total", component=c, **lbl).inc(tokens)
        # Request lane span (submitted -> terminal) over the device-step
        # lane, and the SLO evaluator's per-request observation — both
        # no-ops when attribution is off.
        get_timeline().record_request(
            request_id, self._track(),
            submitted if submitted is not None else end, end, outcome,
            tokens=tokens,
        )
        self.slo.observe(outcome, ttft_s=row.ttft_s, e2e_s=row.e2e_s, t=end)
        self.finished.append((row, evs))  # evs already ends with the terminal
        return row

    def sample_step_gauges(self, occupancy: int, queue_depth: int,
                           decode_steps: int = 1) -> None:
        """Per-decode-chunk pool pressure: current gauges plus distribution
        histograms (1-2-5 buckets), weighted by the steps the chunk ran so a
        long chunk counts proportionally."""
        reg = self._reg()
        c, lbl = self.component, self.labels
        reg.gauge("slot_occupancy", component=c, **lbl).set(occupancy)
        reg.gauge("queue_depth", component=c, **lbl).set(queue_depth)
        occ_h = reg.histogram("slot_occupancy_dist", DEFAULT_COUNT_BOUNDS,
                              component=c, **lbl)
        dep_h = reg.histogram("queue_depth_dist", DEFAULT_COUNT_BOUNDS,
                              component=c, **lbl)
        for _ in range(max(decode_steps, 1)):
            occ_h.observe(occupancy)
            dep_h.observe(queue_depth)


def assert_span_order(events: List[SpanEvent]) -> None:
    """Validate one request's lifecycle: timestamps non-decreasing, starts at
    ``submitted``, at most one terminal event and nothing after it. Raises
    AssertionError with the offending pair — used by tests and by the JSONL
    replay tooling; not called on the serving hot path."""
    if not events:
        return
    if events[0].event != "submitted":
        raise AssertionError(f"lifecycle starts with {events[0].event!r}, "
                             "expected 'submitted'")
    for a, b in zip(events, events[1:]):
        if b.t < a.t:
            raise AssertionError(
                f"span timestamps regress: {a.event}@{a.t} -> {b.event}@{b.t}"
            )
        if a.event in TERMINAL_EVENTS:
            raise AssertionError(f"event {b.event!r} after terminal {a.event!r}")
