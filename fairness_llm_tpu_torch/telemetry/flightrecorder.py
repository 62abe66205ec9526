"""Always-on flight recorder: bounded rings over the high-rate state that
is too voluminous to persist.

The port's copy of ``fairness_llm_tpu/telemetry/flightrecorder.py``; its
consumer is the port's incident engine (``telemetry/incidents.py``).

The registry (``telemetry/registry.py``) keeps AGGREGATES forever and the
JSONL sink persists low-rate events; neither holds the last few seconds of
HIGH-RATE state an incident needs — the recent decode chunks with their
step gaps, the recent breaker/ladder/overload gauge transitions, the recent
request-lifecycle edges, the last-K roofline samples, the decision trail.
When a breaker opens or a replica fences, the gauges have already moved on
and the operator reconstructs "what led here" from logs, if at all.

The flight recorder is the black box: one bounded ``deque`` per ring
category, O(1) append, oldest-evicted, never persisted on its own — its
only consumer is the incident engine (``telemetry/incidents.py``), which
snapshots every ring into a postmortem bundle at the moment a trigger
fires. Ring contents are plain dicts stamped with a monotonic ``t`` so the
bundle can be cross-referenced against timeline spans and span events.

Ring categories (``RING_CATEGORIES``):

- ``chunks``      — recent decode-chunk invocations (program, steps, wall,
                    step gap) from the serving scheduler;
- ``transitions`` — recent gauge transitions (breaker state, ladder level,
                    overload rung, autoscale target, replica health score)
                    recorded ONLY on change (``transition``'s per-key
                    last-value dedup), so an unchanged gauge costs nothing;
- ``lifecycle``   — recent request-lifecycle span events (submitted /
                    admitted / first_token / terminal, per replica);
- ``roofline``    — last-K decode-chunk roofline samples (achieved GB/s,
                    achieved/achievable fraction, per program);
- ``decisions``   — the decision audit trail (``telemetry/incidents.py``
                    appends ``DecisionRecord``s here) — EXCEPT ``route``;
- ``routes``      — per-admission placement decisions, in their own ring:
                    at thousands of admissions/s a shared ring would hold
                    well under a second of history, evicting the rare
                    breaker/fence/autoscale decisions a postmortem's
                    causal chain exists to keep.

Gating mirrors ``set_attribution``: one switch (``set_recording``) turns
the recorder AND the decision trail off process-wide, and the recorder
additionally respects the attribution switch — attribution off records
NOTHING, so the bench ``profiling_overhead`` A/B's off mode stays silent
and the ``incident_overhead`` A/B isolates exactly this layer's cost.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional

from fairness_llm_tpu_torch.telemetry.timeline import attribution_on

RING_CATEGORIES = ("chunks", "transitions", "lifecycle", "roofline",
                   "decisions", "routes", "memory")

DEFAULT_RING_CAPACITY = 512


class FlightRecorder:
    """Bounded per-category rings. Single-threaded by design, like the
    scheduler loop that is its main writer; ``clock`` is injectable for
    deterministic tests."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = True
        self._clock = clock
        self.rings: Dict[str, Deque[Dict]] = {
            cat: deque(maxlen=capacity) for cat in RING_CATEGORIES
        }
        self.dropped: Dict[str, int] = {cat: 0 for cat in RING_CATEGORIES}
        # (name, key) -> last recorded value, the transition dedup store.
        self._last: Dict[tuple, object] = {}

    def recording(self) -> bool:
        """Whether anything is recorded right now: the recorder's own
        switch AND the attribution switch (attribution off silences the
        whole observation layer, this ring included)."""
        return self.enabled and attribution_on()

    def record(self, ring: str, **fields) -> bool:
        """Append one entry to ``ring`` (stamped ``t`` unless the caller
        provided one); O(1), oldest-evicted. Returns False when gated
        off or the category is unknown (never raises — the recorder must
        not be able to take the hot path down)."""
        buf = self.rings.get(ring)
        if buf is None or not self.recording():
            return False
        if len(buf) == buf.maxlen:
            self.dropped[ring] += 1
        fields.setdefault("t", self._clock())
        buf.append(fields)
        return True

    def transition(self, name: str, key: str, value, **ctx) -> bool:
        """Record a gauge transition into the ``transitions`` ring ONLY
        when ``value`` differs from the last recorded one for (name, key)
        — the dedup that makes per-pick health-score sampling affordable.
        The dedup store updates only while recording, so flipping the
        switch back on records the then-current value as a fresh edge."""
        if not self.recording():
            return False
        k = (name, key)
        prev = self._last.get(k, _UNSET)
        if prev == value:
            return False
        self._last[k] = value
        return self.record("transitions", name=name, key=key, value=value,
                           prev=(None if prev is _UNSET else prev), **ctx)

    def snapshot(self) -> Dict:
        """Every ring's contents (oldest first) plus drop counts — the
        shape the incident bundle persists as ``flightrecorder.json``."""
        return {
            "capacity": self.capacity,
            "recording": self.recording(),
            "rings": {cat: list(buf) for cat, buf in self.rings.items()},
            "dropped": dict(self.dropped),
        }

    def clear(self) -> None:
        for buf in self.rings.values():
            buf.clear()
        self.dropped = {cat: 0 for cat in RING_CATEGORIES}
        self._last.clear()


_UNSET = object()


# -- the process-wide recorder -------------------------------------------------

_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder every instrumented call site writes to —
    resolved at write time (never cached), same contract as
    ``get_registry``/``get_timeline``."""
    return _recorder


def set_flight_recorder(rec: FlightRecorder) -> FlightRecorder:
    global _recorder
    prev, _recorder = _recorder, rec
    return prev


class use_flight_recorder:
    """Context manager: route recording to a fresh (or given) recorder
    inside the block — test isolation, like ``use_registry``."""

    def __init__(self, rec: Optional[FlightRecorder] = None):
        self.recorder = rec if rec is not None else FlightRecorder()
        self._prev: Optional[FlightRecorder] = None

    def __enter__(self) -> FlightRecorder:
        self._prev = set_flight_recorder(self.recorder)
        return self.recorder

    def __exit__(self, *exc) -> None:
        set_flight_recorder(self._prev)


def recording_on() -> bool:
    """Whether the flight recorder + decision trail record anything — the
    incident layer's one switch (the attribution switch still vetoes)."""
    return _recorder.recording()


def set_recording(on: bool) -> bool:
    """Flip the recorder + decision-trail layer process-wide; returns the
    previous state (the bench ``incident_overhead`` A/B's off switch —
    ``set_attribution``'s sibling)."""
    prev = _recorder.enabled
    _recorder.enabled = bool(on)
    return prev
