"""Heartbeat logger for long sweeps (counterpart of
``fairness_llm_tpu/telemetry/heartbeat.py``).

A multi-hour sweep (thousands of profiles, or a long serving drain) emits
per-chunk DEBUG/INFO lines that scroll away; the heartbeat is the opposite:
a LOW-frequency, high-signal pulse — at most one line per ``interval_s`` —
carrying cumulative progress and the registry's live totals, plus a JSONL
``heartbeat`` event when a sink is installed so liveness is reconstructable
from the telemetry dir after the fact ("was it still making progress at
02:13, and at what rate?").

Passive by design: ``poke()`` is called from loops that already run on the
host (``decode_sweep`` per chunk, the scheduler per iteration) and does
nothing until the interval elapses. No background thread — a thread would
outlive test processes and interleave with kernel launches for zero benefit at
a once-per-30s duty cycle.

Missed-beat gap detection: a passive pulse that is LATE is itself a signal
— the loop that should have poked it went dark (a hung kernel, a
co-tenant stealing the host, a silent stall the watchdog's per-step budget
was too generous to classify). When a beat arrives more than
``GAP_FACTOR`` x the interval after the previous one, the full dark period
is observed into the ``heartbeat_gap_s`` histogram and the worst case into
the ``heartbeat_gap_max_s`` gauge, so ``telemetry-report`` surfaces the
max gap next to the beat count. Each gap is a ``heartbeat`` decision of the
incident engine (``telemetry/incidents.py``), and a gap past
``INCIDENT_GAP_FACTOR`` intervals triggers a ``heartbeat_gap`` bundle. The
clock is injectable for tests.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)


# A beat later than this many intervals after the previous one counts as a
# missed-beat gap (1.5: one whole missed interval plus scheduling slop —
# normal cadence lands just past 1.0x).
GAP_FACTOR = 1.5

# A gap past this many intervals is a SUSTAINED dark period, routed through
# the incident trigger registry: two whole missed beats beyond the
# ordinary-gap threshold (co-tenant jitter recovers inside one interval; a
# wedge does not).
INCIDENT_GAP_FACTOR = 4.0


class Heartbeat:
    def __init__(self, interval_s: float = 30.0, name: str = "sweep",
                 clock=time.monotonic):
        self.interval_s = interval_s
        self.name = name
        self._clock = clock
        self.started_at = clock()
        self._last_beat: Optional[float] = None
        self.beats = 0
        self.max_gap_s = 0.0

    def poke(self, **fields) -> bool:
        """Maybe emit one heartbeat; returns True when it fired. ``fields``
        are caller progress (e.g. ``completed=32, total=45``) merged into
        both the log line and the JSONL event."""
        now = self._clock()
        from fairness_llm_tpu_torch.telemetry import emit_event, get_registry

        if self._last_beat is not None:
            since = now - self._last_beat
            if since < self.interval_s:
                return False
            if since > GAP_FACTOR * self.interval_s:
                # The loop went dark: record the WHOLE dark period (what an
                # operator grepping "was it alive at 02:13" experiences),
                # not just the overshoot.
                self.max_gap_s = max(self.max_gap_s, since)
                reg = get_registry()
                reg.histogram("heartbeat_gap_s",
                              component=self.name).observe(since)
                reg.gauge("heartbeat_gap_max_s",
                          component=self.name).set_max(since)
                emit_event("heartbeat_gap", name=self.name,
                           gap_s=round(since, 2))
                from fairness_llm_tpu_torch.telemetry.incidents import (
                    maybe_trigger,
                    record_decision,
                )

                record_decision(
                    "heartbeat", "gap",
                    signals={"name": self.name, "gap_s": round(since, 2),
                             "interval_s": self.interval_s},
                )
                if since > INCIDENT_GAP_FACTOR * self.interval_s:
                    maybe_trigger(
                        "heartbeat_gap",
                        f"{self.name} went dark {since:.1f}s "
                        f"(interval {self.interval_s:g}s)",
                        scope=self.name, gap_s=round(since, 2),
                    )
        self._last_beat = now
        self.beats += 1
        uptime = now - self.started_at
        get_registry().counter("heartbeats_total", component=self.name).inc()
        info = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.info("heartbeat[%s] uptime=%.0fs %s", self.name, uptime, info)
        emit_event("heartbeat", name=self.name, uptime_s=round(uptime, 1),
                   **fields)
        return True
