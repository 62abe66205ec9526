"""Per-stage circuit breakers and the degradation ladder they drive (the
port's copy of ``fairness_llm_tpu/resilience/breaker.py``).

The fault containment added with the serving subsystem is *per-request*:
requeue once, then fail the request. That is the right unit for a transient
fault, and exactly wrong for a persistent one — a stage that fails every
attempt (a poisoned weight, a sick device, an OOM-thrashing pool)
would burn a prefill + a decode chunk per victim forever, at full rate.

``CircuitBreaker`` is the classic closed -> open -> half-open machine, one
per stage (``prefill`` / ``decode`` / ``speculate``), driven by CONSECUTIVE
fault counts (single-threaded loops, so no windowed rates needed):

- closed:    normal operation; ``failure_threshold`` consecutive faults trip
             it open (any success resets the count).
- open:      ``allow()`` refuses work for ``cooldown_s``, so the loop stops
             hammering the failing stage (queued work waits; live requests
             are already requeued/failed by containment).
- half-open: after the cooldown, attempts are allowed again as probes — the
             first success closes the breaker, the first failure re-opens it
             and restarts the cooldown.

``BreakerBoard`` groups the stages and owns the :class:`DegradationLadder`:
each stage's closed->open trip advances one rung and its recovery to closed
retreats it (a stage holds at most one rung while tripped, so all-breakers-
healthy always means level 0). The rungs order features by what they cost
to lose:

    0  normal              everything on
    1  no_speculation      drop speculative decoding — a pure-throughput
                           feature whose output is identical by construction
                           (greedy draft-and-verify), so shedding it costs
                           latency but never correctness
    2  reduced_footprint   halve the serving decode chunk and soft-cap the
                           slot pool at half — shorter decode chunks and a
                           smaller blast radius per fault
    3  static_fallback     route new generate() calls through the static
                           ``DecodeEngine`` path (``serving/backend.py``) —
                           the least-clever program, which runs the same
                           hand-written kernels (no plain-version fallback)

Every transition is exported: ``breaker_state{stage}`` gauges (0 closed,
1 half-open, 2 open), ``breaker_transitions_total{stage,to}`` counters,
``degradation_level`` gauge, plus JSONL events when a sink is installed.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision

logger = logging.getLogger(__name__)

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

STAGES: Tuple[str, ...] = ("prefill", "decode", "speculate")


class CircuitBreaker:
    """One stage's closed/open/half-open machine. Single-threaded by design
    (like every loop that consults it); ``clock`` is injectable so tests and
    chaos drills never sleep through a cooldown."""

    def __init__(
        self,
        stage: str,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        component: str = "serving",
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
        labels: Optional[Mapping[str, str]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.stage = stage
        self.failure_threshold = failure_threshold
        self.cooldown_s = float(cooldown_s)
        self.component = component
        # Extra instrument labels (a fleet replica's board passes
        # {"replica": name} so per-replica breaker state never aliases);
        # empty for the single-engine path — metric keys unchanged.
        self.labels = dict(labels or {})
        self.clock = clock
        self.on_transition = on_transition
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        # Gauge exists (at 0 = closed) from construction, so a snapshot of a
        # healthy run still shows the breaker was armed.
        get_registry().gauge(
            "breaker_state", component=component, stage=stage, **self.labels
        ).set(_STATE_CODE[CLOSED])

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        if new == OPEN:
            self.opened_at = self.clock()
        reg = get_registry()
        reg.gauge("breaker_state", component=self.component,
                  stage=self.stage, **self.labels).set(_STATE_CODE[new])
        reg.counter("breaker_transitions_total", component=self.component,
                    stage=self.stage, to=new, **self.labels).inc()
        emit_event("breaker_transition", component=self.component,
                   stage=self.stage, from_state=old, to_state=new,
                   consecutive_failures=self.consecutive_failures,
                   **self.labels)
        logger.warning("breaker[%s/%s]: %s -> %s", self.component, self.stage,
                       old, new)
        # Incident engine (telemetry/incidents.py): the transition as a
        # first-class decision with its input signal (the consecutive-fault
        # count that drove it), a flight-recorder gauge edge, and — on the
        # trip to OPEN — an incident trigger so the moment-of-failure state
        # is captured while it still exists. Scope is the replica (or the
        # component for the single-engine path), so one sick replica's
        # fault storm dedups to one bundle however many stages it takes.
        scope = self.labels.get("replica") or self.component
        record_decision(
            "breaker", f"{self.stage}:{old}->{new}",
            signals={"consecutive_failures": self.consecutive_failures,
                     "stage": self.stage},
            replica=self.labels.get("replica"),
        )
        get_flight_recorder().transition(
            "breaker_state", f"{scope}/{self.stage}", new, prev_state=old
        )
        if new == OPEN:
            maybe_trigger(
                "breaker_open",
                f"{self.stage} breaker open after "
                f"{self.consecutive_failures} consecutive failure(s)",
                scope=scope, replica=self.labels.get("replica"),
                stage=self.stage,
            )
        if self.on_transition is not None:
            self.on_transition(self.stage, old, new)

    def allow(self) -> bool:
        """May the caller attempt this stage right now? Open refuses until
        the cooldown elapses, then flips half-open (this call IS the first
        probe's permission). Half-open allows attempts — the single-threaded
        caller records each outcome before asking again, so probes can't
        stampede."""
        if self.state == OPEN:
            if self.opened_at is not None and \
                    self.clock() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
                return True
            return False
        return True

    def record_failure(self) -> None:
        get_registry().counter("breaker_failures_total",
                               component=self.component,
                               stage=self.stage, **self.labels).inc()
        if self.state == HALF_OPEN:
            # The probe failed: straight back to open, cooldown restarts.
            self.consecutive_failures += 1
            self._transition(OPEN)
            return
        self.consecutive_failures += 1
        if self.state == CLOSED and \
                self.consecutive_failures >= self.failure_threshold:
            self._transition(OPEN)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self._transition(CLOSED)

    @property
    def seconds_until_probe(self) -> Optional[float]:
        """How long until an open breaker half-opens (None unless open) —
        lets a blocked loop sleep instead of spinning on ``allow()``."""
        if self.state != OPEN or self.opened_at is None:
            return None
        return max(0.0, self.cooldown_s - (self.clock() - self.opened_at))


class DegradationLadder:
    """Monotone rung counter mapping breaker trips to shed features.

    ``advance()``/``retreat()`` move one rung and export the level; the
    *effects* live with the owners of the features (the scheduler applies
    rungs 1-2, ``ServingBackend`` applies rung 3) by polling ``level`` —
    effects-by-polling keeps the ladder free of references into the serving
    stack, so it is reusable by the engine-only path too.
    """

    RUNGS: Tuple[str, ...] = (
        "normal", "no_speculation", "reduced_footprint", "static_fallback"
    )

    def __init__(self, component: str = "serving",
                 labels: Optional[Mapping[str, str]] = None):
        self.component = component
        self.labels = dict(labels or {})
        self.level = 0
        get_registry().gauge("degradation_level", component=component,
                             **self.labels).set(0)

    @property
    def rung(self) -> str:
        return self.RUNGS[self.level]

    def _set(self, level: int) -> None:
        level = max(0, min(level, len(self.RUNGS) - 1))
        if level == self.level:
            return
        old, self.level = self.level, level
        reg = get_registry()
        reg.gauge("degradation_level", component=self.component,
                  **self.labels).set(level)
        reg.counter("degradation_transitions_total", component=self.component,
                    to=self.RUNGS[level], **self.labels).inc()
        emit_event("degradation", component=self.component,
                   from_level=old, to_level=level, rung=self.RUNGS[level],
                   **self.labels)
        scope = self.labels.get("replica") or self.component
        record_decision(
            "ladder", f"{old}->{level}",
            signals={"rung": self.RUNGS[level]},
            replica=self.labels.get("replica"),
        )
        get_flight_recorder().transition("degradation_level", scope, level)
        log = logger.warning if level > old else logger.info
        log("degradation[%s]: level %d (%s) -> %d (%s)", self.component,
            old, self.RUNGS[old], level, self.RUNGS[level])

    def advance(self) -> None:
        self._set(self.level + 1)

    def retreat(self) -> None:
        self._set(self.level - 1)


class BreakerBoard:
    """The per-stage breakers plus the ladder they drive, as one unit the
    scheduler/engine/backend share (``backend_for`` builds one per serving
    backend; the engine's speculate breaker is the same board's)."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        component: str = "serving",
        clock: Callable[[], float] = time.monotonic,
        stages: Tuple[str, ...] = STAGES,
        labels: Optional[Mapping[str, str]] = None,
    ):
        self.ladder = DegradationLadder(component=component, labels=labels)
        self.breakers: Dict[str, CircuitBreaker] = {
            stage: CircuitBreaker(
                stage, failure_threshold=failure_threshold,
                cooldown_s=cooldown_s, component=component, clock=clock,
                on_transition=self._on_transition, labels=labels,
            )
            for stage in stages
        }

    def _on_transition(self, stage: str, old: str, new: str) -> None:
        # Each stage holds AT MOST one rung while tripped: advance on the
        # closed -> open trip only (a failed half-open probe re-opens but
        # the stage already contributed), retreat when it recovers to
        # closed. Invariant: all breakers closed => ladder back at 0 —
        # degradation is a function of current health, not trip history.
        if new == OPEN and old == CLOSED:
            self.ladder.advance()
        elif new == CLOSED and old == HALF_OPEN:
            self.ladder.retreat()

    def allow(self, stage: str) -> bool:
        return self.breakers[stage].allow()

    def record_failure(self, stage: str) -> None:
        self.breakers[stage].record_failure()

    def record_success(self, stage: str) -> None:
        self.breakers[stage].record_success()

    def state(self, stage: str) -> str:
        return self.breakers[stage].state

    def open_count(self) -> int:
        """Stages currently refusing work — a fleet-router fence input."""
        return sum(1 for b in self.breakers.values() if b.state == OPEN)

    def trip(self, stage: str) -> None:
        """Force one stage's breaker open — for detectors with DIRECT
        evidence the stage is dead (a canary mismatch, a replica crash
        signal), which spend the whole failure budget at once instead of
        accumulating consecutive faults. Recovery stays the breaker's own
        half-open probe."""
        breaker = self.breakers[stage]
        while breaker.state != OPEN:
            breaker.record_failure()

    def seconds_until_probe(self, stage: str) -> Optional[float]:
        return self.breakers[stage].seconds_until_probe
