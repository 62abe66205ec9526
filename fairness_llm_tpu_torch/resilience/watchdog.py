"""Step-progress watchdog: classify a step as hung (the port's copy of
``fairness_llm_tpu/resilience/watchdog.py``).

The serving scheduler and the decode engine stamp per-step liveness into
telemetry: the ``step_last_completed_ts`` gauge, updated after every
prefill and decode call, and the 30 s ``Heartbeat`` pulse. The watchdog is
a *policy* on top of those timestamps: a call that never returns (a device
lockup, a preempted-but-not-killed host) stalls the single-threaded loop
forever with no signal distinguishing "slow" from "dead".

``StepWatchdog`` is that policy, in two modes sharing one threshold:

- **Inline enforcement** (the containment path): the loop ``arm()``s before
  a call and ``observe()``s after it. A step's wall time means something
  only once the device has finished it, so the callers observe after a
  sync: the serve loop reads its tokens back every step, and the prefills
  end in ``engine._sync()``. A step whose wall time exceeds
  ``max_step_seconds`` raises :class:`HangFault`, a ``DecodeFault``, so
  every containment path already absorbs it. Classification is post-hoc (a
  single-threaded loop cannot interrupt its own blocked call); its value is
  turning "silently 40x slower than budget" into a contained, counted,
  breaker-visible fault.
- **External stall detection** (``stalled()``): any other thread holding
  the registry reads the ``step_last_completed_ts`` gauge back and learns
  how long the loop has gone without completing a step.

First use is exempt (``classify=False``): in the port that is the first
call of a (stage, shape) key in the process and any call during which a
kernel library was built or loaded (``first_use``), since the first use of
a kernel runs ``nvcc`` (minutes) and the first call at a shape pays for
allocations and library warm-up. Hangs are injectable without sleeping:
``ScriptedFaultInjector`` hangs feed ``observe(extra_s=...)``, and they
classify regardless of the exemption; ``clock`` is injectable for tests.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional

from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.utils.failures import HangFault

# The gauge the scheduler/engine loops stamp after every completed step;
# ``stalled()`` reads it back. One gauge per (component, labels): a fleet
# replica's watchdog stamps its own gauge, so one hung replica's stall probe
# can fire while its siblings' gauges stay fresh.
LAST_STEP_GAUGE = "step_last_completed_ts"


# (stage, shape) keys already called in this process: kernel builds, loads
# and first-shape allocations are process-wide, so the exemption is too.
_seen_keys: set = set()


def first_use(key: tuple, load_events_before: int) -> bool:
    """Whether a call keyed ``key`` (its stage and shape) was the first of
    its key in this process, or built or loaded a kernel library (the
    ``ops._build.load_events`` count moved past ``load_events_before``, the
    count read before the call). Records ``key`` as seen."""
    fresh = key not in _seen_keys
    _seen_keys.add(key)
    return fresh or _build.load_events != load_events_before


def mark_step_completed(component: str,
                        clock: Callable[[], float] = time.monotonic,
                        labels: Optional[Mapping[str, str]] = None) -> None:
    """Stamp the shared liveness gauge (monotonic clock — ``stalled()``
    computes durations from it, never wall-clock math)."""
    get_registry().gauge(LAST_STEP_GAUGE, component=component,
                         **(labels or {})).set(clock())


class StepWatchdog:
    """Hang classification for one component's step loop.

    ``max_step_seconds <= 0`` disables classification (``observe`` still
    feeds the ``step_wall_s`` histogram, so the threshold can be chosen from
    real data before enforcement is turned on).
    """

    def __init__(
        self,
        max_step_seconds: float,
        component: str = "serving",
        clock: Callable[[], float] = time.monotonic,
        labels: Optional[Mapping[str, str]] = None,
    ):
        self.max_step_seconds = float(max_step_seconds)
        self.component = component
        # Extra instrument labels ({"replica": name} for fleet replicas) —
        # both the written histograms/gauges and the liveness gauge
        # ``stalled()`` reads back use them, keeping each replica's
        # liveness its own.
        self.labels = dict(labels or {})
        self.clock = clock
        self._armed: Dict[str, float] = {}  # stage -> arm timestamp

    def arm(self, stage: str) -> float:
        """Mark a call about to start; returns the arm timestamp."""
        t = self.clock()
        self._armed[stage] = t
        return t

    def observe(
        self,
        stage: str,
        elapsed: Optional[float] = None,
        extra_s: float = 0.0,
        classify: bool = True,
        budget_scale: float = 1.0,
    ) -> float:
        """Record one completed step and classify it.

        ``elapsed`` overrides the armed-clock measurement (callers that
        already timed the call); ``extra_s`` adds simulated hang seconds from
        the fault injector so chaos drills never really sleep. Raises
        :class:`HangFault` when the total exceeds ``max_step_seconds``
        (times ``budget_scale`` — the serve loop scales the budget by its
        fuse factor, since one fused call legitimately runs k chunks' worth
        of wall and a threshold tuned for one chunk would classify every
        healthy fused call as a hang).

        ``classify=False`` records the histogram but skips classification —
        for steps whose wall legitimately includes one-off work the budget
        was never meant to cover (``first_use``: a kernel build with
        ``nvcc`` takes minutes, and faulting it would requeue healthy
        requests and feed the breakers on a healthy run). Injected stalls
        (``extra_s > 0``) classify regardless, so scripted chaos is never
        masked by a first use.
        """
        if elapsed is None:
            armed = self._armed.pop(stage, None)
            elapsed = 0.0 if armed is None else self.clock() - armed
        else:
            self._armed.pop(stage, None)
        total = float(elapsed) + float(extra_s)
        budget = self.max_step_seconds * max(float(budget_scale), 1.0)
        reg = get_registry()
        reg.histogram("step_wall_s", component=self.component,
                      stage=stage, **self.labels).observe(total)
        reg.gauge("watchdog_last_step_s", component=self.component,
                  **self.labels).set(total)
        mark_step_completed(self.component, self.clock, self.labels)
        if self.max_step_seconds > 0 and total > budget \
                and (classify or extra_s > 0):
            reg.counter("watchdog_hangs_total", component=self.component,
                        stage=stage, **self.labels).inc()
            emit_event("watchdog_hang", component=self.component, stage=stage,
                       step_s=round(total, 3),
                       max_step_seconds=budget, **self.labels)
            raise HangFault(
                f"{self.component} {stage} step took {total:.3f}s "
                f"(> max_step_seconds {budget:g})"
            )
        return total

    def stalled(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds past ``max_step_seconds`` since the component last
        completed a step, read from the telemetry gauge — None while healthy
        or before any step completed. The external-monitor view: does not
        raise, does not require this object to be the one arming steps."""
        # peek, not gauge(): an observer must not create a zero-valued gauge
        # (which would read as "last step at t=0 = stalled forever").
        g = get_registry().peek(LAST_STEP_GAUGE, component=self.component,
                                **self.labels)
        if g is None or not g.value:
            return None
        now = self.clock() if now is None else now
        idle = now - g.value
        if self.max_step_seconds > 0 and idle > self.max_step_seconds:
            return idle - self.max_step_seconds
        return None
