"""Overload control: QoS classes, deadline-aware admission and SLO-driven
load shedding (the port's copy of ``fairness_llm_tpu/serving/overload.py``).

Fault containment keeps the server alive through faults, not through
overload: without this module every request is equal, and a request whose
deadline is already out of reach still spends a prefill before it expires.
The study's own sweeps are batch floods that would starve interactive
traffic. This module acts on it:

- **QoS classes** (``Request.qos``: ``interactive``, ``batch``, ``probe``):
  the admission queue becomes per-class bounded sub-queues
  (``ClassedAdmissionQueue``, ``serving/queue.py``) with per-class quotas
  and strict-priority-with-aging dequeue.
- **Deadline-feasibility admission** (``DeadlineEstimator``): from the
  scheduler's own ``prefill_wall_s`` and ``per_output_token_s``
  histograms, lower-bound the earliest possible first token (queue
  turnover waves, one prefill, one decode step) and refuse, with
  ``finish_reason="shed"`` and a retry-after hint, a request whose
  remaining deadline is below it. The bound is optimistic on purpose (p50
  estimates, a ``feasibility_safety`` discount, and a cold start never
  refuses): only work that is certainly doomed sheds.
- **SLO-driven shedding** (``ShedController``): a brownout ladder driven by
  the fast-window burn rates (``telemetry/slo.py``) and the queue depth,
  with hysteresis::

      0 healthy
      1 shed_batch          refuse new batch admissions (retry-after)
      2 cap_batch_tokens    also clamp batch max_new_tokens
      3 interactive_only    refuse everything but interactive

  Escalation moves at most one rung per evaluation while a signal is hot;
  each step down needs ``healthy_window_s`` of sustained health. Every
  transition is exported: the ``overload_level`` gauge,
  ``overload_transitions_total{to}``, ``overload_shed``/``overload_restore``
  events, shed/restore instants on the timeline, a decision record and a
  flight-recorder edge. Sheds count ``shed_total{class,reason}``.

The gate lives at the serving front door, the ``ContinuousScheduler``.
Shed requests are left out of the SLO burn (as ``preempted`` is): the
shedding is flow control the controller reports itself, and feeding it back
into the error burn would lock the ladder at its top rung.

The controller and the queue are host-side bookkeeping: a shed is an
explicit ``Result``, never a decode on another device or another path.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from fairness_llm_tpu_torch.config import OverloadConfig
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, QOS_PRIORITY, Request
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import record_decision
from fairness_llm_tpu_torch.telemetry.memory import get_memory_ledger
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline

logger = logging.getLogger(__name__)

# Brownout rungs in escalation order; admits() and batch_cap() hold their
# meaning, the names label events, logs and the gauge.
SHED_LADDER = ("healthy", "shed_batch", "cap_batch_tokens", "interactive_only")


def count_shed(qos: str, reason: str, component: str = "serving",
               labels: Optional[Dict[str, str]] = None) -> None:
    """One shed, attributed: ``shed_total{class, reason}``. Reasons:
    ``overload`` (the class is refused at the current rung),
    ``deadline_infeasible`` (feasibility admission), ``queue_full`` and
    ``rate_limit`` (per-class bounds, where a caller terminates instead of
    backpressuring)."""
    get_registry().counter("shed_total", component=component,
                           **{"class": qos, "reason": reason, **(labels or {})}).inc()


class DeadlineEstimator:
    """Feasibility arithmetic for admission, from live telemetry.

    The earliest first token of a request with ``queued_ahead`` requests of
    the same or a higher class in front of it is at least

        waves x chunk_wall + prefill + one_decode_step

    with ``waves = queued_ahead // num_slots`` (each turnover of the pool
    frees at most ``num_slots`` seats and takes at least one decode chunk)
    and the walls from the scheduler's histograms: ``prefill_wall_s`` p50
    and ``per_output_token_s`` p50. Every term under-estimates, so a
    request failing even this bound is doomed; ``safety`` discounts it
    further. With no telemetry yet, ``estimate_ttft_s`` returns None and
    nothing sheds.

    The p50 includes every prefill the histogram saw, a shape's first call
    too; a caller that arms deadline admission on a process whose first
    calls paid for a kernel build or load warms the shapes first.
    """

    def __init__(self, safety: float = 0.5, component: str = "serving",
                 labels: Optional[Dict[str, str]] = None, clock=time.monotonic):
        self.safety = float(safety)
        self.component = component
        self.labels = dict(labels or {})
        self._clock = clock

    def _p50(self, name: str) -> Optional[float]:
        h = get_registry().peek(name, component=self.component, **self.labels)
        if h is None or not getattr(h, "count", 0):
            return None
        return h.percentile(50)

    def estimate_ttft_s(self, queued_ahead: int, num_slots: int,
                        decode_chunk: int) -> Optional[float]:
        """A lower bound on the seconds to the request's first token, or
        None without telemetry to bound with."""
        prefill = self._p50("prefill_wall_s")
        per_tok = self._p50("per_output_token_s")
        if prefill is None and per_tok is None:
            return None
        waves = max(0, int(queued_ahead)) // max(int(num_slots), 1)
        chunk_s = (per_tok or 0.0) * max(int(decode_chunk), 1)
        return waves * chunk_s + (prefill or 0.0) + (per_tok or 0.0)

    def infeasible(self, request: Request, queued_ahead: int, num_slots: int,
                   decode_chunk: int, now: Optional[float] = None) -> Optional[float]:
        """None when the request may make its deadline (or has none, or the
        safety is 0, or telemetry is cold); else the estimated earliest
        first token in seconds, the retry-after hint's basis. A deadline
        already past is infeasible by definition."""
        if request.deadline_s is None or self.safety <= 0.0:
            return None
        t = self._clock() if now is None else now
        remaining = request.submitted_at + request.deadline_s - t
        est = self.estimate_ttft_s(queued_ahead, num_slots, decode_chunk)
        if remaining <= 0.0:
            return est if est is not None else 0.0
        if est is not None and remaining < self.safety * est:
            return est
        return None


class ShedController:
    """The brownout ladder: one level in [0, 3], walked up under sustained
    overload signals and down only after a sustained-healthy window per
    rung. One controller per serving front door, labelled like its other
    instruments. ``clock`` and ``burn_fn`` are injectable, so that tests
    drive it without sleeping."""

    def __init__(self, config: Optional[OverloadConfig] = None, component: str = "serving",
                 labels: Optional[Dict[str, str]] = None, clock=time.monotonic, burn_fn=None):
        self.config = config or OverloadConfig(enabled=True)
        self.component = component
        self.labels = dict(labels or {})
        self._clock = clock
        # None reads this controller's own labelled burn gauges.
        self._burn_fn = burn_fn
        # Burn-driven escalation needs recent interactive traffic: the burn
        # signal protects latency-sensitive users, and in a single-tenant
        # batch run (a study sweep) the tenant's own deep queue burns the
        # TTFT budget legitimately, where shedding its batch would protect
        # nobody. The depth signal guards the queue in both regimes.
        self._last_interactive: Optional[float] = None
        self.level = 0
        self._healthy_since: Optional[float] = None
        self._last_eval: Optional[float] = None
        # (t, depth) samples over queue_window_s, fed by the serving loop: a
        # maximum that ages out on its own, so the ladder can come down
        # mid-serve.
        self._depth: Deque[Tuple[float, float]] = deque()
        self._depth_capacity = 1.0
        # The gauge exists from construction: a healthy snapshot still
        # shows the controller was armed.
        self._gauge().set(0)

    def _gauge(self):
        return get_registry().gauge("overload_level", component=self.component, **self.labels)

    @property
    def rung(self) -> str:
        return SHED_LADDER[self.level]

    # -- gating -------------------------------------------------------------

    def admits(self, qos: str) -> bool:
        """Whether the current rung admits this class. Rungs 1-2 shed
        ``batch``; rung 3 admits only ``interactive``. Probes live until
        rung 3: blinding the canary while the stack is sick costs more than
        a probe's decode."""
        if self.level <= 0:
            return True
        if self.level >= 3:
            return qos == "interactive"
        return qos != "batch"

    def batch_cap(self, cap: int, qos: str) -> int:
        """At rung 2 and above a batch request's decode budget clamps to
        ``batch_token_cap`` (shorter answers beat none); interactive and
        probe budgets are never touched. With ``headroom_cap_frac`` above 0
        the same clamp engages before rung 2 whenever the memory ledger's
        headroom fraction is at or under it: every decode token is KV
        bytes, so shorter batch answers are the cheapest lever against a
        memory wall."""
        if qos != "batch":
            return cap
        if self.level >= 2:
            return max(1, min(cap, self.config.batch_token_cap))
        if self.config.headroom_cap_frac > 0:
            frac = get_memory_ledger().headroom_frac()
            if frac is not None and frac <= self.config.headroom_cap_frac:
                return max(1, min(cap, self.config.batch_token_cap))
        return cap

    def retry_after(self, est_ttft: Optional[float] = None) -> float:
        """The retry-after hint of a shed: the configured base scaled by the
        rung (a deeper brownout clears slower), or the feasibility estimate
        when that is what refused the request."""
        base = self.config.retry_after_s * max(1, self.level)
        if est_ttft is not None:
            base = max(base, est_ttft)
        return round(base, 3)

    # -- signals and evaluation ---------------------------------------------

    def observe_queue_depth(self, depth: int, capacity: int) -> None:
        """One depth sample from the serving loop (pruned to the window, so
        the windowed maximum decays in quiet stretches)."""
        now = self._clock()
        self._depth.append((now, float(depth)))
        self._depth_capacity = float(max(capacity, 1))
        cutoff = now - self.config.queue_window_s
        while self._depth and self._depth[0][0] < cutoff:
            self._depth.popleft()

    def _depth_frac(self, now: float) -> float:
        cutoff = now - self.config.queue_window_s
        vals = [d for t, d in self._depth if t >= cutoff]
        return (max(vals) / self._depth_capacity) if vals else 0.0

    def _burn(self) -> float:
        """The hottest fast-window burn among the SLOs a brownout relieves
        (error rate and TTFT; e2e recovers with them)."""
        if self._burn_fn is not None:
            return float(self._burn_fn())
        reg = get_registry()
        return max(reg.read_value("slo_burn_rate", default=0.0, component=self.component,
                                  slo=slo, window="fast", **self.labels)
                   for slo in ("error_rate", "ttft_p95"))

    def note_interactive(self, now: Optional[float] = None) -> None:
        """An interactive submission at the front door: arms the burn
        signal for ``interactive_presence_s``."""
        self._last_interactive = self._clock() if now is None else now

    def interactive_present(self, now: float) -> bool:
        return self._last_interactive is not None and \
            now - self._last_interactive <= self.config.interactive_presence_s

    def overloaded(self, now: Optional[float] = None) -> Optional[str]:
        """The hot signal's description, or None when healthy. The queue
        depth always counts; the SLO burn only while interactive traffic
        is present."""
        t = self._clock() if now is None else now
        frac = self._depth_frac(t)
        if frac >= self.config.queue_frac_threshold:
            return f"queue_depth {frac:.2f}x capacity"
        if self.interactive_present(t):
            burn = self._burn()
            if burn >= self.config.burn_threshold:
                return f"slo_burn {burn:.2f}"
        return None

    def maybe_evaluate(self) -> int:
        """``evaluate`` at most once per ``eval_interval_s`` (so reaching
        the top rung takes at least three intervals)."""
        now = self._clock()
        if self._last_eval is not None and now - self._last_eval < self.config.eval_interval_s:
            return self.level
        return self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> int:
        """One controller step: at most one rung up (a signal is hot) or one
        down (healthy for ``healthy_window_s``, the clock restarting per
        rung). Returns the level after the step."""
        t = self._clock() if now is None else now
        self._last_eval = t
        reason = self.overloaded(now=t)
        if reason is not None:
            self._healthy_since = None
            if self.level < len(SHED_LADDER) - 1:
                self._transition(self.level + 1, reason, t)
        else:
            if self._healthy_since is None:
                self._healthy_since = t
            elif self.level > 0 and t - self._healthy_since >= self.config.healthy_window_s:
                # Each step down needs its own healthy window: a marginal
                # signal cannot sawtooth the ladder.
                self._healthy_since = t
                self._transition(self.level - 1, "sustained_healthy", t)
        self._gauge().set(self.level)
        return self.level

    def _transition(self, to: int, reason: str, now: float) -> None:
        frm, self.level = self.level, to
        escalating = to > frm
        self._gauge().set(to)
        scope = self.labels.get("replica") or self.labels.get("fleet") or self.component
        # The rung move with the signals it was judged on, and a flight-
        # recorder edge, so a postmortem shows why the ladder was there.
        record_decision("overload", f"{frm}->{to}",
                        signals={"rung": SHED_LADDER[to], "reason": reason,
                                 "queue_frac": round(self._depth_frac(now), 3),
                                 "burn": round(self._burn(), 3)},
                        replica=self.labels.get("replica"))
        get_flight_recorder().transition("overload_level", scope, to, reason=reason)
        get_registry().counter("overload_transitions_total", component=self.component,
                               to=str(to), **self.labels).inc()
        emit_event("overload_shed" if escalating else "overload_restore", level=to,
                   rung=SHED_LADDER[to], reason=reason, component=self.component, **self.labels)
        get_timeline().record_instant("shed" if escalating else "restore",
                                      self.labels.get("replica") or self.component, t=now,
                                      cat="overload", level=to, reason=reason)
        log = logger.warning if escalating else logger.info
        log("overload level %d -> %d (%s): %s", frm, to, SHED_LADDER[to], reason)


__all__ = [
    "DeadlineEstimator",
    "QOS_CLASSES",
    "QOS_PRIORITY",
    "SHED_LADDER",
    "ShedController",
    "count_shed",
]
