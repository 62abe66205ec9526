"""SLO evaluation: objectives, multi-window burn rates, alert events.

The port's copy of ``fairness_llm_tpu/telemetry/slo.py``. The targets are
set with ``set_slo_targets`` (the CLI sets them from ``TelemetryConfig``
before any scheduler exists). An alert is a decision of the incident engine, and an error-rate alert
triggers a ``slo_burn`` bundle, as in the reference.

The telemetry layer so far exports raw distributions (TTFT/e2e histograms,
fault counters) and leaves "is this fleet healthy?" to a human reading
percentiles. This module gives the stack OBJECTIVES and the standard SRE
derived signal — burn rate — so the fleet router and the CI gates consume
one number instead of re-deriving judgment from histograms:

- **Objectives** (``SLOTargets``, configured via ``TelemetryConfig``):
  - TTFT: at most ``ttft_budget`` (default 5%) of requests may exceed
    ``ttft_p95_s`` — i.e. "p95 TTFT <= target";
  - e2e: at most ``e2e_budget`` (default 1%) may exceed ``e2e_p99_s``;
  - errors: at most ``error_rate`` of requests may fail/expire.
- **Burn rate** = (observed bad fraction) / (budgeted bad fraction): 1.0
  means consuming the error budget exactly as fast as the SLO allows;
  4.0 means burning it 4x too fast. Computed over three windows —
  ``fast`` (default 60 s: page-now signal), ``slow`` (default 600 s:
  sustained problem), and ``run`` (everything retained) — exported as
  ``slo_burn_rate{slo, window}`` gauges (per replica in fleet mode, since
  every scheduler's tracer owns an evaluator labeled like its other
  instruments).
- **Alerts**: crossing burn 1.0 upward counts ``slo_alerts_total{slo,
  window}`` and emits an ``slo_alert`` JSONL event (``slo_resolved`` on
  the way back down). The fleet's ``HealthRouter`` reads the fast-window
  error burn as an additional placement discount, so a replica burning its
  error budget sheds traffic before its breakers ever open.

``preempted`` outcomes are excluded entirely: preemption is infrastructure
scheduling (the request resumes in a successor process), not service
failure — counting it would page on every drain. ``shed`` outcomes are
excluded for the inverse reason: deliberate load shedding
(serving/overload.py) is the CONTROLLER acting on these burn rates, and
feeding its own refusals back into the error burn would lock the brownout
ladder at its top rung. Sheds are first-class observable via
``shed_total{class,reason}`` instead.

The ``slo-report`` CLI subcommand renders these from a snapshot
(``render_slo_report``). Observation gates on the attribution switch
(``timeline.set_attribution``) like the rest of the layer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import attribution_on

ERROR_OUTCOMES = ("failed", "expired")


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Service objectives + burn-rate windows. Frozen/hashable like every
    other config object (``TelemetryConfig`` carries the user-facing
    fields)."""

    ttft_p95_s: float = 2.0
    e2e_p99_s: float = 30.0
    error_rate: float = 0.01
    ttft_budget: float = 0.05  # "p95" objective: 5% may exceed the target
    e2e_budget: float = 0.01  # "p99" objective: 1% may exceed the target
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0


_targets = SLOTargets()


def set_slo_targets(t: SLOTargets) -> SLOTargets:
    """Install process-wide targets (the CLI does this from
    ``TelemetryConfig`` before any scheduler is built); returns the
    previous ones."""
    global _targets
    prev, _targets = _targets, t
    return prev


def get_slo_targets() -> SLOTargets:
    return _targets


class SLOEvaluator:
    """Per-scheduler burn-rate computer, fed one observation per terminal
    request (``RequestTracer.finalize``). Keeps a bounded window of
    (timestamp, flags) tuples — no per-request state beyond that.

    ``targets=None`` resolves ``get_slo_targets()`` at observe time, so a
    late ``set_slo_targets`` (or a test's) takes effect without rebuilding
    schedulers."""

    def __init__(self, targets: Optional[SLOTargets] = None,
                 component: str = "serving",
                 labels: Optional[Dict[str, str]] = None,
                 capacity: int = 4096, clock=time.monotonic):
        self._targets = targets
        self.component = component
        self.labels = dict(labels or {})
        self._clock = clock
        # (t, is_error, ttft_over: Optional[bool], e2e_over: Optional[bool])
        # — the TIME windows' backing store. ``capacity`` bounds it, so the
        # fast/slow windows are exact as long as fewer than ``capacity``
        # requests terminate inside the slow window span; the run window
        # does NOT read this deque (cumulative counters below), so it can
        # never silently truncate.
        self._obs: Deque[Tuple[float, bool, Optional[bool], Optional[bool]]] \
            = deque(maxlen=capacity)
        # Whole-run totals: [n, errors, ttft_n, ttft_over, e2e_n, e2e_over].
        self._run = [0, 0, 0, 0, 0, 0]
        self._alerting: Dict[Tuple[str, str], bool] = {}
        self._targets_published = False
        self._last_eval: Optional[float] = None

    @property
    def targets(self) -> SLOTargets:
        return self._targets if self._targets is not None \
            else get_slo_targets()

    def observe(self, outcome: str, ttft_s: Optional[float] = None,
                e2e_s: Optional[float] = None,
                t: Optional[float] = None) -> Optional[Dict]:
        """Ingest one terminal request and re-evaluate every window.
        Returns the burn rates (None when gated off / preempted / shed)."""
        if not attribution_on() or outcome in ("preempted", "shed"):
            return None
        tg = self.targets
        now = self._clock() if t is None else float(t)
        ob = (
            now,
            outcome in ERROR_OUTCOMES,
            None if ttft_s is None else ttft_s > tg.ttft_p95_s,
            None if e2e_s is None else e2e_s > tg.e2e_p99_s,
        )
        self._obs.append(ob)
        r = self._run
        r[0] += 1
        r[1] += ob[1]
        if ob[2] is not None:
            r[2] += 1
            r[3] += ob[2]
        if ob[3] is not None:
            r[4] += 1
            r[5] += ob[3]
        return self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Burn rates per (window, slo), exported as gauges; alert
        crossings counted/emitted. Shape: {window: {slo: burn}}."""
        tg = self.targets
        if now is None:
            now = self._clock()
        reg = get_registry()
        if not self._targets_published:
            for slo, target in (("ttft_p95", tg.ttft_p95_s),
                                ("e2e_p99", tg.e2e_p99_s),
                                ("error_rate", tg.error_rate)):
                reg.gauge("slo_target", component=self.component, slo=slo,
                          **self.labels).set(target)
            self._targets_published = True
        self._last_eval = now
        out: Dict[str, Dict[str, float]] = {}
        for window, span in (("fast", tg.fast_window_s),
                             ("slow", tg.slow_window_s), ("run", None)):
            if span is None:
                # Whole-run burn from the cumulative counters — exact even
                # past the deque's capacity (an early error burst must not
                # age out of the --fail-on-burn gate).
                n, errors, ttft_n, ttft_over, e2e_n, e2e_over = self._run
            else:
                cutoff = now - span
                obs = [o for o in self._obs if o[0] >= cutoff]
                n = len(obs)
                errors = sum(1 for o in obs if o[1])
                ttft_n = sum(1 for o in obs if o[2] is not None)
                ttft_over = sum(1 for o in obs if o[2])
                e2e_n = sum(1 for o in obs if o[3] is not None)
                e2e_over = sum(1 for o in obs if o[3])
            burns = {
                "error_rate": (errors / n / tg.error_rate) if n else 0.0,
                "ttft_p95": (ttft_over / ttft_n / tg.ttft_budget)
                if ttft_n else 0.0,
                "e2e_p99": (e2e_over / e2e_n / tg.e2e_budget)
                if e2e_n else 0.0,
            }
            out[window] = burns
            reg.gauge("slo_window_requests", component=self.component,
                      window=window, **self.labels).set(n)
            for slo, burn in burns.items():
                reg.gauge("slo_burn_rate", component=self.component,
                          slo=slo, window=window, **self.labels).set(burn)
                self._maybe_alert(slo, window, burn)
        return out

    def maybe_evaluate(self, min_interval_s: float = 1.0) -> None:
        """Re-evaluate the TIME windows when the last evaluation is older
        than ``min_interval_s`` — called from the scheduler loop so a
        burning-then-idle replica's fast-window gauge decays (and its alert
        resolves) as the window ages out, instead of staying stale until
        the next terminal request happens to land here. No-op when nothing
        was ever observed or when attribution is off."""
        if not attribution_on() or not self._run[0]:
            return
        now = self._clock()
        if self._last_eval is None or now - self._last_eval >= min_interval_s:
            self.evaluate(now=now)

    def _maybe_alert(self, slo: str, window: str, burn: float) -> None:
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        key = (slo, window)
        was = self._alerting.get(key, False)
        if burn > 1.0 and not was:
            self._alerting[key] = True
            get_registry().counter(
                "slo_alerts_total", component=self.component, slo=slo,
                window=window, **self.labels,
            ).inc()
            emit_event("slo_alert", slo=slo, window=window,
                       burn_rate=round(burn, 3), component=self.component,
                       **self.labels)
            # Incident engine (telemetry/incidents.py): the alert as a
            # decision, and for the ERROR-budget objective only a bundle
            # trigger. Latency burns alert legitimately in fault-free batch
            # sweeps (a first chunk that builds kernels blows the TTFT
            # target), so bundling them would break the fault-free-runs-
            # produce-zero-bundles contract; an error burn means requests
            # actually failed.
            from fairness_llm_tpu_torch.telemetry.incidents import (
                maybe_trigger,
                record_decision,
            )

            record_decision(
                "slo_alert", f"{slo}:{window}",
                signals={"burn_rate": round(burn, 3)},
                replica=self.labels.get("replica"),
            )
            if slo == "error_rate":
                maybe_trigger(
                    "slo_burn",
                    f"error-rate burn {burn:.2f} over the {window} window",
                    scope=(self.labels.get("replica")
                           or self.labels.get("fleet") or self.component),
                    replica=self.labels.get("replica"),
                    window=window, burn_rate=round(burn, 3),
                )
        elif burn <= 1.0 and was:
            self._alerting[key] = False
            emit_event("slo_resolved", slo=slo, window=window,
                       burn_rate=round(burn, 3), component=self.component,
                       **self.labels)


# -- snapshot rendering (the `slo-report` subcommand) --------------------------


def render_slo_report(snap: Dict) -> str:
    """Render the SLO state recorded in a telemetry snapshot: one table per
    label set (replica/fleet), burn rate per (slo, window), alert counts.
    Burn 1.0 = consuming the error budget exactly at the sustainable rate."""
    targets: Dict[Tuple, Dict[str, float]] = {}
    burns: Dict[Tuple, Dict[Tuple[str, str], float]] = {}
    requests: Dict[Tuple, Dict[str, float]] = {}

    def _key(labels: Dict) -> Tuple:
        return tuple(sorted(
            (k, v) for k, v in labels.items()
            if k not in ("slo", "window", "component")
        ))

    for g in snap.get("gauges", []):
        labels = g.get("labels", {})
        key = _key(labels)
        if g.get("name") == "slo_burn_rate":
            burns.setdefault(key, {})[
                (labels.get("slo", "?"), labels.get("window", "?"))
            ] = g["value"]
        elif g.get("name") == "slo_target":
            targets.setdefault(key, {})[labels.get("slo", "?")] = g["value"]
        elif g.get("name") == "slo_window_requests":
            requests.setdefault(key, {})[labels.get("window", "?")] = g["value"]
    alerts: Dict[Tuple, Dict[Tuple[str, str], float]] = {}
    for c in snap.get("counters", []):
        if c.get("name") != "slo_alerts_total":
            continue
        labels = c.get("labels", {})
        alerts.setdefault(_key(labels), {})[
            (labels.get("slo", "?"), labels.get("window", "?"))
        ] = c["value"]

    lines: List[str] = ["=" * 72, "SLO BURN RATES  (1.0 = error budget "
                        "consumed exactly at the sustainable rate)", "=" * 72]
    if not burns:
        lines.append("(no slo_burn_rate gauges in this snapshot — did the "
                     "run serve any requests?)")
        return "\n".join(lines)
    for key in sorted(burns):
        label_str = ", ".join(f"{k}={v}" for k, v in key) or "(default)"
        nreq = requests.get(key, {})
        lines.append(f"\n[{label_str}]  requests: "
                     + (", ".join(f"{w}={int(n)}" for w, n in
                                  sorted(nreq.items())) or "-"))
        lines.append(f"  {'slo':<12} {'target':>10} {'window':<6} "
                     f"{'burn':>8}  {'status':<8} {'alerts':>6}")
        for (slo, window) in sorted(burns[key]):
            burn = burns[key][(slo, window)]
            target = targets.get(key, {}).get(slo)
            tstr = (f"{target:g}s" if slo != "error_rate" else f"{target:g}") \
                if target is not None else "-"
            status = "BURNING" if burn > 1.0 else "OK"
            n_alerts = int(alerts.get(key, {}).get((slo, window), 0))
            lines.append(f"  {slo:<12} {tstr:>10} {window:<6} {burn:>8.2f}"
                         f"  {status:<8} {n_alerts:>6}")
    return "\n".join(lines)
