"""Health-aware replica router: scoring, placement and the fence policy
(counterpart of ``fairness_llm_tpu/serving/router.py``).

Round robin keeps feeding a sick replica 1/N of all traffic. This router
scores every replica from the health state the serving and resilience
layers already export and places each admission on the healthiest,
least-loaded one:

- **breaker states** (the replica's own ``BreakerBoard``): an OPEN stage
  discounts the score by ``OPEN_BREAKER_DISCOUNT``, a HALF_OPEN one by
  ``HALF_OPEN_BREAKER_DISCOUNT``, so a replica mid-recovery takes a trickle;
- **degradation level**: ``DEGRADATION_RUNG_DISCOUNT`` per rung climbed;
- **canary** (``canary_last_ok``): a replica whose last canary mismatched
  gives wrong-but-finite output, discounted hardest;
- **SLO burn** (``slo_burn_rate{slo="error_rate", window="fast"}``): a
  replica burning its error budget at rate B scores 1/B, floored at
  ``SLO_BURN_DISCOUNT_FLOOR``;
- **load**: live slots, queued and pending requests and a quarter of the
  ``queue_depth_hwm`` gauge, over the pool size.

``should_fence`` is the inferred fence policy: the ladder at
``FleetConfig.fence_ladder_level``, ``fence_open_breakers`` open breakers,
or the stall probe (the replica's watchdog, only while it has work). The
injected replica faults do not come through here: the fleet fences those
directly. Scores depend on replica state only and ties break on the name,
so the same fleet state always routes the same way.

A rollout (``serving/rollout.py``) steers a share of fresh admissions onto
a version by error diffusion (``set_version_traffic``), and a migration
pinned to a version (``pick(require_version=...)``) never crosses versions.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from fairness_llm_tpu_torch.config import FleetConfig
from fairness_llm_tpu_torch.resilience.breaker import HALF_OPEN, OPEN
from fairness_llm_tpu_torch.telemetry import get_registry
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import record_decision

logger = logging.getLogger(__name__)

# Multiplicative score discounts. An OPEN breaker does not zero the score:
# starving a replica whose decode breaker will half-open soon would shift
# its backlog to the siblings and then herd it back on recovery.
OPEN_BREAKER_DISCOUNT = 0.10
HALF_OPEN_BREAKER_DISCOUNT = 0.50
DEGRADATION_RUNG_DISCOUNT = 0.25  # per ladder level
CANARY_MISMATCH_DISCOUNT = 0.25
SLO_BURN_DISCOUNT_FLOOR = 0.20


class HealthRouter:
    """Scores ``Replica`` objects (``serving/fleet.py``) and picks the
    target of one admission. Every health input is read fresh from the
    replica; the only state is the rollout's traffic split."""

    def __init__(self, fleet: Optional[FleetConfig] = None):
        self.fleet = fleet or FleetConfig()
        # (version, fraction) of fresh admissions steered onto that version
        # by error diffusion (the exact fraction over any window, no RNG);
        # None = version-blind.
        self._version_traffic: Optional[tuple] = None
        self._traffic_acc = 0.0

    # -- rollout traffic split -----------------------------------------------

    def set_version_traffic(self, version: Optional[str], fraction: float = 0.0) -> None:
        """Steer ``fraction`` of fresh admissions to replicas at
        ``version``; None or 0 clears the split. Pinned migrations
        (``require_version``) bypass it."""
        if version is None or fraction <= 0.0:
            self._version_traffic = None
        else:
            self._version_traffic = (version, min(1.0, float(fraction)))
        self._traffic_acc = 0.0

    def _steer(self) -> Optional[tuple]:
        """``(version, to_new)`` for this admission under the split: the
        accumulator gains the fraction and each crossing of 1 sends one
        admission onto the version. None = no split."""
        if self._version_traffic is None:
            return None
        version, frac = self._version_traffic
        self._traffic_acc += frac
        if self._traffic_acc >= 1.0:
            self._traffic_acc -= 1.0
            return (version, True)
        return (version, False)

    # -- scoring -------------------------------------------------------------

    def health_score(self, replica) -> float:
        """Health in [0, 1]: 1.0 = nothing wrong, 0.0 = fenced. Load is not
        part of it (``placement_weight`` folds it in), so a busy healthy
        replica reads 1.0 on the ``replica_health_score`` gauge."""
        if replica.fenced:
            score = 0.0
        else:
            score = 1.0
            board = replica.sched.breakers
            if board is not None:
                for breaker in board.breakers.values():
                    if breaker.state == OPEN:
                        score *= OPEN_BREAKER_DISCOUNT
                    elif breaker.state == HALF_OPEN:
                        score *= HALF_OPEN_BREAKER_DISCOUNT
                score *= max(0.0, 1.0 - DEGRADATION_RUNG_DISCOUNT * board.ladder.level)
            # canary_last_ok: 1 ok, 0 mismatch, -1 never probed (neutral)
            last_ok = get_registry().read_value("canary_last_ok", default=-1.0,
                                                component="serving", replica=replica.name)
            if last_ok == 0.0:
                score *= CANARY_MISMATCH_DISCOUNT
            burn = get_registry().read_value("slo_burn_rate", default=0.0, component="serving",
                                             replica=replica.name, slo="error_rate",
                                             window="fast")
            if burn > 1.0:
                score *= max(SLO_BURN_DISCOUNT_FLOOR, 1.0 / burn)
        get_registry().gauge("replica_health_score", component="fleet",
                             replica=replica.name).set(score)
        # Only changes land in the flight recorder's ring.
        get_flight_recorder().transition("replica_health_score", replica.name, round(score, 4))
        return score

    def load(self, replica) -> float:
        """Outstanding work over the pool size: live slots, queued and
        pending requests, and a quarter of the recent queue high-water mark
        (a depth of 0 just after a burst does not read as idle)."""
        sched = replica.sched
        outstanding = sched.pool.occupancy + len(sched.queue) + len(sched._pending)
        hwm = get_registry().read_value("queue_depth_hwm", default=0.0, component="serving",
                                        replica=replica.name)
        return (outstanding + 0.25 * hwm) / max(sched.num_slots, 1)

    def placement_weight(self, replica) -> float:
        """What ``pick`` maximizes: health discounted by load."""
        return self.health_score(replica) / (1.0 + self.load(replica))

    def pick(self, replicas: Sequence, qos: Optional[str] = None,
             require_version: Optional[str] = None) -> Optional[object]:
        """The target of one admission: the routable replica (not fenced,
        queue open and not full, nonzero health) of the highest placement
        weight, ties broken on the name; None when nothing is routable (the
        caller holds the request).

        Non-interactive ``qos`` prefers replicas not burning a fast-window
        SLO budget, falling back to the plain weighting when all burn.
        ``require_version`` filters to replicas of that version, and None
        then means hold; without it, an active traffic split steers this
        admission onto or off the rollout's version, version-blind when the
        steered side has nothing routable."""
        if require_version is not None:
            replicas = [r for r in replicas
                        if getattr(r, "version", require_version) == require_version]
        else:
            steer = self._steer()
            if steer is not None:
                version, to_new = steer
                side = [r for r in replicas
                        if (getattr(r, "version", None) == version) == to_new]
                chosen = self._pick_among(side, qos)
                if chosen is not None:
                    return self._record_pick(*chosen, qos=qos)
        chosen = self._pick_among(replicas, qos)
        if chosen is None:
            return None
        return self._record_pick(*chosen, qos=qos)

    def _pick_among(self, replicas: Sequence, qos: Optional[str]) -> Optional[tuple]:
        """``(replica, weight, calm_preferred)`` of the best routable
        replica among ``replicas``, or None."""
        best, best_weight = None, 0.0
        calm_best, calm_weight = None, 0.0
        prefer_calm = qos is not None and qos != "interactive"
        for rep in replicas:
            if rep.fenced or rep.sched.queue.closed or rep.sched.queue.full:
                continue
            weight = self.placement_weight(rep)
            if weight <= 0.0:
                continue
            if best is None or weight > best_weight or (
                    weight == best_weight and rep.name < best.name):
                best, best_weight = rep, weight
            if prefer_calm and not self._burning(rep):
                if calm_best is None or weight > calm_weight or (
                        weight == calm_weight and rep.name < calm_best.name):
                    calm_best, calm_weight = rep, weight
        if prefer_calm and calm_best is not None:
            return (calm_best, calm_weight, True)
        if best is None:
            return None
        return (best, best_weight, False)

    def _record_pick(self, chosen, weight: float, calm: bool, qos: Optional[str]) -> object:
        # The placement into the decision trail (its own ring: placement is
        # the hottest decision point).
        record_decision("route", chosen.name,
                        signals={"weight": round(weight, 4), "qos": qos or "-",
                                 "calm_preferred": calm},
                        replica=chosen.name)
        return chosen

    @staticmethod
    def _burning(replica) -> bool:
        """Whether the replica's fast-window error or TTFT burn is over 1."""
        reg = get_registry()
        return any(reg.read_value("slo_burn_rate", default=0.0, component="serving",
                                  replica=replica.name, slo=slo, window="fast") > 1.0
                   for slo in ("error_rate", "ttft_p95"))

    # -- fence policy --------------------------------------------------------

    def should_fence(self, replica) -> Optional[str]:
        """Why this replica should be fenced now, or None: the inferred
        path, from the breakers, the ladder and the stall probe."""
        if replica.fenced:
            return None
        board = replica.sched.breakers
        cfg = self.fleet
        if board is not None:
            if 0 < cfg.fence_ladder_level <= board.ladder.level:
                return "degraded"
            if 0 < cfg.fence_open_breakers <= board.open_count():
                return "breakers"
        watchdog = replica.sched.watchdog
        if watchdog is not None and replica.sched.has_work and watchdog.stalled() is not None:
            # Only with work: an idle replica completes no steps, and its
            # liveness gauge going stale is no stall.
            return "stalled"
        return None


def round_robin_pick(replicas: List, counter: int) -> Optional[object]:
    """The health-blind baseline, kept for comparisons: the counter-th
    unfenced replica."""
    live = [r for r in replicas if not r.fenced]
    if not live:
        return None
    return live[counter % len(live)]
