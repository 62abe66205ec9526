"""SLO-coupled autoscaler: replica membership as a runtime control loop
(counterpart of ``fairness_llm_tpu/serving/autoscaler.py``).

One ``Autoscaler`` rides the ``ReplicaSet``'s tick and reads signals the
stack already exports:

- **SLO burn**: the hottest replica's fast-window error or TTFT burn
  (``slo_burn_rate{window="fast"}``);
- **overload level**: the fleet's shed controller browning out;
- **queue depth**: fleet-held backlog over the queue's capacity;
- **load**: the unfenced replicas' mean outstanding work over their slots,
  the scale-down guard.

A scale-up is ``ReplicaSet.add_replica()``: a standby that must pass the
rejoin canary before it takes traffic (a refusal counts
``autoscale_events_total{direction="up_denied"}`` and retries after the
cooldown). A scale-down is ``ReplicaSet.retire_replica(lowest load)``: its
in-flight work migrates with token parity and its device tensors are freed.

Hysteresis: a hot signal must hold ``up_window_s``, every signal must stay
cold ``down_window_s``, each change starts a shared ``cooldown_s``, and the
windows reset whenever the signal flips. Membership stays in
[``min_replicas``, ``max_replicas``], converging one change a cooldown when
it starts outside. ``clock`` is injectable, so that tests walk the windows
without sleeping.

- **device-memory headroom** (opt-in, ``up_headroom_frac`` > 0): the
  memory ledger's headroom fraction (``telemetry/memory.py``) at or under
  it is hot; with no known limit it reads 1.0, "no opinion".

Observable: the ``fleet_replicas_target`` gauge, the
``autoscale_events_total{direction}`` counters, ``autoscale_up``/
``autoscale_down``/``autoscale_denied`` events with the triggering signals,
and ``autoscale`` decisions. ``check_autoscale`` is the port's copy of the
reference validator's ``--require-autoscale`` gate.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from fairness_llm_tpu_torch.config import AutoscaleConfig
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import record_decision
from fairness_llm_tpu_torch.telemetry.memory import get_memory_ledger

logger = logging.getLogger(__name__)


class Autoscaler:
    """One membership controller per ``ReplicaSet`` (or anything with
    ``replicas``, ``queue``, ``_pending``, ``router``, ``serving``,
    ``add_replica``, ``retire_replica`` and ``_max_replica_burn``)."""

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.config = config or AutoscaleConfig(enabled=True)
        cfg = self.config
        if cfg.min_replicas < 1:
            raise ValueError(f"autoscale.min_replicas must be >= 1, got {cfg.min_replicas}")
        if cfg.max_replicas < cfg.min_replicas:
            raise ValueError(f"autoscale.max_replicas ({cfg.max_replicas}) < min_replicas "
                             f"({cfg.min_replicas})")
        self._clock = clock
        self._labels = dict(getattr(fleet, "_fleet_labels", {}) or {})
        self._hot_since: Optional[float] = None
        self._cold_since: Optional[float] = None
        self._last_action: Optional[float] = None
        self._last_eval: Optional[float] = None
        # The membership wanted but refused (a standby failing its canary):
        # keeps the target gauge above fleet_replicas while the pressure
        # lasts.
        self._denied_want: Optional[int] = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.denied = 0
        self._target_gauge().set(len(fleet.replicas))

    # -- instruments ---------------------------------------------------------

    def _target_gauge(self):
        return get_registry().gauge("fleet_replicas_target", component="fleet", **self._labels)

    def _count_event(self, direction: str) -> None:
        get_registry().counter("autoscale_events_total", component="fleet",
                               direction=direction, **self._labels).inc()

    # -- signals -------------------------------------------------------------

    def _queue_frac(self) -> float:
        held = len(self.fleet.queue) + len(self.fleet._pending)
        return held / max(self.fleet.serving.queue_capacity, 1)

    def _overload_level(self) -> int:
        ctl = getattr(self.fleet, "shed_controller", None)
        return ctl.level if ctl is not None else 0

    def _load_frac(self) -> float:
        """The unfenced replicas' mean outstanding work over their slots (a
        fleet crunching a backlog is not idle, however cold its burn)."""
        live = [r for r in self.fleet.replicas if not r.fenced]
        if not live:
            return 1.0
        fracs = []
        for rep in live:
            sched = rep.sched
            outstanding = sched.pool.occupancy + len(sched.queue) + len(sched._pending)
            fracs.append(outstanding / max(sched.num_slots, 1))
        return sum(fracs) / len(fracs)

    def _headroom_frac(self) -> float:
        """Device-memory headroom over the limit, from the memory ledger;
        1.0 when no limit is known (the CPU without an injected budget):
        unknown reads as "no opinion", never as pressure."""
        frac = get_memory_ledger().headroom_frac()
        return 1.0 if frac is None else frac

    def signals(self) -> Dict[str, float]:
        """The controller's inputs, for events and reports."""
        return {
            "burn": round(self.fleet._max_replica_burn(), 3),
            "queue_frac": round(self._queue_frac(), 3),
            "overload_level": self._overload_level(),
            "load_frac": round(self._load_frac(), 3),
            "headroom_frac": round(self._headroom_frac(), 3),
        }

    def _hot_reason(self, sig: Dict[str, float]) -> Optional[str]:
        cfg = self.config
        if sig["burn"] >= cfg.up_burn_threshold:
            return f"slo_burn {sig['burn']:.2f}"
        if sig["queue_frac"] >= cfg.up_queue_frac:
            return f"queue_depth {sig['queue_frac']:.2f}x capacity"
        if cfg.up_overload_level > 0 and sig["overload_level"] >= cfg.up_overload_level:
            return f"overload_level {sig['overload_level']}"
        # A headroom collapse is a capacity signal like a deep queue: more
        # replicas spread the KV pools. Soft: the allocator stays the gate.
        if cfg.up_headroom_frac > 0 and sig["headroom_frac"] <= cfg.up_headroom_frac:
            return f"hbm_headroom {sig['headroom_frac']:.2f}"
        return None

    def _cold(self, sig: Dict[str, float]) -> bool:
        cfg = self.config
        return (sig["burn"] <= cfg.down_burn_threshold
                and sig["queue_frac"] <= cfg.down_queue_frac
                and sig["load_frac"] <= cfg.down_load_frac)

    # -- the control loop ----------------------------------------------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """``tick`` at most once an ``eval_interval_s``; True when
        membership changed."""
        t = self._clock() if now is None else now
        if self._last_eval is not None and t - self._last_eval < self.config.eval_interval_s:
            return False
        return self.tick(now=t) is not None

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One controller step: read the signals, walk the windows and make
        at most one membership change. Returns "up" or "down" when
        membership changed, else None."""
        cfg = self.config
        t = self._clock() if now is None else now
        self._last_eval = t
        n = len(self.fleet.replicas)
        sig = self.signals()
        hot = self._hot_reason(sig)
        action: Optional[str] = None
        in_cooldown = self._last_action is not None and t - self._last_action < cfg.cooldown_s
        if n < cfg.min_replicas or n > cfg.max_replicas:
            # Out of bounds: converge regardless of temperature, one change
            # a cooldown, no window banked in either direction.
            self._hot_since = None
            self._cold_since = None
            if not in_cooldown:
                if n < cfg.min_replicas:
                    action = self._scale_up(f"below min_replicas ({n} < {cfg.min_replicas})",
                                            sig, t)
                else:
                    action = self._scale_down(sig, t)
        elif hot is not None:
            self._cold_since = None
            if self._hot_since is None:
                self._hot_since = t
            if not in_cooldown and n < cfg.max_replicas and t - self._hot_since >= cfg.up_window_s:
                action = self._scale_up(hot, sig, t)
        elif self._cold(sig):
            self._hot_since = None
            if self._cold_since is None:
                self._cold_since = t
            if not in_cooldown and n > cfg.min_replicas \
                    and t - self._cold_since >= cfg.down_window_s:
                action = self._scale_down(sig, t)
        else:
            # Lukewarm: neither direction banks time.
            self._hot_since = None
            self._cold_since = None
        if hot is None:
            self._denied_want = None
        self._target_gauge().set(self._denied_want or len(self.fleet.replicas))
        return action

    def _scale_up(self, reason: str, sig: Dict[str, float], now: float) -> Optional[str]:
        self._last_action = now
        self._hot_since = None  # the next step up needs a fresh window
        rep = self.fleet.add_replica()
        if rep is None:
            self.denied += 1
            self._denied_want = len(self.fleet.replicas) + 1
            self._count_event("up_denied")
            emit_event("autoscale_denied", reason=reason, **sig, **self._labels)
            record_decision("autoscale", "up_denied", signals={"reason": reason, **sig})
            return None
        self._denied_want = None
        self.scale_ups += 1
        self._count_event("up")
        emit_event("autoscale_up", replica=rep.name, reason=reason,
                   replicas=len(self.fleet.replicas), **sig, **self._labels)
        record_decision("autoscale", "up", signals={"reason": reason, **sig}, replica=rep.name)
        get_flight_recorder().transition("fleet_replicas", self._labels.get("fleet") or "fleet",
                                         len(self.fleet.replicas))
        logger.warning("autoscale UP -> %d replicas (%s): %s", len(self.fleet.replicas),
                       rep.name, reason)
        return "up"

    def _scale_down(self, sig: Dict[str, float], now: float) -> Optional[str]:
        live = [r for r in self.fleet.replicas if not r.fenced]
        if len(live) < 2:
            # Retiring the only healthy replica would strand the fenced
            # rest's migrations; wait for a rejoin.
            return None
        self._last_action = now
        self._cold_since = None
        self._denied_want = None
        victim = min(live, key=lambda r: (self.fleet.router.load(r), r.name))
        migrated = self.fleet.retire_replica(victim)
        self.scale_downs += 1
        self._count_event("down")
        emit_event("autoscale_down", replica=victim.name, migrated=migrated,
                   replicas=len(self.fleet.replicas), **sig, **self._labels)
        record_decision("autoscale", "down", signals={"migrated": migrated, **sig},
                        replica=victim.name)
        get_flight_recorder().transition("fleet_replicas", self._labels.get("fleet") or "fleet",
                                         len(self.fleet.replicas))
        logger.warning("autoscale DOWN -> %d replicas (retired %s, %d migrated)",
                       len(self.fleet.replicas), victim.name, migrated)
        return "down"


def check_autoscale(snap: Dict) -> List[str]:
    """The elastic-cycle gate of the reference's ``tools/
    validate_telemetry.py --require-autoscale`` (which imports the JAX
    package), the same problems for the same snapshot: a scale-up and a
    scale-down, every accepted replay request terminal, migrated equal to
    recovered, and every fleet whole at the end."""
    from fairness_llm_tpu_torch.serving.fleet import _fleet_gauges

    problems: List[str] = []
    counters = snap.get("counters", [])

    def total(name, **want):
        return sum(c["value"] for c in counters if c.get("name") == name
                   and all(c.get("labels", {}).get(k) == v for k, v in want.items()))

    if not total("autoscale_events_total", direction="up"):
        problems.append("no autoscale_events_total{direction=up} (the burst never drove a "
                        "scale-up)")
    if not total("autoscale_events_total", direction="down"):
        problems.append("no autoscale_events_total{direction=down} (the quiet tail never drove "
                        "a scale-down)")
    accepted = total("replay_accepted_total")
    terminal = total("replay_terminal_total")
    if not accepted:
        problems.append("replay_accepted_total is zero (no replay ran)")
    elif accepted != terminal:
        problems.append(f"replay accepted ({accepted:g}) != terminal ({terminal:g}) — "
                        "accepted requests were lost")
    migrated = total("fleet_migrated_requests_total")
    recovered = total("fleet_migrated_recovered_total")
    if migrated != recovered:
        problems.append(f"migrated ({migrated:g}) != recovered ({recovered:g}) — migrated "
                        "requests were lost")
    saw_fleet = False
    for key, vals in _fleet_gauges(snap).items():
        if "fleet_replicas" not in vals:
            continue
        saw_fleet = True
        replicas = vals["fleet_replicas"]
        healthy = vals.get("fleet_healthy_replicas", -1)
        if healthy != replicas:
            tag = dict(key).get("fleet", "default")
            problems.append(f"fleet {tag!r}: fleet_healthy_replicas ({healthy:g}) != "
                            f"fleet_replicas ({replicas:g}) — the final fleet is not healthy")
    if not saw_fleet:
        problems.append("no fleet_replicas gauge (no fleet was armed)")
    return problems
