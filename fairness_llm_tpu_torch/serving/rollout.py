"""Rolling upgrades: canary- and fairness-gated waves over the fleet
(counterpart of ``fairness_llm_tpu/serving/rollout.py``).

A :class:`RolloutController` walks a ``ReplicaSet`` from its version to a
new immutable version id, one wave at a time: add ONE standby at the new
version through the canary-gated ``add_replica`` (judged against its own
version's recorded rows), move the traffic share onto it in
``traffic_steps`` error-diffusion steps (``HealthRouter.
set_version_traffic``), watch the gates ``canary_window_s`` a step, then
retire one old-version replica through the planned-exit path; until the
whole fleet serves the new version. Requests keep the version that first
admitted them (``HealthRouter.pick(require_version=...)``), so greedy rows
stay single-version mid-rollout.

Deployment gates, any of which rolls the fleet back while new-version
replicas exist: the manifest refusing the incoming weights (``engine_fn``
raises ``IntegrityError`` while PREPARING, before anything joins), a canary
mismatch, a fence or open breaker on a new replica, fast-window SLO burn at
or over ``gate_burn_threshold`` on a new replica's label, and with
``abort_on_fairness_alert`` a fairness alert or a counterfactual pair
divergence served on a new replica. Rollback re-fences the new replicas
(their work migrates back), retires them, clears the split and dumps one
``rollout`` incident bundle naming the gate. While a rollout is active the
autoscaler is paused.

States and the only legal edges (``LEGAL_TRANSITIONS``)::

    idle -> preparing -> canary -> shifting -> retiring -+-> complete
               |            |         |           |      |
               |            +---------+-----------+      +--> canary
               v                      v                     (next wave)
          rolled_back  <------  rolling_back

Telemetry: ``rollout_state``, ``rollout_wave``, ``rollout_traffic_frac``
and ``rollout_version_replicas{version}`` gauges;
``rollout_transitions_total{to}``, ``rollout_rollbacks_total{cause}``,
``rollout_waves_total``, ``rollout_affinity_restamped_total``,
``rollout_resume_restamped_total`` and ``rollout_autoscale_paused_total``
counters; ``rollout`` decisions and events. ``check_rollout`` is the port's
copy of the reference validator's ``--require-rollout`` gate, and
``render_rollout_report`` the ``telemetry-report`` section.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

from fairness_llm_tpu_torch.config import RolloutConfig, ServingConfig
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.fairness import get_fairness_monitor
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline

logger = logging.getLogger(__name__)

# The wave machine. Closed sets, same stance as incidents.DECISIONS: a
# typo'd state must fail loudly, and the property test enumerates these.
ROLLOUT_STATES = (
    "idle",          # constructed, not started
    "preparing",     # acquiring/verifying the new engine (manifest gate)
    "canary",        # adding this wave's canary-gated v+1 standby
    "shifting",      # walking the traffic fraction up, gates watched
    "retiring",      # retiring one old-version replica (wave tail)
    "rolling_back",  # unwinding every v+1 replica
    "rolled_back",   # terminal: fleet back on the old version
    "complete",      # terminal: fleet entirely on the new version
)
TERMINAL_STATES = frozenset({"rolled_back", "complete"})
LEGAL_TRANSITIONS = frozenset({
    ("idle", "preparing"),
    ("preparing", "canary"),
    ("preparing", "rolled_back"),   # manifest refusal: nothing to unwind
    ("canary", "shifting"),
    ("canary", "rolling_back"),
    ("shifting", "retiring"),
    ("shifting", "rolling_back"),
    ("retiring", "canary"),         # next wave
    ("retiring", "complete"),
    ("retiring", "rolling_back"),
    ("rolling_back", "rolled_back"),
})


class RolloutController:
    """Drives one versioned upgrade over a ``ReplicaSet`` (or any
    duck-typed fleet exposing ``replicas``/``add_replica``/
    ``retire_replica``/``_fence``/``router``/``version``: the tests run the
    machine against a fake fleet).

    ``engine``: a prebuilt new-version engine; ``engine_fn``: a callable
    returning one, invoked during PREPARING so a manifest refusal
    (``IntegrityError``) becomes the first gate; both None = a config-only
    rollout (new replicas share the pool's params). ``serving``: optional
    new ServingConfig for new-version replicas. The fleet's ``_tick``
    drives ``maybe_tick`` while the controller is active; drills may call
    ``tick(now=...)`` with an injected clock instead.
    """

    def __init__(self, fleet, to_version: str,
                 engine=None,
                 engine_fn: Optional[Callable[[], object]] = None,
                 serving: Optional[ServingConfig] = None,
                 config: Optional[RolloutConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not to_version:
            raise ValueError("to_version must be a non-empty version id")
        if to_version == fleet.version:
            raise ValueError(
                f"to_version {to_version!r} is the fleet's current version"
            )
        self.fleet = fleet
        self.from_version = fleet.version
        self.to_version = to_version
        self.engine = engine
        self.engine_fn = engine_fn
        self.serving = serving
        self.config = config or RolloutConfig(enabled=True)
        if self.config.traffic_steps < 1:
            raise ValueError("traffic_steps must be >= 1")
        self._clock = clock
        self._labels = dict(getattr(fleet, "_fleet_labels", {}) or {})
        self.state = "idle"
        self.wave = 0
        self.traffic_step = 0
        self.cause: Optional[str] = None  # rollback cause, when rolled back
        self._frac = 0.0
        self._new_engine = None
        self._new_reps: List[object] = []
        self._waves_total = 0
        self._step_started: Optional[float] = None
        self._baseline: Dict[str, float] = {}
        fleet.rollout = self

    # -- surface -------------------------------------------------------------

    @property
    def active(self) -> bool:
        """True while the controller owns the fleet's membership (started
        and not yet terminal) — what pauses the autoscaler."""
        return self.state != "idle" and self.state not in TERMINAL_STATES

    @property
    def new_replicas(self) -> List[object]:
        """New-version replicas still in the fleet."""
        return [r for r in self._new_reps if r in self.fleet.replicas]

    def start(self, now: Optional[float] = None) -> "RolloutController":
        """Arm the wave machine: snapshot the gate baselines and enter
        PREPARING. The next ``tick`` acquires/verifies the new engine."""
        if self.state != "idle":
            raise RuntimeError(f"rollout already started (state "
                               f"{self.state!r})")
        now = self._clock() if now is None else now
        self._waves_total = max(1, len([
            r for r in self.fleet.replicas
            if r.version == self.from_version
        ]))
        self._snapshot_gate_baseline()
        if getattr(self.fleet, "autoscaler", None) is not None:
            # Arbitration: membership has ONE owner while the rollout is
            # active — the fleet's tick skips autoscaler.maybe_tick()
            # until we reach a terminal state.
            get_registry().counter(
                "rollout_autoscale_paused_total", component="rollout",
                **self._labels,
            ).inc()
        emit_event("rollout_started", from_version=self.from_version,
                   to_version=self.to_version, waves=self._waves_total,
                   traffic_steps=self.config.traffic_steps)
        logger.warning(
            "rollout %s -> %s: %d wave(s), %d traffic step(s)/wave, "
            "gate window %.2fs", self.from_version, self.to_version,
            self._waves_total, self.config.traffic_steps,
            self.config.canary_window_s,
        )
        self._transition("preparing", now=now)
        return self

    def maybe_tick(self) -> bool:
        """The fleet-tick hook: one wave-machine step on the wall clock."""
        return self.tick()

    def tick(self, now: Optional[float] = None) -> bool:
        """One controller step. Returns True when the machine moved
        (state change, traffic shift, membership change)."""
        if self.state == "idle" or self.state in TERMINAL_STATES:
            return False
        now = self._clock() if now is None else now
        if self.state == "preparing":
            return self._prepare(now)
        gate = self._check_gates()
        if gate is not None:
            self._rollback(*gate, now=now)
            return True
        if self.state == "canary":
            return self._begin_wave(now)
        if self.state == "shifting":
            return self._maybe_advance(now)
        if self.state == "retiring":
            return self._retire_one(now)
        return False

    # -- wave machine --------------------------------------------------------

    def _prepare(self, now: float) -> bool:
        from fairness_llm_tpu_torch.integrity.manifest import IntegrityError

        try:
            self._new_engine = (self.engine_fn() if self.engine_fn is not None
                                else self.engine)
        except IntegrityError as e:
            # The manifest REFUSED the incoming weights: the first and
            # cheapest gate — no replica ever joined, nothing to unwind,
            # zero user-visible impact. Straight to rolled_back.
            self._record_rollback("manifest", str(e), now=now)
            return True
        except Exception as e:  # engine build failed some other way
            self._record_rollback("prepare", f"{type(e).__name__}: {e}",
                                  now=now)
            return True
        self._transition("canary", now=now)
        return True

    def _begin_wave(self, now: float) -> bool:
        self.wave += 1
        get_registry().counter("rollout_waves_total", component="rollout",
                               **self._labels).inc()
        rep = self.fleet.add_replica(
            engine=self._new_engine, version=self.to_version,
            serving=self._serving_override(),
        )
        if rep is None:
            # add_replica's canary gate refused the standby — the new
            # version cannot decode its own golden prompt.
            self._rollback(
                "canary",
                f"standby at {self.to_version} refused by its canary gate "
                f"(wave {self.wave})", now=now,
            )
            return True
        self._new_reps.append(rep)
        self.traffic_step = 1
        self._step_started = now
        self._set_traffic(self._target_frac())
        self._transition("shifting", now=now)
        return True

    def _maybe_advance(self, now: float) -> bool:
        if self._step_started is not None and \
                now - self._step_started < self.config.canary_window_s:
            return False  # gate window still open; keep watching
        if self.traffic_step < self.config.traffic_steps:
            self.traffic_step += 1
            self._step_started = now
            self._set_traffic(self._target_frac())
            return True
        self._transition("retiring", now=now)
        return True

    def _retire_one(self, now: float) -> bool:
        old = [r for r in self.fleet.replicas
               if r.version == self.from_version and not r.fenced]
        if old:
            # Same victim policy as the autoscaler's scale-down: the
            # least-loaded old replica leaves through the planned-exit
            # drain/migration path (token parity kept for its in-flight
            # work — which, being pinned to the OLD version, lands on its
            # surviving old-version siblings while any remain).
            victim = min(old, key=lambda r: (self.fleet.router.load(r),
                                             r.name))
            migrated = self.fleet.retire_replica(victim)
            get_registry().counter(
                "rollout_replicas_retired_total", component="rollout",
                **self._labels,
            ).inc()
            emit_event("rollout_replica_retired", replica=victim.name,
                       version=self.from_version, migrated=migrated,
                       wave=self.wave)
        remaining = [r for r in self.fleet.replicas
                     if r.version == self.from_version]
        if remaining:
            self._transition("canary", now=now)  # next wave
        else:
            self._complete(now)
        return True

    def _complete(self, now: float) -> None:
        self.fleet.version = self.to_version
        if self._new_engine is not None:
            # Future membership changes (autoscaler scale-ups, the next
            # rollout's baseline) draw the NEW engine.
            self.fleet._engine_pool = [self._new_engine]
        if self.serving is not None:
            self.fleet._rep_serving = self._serving_override()
        self.fleet.router.set_version_traffic(None)
        self._set_frac_gauge(0.0)
        self._transition("complete", now=now)
        emit_event("rollout_complete", to_version=self.to_version,
                   waves=self.wave)
        logger.warning("rollout complete: fleet is entirely on %s "
                       "(%d wave(s))", self.to_version, self.wave)

    # -- gates ---------------------------------------------------------------

    def _check_gates(self) -> Optional[tuple]:
        """``(gate, detail)`` for the first deployment gate currently
        firing against a new-version replica, else None."""
        reg = get_registry()
        for rep in self.new_replicas:
            if rep.fenced:
                reason = rep.fence_reason or "fenced"
                gate = ("watchdog" if reason in
                        ("replica_crash", "replica_hang", "stalled")
                        else "breaker")
                return (gate, f"new replica {rep.name} fenced: {reason}")
            board = getattr(getattr(rep, "sched", None), "breakers", None)
            if board is not None and board.open_count() > 0:
                return ("breaker",
                        f"open breaker(s) on new replica {rep.name}")
            if reg.read_value("canary_last_ok", default=-1.0,
                              component="serving", replica=rep.name) == 0.0:
                return ("canary",
                        f"canary mismatch on new replica {rep.name}")
            for slo in ("error_rate", "ttft_p95"):
                burn = reg.read_value("slo_burn_rate", default=0.0,
                                      component="serving", replica=rep.name,
                                      slo=slo, window="fast")
                if burn >= self.config.gate_burn_threshold:
                    return ("slo_burn",
                            f"fast-window {slo} burn {burn:.2f} on new "
                            f"replica {rep.name}")
        if self.config.abort_on_fairness_alert and self.new_replicas:
            alerts = self._counter_total("fairness_alerts_total")
            if alerts > self._baseline.get("fairness_alerts", 0.0):
                return ("fairness_alert",
                        "fairness alert during the gate window")
            mon = get_fairness_monitor()
            if mon.pairs_divergent > self._baseline.get("pairs_divergent", 0):
                new_names = {r.name for r in self.new_replicas} \
                    | {r.name for r in self._new_reps}
                for record in list(mon.divergent):
                    members = record.get("members", {}) or {}
                    hit = [m.get("replica") for m in members.values()
                           if m.get("replica") in new_names]
                    if hit:
                        return ("pair_divergence",
                                f"counterfactual pair "
                                f"{record.get('pair_id')} diverged; "
                                f"member served on new replica {hit[0]}")
        return None

    def _snapshot_gate_baseline(self) -> None:
        self._baseline = {
            "fairness_alerts": self._counter_total("fairness_alerts_total"),
            "pairs_divergent": get_fairness_monitor().pairs_divergent,
        }

    @staticmethod
    def _counter_total(name: str) -> float:
        """Sum a counter across every label set (alerts carry
        attribute/signal labels; any of them firing aborts)."""
        return float(sum(
            getattr(m, "value", 0.0)
            for m in get_registry().instruments()
            if getattr(m, "name", None) == name
        ))

    # -- rollback ------------------------------------------------------------

    def _rollback(self, gate: str, detail: str, now: float) -> None:
        """Unwind every new-version replica: re-fence (in-flight work
        migrates back; pins restamp to the old version once the new one
        has no live replica), retire through the planned-exit path, clear
        the traffic split, dump ONE ``rollout`` incident bundle naming
        the gate."""
        self._transition("rolling_back", now=now, cause=f"{gate}: {detail}")
        self.fleet.router.set_version_traffic(None)
        self._set_frac_gauge(0.0)
        for rep in list(self._new_reps):
            if rep not in self.fleet.replicas:
                continue
            if not rep.fenced:
                self.fleet._fence(rep, "rollout_rollback")
            if len(self.fleet.replicas) > 1:
                self.fleet.retire_replica(rep)
        self._new_reps = []
        self._record_rollback(gate, detail, now=now)

    def _record_rollback(self, gate: str, detail: str,
                         now: float) -> None:
        self.cause = f"{gate}: {detail}"
        get_registry().counter("rollout_rollbacks_total",
                               component="rollout", cause=gate,
                               **self._labels).inc()
        # ONE deduplicated bundle per (class, fleet:version) scope: a gate
        # that keeps firing during the unwind is suppressed, not re-dumped.
        maybe_trigger(
            "rollout",
            f"rollout {self.from_version} -> {self.to_version} rolled "
            f"back: {self.cause}",
            scope=f"{self.fleet.name or 'fleet'}:{self.to_version}",
            gate=gate, wave=self.wave, traffic_frac=round(self._frac, 4),
        )
        emit_event("rollout_rolled_back", gate=gate, detail=detail,
                   wave=self.wave, to_version=self.to_version)
        logger.warning("rollout %s -> %s ROLLED BACK (%s): %s",
                       self.from_version, self.to_version, gate, detail)
        self._transition("rolled_back", now=now, cause=self.cause)

    def resolve_crashed(self, detail: str = "mid-rollout crash resumed "
                        "on the old version") -> None:
        """Stamp the terminal verdict for a rollout that died mid-wave
        with its process. ``resume_serving(..., version=<old>)`` has
        already rolled the wave back at the journal level (new-version
        pins restamped, every stream re-decoded single-version); this
        records that outcome in the state machine and telemetry without
        touching membership — the crash dissolved it. No-op when idle or
        already terminal."""
        if self.state == "idle" or self.state in TERMINAL_STATES:
            return
        now = self._clock()
        if self.state != "preparing":
            # canary/shifting/retiring -> rolling_back -> rolled_back;
            # preparing goes straight to rolled_back (nothing ever joined).
            self._transition("rolling_back", now=now,
                             cause=f"crash: {detail}")
        self._new_reps = []
        self.fleet.router.set_version_traffic(None)
        self._set_frac_gauge(0.0)
        self._record_rollback("crash", detail, now=now)

    # -- plumbing ------------------------------------------------------------

    def _serving_override(self) -> Optional[ServingConfig]:
        if self.serving is None:
            return None
        # Rate limiting stays at the FLEET queue (the _rep_serving rule).
        return dataclasses.replace(self.serving, admission_per_minute=None)

    def _target_frac(self) -> float:
        """Traffic share for the current (wave, step): the new version's
        share walks from the previous wave's plateau toward wave/waves in
        ``traffic_steps`` equal increments."""
        prev = (self.wave - 1) / self._waves_total
        step = self.traffic_step / self.config.traffic_steps
        return min(1.0, prev + step / self._waves_total)

    def _set_traffic(self, frac: float) -> None:
        self._frac = frac
        self.fleet.router.set_version_traffic(self.to_version, frac)
        self._set_frac_gauge(frac)
        record_decision(
            "rollout", "shift",
            signals={"traffic_frac": round(frac, 4), "wave": self.wave,
                     "step": self.traffic_step},
        )
        emit_event("rollout_traffic_shift", traffic_frac=round(frac, 4),
                   wave=self.wave, step=self.traffic_step)

    def _set_frac_gauge(self, frac: float) -> None:
        get_registry().gauge("rollout_traffic_frac", component="rollout",
                             **self._labels).set(round(frac, 4))

    def _transition(self, to: str, now: float,
                    cause: Optional[str] = None) -> None:
        frm = self.state
        if (frm, to) not in LEGAL_TRANSITIONS:
            raise RuntimeError(
                f"illegal rollout transition {frm!r} -> {to!r}"
            )
        self.state = to
        reg = get_registry()
        reg.gauge("rollout_state", component="rollout",
                  **self._labels).set(ROLLOUT_STATES.index(to))
        reg.gauge("rollout_wave", component="rollout",
                  **self._labels).set(self.wave)
        counts: Dict[str, int] = {}
        for r in self.fleet.replicas:
            counts[r.version] = counts.get(r.version, 0) + 1
        for v in sorted(set(counts) | {self.from_version, self.to_version}):
            reg.gauge("rollout_version_replicas", component="rollout",
                      version=v, **self._labels).set(counts.get(v, 0))
        reg.counter("rollout_transitions_total", component="rollout",
                    to=to, **self._labels).inc()
        signals = {"from": frm, "wave": self.wave,
                   "traffic_frac": round(self._frac, 4)}
        if cause:
            signals["cause"] = cause
        record_decision("rollout", to, signals=signals)
        emit_event("rollout_transition", state=to, from_state=frm,
                   wave=self.wave, **({"cause": cause} if cause else {}))
        scope = self.fleet.name or "fleet"
        get_flight_recorder().transition("rollout_state", scope, to)
        get_timeline().record_instant("rollout", scope, t=now, state=to)


def render_rollout_report(snap: Dict, width: int = 78) -> str:
    """Terminal rollout section from a telemetry snapshot — the
    ``telemetry-report`` ride-along (rendered whenever rollout-component
    rows exist)."""
    gauges = [g for g in snap.get("gauges", [])
              if g.get("labels", {}).get("component") == "rollout"]
    counters = [c for c in snap.get("counters", [])
                if c.get("labels", {}).get("component") == "rollout"]
    if not gauges and not counters:
        return ""
    lines = ["", "=" * width, "ROLLOUTS".center(width), "=" * width]

    def gval(name):
        vals = [g["value"] for g in gauges if g["name"] == name]
        return vals[-1] if vals else None

    state = gval("rollout_state")
    if state is not None:
        idx = int(state)
        name = (ROLLOUT_STATES[idx] if 0 <= idx < len(ROLLOUT_STATES)
                else f"?{idx}")
        lines.append(f"  state: {name}   wave: "
                     f"{int(gval('rollout_wave') or 0)}   traffic_frac: "
                     f"{gval('rollout_traffic_frac') or 0.0}")
    versions = [(g["labels"].get("version"), g["value"]) for g in gauges
                if g["name"] == "rollout_version_replicas"]
    if versions:
        lines.append("  replicas by version: " + ", ".join(
            f"{v}={int(n)}" for v, n in sorted(versions)))
    transitions = [(c["labels"].get("to"), c["value"]) for c in counters
                   if c["name"] == "rollout_transitions_total"]
    if transitions:
        lines.append("  transitions: " + ", ".join(
            f"{t}x{int(n)}" for t, n in sorted(transitions)))
    rollbacks = [(c["labels"].get("cause"), c["value"]) for c in counters
                 if c["name"] == "rollout_rollbacks_total"]
    if rollbacks:
        lines.append("  rollbacks: " + ", ".join(
            f"{cause}x{int(n)}" for cause, n in sorted(rollbacks)))
    for cname, label in (
        ("rollout_waves_total", "waves"),
        ("rollout_replicas_retired_total", "old replicas retired"),
        ("rollout_affinity_restamped_total", "affinity restamps"),
        ("rollout_resume_restamped_total", "resume restamps"),
        ("rollout_autoscale_paused_total", "autoscaler pauses"),
    ):
        total = sum(c["value"] for c in counters if c["name"] == cname)
        if total:
            lines.append(f"  {label}: {int(total)}")
    return "\n".join(lines)


def check_rollout(snap: Dict) -> List[str]:
    """The rollout gate of the reference's ``tools/validate_telemetry.py
    --require-rollout`` (which imports the JAX package), the same problems
    for the same snapshot: a rollout completed and one rolled back through
    a named gate, every rollout ended in a terminal state, and migration
    balanced."""
    problems: List[str] = []
    counters = snap.get("counters", [])

    def total(name, **want):
        return sum(c["value"] for c in counters if c.get("name") == name
                   and all(c.get("labels", {}).get(k) == v for k, v in want.items()))

    if not total("rollout_transitions_total", to="complete"):
        problems.append("no rollout reached complete (the clean-upgrade half of the drill "
                        "never finished a wave sequence)")
    if not total("rollout_transitions_total", to="rolled_back"):
        problems.append("no rollout ever rolled back (the gate half of the drill never fired)")
    causes = {c.get("labels", {}).get("cause") for c in counters
              if c.get("name") == "rollout_rollbacks_total" and c["value"] > 0}
    if not causes or None in causes:
        problems.append("rollout_rollbacks_total carries no named gate cause (a rollback must "
                        "say WHICH deployment gate fired)")
    terminal = {float(ROLLOUT_STATES.index("rolled_back")),
                float(ROLLOUT_STATES.index("complete"))}
    for g in snap.get("gauges", []):
        if g.get("name") == "rollout_state" and g.get("value") not in terminal:
            problems.append(f"rollout_state {g.get('labels', {})} ended mid-wave (value "
                            f"{g.get('value')}) — rollout neither completed nor rolled back")
    migrated = total("fleet_migrated_requests_total")
    recovered = total("fleet_migrated_recovered_total")
    if migrated != recovered:
        problems.append(f"fleet migration accounting unbalanced across the rollout "
                        f"({migrated:g} migrated != {recovered:g} recovered)")
    return problems


__all__ = [
    "LEGAL_TRANSITIONS",
    "ROLLOUT_STATES",
    "TERMINAL_STATES",
    "RolloutController",
    "check_rollout",
    "render_rollout_report",
]
