"""Incident engine: decision audit trail, trigger registry, postmortem
bundles (the port's copy of ``fairness_llm_tpu/telemetry/incidents.py``).

Two differences from the reference. The bundle's config fingerprint
(``_config_fingerprint``) names torch, its CUDA version and the device
instead of JAX and its backend: ``torch``, ``cuda`` and ``device`` in place
of ``jax`` and ``platform``. And the class set has one more entry,
``device_fatal``: a CUDA error the port re-raises instead of containing
(``utils/failures.note_fatal_device_error``), which the reference, whose
XLA errors are not sticky, never raises. The reference's
``validate_incidents`` accepts every other class's bundles.

Every aggregate signal the stack exports (histograms, burn rates, fairness
gauges, the cost ledger) answers "how is the system doing"; none answers
the question an operator asks at 3am: *why did THIS breaker open / THIS
replica fence / THIS pair diverge, and which requests were involved?* At
the ROADMAP's million-user scale nobody attaches a debugger — the system
must capture its own evidence at the moment of failure, with the decision
chain recorded as first-class data rather than inferred from logs. That is
also the paper's audit claim turned operational ("is the system fair, and
can you prove it?"): a fairness alert without the decision trail behind it
is an accusation, not evidence.

Three pieces, layered on the flight recorder
(``telemetry/flightrecorder.py``):

- **Decision audit trail** (``record_decision``): every control-plane
  decision point — ``HealthRouter.pick`` placements, ``ShedController``
  rung transitions, ``DeadlineEstimator`` rejections, breaker/ladder
  transitions, autoscale up/down/denied, fence/rejoin, canary verdicts,
  fault containment — emits a structured :class:`DecisionRecord` carrying
  the decision, the chosen action, and the INPUT SIGNAL VALUES at decision
  time (plus request id / replica when applicable) into the recorder's
  ``decisions`` ring, and — throttled per decision kind — into the JSONL
  event sink. The ring is the complete recent trail; the sink is the
  durable sample.
- **Trigger registry** (``maybe_trigger`` / :class:`IncidentManager`): a
  fixed set of incident classes (``INCIDENT_CLASSES``) — breaker open,
  fence, watchdog hang, numerics/corruption fault, canary mismatch,
  fairness pair-divergence or alert, error-budget SLO alert, integrity
  (manifest) failure, sustained heartbeat gap — each with per-(class,
  scope) dedup and a cooldown (injectable clock), so a fault storm
  produces ONE bundle per class, not thousands. Triggers are no-ops until
  the manager is ARMED with a directory (``arm_incidents``); the chaos
  drill and ``--incidents`` runs arm it, fault-free CI proves zero
  bundles.
- **Postmortem bundles**: a firing trigger atomically dumps a
  self-contained incident directory — flight-recorder rings, full registry
  snapshot, a trace slice around the trigger, the decision trail (full +
  filtered to the implicated request/replica), the serving-journal tail,
  and a config fingerprint. The dump builds in a ``.partial`` sibling and
  renames into place, so a mid-dump kill can never leave a torn bundle;
  any dump failure is contained (counted, never raised into the serving
  loop). ``cli incident-report <dir>`` renders the causal chain
  ("fence(r1) <- 3x breaker:decode trips <- fault:decode:numerics <-
  requests a, b"); ``tools/validate_telemetry.py --require-incidents``
  gates CI on bundle presence + shape, ``--forbid-incidents`` gates
  fault-free runs on their absence.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional

from fairness_llm_tpu_torch.telemetry.export import snapshot as registry_snapshot
from fairness_llm_tpu_torch.telemetry.flightrecorder import (
    get_flight_recorder,
    recording_on,
)
from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import Timeline, get_timeline

logger = logging.getLogger(__name__)

BUNDLE_SCHEMA_VERSION = 1
INCIDENTS_DIRNAME = "incidents"
MANIFEST_FILENAME = "incident.json"

# The control-plane decision kinds the audit trail records. Closed set on
# purpose: a typo'd kind at a call site should fail tests, not silently
# open a new label cardinality.
DECISIONS = (
    "route",       # HealthRouter.pick chose a replica for one admission
    "shed",        # overload/deadline gate terminally refused a request
    "fault",       # containment branch absorbed a prefill/decode fault
    "breaker",     # CircuitBreaker state transition
    "ladder",      # DegradationLadder level change
    "overload",    # ShedController rung transition
    "autoscale",   # Autoscaler up / down / up_denied
    "fence",       # ReplicaSet fenced a replica
    "rejoin",      # fenced replica probed for rejoin (ok / denied)
    "canary",      # canary probe verdict (ok / mismatch)
    "slo_alert",   # burn-rate alert crossing
    "heartbeat",   # missed-beat gap classified
    "rollout",     # RolloutController wave transition / gate verdict
    "incident",    # a trigger fired (dumped or suppressed)
)

# Incident classes the trigger registry accepts; same closed-set stance.
INCIDENT_CLASSES = (
    "breaker_open",
    "fence",
    "watchdog_hang",
    "numerics_fault",
    "canary_mismatch",
    "fairness_alert",
    "pair_divergence",
    "slo_burn",
    "integrity_fault",
    "heartbeat_gap",
    "memory_pressure",   # paged-arena exhaustion deferred admissions
    "rollout",           # a rollout rolled back (the gate that fired)
    "device_fatal",      # a CUDA error re-raised, not contained (port only)
)

# Per-decision-kind JSONL emission throttle: the ring keeps the complete
# recent trail; the sink gets at most one event per kind per interval (a
# router placing thousands of admissions/s must not turn events.jsonl into
# a placement log).
DECISION_EMIT_INTERVAL_S = 1.0

# Trace-slice window: timeline events younger than this ride the bundle.
INCIDENT_TRACE_WINDOW_S = 30.0

_emit_last: Dict[str, float] = {}


@dataclasses.dataclass
class DecisionRecord:
    """One control-plane decision, with its inputs at decision time."""

    decision: str
    action: str
    signals: Dict
    request_id: Optional[str] = None
    replica: Optional[str] = None
    t: float = 0.0

    def as_dict(self) -> Dict:
        d = {"decision": self.decision, "action": self.action,
             "signals": self.signals, "t": self.t}
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.replica is not None:
            d["replica"] = self.replica
        return d


def record_decision(decision: str, action: str,
                    signals: Optional[Dict] = None,
                    request_id: Optional[str] = None,
                    replica: Optional[str] = None) -> Optional[DecisionRecord]:
    """Append one decision to the audit trail: the flight recorder's
    ``decisions`` ring (complete recent history, O(1)), a
    ``decisions_total{decision}`` counter, and — throttled per kind — a
    ``decision`` JSONL event. Gated on the recording switch: with the
    recorder (or attribution) off, the whole trail costs nothing and
    records nothing."""
    if decision not in DECISIONS:
        raise ValueError(f"unknown decision kind {decision!r} "
                         f"(choose from {DECISIONS})")
    if not recording_on():
        return None
    now = time.monotonic()
    rec = DecisionRecord(decision=decision, action=str(action),
                         signals=dict(signals or {}),
                         request_id=request_id, replica=replica, t=now)
    # Placement decisions are the one per-admission-rate kind: they get
    # their own ring so a routing flood can never evict the rare critical
    # decisions (breaker/fence/autoscale) out of the audit trail.
    ring = "routes" if decision == "route" else "decisions"
    get_flight_recorder().record(ring, **rec.as_dict())
    get_registry().counter("decisions_total", component="incidents",
                           decision=decision).inc()
    last = _emit_last.get(decision)
    if last is None or now - last >= DECISION_EMIT_INTERVAL_S:
        _emit_last[decision] = now
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        emit_event("decision", **rec.as_dict())
    return rec


# -- journal registration ------------------------------------------------------
# The serving journal registers its path at construction so bundles can
# include the intake-ledger tail without the incident layer importing the
# resilience package (which imports telemetry — the reverse edge would
# cycle).

_journal_path: Optional[str] = None


def note_journal(path: str) -> None:
    """Record the active serving journal's path for bundle inclusion."""
    global _journal_path
    _journal_path = path


def _config_fingerprint() -> Dict:
    import platform
    import sys

    fp = {
        "argv": list(sys.argv),
        "python": platform.python_version(),
        "cwd": os.getcwd(),
    }
    import torch

    fp["torch"] = torch.__version__
    fp["cuda"] = torch.version.cuda
    try:
        fp["device"] = (torch.cuda.get_device_name(0) if torch.cuda.is_initialized()
                        else "cpu")
    except Exception:  # noqa: BLE001 — after a fatal device error the query may fail
        fp["device"] = "unknown"
    return fp


def _sanitize(s: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in s)[:64]


class IncidentManager:
    """Trigger registry + bundle dumper. Disarmed (``dir=None``) by
    default: triggers are free no-ops until ``arm()`` gives them somewhere
    to dump. ``clock`` is injectable so dedup/cooldown tests never sleep."""

    def __init__(self, dir: Optional[str] = None, cooldown_s: float = 60.0,
                 clock=time.monotonic):
        self.dir = dir
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._seq = 0
        # (class, scope) -> last dump time: the dedup store. A suppressed
        # trigger within the cooldown increments a counter instead of
        # producing bundle number N of the same storm.
        self._last_dump: Dict[tuple, float] = {}
        self.bundles: List[str] = []

    @property
    def armed(self) -> bool:
        return self.dir is not None

    def arm(self, dir: str, cooldown_s: Optional[float] = None) -> None:
        os.makedirs(dir, exist_ok=True)
        self.dir = dir
        if cooldown_s is not None:
            self.cooldown_s = float(cooldown_s)

    def disarm(self) -> None:
        self.dir = None

    # -- triggering ----------------------------------------------------------

    def trigger(self, incident_class: str, cause: str,
                scope: Optional[str] = None, replica: Optional[str] = None,
                request_id: Optional[str] = None, **ctx) -> Optional[str]:
        """One trigger condition fired. Dedup on (class, scope): inside the
        cooldown the trigger is counted suppressed and nothing is written
        — a fault storm produces one bundle per class+scope, not one per
        fault. Returns the bundle path when a dump happened. Never raises:
        a broken dump must not take the serving loop down with it."""
        if incident_class not in INCIDENT_CLASSES:
            raise ValueError(f"unknown incident class {incident_class!r} "
                             f"(choose from {INCIDENT_CLASSES})")
        if not self.armed:
            return None
        reg = get_registry()
        reg.counter("incident_triggers_total", component="incidents",
                    **{"class": incident_class}).inc()
        now = self._clock()
        key = (incident_class, scope or replica or "")
        last = self._last_dump.get(key)
        if last is not None and now - last < self.cooldown_s:
            reg.counter("incident_suppressed_total", component="incidents",
                        **{"class": incident_class}).inc()
            return None
        # The trigger is itself the newest decision — recorded BEFORE the
        # ring snapshot so the bundle contains its own head of chain.
        record_decision("incident", incident_class,
                        signals={"cause": cause, "scope": key[1], **ctx},
                        request_id=request_id, replica=replica)
        try:
            path = self._dump(incident_class, cause, key[1], replica,
                              request_id, ctx, now)
        except Exception as e:  # noqa: BLE001 — containment is the point
            # The cooldown is NOT stamped on failure: a trigger whose dump
            # died (disk full, permissions) must stay retriggerable —
            # stamping here would suppress the whole class for a cooldown
            # with zero bundles on disk to debug from.
            reg.counter("incident_dump_failures_total",
                        component="incidents").inc()
            logger.warning("incident bundle dump failed (%s/%s): %s",
                           incident_class, key[1], e)
            return None
        self._last_dump[key] = now
        reg.counter("incident_bundles_total", component="incidents",
                    **{"class": incident_class}).inc()
        from fairness_llm_tpu_torch.telemetry import emit_event  # lazy: no cycle

        emit_event("incident", **{"class": incident_class}, cause=cause,
                   scope=key[1], bundle=path)
        logger.warning("incident bundle dumped: %s (%s)", path, cause)
        self.bundles.append(path)
        return path

    # -- the dump ------------------------------------------------------------

    def _dump(self, incident_class: str, cause: str, scope: str,
              replica: Optional[str], request_id: Optional[str],
              ctx: Dict, now: float) -> str:
        # Seq is per-manager, but the DIR can outlive the manager (a
        # repeated study re-arming into the same incidents dir): skip past
        # any name already on disk so a fresh process never renames onto a
        # prior run's bundle.
        while True:
            self._seq += 1
            stem = (f"{incident_class}-{_sanitize(scope)}-{self._seq:03d}"
                    if scope else f"{incident_class}-{self._seq:03d}")
            final = os.path.join(self.dir, stem)
            if not os.path.exists(final):
                break
        tmp = final + ".partial"
        # Atomicity: everything lands in the .partial sibling first; the
        # rename is the commit. A mid-dump kill leaves only a .partial dir
        # (cleaned by the next dump attempt / ignored by readers), never a
        # half-filled bundle that looks complete.
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            recorder = get_flight_recorder()
            trail = list(recorder.rings["decisions"])
            implicated = [
                d for d in trail
                if (replica is not None and d.get("replica") == replica)
                or (request_id is not None
                    and d.get("request_id") == request_id)
                or (request_id is not None and request_id in
                    (d.get("signals") or {}).get("request_ids", ()))
            ]
            manifest = {
                "schema_version": BUNDLE_SCHEMA_VERSION,
                "class": incident_class,
                "cause": cause,
                "scope": scope,
                "replica": replica,
                "request_id": request_id,
                "context": ctx,
                "t_monotonic": now,
                "created_at_unix": time.time(),
                "cooldown_s": self.cooldown_s,
                "config": _config_fingerprint(),
                "ring_depths": {k: len(v)
                                for k, v in recorder.rings.items()},
                "decisions_implicated": len(implicated),
            }
            self._write_json(tmp, MANIFEST_FILENAME, manifest)
            self._write_json(tmp, "flightrecorder.json",
                             recorder.snapshot())
            self._write_jsonl(tmp, "decisions.jsonl", trail)
            self._write_jsonl(tmp, "decisions_implicated.jsonl", implicated)
            self._write_json(tmp, "snapshot.json",
                             registry_snapshot(get_registry()))
            # The slice cutoff uses the REAL monotonic clock, not the
            # manager's injectable one (that exists for dedup math only):
            # timeline events carry time.monotonic stamps, and filtering
            # them against a fake clock would make the window meaningless.
            self._write_json(tmp, "trace_slice.json",
                             self._trace_slice(time.monotonic()))
            self._journal_tail(tmp)
            os.rename(tmp, final)
        except BaseException:
            # Leave nothing torn behind: the .partial dir is removed even
            # on KeyboardInterrupt-class exits mid-dump.
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    @staticmethod
    def _write_json(dir_: str, name: str, obj) -> None:
        with open(os.path.join(dir_, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1, sort_keys=True, default=str)

    @staticmethod
    def _write_jsonl(dir_: str, name: str, rows: List[Dict]) -> None:
        with open(os.path.join(dir_, name), "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row, sort_keys=True, default=str) + "\n")

    @staticmethod
    def _trace_slice(now: float,
                     window_s: float = INCIDENT_TRACE_WINDOW_S) -> Dict:
        """The timeline's last ``window_s`` as a self-contained Chrome
        trace — the Perfetto view of the seconds before the trigger."""
        cutoff = now - window_s
        evs = [ev for ev in get_timeline().events()
               if ev.get("t0", 0.0) + ev.get("dur_s", 0.0) >= cutoff]
        tl = Timeline(capacity=max(len(evs), 1))
        for ev in evs:
            tl._push(ev)  # same package; re-deriving the epoch is the point
        trace = tl.to_chrome_trace()
        trace["otherData"]["slice_window_s"] = window_s
        return trace

    @staticmethod
    def _journal_tail(dir_: str, max_lines: int = 200) -> None:
        if _journal_path is None or not os.path.exists(_journal_path):
            return
        try:
            with open(_journal_path, encoding="utf-8") as f:
                tail = f.readlines()[-max_lines:]
            with open(os.path.join(dir_, "journal_tail.jsonl"), "w",
                      encoding="utf-8") as f:
                f.writelines(tail)
        except OSError as e:
            logger.warning("journal tail unavailable for bundle: %s", e)


# -- the process-wide manager --------------------------------------------------

_manager = IncidentManager()


def get_incident_manager() -> IncidentManager:
    return _manager


def set_incident_manager(m: IncidentManager) -> IncidentManager:
    global _manager
    prev, _manager = _manager, m
    return prev


class use_incident_manager:
    """Context manager: route triggers to a fresh (or given) manager
    inside the block — test isolation, like ``use_registry``."""

    def __init__(self, m: Optional[IncidentManager] = None):
        self.manager = m if m is not None else IncidentManager()
        self._prev: Optional[IncidentManager] = None

    def __enter__(self) -> IncidentManager:
        self._prev = set_incident_manager(self.manager)
        return self.manager

    def __exit__(self, *exc) -> None:
        set_incident_manager(self._prev)


def arm_incidents(dir: str, cooldown_s: Optional[float] = None) -> None:
    """Arm the process-wide trigger registry: bundles dump under ``dir``
    from here on (the CLI's ``--incidents`` and the chaos drill call
    this; without it every trigger is a free no-op)."""
    _manager.arm(dir, cooldown_s=cooldown_s)


def maybe_trigger(incident_class: str, cause: str, **kwargs) -> Optional[str]:
    """Module-level trigger entry every instrumented component calls —
    resolved through the process-wide manager at call time."""
    return _manager.trigger(incident_class, cause, **kwargs)


# -- bundle reading / validation / rendering -----------------------------------


def list_bundles(incidents_dir: str) -> List[Dict]:
    """Manifests of every complete bundle under ``incidents_dir`` (sorted
    by name = dump order), each with its ``path``. ``.partial`` leftovers
    are not bundles and are skipped."""
    out: List[Dict] = []
    if not os.path.isdir(incidents_dir):
        return out
    for name in sorted(os.listdir(incidents_dir)):
        path = os.path.join(incidents_dir, name)
        manifest = os.path.join(path, MANIFEST_FILENAME)
        if name.endswith(".partial") or not os.path.isfile(manifest):
            continue
        try:
            with open(manifest, encoding="utf-8") as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        m["path"] = path
        out.append(m)
    return out


BUNDLE_REQUIRED_FILES = (
    MANIFEST_FILENAME, "flightrecorder.json", "decisions.jsonl",
    "snapshot.json", "trace_slice.json",
)


def validate_incidents(telemetry_dir: str, require: bool = False,
                       forbid: bool = False) -> List[str]:
    """The ``--require-incidents`` / ``--forbid-incidents`` gate
    (tools/validate_telemetry.py): ``require`` demands at least one
    complete, well-shaped bundle (manifest parses with a known class, every
    required file present, no ``.partial`` leftovers); ``forbid`` demands
    ZERO bundles — the fault-free contract. Returns problems (empty =
    valid)."""
    problems: List[str] = []
    inc_dir = os.path.join(telemetry_dir, INCIDENTS_DIRNAME)
    bundles = list_bundles(inc_dir)
    if forbid:
        if bundles:
            problems.append(
                f"{len(bundles)} incident bundle(s) under {inc_dir} in a "
                "run that must produce none: "
                + ", ".join(os.path.basename(b["path"]) for b in bundles)
            )
        # A .partial leftover means a trigger FIRED and died mid-dump —
        # that is still an incident in a run that must have none.
        if os.path.isdir(inc_dir):
            for n in sorted(os.listdir(inc_dir)):
                if n.endswith(".partial"):
                    problems.append(
                        f"torn bundle leftover {n!r} — a trigger fired in "
                        "a run that must produce none (the dump died "
                        "mid-write)"
                    )
        return problems
    if not require:
        return problems
    if not os.path.isdir(inc_dir):
        problems.append(f"{inc_dir} missing (incident engine never armed — "
                        "arm_incidents / --incidents)")
        return problems
    partial = [n for n in os.listdir(inc_dir) if n.endswith(".partial")]
    for n in partial:
        problems.append(f"torn bundle leftover {n!r} (a dump died mid-write "
                        "and was not cleaned)")
    if not bundles:
        problems.append(f"no incident bundles under {inc_dir} (no trigger "
                        "ever dumped)")
        return problems
    for m in bundles:
        where = os.path.basename(m["path"])
        if m.get("class") not in INCIDENT_CLASSES:
            problems.append(f"{where}: unknown incident class "
                            f"{m.get('class')!r}")
        if not m.get("cause"):
            problems.append(f"{where}: manifest has no cause")
        for fn in BUNDLE_REQUIRED_FILES:
            if not os.path.isfile(os.path.join(m["path"], fn)):
                problems.append(f"{where}: required file {fn!r} missing")
    return problems


def _read_jsonl(path: str) -> List[Dict]:
    out: List[Dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def causal_chain(manifest: Dict, trail: List[Dict],
                 implicated: List[Dict], max_links: int = 6) -> str:
    """The one-line story: the trigger, then the distinct decisions that
    led to it (newest first, counted when repeated), then the implicated
    request ids. Derived from the recorded trail, never from logs."""
    scope = manifest.get("scope") or manifest.get("replica") or ""
    head = f"{manifest.get('class', '?')}({scope})" if scope \
        else str(manifest.get("class", "?"))
    source = implicated or trail
    counts: Dict[tuple, int] = {}
    order: List[tuple] = []
    requests: List[str] = []
    for d in reversed(source):
        if d.get("decision") == "incident":
            continue  # the trigger itself is the head, not a link
        key = (d.get("decision", "?"), d.get("action", "?"))
        if key not in counts:
            order.append(key)
        counts[key] = counts.get(key, 0) + 1
        rid = d.get("request_id")
        rids = (d.get("signals") or {}).get("request_ids", ())
        for r in ([rid] if rid else []) + list(rids):
            if r not in requests:
                requests.append(r)
    links = [head]
    for key in order[:max_links]:
        n = counts[key]
        label = f"{key[0]}:{key[1]}"
        links.append(f"{n}x {label}" if n > 1 else label)
    if requests:
        shown = ", ".join(requests[:8])
        more = f" (+{len(requests) - 8} more)" if len(requests) > 8 else ""
        links.append(f"requests {shown}{more}")
    return " <- ".join(links)


def render_incident_report(bundle_dir: str, width: int = 78) -> str:
    """Terminal rendering of one bundle: manifest, the causal chain, ring
    depths, and the implicated decision tail — the ``cli incident-report``
    view."""
    manifest_path = os.path.join(bundle_dir, MANIFEST_FILENAME)
    with open(manifest_path, encoding="utf-8") as f:
        manifest = json.load(f)
    trail = _read_jsonl(os.path.join(bundle_dir, "decisions.jsonl"))
    implicated = _read_jsonl(
        os.path.join(bundle_dir, "decisions_implicated.jsonl"))
    lines: List[str] = []
    lines.append("=" * width)
    lines.append(f"INCIDENT  {manifest.get('class')}  "
                 f"(bundle {os.path.basename(bundle_dir)})")
    lines.append("=" * width)
    ts = manifest.get("created_at_unix")
    if ts:
        lines.append("when:     " + time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(ts)))
    lines.append(f"cause:    {manifest.get('cause')}")
    if manifest.get("replica"):
        lines.append(f"replica:  {manifest['replica']}")
    if manifest.get("request_id"):
        lines.append(f"request:  {manifest['request_id']}")
    if manifest.get("context"):
        lines.append(f"context:  {manifest['context']}")
    lines.append("")
    lines.append("causal chain:")
    lines.append("  " + causal_chain(manifest, trail, implicated))
    depths = manifest.get("ring_depths") or {}
    if depths:
        lines.append("")
        lines.append("flight recorder: " + ", ".join(
            f"{k}={v}" for k, v in sorted(depths.items())))
    tail = (implicated or trail)[-16:]
    if tail:
        lines.append("")
        lines.append(f"decision trail ({'implicated' if implicated else 'full'}"
                     f", last {len(tail)}):")
        lines.append(f"  {'decision':<10} {'action':<28} {'request':<18} "
                     f"{'replica':<8} signals")
        for d in tail:
            sig = d.get("signals") or {}
            sig_str = ", ".join(f"{k}={v}" for k, v in sorted(sig.items()))
            lines.append(
                f"  {d.get('decision', '?'):<10} "
                f"{str(d.get('action', ''))[:28]:<28} "
                f"{str(d.get('request_id') or '-')[:18]:<18} "
                f"{str(d.get('replica') or '-'):<8} {sig_str[:40]}"
            )
    return "\n".join(lines)
