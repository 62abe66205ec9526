"""Replica fleet: N replicas behind one bounded admission queue
(counterpart of ``fairness_llm_tpu/serving/fleet.py``).

Everything below the fleet protects ONE scheduler: the watchdog, the
breakers and the ladder, the numerics guard, the canary. The
``ReplicaSet`` is the next boundary up, so that a sick replica drains and
the fleet serves on:

- **N replicas**, each a ``ContinuousScheduler`` with its own KV slot pool
  (or paged arena), breakers, ladder, watchdog and rejoin canary, every
  instrument labeled ``{"replica": name}``. Replicas share one engine's
  parameters (one weight tree, N pools on the card) or take one engine
  each.
- **Health-aware routing** (``serving/router.py``): admissions pop from the
  fleet's queue and land on the healthiest, least-loaded replica.
- **Fencing**: a replica whose ladder reaches
  ``FleetConfig.fence_ladder_level``, whose open breakers reach
  ``fence_open_breakers``, whose stall probe fires, or that takes an
  injected ``replica_crash``/``replica_hang`` is drained with zero grace
  (its breakers forced open for the crash-class reasons), and every
  unfinished request **migrates** with its id, settings and row seed (and a
  fresh retry budget) to the head of a healthy replica's queue, so greedy
  rows stay token for token those of a single scheduler.
- **Canary-gated rejoin**: after ``fence_cooldown_s``, and once its
  breakers can half-open, a fenced replica must pass a probe through its
  own scheduler: greedy fleets compare the golden prompt token for token
  with the version's recorded rows, sampled fleets need a smoke decode to
  finish. A failed probe restarts the cooldown.
- **Zero loss**: every request accepted reaches a terminal ``Result`` or
  stays in the journal; a process-wide drain (``GracefulDrain``) drains
  every replica with the configured grace and preempts the fleet-held
  tail.
- **Elastic membership** (``serving/autoscaler.py``): ``add_replica`` builds
  a canary-gated standby, ``retire_replica`` evacuates the victim through
  the fence's zero-grace path and frees its device tensors and ledger
  entries (``ContinuousScheduler.release_memory``); ``submit``/``tick``/
  ``take_result`` let a driver (``serving/replay.py``) stream requests in.
- **Versions** (``serving/rollout.py``): each replica serves one version,
  and a request keeps the version that first admitted it while that
  version has a live replica.

The fleet is the front door: with overload control on, the gate
(``ShedController``, deadline feasibility over the fastest replica's p50s)
runs at its intake, and the replica schedulers get none.

Where the port departs from the reference: the rejoin canary's reference
rows are recorded per version in a private scheduler of the replica's
``ServingConfig``, not by the static engine (``integrity/canary.py``: on
the card K2 plans its key splits from the batch and the cache length, so a
bf16 row of another shape parts at near ties, and a cross-shape canary
would fence a healthy replica); a retired replica frees its pool and
buffers as well as releasing its memory-ledger entries; and a fatal CUDA
error raised inside a replica
(``utils/failures.is_fatal_device_error``) re-raises out of the fleet. The
scheduler records and raises it, and nothing here catches it: it is not
counted as a crash, fenced or migrated.

Telemetry: ``fleet_replicas`` and ``fleet_healthy_replicas`` gauges,
``fleet_fenced_total{replica,reason}``, ``fleet_rejoins_total{replica}``,
``fleet_migrated_requests_total``, ``fleet_migrated_recovered_total``,
``fleet_retired_total``, ``fleet_standby_denied_total``, and
``fleet_failover_recovery_s`` (fence to the first migrated request's first
token). ``check_fleet`` is the port's copy of the reference validator's
``--require-fleet`` gate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from fairness_llm_tpu_torch.config import (
    AutoscaleConfig,
    FleetConfig,
    IntegrityConfig,
    ModelSettings,
    OverloadConfig,
    ResilienceConfig,
    ServingConfig,
)
from fairness_llm_tpu_torch.resilience.drain import ServingJournal, drain_requested
from fairness_llm_tpu_torch.serving.overload import DeadlineEstimator, ShedController, count_shed
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue, ClassedAdmissionQueue
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, QOS_PRIORITY, Request, Result
from fairness_llm_tpu_torch.serving.router import HealthRouter
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler
from fairness_llm_tpu_torch.telemetry import emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.fairness import get_fairness_monitor
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline
from fairness_llm_tpu_torch.utils.profiling import ServingStats
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter

logger = logging.getLogger(__name__)

# Fence reasons that arrive as signals (injected faults, the stall probe):
# the replica's stages are presumed dead, so its breakers are forced open
# and the rejoin must pass their half-open machinery.
CRASH_CLASS_REASONS = ("replica_crash", "replica_hang", "stalled")


@contextlib.contextmanager
def _synthetic(sched: ContinuousScheduler):
    """A probe through ``sched`` is synthetic traffic: no journal record (a
    successor process must never resume it) and the scheduler's prefill and
    decode seconds left as they were."""
    saved = sched.journal, sched.last_seconds
    sched.journal = None
    try:
        yield
    finally:
        sched.journal, sched.last_seconds = saved


class _FleetDeadlineEstimator(DeadlineEstimator):
    """Fleet-wide feasibility: the lower bound reads the fastest replica's
    p50s (the replicas' histograms carry ``{"replica": name}``)."""

    def __init__(self, replicas, safety: float = 0.5):
        super().__init__(safety=safety)
        self._replicas = replicas

    def _p50(self, name: str):
        vals = []
        for rep in self._replicas:
            h = get_registry().peek(name, component="serving", replica=rep.name)
            if h is not None and getattr(h, "count", 0):
                vals.append(h.percentile(50))
        return min(vals) if vals else None


class Replica:
    """One fault domain: a scheduler (its own pool, board and watchdog),
    fence state, and the requests the fleet routed to it."""

    def __init__(self, name: str, engine, sched: ContinuousScheduler, version: str = "v0"):
        self.name = name
        self.engine = engine
        self.sched = sched
        # The rollout version this replica serves (serving/rollout.py).
        self.version = version
        self.stats = ServingStats(num_slots=sched.num_slots)
        self.fenced = False
        self.fenced_at: Optional[float] = None
        self.fence_reason: Optional[str] = None
        self.fences = 0
        self.rejoins = 0
        # Request ids routed here -> their Requests (the migration source:
        # Results carry only ids).
        self.assigned: Dict[str, Request] = {}
        self.canary = None  # built on first use (ReplicaSet._replica_canary)


class ReplicaSet:
    """N replicas and the router behind the ``ContinuousScheduler`` surface
    that ``ServingBackend`` reads (``serve``, ``last_stats``,
    ``last_seconds``, ``num_slots``, ...), so the phases run through a fleet
    unchanged.

    ``engines``: one engine (shared parameters, a pool a replica) or a
    sequence of ``fleet.replicas`` engines (one each).
    """

    def __init__(
        self,
        engines,
        serving: Optional[ServingConfig] = None,
        settings: Optional[ModelSettings] = None,
        fleet: Optional[FleetConfig] = None,
        resilience: Optional[ResilienceConfig] = None,
        journal: Optional[ServingJournal] = None,
        fault_injector=None,
        integrity: Optional[IntegrityConfig] = None,
        name: Optional[str] = None,
        overload: Optional[OverloadConfig] = None,
        autoscale: Optional[AutoscaleConfig] = None,
    ):
        # ``name`` namespaces a second fleet in one process (the backend's
        # "s1", ...): replica labels become "<name>.r0" and the fleet's own
        # instruments gain {"fleet": name}. None keeps r0, r1, ...
        self.name = name
        self._fleet_labels = {"fleet": name} if name else {}
        self.serving = serving or ServingConfig(enabled=True)
        self.settings = settings or ModelSettings()
        self.fleet = fleet or FleetConfig(replicas=2)
        if self.fleet.replicas < 1:
            raise ValueError(f"fleet.replicas must be >= 1, got {self.fleet.replicas}")
        self.resilience = resilience
        self.journal = journal
        self.fault_injector = fault_injector
        self.integrity = integrity or IntegrityConfig()
        self.router = HealthRouter(self.fleet)
        if isinstance(engines, (list, tuple)):
            if len(engines) != self.fleet.replicas:
                raise ValueError(
                    f"{len(engines)} engines for {self.fleet.replicas} replicas — pass one "
                    "engine per replica, or a single engine to share its params")
            per_replica = list(engines)
        else:
            per_replica = [engines] * self.fleet.replicas
        # Rate limiting stays at the fleet's queue: one quota, not N.
        self._rep_serving = dataclasses.replace(self.serving, admission_per_minute=None)
        # What a scale-up draws from: the one engine, or the original
        # engines in turn.
        self._engine_pool = per_replica
        # Monotone names: a retired name is never reused.
        self._replica_seq = self.fleet.replicas
        # The fleet's current version; each request pins to the version of
        # the replica that first admitted it.
        self.version = "v0"
        self._request_version: Dict[str, str] = {}
        self.rollout = None  # the RolloutController while one is attached
        self.replicas: List[Replica] = []
        for i, eng in enumerate(per_replica):
            self.replicas.append(self._new_replica(f"{name}.r{i}" if name else f"r{i}", eng,
                                                   self.version, self._rep_serving))
        # Stats of replicas retired since the last stats close.
        self._retired_stats: List[ServingStats] = []
        # Overload control at the fleet's intake (the replicas get none:
        # gating again after routing would shed an accepted request twice).
        self.overload = overload if (overload is not None and overload.enabled) else None
        self.shed_controller: Optional[ShedController] = None
        self.deadline_estimator: Optional[DeadlineEstimator] = None
        if self.overload is not None:
            self.shed_controller = ShedController(self.overload, labels=self._fleet_labels,
                                                  burn_fn=self._max_replica_burn)
            if self.overload.deadline_admission:
                self.deadline_estimator = _FleetDeadlineEstimator(
                    self.replicas, safety=self.overload.feasibility_safety)
        self._shed_fleet = 0  # fleet-intake sheds since the last stats close
        # The fleet's own bounded queue: the backpressure callers see.
        fleet_rate = (RateLimiter(self.serving.admission_per_minute)
                      if self.serving.admission_per_minute else None)
        if self.overload is not None:
            self.queue: AdmissionQueue = ClassedAdmissionQueue(
                capacity=self.serving.queue_capacity, rate_limiter=fleet_rate,
                overload=self.overload)
        else:
            self.queue = AdmissionQueue(capacity=self.serving.queue_capacity,
                                        rate_limiter=fleet_rate)
        self._pending: Deque[Request] = deque()
        self._migrating: Deque[Request] = deque()
        self._results: Dict[str, Result] = {}
        self._migrated_ids: set = set()
        self._recovered_ids: set = set()
        self._canary_rr = 0  # the periodic canary's round-robin cursor
        self._rejected_taken = 0
        # The rejoin canary's recorded rows, one per version (a v+1 standby
        # is judged against its own version's rows).
        self._canary_refs: Dict[str, object] = {}
        self._probe_seq = 0
        self._fence_t: Optional[float] = None
        self._failover_pending = False
        self.last_failover_s: Optional[float] = None
        self.last_stats: Optional[ServingStats] = None
        reg = get_registry()
        reg.gauge("fleet_replicas", component="fleet",
                  **self._fleet_labels).set(len(self.replicas))
        reg.gauge("fleet_healthy_replicas", component="fleet",
                  **self._fleet_labels).set(len(self.replicas))
        self.autoscaler = None
        if autoscale is not None and autoscale.enabled:
            from fairness_llm_tpu_torch.serving.autoscaler import Autoscaler

            self.autoscaler = Autoscaler(self, autoscale)

    def _new_replica(self, rep_name: str, engine, version: str,
                     serving: ServingConfig) -> Replica:
        sched = ContinuousScheduler(engine, serving, settings=self.settings,
                                    fault_injector=self.fault_injector,
                                    resilience=self.resilience, journal=self.journal,
                                    replica=rep_name)
        sched.journal_version = version
        return Replica(rep_name, engine, sched, version=version)

    # -- the scheduler surface -----------------------------------------------

    @property
    def num_slots(self) -> int:
        """Slots across the fleet (the backend's decode batch)."""
        return sum(r.sched.num_slots for r in self.replicas)

    @property
    def max_prompt_bucket(self) -> int:
        return self.replicas[0].sched.max_prompt_bucket

    @property
    def cache_len(self) -> int:
        return self.replicas[0].sched.cache_len

    @property
    def last_seconds(self) -> Dict[str, float]:
        """Prefill and decode seconds of the live replicas since the last
        ``serve`` began (host clock, each ending in a sync)."""
        out = {"prefill": 0.0, "decode": 0.0}
        for rep in self.replicas:
            for k in out:
                out[k] += rep.sched.last_seconds[k]
        return out

    @property
    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if not r.fenced)

    # -- overload gate --------------------------------------------------------

    def _max_replica_burn(self) -> float:
        """The controller's burn signal: the hottest fast-window burn of
        any replica."""
        reg = get_registry()
        return max((reg.read_value("slo_burn_rate", default=0.0, component="serving",
                                   replica=rep.name, slo=slo, window="fast")
                    for rep in self.replicas for slo in ("error_rate", "ttft_p95")),
                   default=0.0)

    def _queued_ahead(self, qos: str) -> int:
        """Fleet-held work of the same or a higher class."""
        if isinstance(self.queue, ClassedAdmissionQueue):
            ahead = sum(d for c, d in self.queue.class_depths().items()
                        if QOS_PRIORITY[c] <= QOS_PRIORITY[qos])
        else:
            ahead = len(self.queue)
        return ahead + sum(1 for r in self._pending if QOS_PRIORITY[r.qos] <= QOS_PRIORITY[qos])

    def _deliver_shed(self, req: Request, reason: str, error: str, retry_after: float,
                      journaled: bool) -> None:
        count_shed(req.qos, reason, labels=self._fleet_labels)
        # A terminal outcome for dashboards summing requests_finished_total
        # (no replica's tracer ever saw it).
        get_registry().counter("requests_finished_total", component="fleet", outcome="shed",
                               **self._fleet_labels).inc()
        self._shed_fleet += 1
        ctl = self.shed_controller
        record_decision("shed", reason,
                        signals={"qos": req.qos, "retry_after_s": retry_after,
                                 "level": ctl.level if ctl is not None else 0,
                                 "front_door": "fleet"},
                        request_id=req.id)
        # The neutrality audit must see it: no replica ever will.
        get_fairness_monitor().observe_request(req, "shed")
        if journaled and self.journal is not None:
            self.journal.record_terminal(req.id, "shed")
        self._deliver(req.id, Result(
            id=req.id, ok=False, finish_reason="shed", error=error, retries=req.retries,
            latency_s=time.monotonic() - req.submitted_at, retry_after_s=retry_after))

    def _overload_gate(self, req: Request, journaled: bool = True) -> bool:
        """True when the fleet shed ``req`` (its Result delivered): the
        ladder's class admission, then deadline feasibility, as the
        scheduler's gate."""
        ctl = self.shed_controller
        if ctl is None:
            return False
        if req.qos == "interactive":
            ctl.note_interactive()
        if not ctl.admits(req.qos):
            self._deliver_shed(
                req, "overload",
                f"overload level {ctl.level} ({ctl.rung}) sheds {req.qos}-class admissions; "
                f"retry after {ctl.retry_after()}s",
                ctl.retry_after(), journaled)
            return True
        if self.deadline_estimator is not None and req.deadline_s is not None:
            est = self.deadline_estimator.infeasible(
                req, self._queued_ahead(req.qos), self.num_slots,
                self.replicas[0].sched.decode_chunk)
            if est is not None:
                self._deliver_shed(
                    req, "deadline_infeasible",
                    "deadline provably unmeetable at fleet intake (estimated earliest first "
                    f"token {est:.3f}s)",
                    ctl.retry_after(est), journaled)
                return True
        return False

    # -- serve ---------------------------------------------------------------

    def serve(self, requests: Sequence[Request]) -> List[Result]:
        """Serve ``requests`` across the fleet; Results in submission
        order. Each loop iteration routes, steps every replica once,
        fences and migrates the sick and probes the fenced, until every
        request is terminal."""
        now = time.monotonic()
        ids = [r.id for r in requests]
        if len(set(ids)) != len(ids):
            dup = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"duplicate request ids in serve() batch: {dup}")
        for req in requests:
            self.replicas[0].sched._check_settings(req)
        for rep in self.replicas:
            rep.sched.last_seconds = {"prefill": 0.0, "decode": 0.0}
        for req in requests:
            req.submitted_at = now
            # The gate before acceptance: a shed request was never accepted,
            # so it is not journaled.
            if self._overload_gate(req, journaled=False):
                continue
            if self.journal is not None:
                # The fleet's intake ledger: a request drained before it
                # reached a replica must survive for resume-serving too.
                self.journal.record_submitted(req)
            self._pending.append(req)
        expected = set(ids)
        while not expected.issubset(self._results):
            if drain_requested():
                self._drain_all()
                break
            if not self._tick():
                # Nothing moved: yield instead of spinning.
                time.sleep(0.002)
        self._finish_stats()
        out = [self._results.pop(rid) for rid in ids]
        for rid in ids:
            self._migrated_ids.discard(rid)
            self._recovered_ids.discard(rid)
        return out

    def await_recovery(self, timeout_s: float = 30.0, poll_s: float = 0.01) -> bool:
        """Probe fenced replicas until the fleet is whole (True) or
        ``timeout_s`` passes (False)."""
        deadline = time.monotonic() + timeout_s
        while any(r.fenced for r in self.replicas):
            for rep in self.replicas:
                if rep.fenced:
                    self._maybe_rejoin(rep)
            if not any(r.fenced for r in self.replicas):
                break
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)
        return True

    # -- the streaming surface ------------------------------------------------

    def submit(self, request: Request, restamp: bool = True,
               count_rejection: bool = True) -> bool:
        """Queue one request at the fleet's intake; False = backpressure
        (nothing enqueued) or a terminal overload shed (a claimable
        ``finish_reason="shed"`` Result). Accepted requests are journaled
        here and routed on a later ``tick``. ``count_rejection=False``
        marks a re-offer whose first refusal was counted."""
        self.replicas[0].sched._check_settings(request)
        if restamp:
            request.submitted_at = time.monotonic()
        if self._overload_gate(request, journaled=False):
            return False
        accepted = self.queue.submit(request, count_rejection=count_rejection)
        if accepted and self.journal is not None:
            self.journal.record_submitted(request)
        return accepted

    def tick(self) -> bool:
        """One fleet loop iteration (a process-wide drain runs instead);
        True when any work moved."""
        if drain_requested():
            self._drain_all()
            return False
        return self._tick()

    def take_result(self, request_id: str) -> Optional[Result]:
        """Claim (and remove) the Result of a ``submit()``-ed request."""
        res = self._results.pop(request_id, None)
        if res is not None:
            self._migrated_ids.discard(request_id)
            self._recovered_ids.discard(request_id)
        return res

    @property
    def has_work(self) -> bool:
        """Anything still owed a Result, fleet-held or on a replica."""
        return bool(self._pending or len(self.queue) or self._migrating
                    or any(r.sched.has_work for r in self.replicas))

    def request_version(self, request_id: str) -> Optional[str]:
        """The version ``request_id`` is pinned to, or None before
        placement (kept for the run)."""
        return self._request_version.get(request_id)

    def drain(self) -> ServingStats:
        """Run the loop until nothing is owed, then close the stats window;
        the Results wait in ``take_result``."""
        while self.has_work:
            if drain_requested():
                self._drain_all()
                break
            if not self._tick():
                time.sleep(0.002)
        self._finish_stats()
        return self.last_stats

    # -- the fleet loop --------------------------------------------------------

    def _tick(self) -> bool:
        if self.shed_controller is not None:
            self.shed_controller.observe_queue_depth(len(self.queue) + len(self._pending),
                                                     self.serving.queue_capacity)
            self.shed_controller.maybe_evaluate()
        progressed = False
        rollout_active = self.rollout is not None and self.rollout.active
        # Membership before routing, so that an added replica takes traffic
        # this tick and a retired one's work is already waiting to migrate.
        # A rollout owns membership while active: the autoscaler pauses.
        if self.autoscaler is not None and not rollout_active:
            progressed |= self.autoscaler.maybe_tick()
        if rollout_active:
            progressed |= self.rollout.maybe_tick()
        progressed |= self._expire_held()
        progressed |= self._route()
        for rep in list(self.replicas):
            if rep.fenced:
                progressed |= self._maybe_rejoin(rep)
                continue
            injector_fault = getattr(self.fault_injector, "maybe_replica_fault", None)
            injected = injector_fault(rep.name) if injector_fault is not None else None
            if injected is not None:
                self._fence(rep, injected)
                progressed = True
                continue
            # The burn windows decay even on an idle replica: the router
            # reads them at every placement.
            rep.sched.tracer.slo.maybe_evaluate()
            if rep.sched.has_work:
                progressed |= rep.sched.step(rep.stats)
                self._collect(rep)
            reason = self.router.should_fence(rep)
            if reason is not None:
                self._fence(rep, reason)
                progressed = True
        return progressed

    def _expire_held(self) -> bool:
        """Deadline-expire fleet-held requests (pending, queued, awaiting
        migration): one stranded while the whole fleet is fenced must still
        end."""
        now = time.monotonic()
        expired: List[Request] = list(self.queue.drain_expired(now))
        for held in (self._pending, self._migrating):
            live = [r for r in held if not r.expired(now)]
            if len(live) != len(held):
                expired.extend(r for r in held if r.expired(now))
                held.clear()
                held.extend(live)
        for req in expired:
            if self.journal is not None:
                self.journal.record_terminal(req.id, "expired")
            self._deliver(req.id, Result(
                id=req.id, ok=False, finish_reason="deadline",
                error="deadline expired before a healthy replica could take the request",
                retries=req.retries, latency_s=now - req.submitted_at))
        return bool(expired)

    def _route(self) -> bool:
        """Feed the fleet queue from the pending overflow, then place
        migrating requests (at the head of a replica's queue) and queued
        admissions on the healthiest replicas."""
        moved = False
        if self.shed_controller is None:
            while self._pending and not self.queue.full:
                if not self.queue.submit(self._pending[0], count_rejection=False):
                    break  # rate-limited; retry next tick
                self._pending.popleft()
                moved = True
        else:
            # Re-gate at each feed (the ladder may have climbed), one pass,
            # a class skipped after its first refusal: the scheduler's _feed.
            blocked: set = set()
            kept: Deque[Request] = deque()
            while self._pending:
                if len(blocked) == len(QOS_CLASSES):
                    kept.extend(self._pending)
                    self._pending.clear()
                    break
                req = self._pending.popleft()
                if req.qos in blocked:
                    kept.append(req)
                    continue
                if self._overload_gate(req):  # journaled at intake
                    moved = True
                    continue
                if not self.queue.submit(req, count_rejection=False):
                    blocked.add(req.qos)
                    kept.append(req)
                else:
                    moved = True
            self._pending = kept
        while self._migrating:
            req = self._migrating[0]
            # A migration stays on its pinned version while that version has
            # a live replica (an unroutable pick holds); only once it has
            # none is the pin restamped, and the request decodes afresh on
            # the surviving version.
            pinned = self._request_version.get(req.id)
            rep = self.router.pick(self.replicas, qos=req.qos, require_version=pinned)
            if rep is None and pinned is not None and not any(
                    r.version == pinned and not r.fenced for r in self.replicas):
                rep = self.router.pick(self.replicas, qos=req.qos)
                if rep is not None:
                    get_registry().counter("rollout_affinity_restamped_total",
                                           component="rollout", **self._fleet_labels).inc()
                    record_decision("rollout", "restamp",
                                    signals={"from_version": pinned, "to_version": rep.version},
                                    request_id=req.id, replica=rep.name)
                    emit_event("rollout_affinity_restamped", request_id=req.id,
                               from_version=pinned, to_version=rep.version)
            if rep is None:
                break
            self._migrating.popleft()
            # front=True: it waited through its fenced replica's queue once,
            # which also bounds failover recovery to about one admission
            # and chunk. restamp=False throughout: the deadline clock runs
            # from the fleet's intake.
            if not rep.sched.submit(req, front=True, restamp=False):
                self._migrating.appendleft(req)
                break
            rep.assigned[req.id] = req
            self._request_version[req.id] = rep.version
            moved = True
        while len(self.queue):
            req = self.queue.pop(1)[0]
            rep = self.router.pick(self.replicas, qos=req.qos)
            if rep is None or not rep.sched.submit(req, restamp=False):
                self.queue.requeue(req)
                break
            rep.assigned[req.id] = req
            # Pinned at first placement: its first token is this version's.
            self._request_version[req.id] = rep.version
            moved = True
        return moved

    def _collect(self, rep: Replica) -> None:
        """Claim the terminal Results of everything routed to ``rep``."""
        for rid in list(rep.assigned):
            res = rep.sched.take_result(rid)
            if res is None:
                continue
            del rep.assigned[rid]
            self._deliver(rid, res, rep=rep)

    def _deliver(self, rid: str, res: Result, rep: Optional[Replica] = None) -> None:
        """Hand one terminal Result to the caller, crediting a migrated
        request's recovery once (whatever its outcome and wherever it
        ended), so that migrated == recovered counts unique requests."""
        self._results[rid] = res
        if rid in self._migrated_ids and rid not in self._recovered_ids:
            self._recovered_ids.add(rid)
            get_registry().counter("fleet_migrated_recovered_total", component="fleet",
                                   **self._fleet_labels).inc()
            self._record_failover(rep, res)

    def _record_failover(self, rep: Optional[Replica], res: Result) -> None:
        """Failover recovery: the fence to the first migrated request's
        first token on its new replica (from that replica's tracer; the
        delivery time when there is none, an upper bound)."""
        if not self._failover_pending or self._fence_t is None:
            return
        self._failover_pending = False
        recovery = None
        if rep is not None:
            for row, evs in rep.sched.tracer.finished:
                if row.request_id == res.id:
                    stamps = [e.t for e in evs if e.event == "first_token"]
                    if stamps:
                        recovery = stamps[-1] - self._fence_t
        if recovery is None:
            recovery = time.monotonic() - self._fence_t
        recovery = max(recovery, 0.0)
        self.last_failover_s = recovery
        reg = get_registry()
        reg.gauge("fleet_failover_recovery_s", component="fleet",
                  **self._fleet_labels).set(recovery)
        reg.histogram("fleet_failover_recovery_dist_s", component="fleet",
                      **self._fleet_labels).observe(recovery)
        emit_event("fleet_failover_recovered", replica=rep.name if rep is not None else None,
                   request_id=res.id, recovery_s=round(recovery, 4))

    # -- fence, migrate, rejoin ----------------------------------------------

    def _fence(self, rep: Replica, reason: str) -> None:
        if rep.fenced:
            return
        now = time.monotonic()
        rep.fenced = True
        rep.fenced_at = now
        rep.fence_reason = reason
        rep.fences += 1
        if not self._failover_pending:
            # The failover clock measures the oldest unrecovered fence.
            self._fence_t = now
        get_registry().counter("fleet_fenced_total", component="fleet", replica=rep.name,
                               reason=reason).inc()
        self._update_health_gauge()
        emit_event("replica_fenced", replica=rep.name, reason=reason,
                   live=rep.sched.pool.occupancy, queued=len(rep.sched.queue))
        get_timeline().record_instant("fence", rep.name, t=now, reason=reason)
        logger.warning("fencing replica %s (%s): %d live, %d queued — draining and migrating",
                       rep.name, reason, rep.sched.pool.occupancy, len(rep.sched.queue))
        migrated = self._evacuate(rep, reason)
        emit_event("replica_fence_complete", replica=rep.name, reason=reason, migrated=migrated)
        board = rep.sched.breakers
        record_decision(
            "fence", reason,
            signals={"migrated": migrated,
                     "health_score": round(get_registry().read_value(
                         "replica_health_score", default=-1.0, component="fleet",
                         replica=rep.name), 4),
                     "open_breakers": board.open_count() if board is not None else 0,
                     "ladder_level": board.ladder.level if board is not None else 0},
            replica=rep.name)
        maybe_trigger("fence", f"replica {rep.name} fenced: {reason}", scope=rep.name,
                      replica=rep.name, migrated=migrated)

    def _evacuate(self, rep: Replica, reason: str, count_failover: bool = True) -> int:
        """Drain ``rep`` with zero grace and migrate everything unfinished:
        the mechanics of a fence and of a retirement (which stays off the
        failover clock, ``count_failover=False``). Returns the migrated
        count."""
        rep.sched.request_drain(grace_s=0.0)
        rep.sched.step(rep.stats)
        if reason in CRASH_CLASS_REASONS and rep.sched.breakers is not None:
            rep.sched.breakers.trip("prefill")
            rep.sched.breakers.trip("decode")
        migrated, newly_migrated = 0, 0
        for rid in list(rep.assigned):
            req = rep.assigned.pop(rid)
            res = rep.sched.take_result(rid)
            if res is not None and res.finish_reason != "preempted":
                # Terminal before the fence took hold.
                self._deliver(rid, res, rep=rep)
                continue
            # Migrate with the original id, settings and row seed, and a
            # fresh retry budget (the requeue-once rule is per replica).
            req.retries = 0
            get_fairness_monitor().note_event(
                rid, f"migrated:{rep.name}",
                tagged=(req.group is not None or req.pair_id is not None))
            self._migrating.append(req)
            migrated += 1
            if rid not in self._migrated_ids:
                self._migrated_ids.add(rid)
                newly_migrated += 1
        if newly_migrated:
            get_registry().counter("fleet_migrated_requests_total", component="fleet",
                                   **self._fleet_labels).inc(newly_migrated)
        if migrated:
            if count_failover:
                self._failover_pending = True
            get_timeline().record_instant("migrate", rep.name, migrated=migrated)
        return migrated

    # -- elastic membership ----------------------------------------------------

    def add_replica(self, engine=None, version: Optional[str] = None,
                    serving: Optional[ServingConfig] = None) -> Optional[Replica]:
        """Build a standby replica and let it join only if it passes the
        rejoin probe. Returns it, or None when the probe refused it
        (``fleet_standby_denied_total``). ``engine``/``version``/``serving``
        are a rollout's new version; by default the engine pool at the
        fleet's version."""
        i = self._replica_seq
        self._replica_seq += 1
        rep_name = f"{self.name}.r{i}" if self.name else f"r{i}"
        if engine is None:
            engine = self._engine_pool[i % len(self._engine_pool)]
        rep = self._new_replica(rep_name, engine, version or self.version,
                                serving or self._rep_serving)
        if not self._rejoin_probe(rep):
            rep.sched.release_memory()
            get_registry().counter("fleet_standby_denied_total", component="fleet",
                                   replica=rep_name).inc()
            emit_event("replica_standby_denied", replica=rep_name)
            logger.warning("standby replica %s failed its canary gate; not joining the fleet",
                           rep_name)
            return None
        self.replicas.append(rep)
        reg = get_registry()
        reg.counter("fleet_scale_ups_total", component="fleet", **self._fleet_labels).inc()
        reg.gauge("fleet_replicas", component="fleet",
                  **self._fleet_labels).set(len(self.replicas))
        self._update_health_gauge()
        emit_event("replica_added", replica=rep_name, replicas=len(self.replicas))
        get_timeline().record_instant("scale_up", rep_name)
        logger.warning("replica %s passed its standby canary; joined the fleet (%d replicas)",
                       rep_name, len(self.replicas))
        return rep

    def retire_replica(self, rep: Replica) -> int:
        """Take ``rep`` out of the fleet: its in-flight requests migrate
        through the zero-grace path (the fence's contract), its stats fold
        into the fleet's and its device tensors are freed. A planned exit:
        no fence counter, no failover clock, no rejoin. Returns the
        migrated count."""
        if len(self.replicas) <= 1:
            raise ValueError("cannot retire the last replica")
        if rep not in self.replicas:
            raise ValueError(f"replica {rep.name!r} is not in this fleet")
        # Fenced while it evacuates, so that nothing is routed to it.
        rep.fenced = True
        rep.fence_reason = "retired"
        reg = get_registry()
        reg.counter("fleet_retired_total", component="fleet", replica=rep.name).inc()
        emit_event("replica_retiring", replica=rep.name, live=rep.sched.pool.occupancy,
                   queued=len(rep.sched.queue))
        get_timeline().record_instant("scale_down", rep.name)
        logger.warning("retiring replica %s: %d live, %d queued — draining and migrating to "
                       "survivors", rep.name, rep.sched.pool.occupancy, len(rep.sched.queue))
        migrated = self._evacuate(rep, "retired", count_failover=False)
        # The permanent exit: its pool, buffers and ledger entries leave
        # with it (a fence keeps the replica and its memory).
        rep.sched.release_memory()
        rep.sched.finish_stats(rep.stats)
        self._retired_stats.append(rep.stats)
        self.replicas.remove(rep)
        reg.gauge("fleet_replicas", component="fleet",
                  **self._fleet_labels).set(len(self.replicas))
        self._update_health_gauge()
        emit_event("replica_retired", replica=rep.name, migrated=migrated,
                   replicas=len(self.replicas))
        return migrated

    def _maybe_rejoin(self, rep: Replica) -> bool:
        """Probe a fenced replica once its cooldown has passed: rejoin on a
        pass, restart the cooldown on a failure. True when a probe ran."""
        now = time.monotonic()
        if rep.fenced_at is None or now - rep.fenced_at < self.fleet.fence_cooldown_s:
            return False
        board = rep.sched.breakers
        if board is not None and any((board.seconds_until_probe(stage) or 0) > 0
                                     for stage in board.breakers):
            # A breaker still inside its own cooldown cannot half-open: the
            # probe's serve would spin the single-threaded fleet loop.
            return False
        if not self._rejoin_probe(rep):
            rep.fenced_at = now  # the cooldown restarts
            get_registry().counter("fleet_rejoin_denied_total", component="fleet",
                                   replica=rep.name).inc()
            emit_event("replica_rejoin_denied", replica=rep.name)
            record_decision("rejoin", "denied",
                            signals={"fence_reason": rep.fence_reason, "fences": rep.fences},
                            replica=rep.name)
            logger.warning("replica %s failed its rejoin probe; staying fenced", rep.name)
            return True
        rep.fenced = False
        rep.fenced_at = None
        rep.fence_reason = None
        rep.rejoins += 1
        get_registry().counter("fleet_rejoins_total", component="fleet",
                               replica=rep.name).inc()
        self._update_health_gauge()
        emit_event("replica_rejoined", replica=rep.name)
        record_decision("rejoin", "ok", signals={"rejoins": rep.rejoins}, replica=rep.name)
        get_timeline().record_instant("rejoin", rep.name)
        logger.warning("replica %s passed its rejoin probe; back in the fleet", rep.name)
        return True

    def _greedy_settings(self) -> bool:
        s = self.settings
        return s.temperature == 0.0 and s.top_k == 0 and s.top_p == 1.0

    def _rejoin_probe(self, rep: Replica) -> bool:
        """The canary gate: greedy fleets decode the golden prompt through
        the replica's own scheduler against its version's recorded rows,
        sampled fleets need a smoke decode to finish. The probe's decode is
        the replica breakers' half-open probe. The journal is detached and
        the replica's seconds kept: a probe is synthetic traffic."""
        with _synthetic(rep.sched):
            if self._greedy_settings():
                return self._replica_canary(rep).probe(rep.sched)
            self._probe_seq += 1
            smoke = Request(
                prompt="warm-up probe: list three colors.",
                id=f"__fleet_probe_{rep.name}_{self._probe_seq}__",
                settings=dataclasses.replace(self.settings, max_tokens=min(
                    self.settings.max_tokens, self.integrity.canary_max_tokens)),
                row_seed=0, qos="probe")
            res = rep.sched.serve([smoke])[0]
            get_registry().counter("canary_runs_total", component="serving",
                                   replica=rep.name).inc()
            return bool(res.ok)

    def _replica_canary(self, rep: Replica):
        """The replica's probe, over its version's recorded rows (recorded
        on first use in a private scheduler of the replica's
        ``ServingConfig``); the rejoin gate and the periodic canary share
        it."""
        if rep.canary is None:
            from fairness_llm_tpu_torch.integrity.canary import CanaryProbe

            ref = self._canary_refs.get(rep.version)
            if ref is None:
                # Clamped to the decode cap: the probe decodes through the
                # replica's scheduler, which clamps every request to it.
                ref = CanaryProbe.record(
                    rep.engine, rep.sched.serving,
                    max_tokens=min(self.integrity.canary_max_tokens,
                                   self.serving.max_new_tokens))
                self._canary_refs[rep.version] = ref
            rep.canary = ref.for_replica(rep.name, board=rep.sched.breakers)
        return rep.canary

    def periodic_canary(self) -> bool:
        """The backend's ``--canary-every`` in fleet mode: probe one
        unfenced replica (round robin) with its own canary, so that a
        mismatch trips that replica's decode breaker. Greedy fleets only;
        True when nothing was probeable."""
        if not self._greedy_settings():
            return True
        live = [r for r in self.replicas if not r.fenced]
        if not live:
            return True
        rep = live[self._canary_rr % len(live)]
        self._canary_rr += 1
        probe = self._replica_canary(rep)
        with _synthetic(rep.sched):
            return probe.probe(rep.sched)

    def _update_health_gauge(self) -> None:
        get_registry().gauge("fleet_healthy_replicas", component="fleet",
                             **self._fleet_labels).set(self.healthy_count)

    # -- process-wide drain, stats ------------------------------------------

    def _drain_all(self) -> None:
        """A process-wide drain (SIGTERM): every replica drains with the
        configured grace (preemption, not sickness) and the fleet-held tail
        is preempted; journal records stay open for resume-serving."""
        logger.warning("fleet drain: %d replica(s), %d fleet-held request(s)",
                       len(self.replicas),
                       len(self._pending) + len(self.queue) + len(self._migrating))
        for rep in self.replicas:
            if rep.sched.has_work:
                rep.sched.step(rep.stats)  # step() honours the drain flag
            for rid in list(rep.assigned):
                res = rep.sched.take_result(rid)
                if res is not None:
                    del rep.assigned[rid]
                    self._deliver(rid, res, rep=rep)
        hint = (f"resume with: resume-serving {self.journal.journal_dir}"
                if self.journal is not None
                else "no serving journal configured; request is lost at exit")
        held = list(self._pending) + self.queue.pop(len(self.queue)) + list(self._migrating)
        self._pending.clear()
        self._migrating.clear()
        for req in held:
            self._deliver(req.id, Result(
                id=req.id, ok=False, finish_reason="preempted",
                error=f"drained before routing ({hint})", retries=req.retries,
                latency_s=time.monotonic() - req.submitted_at))
        get_registry().counter("serving_preempted_total", component="fleet",
                               **self._fleet_labels).inc(len(held))

    def _finish_stats(self) -> None:
        agg = ServingStats(num_slots=0)
        # Replicas retired in this window first: their work belongs to it.
        for st in self._retired_stats:
            agg = agg.merge(st)
        self._retired_stats = []
        for rep in self.replicas:
            rep.sched.finish_stats(rep.stats)
            agg = agg.merge(rep.stats)
            rep.stats = ServingStats(num_slots=rep.sched.num_slots)
        agg.num_slots = self.num_slots
        agg.rejected += self.queue.rejected - self._rejected_taken
        self._rejected_taken = self.queue.rejected
        agg.shed += self._shed_fleet
        self._shed_fleet = 0
        self.last_stats = agg


def _fleet_gauges(snap: Dict) -> Dict[tuple, Dict[str, float]]:
    """The fleet gauges of a snapshot by label set (a process may run more
    than one fleet, each with its {"fleet": name} label)."""
    fleets: Dict[tuple, Dict[str, float]] = {}
    for g in snap.get("gauges", []):
        labels = g.get("labels", {})
        if labels.get("component") != "fleet":
            continue
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "component"))
        fleets.setdefault(key, {})[g["name"]] = g["value"]
    return fleets


def check_fleet(snap: Dict) -> List[str]:
    """The failover gate of the reference's ``tools/validate_telemetry.py
    --require-fleet`` (which imports the JAX package), the same problems
    for the same snapshot: a replica was fenced, the migrated requests all
    recovered (``fleet_migrated_requests_total`` equal to
    ``fleet_migrated_recovered_total``, nonzero), and every fleet of two or
    more replicas ends whole (``fleet_healthy_replicas`` equal to
    ``fleet_replicas``)."""
    problems: List[str] = []
    counters = snap.get("counters", [])

    def total(name):
        return sum(c["value"] for c in counters if c.get("name") == name)

    if not total("fleet_fenced_total"):
        problems.append("fleet_fenced_total is zero (no replica was ever fenced)")
    migrated = total("fleet_migrated_requests_total")
    recovered = total("fleet_migrated_recovered_total")
    if not migrated:
        problems.append("fleet_migrated_requests_total is zero (failover never migrated "
                        "anything)")
    elif migrated != recovered:
        problems.append(f"migrated ({migrated}) != recovered ({recovered}) — migrated "
                        "requests were lost")
    sized = {k: v for k, v in _fleet_gauges(snap).items() if v.get("fleet_replicas", 0) >= 2}
    if not sized:
        problems.append("no fleet_replicas gauge >= 2 (no fleet was armed)")
    for key, vals in sized.items():
        replicas = vals["fleet_replicas"]
        healthy = vals.get("fleet_healthy_replicas", -1)
        if healthy != replicas:
            tag = dict(key).get("fleet", "default")
            problems.append(f"fleet {tag!r}: fleet_healthy_replicas ({healthy}) != "
                            f"fleet_replicas ({replicas}) — a fenced replica never rejoined")
    return problems
