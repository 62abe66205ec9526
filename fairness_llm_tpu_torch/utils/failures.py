"""Failure containment for decode sweeps and the serving loop (the port's
copy of ``fairness_llm_tpu/utils/failures.py``).

A whole decode chunk fails at once (an out-of-memory, a bad checkpoint, a
stalled step), so ``with_failure_containment`` retries a failed chunk once
and then degrades to per-prompt ``None`` sentinels, keeping the sweep alive
and the failure visible in the results. The continuous-batching scheduler
contains faults per request instead (requeue once, then a failed
``Result``). ``ScriptedFaultInjector`` scripts faults, hangs, corruptions,
bit flips and replica faults for the drills.

One rule of the port's own: an error after which the process's CUDA
context cannot be used is NOT contained. A device-side assert or an illegal
address is sticky on a CUDA device (every later call in the process fails
too), where the reference's XLA errors are not; containing it would turn
one bad launch into a sweep of ``None`` rows that exits 0. Such an error
(``is_fatal_device_error``: ``torch.AcceleratorError``, a ``RuntimeError``
that names a CUDA error, or ``ops._build.KernelError``, a kernel that
failed to build, load or launch) is counted once as
``faults_total{kind="device_fatal"}``, logged at ERROR, triggers a
``device_fatal`` incident when the incident engine is armed
(``note_fatal_device_error``), and is re-raised. ``torch.OutOfMemoryError``
and every other exception are contained as the reference contains them.
The scheduler and ``with_failure_containment`` share the predicate.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from fairness_llm_tpu_torch.ops._build import KernelError
from fairness_llm_tpu_torch.telemetry import get_registry
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision

logger = logging.getLogger(__name__)


class DecodeFault(RuntimeError):
    """A (possibly injected) per-request decode failure.

    The continuous-batching scheduler (``serving/scheduler.py``) treats this
    as a SLOT-level event, not a process-level one: the hit request is
    requeued once (fresh prefill, fresh slot) and, if it faults again,
    surfaced as a failed ``Result``; the step loop itself never dies."""


class HangFault(DecodeFault):
    """A step classified as hung by the watchdog (``resilience/watchdog.py``:
    wall time past ``max_step_seconds``).

    Subclasses ``DecodeFault`` so every containment path (slot release and
    requeue-once in the scheduler, chunk retry in
    ``with_failure_containment``) absorbs it; the distinct type is what the
    telemetry labels key on."""


class NumericsFault(DecodeFault):
    """A chunk whose logits held NaN/Inf, caught by the numerics guard
    (``integrity/numerics.py``) before its tokens were delivered.

    Subclasses ``DecodeFault`` as ``HangFault`` does: the scheduler releases
    the chunk's slots and requeues each rider once (a fresh prefill
    re-derives every activation), ``with_failure_containment`` retries the
    engine chunk once then emits ``None`` sentinels, and the breakers see a
    persistent numeric sickness as consecutive failures. The type keys the
    ``kind="numerics"`` labels and ``numerics_faults_total``."""


def is_fatal_device_error(e: BaseException) -> bool:
    """Whether ``e`` leaves the process's CUDA context unusable, so that no
    containment may absorb it: ``torch.AcceleratorError`` (a device-side
    assert, an illegal address), a ``RuntimeError`` naming a CUDA error (as
    torch builds without ``AcceleratorError`` raise them), or a kernel that
    failed to build, load or launch (``ops._build.KernelError``). An
    out-of-memory error is not fatal: the context survives it."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    if isinstance(e, (KernelError, torch.AcceleratorError)):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def note_fatal_device_error(e: BaseException, component: str, stage: str,
                            labels: Optional[Dict[str, str]] = None) -> None:
    """Record a fatal device error once, at the innermost layer that sees
    it: ``faults_total{kind="device_fatal"}``, an ERROR log line and a
    ``device_fatal`` incident (when armed). Outer layers re-raise the same
    exception without counting it again."""
    if getattr(e, "_fatal_noted", False):
        return
    try:
        e._fatal_noted = True
    except AttributeError:  # an exception type without a __dict__
        pass
    get_registry().counter("faults_total", component=component, kind="device_fatal",
                           stage=stage, **(labels or {})).inc()
    logger.error("fatal device error in %s %s (not contained; the CUDA context is "
                 "unusable): %s: %s", component, stage, type(e).__name__, e)
    record_decision("fault", f"{stage}:device_fatal",
                    signals={"error": str(e)[:200], "component": component},
                    replica=(labels or {}).get("replica"))
    maybe_trigger("device_fatal", f"{component} {stage}: {type(e).__name__}: {e}"[:400],
                  scope=component, stage=stage)


class ScriptedFaultInjector:
    """Deterministic fault injection for serving tests and chaos drills.

    ``faults`` maps ``(request_id, stage)``, or a plain ``request_id`` for
    any stage, to the number of times that request should fault. Stages are
    ``"prefill"`` and ``"decode"``. Each ``maybe_fail`` hit decrements the
    budget, so "fail once then succeed" is ``{rid: 1}`` and "fail
    permanently" is ``{rid: 2}`` (the scheduler requeues exactly once).

    ``hangs`` (same key scheme) scripts HANGS: each ``maybe_hang`` hit
    returns ``hang_seconds`` of simulated stall, which the scheduler feeds
    to the step watchdog as extra elapsed time, a ``HangFault`` without
    sleeping.

    ``corruptions`` (same key scheme) scripts SILENT CORRUPTION: each
    ``maybe_corrupt`` hit tells the scheduler to poison that request's
    carried logits (``corruption_mode``: "nan" or "inf") before the next
    decode chunk, so the numerics guard (``integrity/numerics.py``) has
    something real to catch. ``flip_bit`` is the at-rest sibling: one
    flipped bit in an artifact file, for manifest drills.

    ``replica_crashes`` / ``replica_hangs`` script REPLICA-level faults for
    the reference's fleet router: keys are replica names, values the number
    of health polls the replica survives before the fault fires once
    (``maybe_replica_fault``, which ``serving/fleet.py`` calls).

    TIME-INDEXED schedule: ``faults_at`` / ``hangs_at`` / ``corruptions_at``
    (same key scheme, values in seconds) and ``replica_crashes_at`` /
    ``replica_hangs_at`` fire ONCE the first time the matching hook runs at
    or after that many seconds on the injector's clock, which starts at the
    first hook call or at ``arm()``.
    """

    def __init__(
        self,
        faults: Optional[Dict[object, int]] = None,
        hangs: Optional[Dict[object, int]] = None,
        hang_seconds: float = 3600.0,
        corruptions: Optional[Dict[object, int]] = None,
        corruption_mode: str = "nan",
        replica_crashes: Optional[Dict[str, int]] = None,
        replica_hangs: Optional[Dict[str, int]] = None,
        faults_at: Optional[Dict[object, float]] = None,
        hangs_at: Optional[Dict[object, float]] = None,
        corruptions_at: Optional[Dict[object, float]] = None,
        replica_crashes_at: Optional[Dict[str, float]] = None,
        replica_hangs_at: Optional[Dict[str, float]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if corruption_mode not in ("nan", "inf"):
            raise ValueError(f"corruption_mode must be 'nan' or 'inf', got {corruption_mode!r}")
        self._budget = dict(faults or {})
        self._hang_budget = dict(hangs or {})
        self._corruption_budget = dict(corruptions or {})
        self._replica_delay: Dict[str, tuple] = {}
        for name, delay in (replica_crashes or {}).items():
            self._replica_delay[name] = (int(delay), "replica_crash")
        for name, delay in (replica_hangs or {}).items():
            if name in self._replica_delay:
                raise ValueError(f"replica {name!r} scripted for both crash and hang")
            self._replica_delay[name] = (int(delay), "replica_hang")
        self._at = {
            "fault": dict(faults_at or {}),
            "hang": dict(hangs_at or {}),
            "corruption": dict(corruptions_at or {}),
        }
        self._replica_at: Dict[str, tuple] = {}
        for name, at in (replica_crashes_at or {}).items():
            if name in self._replica_delay:
                raise ValueError(f"replica {name!r} scripted for more than one fault")
            self._replica_at[name] = (float(at), "replica_crash")
        for name, at in (replica_hangs_at or {}).items():
            if name in self._replica_at or name in self._replica_delay:
                raise ValueError(f"replica {name!r} scripted for more than one fault")
            self._replica_at[name] = (float(at), "replica_hang")
        self._clock: Callable[[], float] = clock or time.monotonic
        self._t0: Optional[float] = None
        self.corruption_mode = corruption_mode
        self.hang_seconds = float(hang_seconds)
        self.fired: List[tuple] = []  # (request_id, stage) audit log
        self.hangs_fired: List[tuple] = []
        self.corruptions_fired: List[tuple] = []
        self.replica_faults_fired: List[tuple] = []  # (replica, kind)

    # -- the time-indexed clock ----------------------------------------------

    def arm(self, clock: Optional[Callable[[], float]] = None) -> None:
        """Start (or restart) the schedule clock; ``clock`` replaces the
        injector's clock for the rest of the run."""
        if clock is not None:
            self._clock = clock
        self._t0 = self._clock()

    def _elapsed(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def _due(self, kind: str, request_id: str, stage: str) -> bool:
        """One consumed time-schedule hit for ``kind`` (fault/hang/
        corruption), matching the count-based key scheme."""
        sched = self._at[kind]
        if not sched:
            return False
        elapsed = self._elapsed()
        for key in ((request_id, stage), request_id):
            at = sched.get(key)
            if at is not None and elapsed >= at:
                del sched[key]
                return True
        return False

    def _take(self, budget: Dict[object, int], request_id: str, stage: str) -> bool:
        for key in ((request_id, stage), request_id):
            n = budget.get(key, 0)
            if n > 0:
                budget[key] = n - 1
                return True
        return False

    def maybe_fail(self, request_id: str, stage: str) -> None:
        if self._due("fault", request_id, stage) or self._take(self._budget, request_id, stage):
            self.fired.append((request_id, stage))
            # Injected faults are labeled apart from device-raised ones
            # (the scheduler counts those kind="device").
            get_registry().counter("faults_total", component="serving", kind="injected",
                                   stage=stage).inc()
            raise DecodeFault(f"injected {stage} fault for request {request_id!r}")

    def maybe_hang(self, request_id: str, stage: str) -> float:
        """Simulated stall seconds this request adds to the current step
        (0.0 almost always)."""
        if self._due("hang", request_id, stage) or \
                self._take(self._hang_budget, request_id, stage):
            self.hangs_fired.append((request_id, stage))
            get_registry().counter("faults_total", component="serving", kind="injected_hang",
                                   stage=stage).inc()
            return self.hang_seconds
        return 0.0

    def maybe_corrupt(self, request_id: str, stage: str) -> Optional[str]:
        """The corruption mode ("nan"/"inf") the scheduler should poison
        this request's carried logits with before the next decode chunk;
        None almost always. The poison happens on the host side of the
        call, so the guarded step itself stays the production one."""
        if self._due("corruption", request_id, stage) or \
                self._take(self._corruption_budget, request_id, stage):
            self.corruptions_fired.append((request_id, stage))
            get_registry().counter("faults_total", component="serving",
                                   kind="injected_corruption", stage=stage).inc()
            return self.corruption_mode
        return None

    def maybe_replica_fault(self, replica: str) -> Optional[str]:
        """Replica-level fault due this health poll: ``"replica_crash"``,
        ``"replica_hang"``, or None (almost always). The scripted delay
        counts down one per poll and the fault fires once; a ``*_at`` entry
        fires at its scheduled second instead."""
        kind = None
        at_entry = self._replica_at.get(replica)
        if at_entry is not None and self._elapsed() >= at_entry[0]:
            del self._replica_at[replica]
            kind = at_entry[1]
        if kind is None:
            entry = self._replica_delay.get(replica)
            if entry is None:
                return None
            delay, k = entry
            if delay > 0:
                self._replica_delay[replica] = (delay - 1, k)
                return None
            del self._replica_delay[replica]
            kind = k
        self.replica_faults_fired.append((replica, kind))
        get_registry().counter("faults_total", component="fleet", kind=f"injected_{kind}",
                               stage="replica", replica=replica).inc()
        return kind

    @staticmethod
    def flip_bit(path: str, bit_index: int) -> None:
        """Flip one bit of a file in place, for artifact-corruption drills:
        with a manifest (``integrity/manifest.py``) the file must then be
        refused at load with an error naming it."""
        with open(path, "r+b") as f:
            f.seek(bit_index // 8)
            byte = f.read(1)
            if not byte:
                raise ValueError(f"bit_index {bit_index} beyond end of {path}")
            f.seek(bit_index // 8)
            f.write(bytes([byte[0] ^ (1 << (bit_index % 8))]))
        get_registry().counter("faults_total", component="integrity", kind="injected_bitflip",
                               stage="artifact").inc()


def with_failure_containment(
    generate: Callable[..., List[str]],
    retries: int = 1,
) -> Callable[..., List[Optional[str]]]:
    """Wrap a backend ``generate`` so that chunk failures return ``None``
    sentinels instead of raising (after ``retries`` fresh attempts).

    ``None``, not "", so that callers tell a failed decode from a model that
    emitted empty text, keep failures out of resume checkpoints (a failed
    prompt is retried on resume, not skipped), and still show the gap in
    the results. A fatal device error (``is_fatal_device_error``) is not
    contained: it is recorded once and re-raised."""

    def wrapped(
        prompts: Sequence[str], settings=None, seed: int = 0, keys=None,
        prefix_ids=None,
    ) -> List[Optional[str]]:
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            try:
                return list(generate(
                    prompts, settings, seed=seed, keys=keys, prefix_ids=prefix_ids
                ))
            except Exception as e:  # noqa: BLE001 — containment is the point
                if is_fatal_device_error(e):
                    note_fatal_device_error(e, "pipeline", "generate")
                    raise
                last = e
                # error_type label, so that a drill's report splits
                # HangFault from DecodeFault from raw device errors.
                get_registry().counter(
                    "contained_chunk_failures_total", component="pipeline",
                    error_type=type(e).__name__,
                ).inc()
                logger.warning("decode chunk failed (attempt %d/%d): %s",
                               attempt + 1, retries + 1, e)
        logger.error("decode chunk failed permanently; emitting None sentinels: %s", last)
        return [None for _ in prompts]

    return wrapped
