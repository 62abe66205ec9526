"""Continuous-batching step loop over a slot pool (counterpart of the core
loop of ``fairness_llm_tpu/serving/scheduler.py``).

The engine (``runtime/engine.py``) decodes one batch per call: every row
pads to the longest prompt and the batch is held until its last row is
done. This scheduler instead keeps ONE persistent device cache of
``num_slots`` rows and runs an admission loop:

1. fail deadlined requests, queued or mid-decode;
2. backfill free slots from the admission queue: the admitted prompts
   prefill in one ``[nb, P]`` forward (P the largest prompt bucket of the
   group, nb a power of two), each row's KV written into its slot's row of
   the pool (``stepbuilder.build_serve_prefill``);
3. decode every live slot up to ``decode_chunk * fuse_steps`` steps
   (``stepbuilder.build_serve_step``): per-row sampling streams seeded on
   the request's identity, per-row write offsets ``base + emitted``,
   per-row EOS and budget stops;
4. evict finished rows, release their slots (invalidated at the next
   step's entry unless a prefill re-initializes them first), and loop.

The parity contract (``tests/test_torch_serving.py``): a request decodes
the same tokens through the server as through ``DecodeEngine.generate([
prompt])`` alone, for prompts within the serving budget. Each slot holds
the engine's batch-1 layout: the left-padded prompt in slots [0, P), decode
writes at ``P + emitted``, positions counted over real tokens, attention
masked to the row's own valid keys.

With ``ServingConfig.paged_kv`` the slots hold block tables into one
shared arena instead (``serving/paged.py``): admission matches each prompt
against the radix index of cached prompt blocks, claims blocks (a private
tail and refs on the shared prefix chain), and prefills only the unmatched
suffix, in groups of one suffix bucket (``stepbuilder.build_paged_prefill``);
the decode step gathers the arena into a per-row view once a chunk and
scatters the private blocks back. A slot's extent is ``prompt_budget +
max(max_new_tokens, seq_bucket)`` rounded up to whole blocks.

Telemetry (``telemetry/``): the ``RequestTracer`` records each request's
lifecycle (queue wait, TTFT, per-token and end-to-end histograms, SLO burn
rates), every prefill batch and decode chunk is a span on the timeline's
``serving`` track (the gap between chunks feeds ``step_gap_s``), decode
chunks go to the flight recorder, a heartbeat pulses every 30 s, each drain
publishes its ``ServingStats``, and the paged manager its block accounting.

Fault containment (``utils/failures.py``): an injected or raised prefill
or decode fault releases the hit slots and requeues each request once (a
fresh prefill in a fresh slot); a second fault turns it into a failed
``Result``, and the loop goes on. The scripted injector's hooks
(``maybe_fail``, ``maybe_hang``, ``maybe_corrupt``) fire on the host before
the device call. A paged decode chunk whose device call itself raised also
drops the arena's contents and its cached prefixes (the arena may be half
written); an injected, numerics or hang fault leaves the arena intact (the
call completed, or never ran) and releases only the riders, so the prefix
cache and its counters survive. A fatal CUDA error
(``utils/failures.is_fatal_device_error``) is never contained: it is
counted, logged, triggers an incident and raises out of ``serve``.

Resilience (``resilience/``, with ``ResilienceConfig``): the step watchdog
classifies an over-budget prefill or decode call as a ``HangFault``
(contained as a decode fault; first use of a (stage, shape) key and calls
that built or loaded a kernel are exempt), per-stage circuit breakers stop
hammering a persistently failing prefill or decode (an open breaker skips
the stage until a half-open probe), breaker trips advance a degradation
ladder (drop speculation -> halve the decode chunk and soft-cap the pool
-> the backend's static-engine fallback), and a drain (SIGTERM/SIGINT via
``GracefulDrain``, or ``request_drain()``) stops admission, gives live
slots ``drain_grace_s`` to finish and preempts the rest, whose journal
records stay unfinished for ``resume-serving``.

Integrity (``integrity/``): with the engine's ``numerics_guards`` each
prefill and decode chunk's finite flag is read with its tokens, and a
tripped flag discards the chunk as a ``NumericsFault`` (requeue once,
breaker-visible, ``numerics_faults_total``).

Overload control (``serving/overload.py``, with ``OverloadConfig.enabled``):
the scheduler is the serving front door. The queue becomes the per-class
``ClassedAdmissionQueue``; ``_overload_gate`` runs before a request is
accepted (``submit``, and ``_feed`` for ``serve``'s intake): the shed
controller's rung refuses a class, then ``DeadlineEstimator`` refuses a
request whose deadline is provably out of reach, with queued-ahead counted
over the same and higher classes. ``_shed`` ends such a request with a
``finish_reason="shed"`` Result carrying ``retry_after_s``, counted in
``shed_total`` and the decision trail; a ``submit``-time shed was never
accepted, so it owes the journal nothing. The controller samples the
queue depth and evaluates once per loop iteration; at rung 2 batch decode
budgets clamp to ``batch_token_cap`` (``_cap_for``), and a request whose
deadline cannot cover one prefill and one decode step sheds at pop time
instead of being prefilled.

Fairness (``telemetry/fairness.py``): every terminal outcome (``_finish``,
``_fail``, ``_shed``, expiry) feeds the fairness monitor's neutrality audit
and pair watch (``_note_fairness``; a preempted request is left to the
monitor, which drops it), and a requeue is noted as a serving event of a
tagged request.

Replica fleet (``serving/fleet.py``): a fleet replica's scheduler is built
with ``replica=name``, which labels every instrument it writes
(``{"replica": name}``), gives it a timeline track and a heartbeat of its
own and names it in its decisions and incidents; the fleet drives it one
iteration at a time through ``step``, places migrated requests at the head
of its queue (``submit(front=True, restamp=False)``), and at retirement
frees its device tensors and their ledger entries (``release_memory``).

Tensor parallelism: the scheduler takes an engine over a tp-only mesh (a
dp or sp axis is refused, as the reference refuses it: the slot scatter is
not dp/sp-aware) and a ``ServingConfig.tp`` that must equal the mesh's.
Each tp rank runs this loop over the same requests; its KV pool or block
arena holds the rank's local kv heads (the rank model's config), and the
carried logits the full vocabulary (the model gathers them), so every rank
samples the same tokens and takes the same decisions. Program labels gain
``@tp<k>`` and keys ``("tp", k)`` (``stepbuilder.program_label``,
``tp_key``), unchanged at tp=1, and each program's cost ledger adds
``tp_collective_costs`` where its walk charged no collective.

Device-facing telemetry (``telemetry/memory.py``, ``compilestats.py``,
``roofline.py``, ``costmodel.py``): the KV pool (``kv_contiguous``) or the
block arena (``kv_paged``), the carried logits (``logits_carry``) and the
paged view and table buffers (``other``) are memory-ledger entries, made at
init and after a paged reset (``_account_device_state``); a block-exhaustion
deferral raises ``memory_pressure_active``, prices the deferred admission
against the headroom and fires the ``memory_pressure`` incident
(``_note_block_pressure``). Every prefill group and decode chunk looks up
its program key (``serve_prefill``, ``paged_prefill``, ``serve_step``,
``paged_step``, ``_fused`` with a fuse), records its first use as a
compile, runs its first armed call under the cost walk, and folds its wall
into the gap attribution; each decode chunk feeds the roofline gauges.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from fairness_llm_tpu_torch.config import (
    ModelSettings,
    OverloadConfig,
    ResilienceConfig,
    ServingConfig,
)
from fairness_llm_tpu_torch.integrity.numerics import check_finite
from fairness_llm_tpu_torch.models.tokenizer import _left_pad
from fairness_llm_tpu_torch.models.transformer import check_write_offsets, init_cache
from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.parallel.sharding import axis_size, mesh_shape
from fairness_llm_tpu_torch.resilience.breaker import BreakerBoard
from fairness_llm_tpu_torch.resilience.drain import (
    ServingJournal,
    drain_requested,
    take_signal_telemetry,
)
from fairness_llm_tpu_torch.resilience.watchdog import StepWatchdog, first_use
from fairness_llm_tpu_torch.runtime.engine import _bucket_len
from fairness_llm_tpu_torch.runtime.sampling import SamplerSettings
from fairness_llm_tpu_torch.runtime.stepbuilder import (
    build_paged_prefill,
    build_serve_prefill,
    build_serve_step,
    program_label,
    tp_key,
)
from fairness_llm_tpu_torch.serving.overload import (
    DeadlineEstimator,
    ShedController,
    count_shed,
)
from fairness_llm_tpu_torch.serving.paged import PagedKV, init_arena
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue, ClassedAdmissionQueue
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, QOS_PRIORITY, Request, Result
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState
from fairness_llm_tpu_torch.telemetry import Heartbeat, RequestTracer, emit_event, get_registry
from fairness_llm_tpu_torch.telemetry.compilestats import note_lookup, record_compile
from fairness_llm_tpu_torch.telemetry.costmodel import (
    InstrumentedProgram,
    note_invocation,
    tp_collective_costs,
)
from fairness_llm_tpu_torch.telemetry.fairness import get_fairness_monitor
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.incidents import maybe_trigger, record_decision
from fairness_llm_tpu_torch.telemetry.memory import get_memory_ledger, tree_device_bytes
from fairness_llm_tpu_torch.telemetry.roofline import observe_decode
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline
from fairness_llm_tpu_torch.utils.failures import (
    DecodeFault,
    HangFault,
    NumericsFault,
    is_fatal_device_error,
    note_fatal_device_error,
)
from fairness_llm_tpu_torch.utils.profiling import ServingStats
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter

logger = logging.getLogger(__name__)


def _bucket_pow2(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _fault_kind(e: Exception) -> str:
    return ("hang" if isinstance(e, HangFault)
            else "numerics" if isinstance(e, NumericsFault) else "device")


class ContinuousScheduler:
    """Serves one ``DecodeEngine``'s model from a fixed slot pool.

    One scheduler samples one way (``settings`` temperature, top_k, top_p)
    under one decode-length cap; ``ServingBackend`` keeps one per settings
    tuple. Direct use:

        sched = ContinuousScheduler(engine, ServingConfig(num_slots=8))
        results = sched.serve([Request(prompt=p) for p in prompts])

    ``last_seconds`` holds the last drain's host-clock seconds of prefill
    and of decode (each ends in a sync with the device).

    ``fault_injector`` (a ``ScriptedFaultInjector``) scripts faults, hangs
    and corruptions; ``resilience`` arms the watchdog and the breakers;
    ``journal`` ledgers every accepted request and its outcome; ``breakers``
    shares a ``BreakerBoard`` (``ServingBackend`` hands one board to all its
    schedulers and the engine); ``overload`` (an enabled ``OverloadConfig``)
    arms the QoS queue, the shed controller and deadline admission;
    ``replica`` names a fleet replica (``serving/fleet.py``), whose
    instruments carry ``{"replica": name}``.
    """

    # Memory-ledger handles: one per scheduler in the process.
    _mem_seq = 0

    def __init__(self, engine, serving: Optional[ServingConfig] = None,
                 settings: Optional[ModelSettings] = None, fault_injector=None,
                 resilience: Optional[ResilienceConfig] = None,
                 journal: Optional[ServingJournal] = None,
                 breakers: Optional[BreakerBoard] = None,
                 replica: Optional[str] = None,
                 overload: Optional[OverloadConfig] = None):
        mesh = getattr(engine, "mesh", None)
        if axis_size(mesh, "dp") > 1 or axis_size(mesh, "sp") > 1:
            raise ValueError(
                "ContinuousScheduler supports single-device and tp-only meshes (the slot "
                "scatter is not dp/sp-aware yet); build the engine with a tp-only mesh or "
                "without one")
        self.mesh = mesh
        self.tp = axis_size(mesh, "tp")
        self.engine = engine
        self.serving = serving or ServingConfig(enabled=True)
        want_tp = max(1, self.serving.tp)
        if want_tp > 1 and self.tp != want_tp:
            raise ValueError(
                f"ServingConfig.tp={want_tp} but the engine's mesh is "
                f"{None if mesh is None else mesh_shape(mesh)}; build the engine over a "
                "matching tp mesh (parallel.make_mesh)")
        # Replica identity: a fleet replica's instruments carry
        # {"replica": name} and it gets its own timeline track; None (a
        # single scheduler) adds no label.
        self.replica = replica
        self.labels: Dict[str, str] = {"replica": replica} if replica else {}
        self.track = replica or "serving"
        self.settings = settings or ModelSettings()
        self.sampler = SamplerSettings(temperature=self.settings.temperature,
                                       top_k=self.settings.top_k, top_p=self.settings.top_p)
        cfg = engine.config
        # The KV pool's shapes: the rank's local kv heads under tp.
        local_cfg = engine.model.config
        cap = self.serving.max_new_tokens
        if cap < 1 or cap >= cfg.max_seq_len:
            raise ValueError(f"max_new_tokens {cap} must be in [1, {cfg.max_seq_len})")
        # The per-request prompt budget, clamped so that the longest prompt
        # and the decode cap fit the model's position tables.
        self.prompt_budget = min(self.serving.max_prompt_len, cfg.max_seq_len - cap)
        if self.prompt_budget < 1:
            raise ValueError(f"no prompt budget left: max_seq_len {cfg.max_seq_len} - "
                             f"max_new_tokens {cap} <= 0")
        # The largest per-row prompt bucket (the cache layout; the real-token
        # budget above bounds the positions).
        self.max_prompt_bucket = _bucket_len(self.prompt_budget, engine.seq_bucket)
        self.num_slots = self.serving.num_slots
        self.paged = bool(self.serving.paged_kv)
        dev = engine.device
        if self.paged:
            # A slot's extent covers the prompt budget and the decode cap,
            # plus one suffix bucket of headroom: the suffix prefill writes
            # a bucketed window at the row's matched offset, and grouping by
            # suffix bucket bounds its end by prompt_budget + seq_bucket.
            bs = self.serving.kv_block_size
            span = self.prompt_budget + max(cap, engine.seq_bucket)
            blocks_per_slot = -(-span // bs)
            self.cache_len = blocks_per_slot * bs  # the gathered view's length
            self.pool = SlotPool(self.num_slots, paged=PagedKV(
                self.num_slots, blocks_per_slot, bs, num_blocks=self.serving.kv_blocks,
                labels=self.labels or None))
        else:
            self.cache_len = self.max_prompt_bucket + cap
            self.pool = SlotPool(self.num_slots)
        rate_limiter = (RateLimiter(self.serving.admission_per_minute)
                        if self.serving.admission_per_minute else None)
        # Overload control: with it armed, the queue is the per-class one and
        # the shed controller and the deadline estimator gate admission.
        self.overload = overload if (overload is not None and overload.enabled) else None
        self.shed_controller: Optional[ShedController] = None
        self.deadline_estimator: Optional[DeadlineEstimator] = None
        if self.overload is not None:
            self.queue: AdmissionQueue = ClassedAdmissionQueue(
                capacity=self.serving.queue_capacity, rate_limiter=rate_limiter,
                overload=self.overload)
            self.shed_controller = ShedController(self.overload, labels=self.labels)
            if self.overload.deadline_admission:
                self.deadline_estimator = DeadlineEstimator(
                    safety=self.overload.feasibility_safety, labels=self.labels)
        else:
            self.queue = AdmissionQueue(capacity=self.serving.queue_capacity,
                                        rate_limiter=rate_limiter)
        # Sheds of submit() calls between drains, folded into the next
        # drain's stats as its rejections are.
        self._shed_untaken = 0
        # Persistent device state: the pool's KV cache (private rows, or the
        # paged block arena with its view and table buffers) and each slot's
        # carried next-token logits (f32, what the sampler reads).
        if self.paged:
            paged = self.pool.paged
            self._cache = None
            self._arena = init_arena(local_cfg, paged.num_blocks, paged.block_size, self.num_slots,
                                     device=dev)
            # One view and one pair of table buffers serve the decode step
            # (num_slots rows) and every prefill group (at most the largest
            # batch bucket's rows), each filled in place.
            group = self.serving.prefill_group
            rows = max(self.num_slots,
                       _bucket_pow2(min(self.num_slots, group), max(group, 1)))
            self._view = init_cache(local_cfg, rows, self.cache_len, device=dev)
            self._tables = torch.zeros((rows, paged.blocks_per_slot), dtype=torch.long,
                                       device=dev)
            self._wtables = torch.full_like(self._tables, paged.num_blocks)
        else:
            self._cache = init_cache(local_cfg, self.num_slots, self.cache_len, device=dev)
            self._arena = None
        self._prev_logits = torch.zeros((self.num_slots, cfg.vocab_size), dtype=torch.float32,
                                        device=dev)
        self._mem_handle = f"sched{ContinuousScheduler._mem_seq}"
        ContinuousScheduler._mem_seq += 1
        self._block_pressure = False
        self._account_device_state()
        # Program keys seen (the reference's compiled-program cache): each
        # holds its cost ledger and memory capture.
        self._programs: Dict[tuple, InstrumentedProgram] = {}
        # One decode function: decode_chunk x fuse_steps steps a call, or
        # fewer once every live row is done. Degradation rung 2 halves the
        # chunk and drops the fuse; both come back as the ladder retreats.
        self.decode_chunk = self._base_decode_chunk = max(1, self.serving.decode_chunk)
        self.fuse_steps = self._base_fuse_steps = max(1, self.serving.fuse_steps)
        self._build_step()
        if self.paged:
            self._paged_prefill = build_paged_prefill(engine.model)
        # Request lifecycle spans and their histograms (and SLO burn rates),
        # and a liveness pulse: host-side timestamps only.
        self.tracer = RequestTracer(component="serving", labels=self.labels)
        self._heartbeat = Heartbeat(interval_s=30.0,
                                    name=f"serving[{replica}]" if replica else "serving")
        # serve()'s overflow beyond the queue's capacity
        self._pending: Deque[Request] = deque()
        self._results: Dict[str, Result] = {}
        # queue rejections already reported by an earlier drain
        self._rejected_taken = 0
        self.last_stats: Optional[ServingStats] = None
        self.last_seconds = {"prefill": 0.0, "decode": 0.0}
        self.fault_injector = fault_injector
        # Resilience (resilience/): the watchdog and the breakers arm only
        # when the config enables them (or a shared board is handed in);
        # the journal ledgers intake when present. In a fault-free run they
        # cost a few host-side timestamps per chunk.
        self.resilience = resilience or ResilienceConfig()
        r = self.resilience
        if breakers is not None:
            self.breakers: Optional[BreakerBoard] = breakers
        elif r.enabled:
            self.breakers = BreakerBoard(failure_threshold=r.breaker_threshold,
                                         cooldown_s=r.breaker_cooldown_s, labels=self.labels)
        else:
            self.breakers = None
        self.watchdog: Optional[StepWatchdog] = (
            StepWatchdog(r.max_step_seconds, labels=self.labels)
            if r.enabled and r.max_step_seconds > 0 else None)
        self.journal = journal
        # The version stamped on this scheduler's journal records (the fleet
        # sets its replica's rollout version; None outside a fleet).
        self.journal_version: Optional[str] = None
        self._drain_flag = False
        # request_drain(grace_s=...) overrides the configured grace for one
        # drain.
        self._drain_grace_override: Optional[float] = None
        # Degradation rung 2 soft-caps concurrent slots at half the pool.
        self.live_cap = self.num_slots
        self._applied_level = 0

    def _build_step(self) -> None:
        tok = self.engine.tokenizer
        self._step = build_serve_step(
            self.engine.model, self.sampler, tok.pad_id, tok.eos_id, num_slots=self.num_slots,
            chunk=self.decode_chunk, fuse=self.fuse_steps, paged=self.paged)
        # The decode function's telemetry name, as the reference labels it.
        self._program = program_label("paged_step" if self.paged else "serve_step",
                                      self.fuse_steps, tp=self.tp)

    def _guard(self) -> bool:
        """The numerics-guard switch, read from the engine (one switch for
        the engine and serving paths)."""
        return bool(getattr(self.engine, "numerics_guards", False))

    # -- submission ----------------------------------------------------------

    def _check_settings(self, request: Request) -> None:
        """A request whose sampler settings differ from the scheduler's is
        refused: it would decode with the wrong temperature."""
        s = request.settings
        if s is None:
            return
        rs = SamplerSettings(temperature=s.temperature, top_k=s.top_k, top_p=s.top_p)
        if rs != self.sampler:
            raise ValueError(f"request {request.id!r} sampler settings {rs} != scheduler "
                             f"sampler {self.sampler}; use a scheduler for those settings")

    def submit(self, request: Request, front: bool = False, restamp: bool = True) -> bool:
        """Queue one request; False = backpressure (queue full or rate
        quota) or an overload shed. The two read apart through
        ``take_result``: a shed leaves a ``finish_reason="shed"`` Result
        with a retry-after hint, backpressure leaves nothing. Its deadline
        and latency clock start here, unless ``restamp=False`` keeps the
        stamp of an earlier intake (the fleet's: routing and migration must
        not extend a deadline). ``front=True`` admits at the head of the
        line (the fleet's migration path)."""
        self._check_settings(request)
        if restamp:
            request.submitted_at = time.monotonic()
        # The gate runs before acceptance: a shed request was never
        # accepted, so it owes the journal nothing.
        if self._overload_gate(request, journaled=False):
            return False
        accepted = self.queue.submit(request, front=front)
        if accepted:
            self.tracer.record(request.id, "submitted", t=request.submitted_at)
            if self.journal is not None:
                # Ledgered at acceptance: from here on the request reaches a
                # terminal Result or survives in the journal.
                self.journal.record_submitted(request, version=self.journal_version)
        return accepted

    def take_result(self, request_id: str) -> Optional[Result]:
        """Claim (and remove) the Result of a request that ended in an
        earlier ``serve``/``drain``: the way back for ``submit()``-ed
        requests."""
        return self._results.pop(request_id, None)

    def release_memory(self) -> None:
        """Free this scheduler's device tensors (the KV slot pool or the
        paged arena with its view and table buffers, and the carried
        logits) and release every ledger entry it registered. The fleet
        calls it when it retires a replica (a fence keeps the replica and
        its memory); the scheduler serves nothing after it."""
        self._cache = self._arena = self._view = None
        self._tables = self._wtables = self._prev_logits = None
        get_memory_ledger().release_matching(f"{self._mem_handle}:")

    # -- the memory ledger ---------------------------------------------------

    def _account_device_state(self) -> None:
        """Register the persistent device tensors with the memory ledger:
        the arena under ``kv_paged`` (with the per-block bytes the headroom
        forecast prices a paged admission with), the slot cache under
        ``kv_contiguous``, the carried logits under ``logits_carry``, and
        the paged view and table buffers, which the reference keeps inside
        its compiled step, under ``other``. Runs at init and after a paged
        reset; re-registering a handle replaces its entry."""
        mem = get_memory_ledger()
        if self._arena is not None:
            mem.register("kv_paged", f"{self._mem_handle}:arena", self._arena,
                         replica=self.replica)
            self._block_bytes = tree_device_bytes(self._arena) // max(1, self.pool.paged.num_blocks)
            mem.register("other", f"{self._mem_handle}:view",
                         [self._view, self._tables, self._wtables], replica=self.replica)
        else:
            self._block_bytes = 0
        if self._cache is not None:
            mem.register("kv_contiguous", f"{self._mem_handle}:cache", self._cache,
                         replica=self.replica)
        mem.register("logits_carry", f"{self._mem_handle}:logits", self._prev_logits,
                     replica=self.replica)

    def _note_block_pressure(self, exhausted: bool, deferred) -> None:
        """The block-exhaustion deferral's memory signals: the recoverable
        ``memory_pressure_active`` gauge, and on exhaustion the deferred
        admission's worst case (a whole slot's private blocks) priced
        against the headroom and the deduplicated ``memory_pressure``
        incident naming the deferred requests. Soft: the arena's allocator
        stays the gate."""
        mem = get_memory_ledger()
        scope = self.replica or "serving"
        if not exhausted:
            if self._block_pressure:
                self._block_pressure = False
                mem.note_pressure(scope, False)
            return
        self._block_pressure = True
        mem.note_pressure(scope, True)
        fc = mem.forecast(self.pool.paged.blocks_per_slot * self._block_bytes)
        maybe_trigger("memory_pressure",
                      cause=f"paged arena exhausted; {len(deferred)} admission(s) deferred "
                            "to decode-side block frees",
                      scope=scope, replica=self.replica, request_ids=[r.id for r in deferred],
                      deferred=len(deferred), cost_bytes=fc["cost_bytes"],
                      headroom_bytes=fc["headroom_bytes"], basis=fc["basis"])

    def _program_for(self, key: tuple, label: str, rows: int, tokens: int, scope: str):
        """(the program of ``key``, labelled ``label``, and whether this is
        its first use); the lookup counts as a hit or a miss. A new program's
        ledger adds the tp collectives of a forward of ``rows x tokens``
        positions (``tp_collective_costs``, in ``scope``)."""
        key = tp_key(key, self.tp)
        prog = self._programs.get(key)
        note_lookup(label, hit=prog is not None, labels=self.labels)
        if prog is None:
            prog = self._programs[key] = InstrumentedProgram(
                label, device=self.engine.device,
                collectives=tp_collective_costs(self.engine.config, self.tp, rows,
                                                tokens=tokens, scope=scope))
            return prog, True
        return prog, False

    def _note_program(self, prog: InstrumentedProgram, key: tuple, fresh: bool, t0: float,
                      wall: float, steps: int = 0, reason: str = "shape") -> None:
        """A finished program call: its first use recorded as a compile, its
        wall folded into the gap attribution."""
        if fresh:
            record_compile(prog.program, reason=reason, seconds=wall, track=self.track, key=key,
                           labels=self.labels, t0=t0)
        note_invocation(prog.program, wall, steps, ledger=prog.ledger, compiling=fresh)

    def drain(self) -> ServingStats:
        """Run the loop until the queue and the pool are empty; the Results
        wait in ``take_result``."""
        stats = ServingStats(num_slots=self.num_slots)
        self._run_loop(stats)
        self.last_stats = stats
        return stats

    def serve(self, requests: Sequence[Request]) -> List[Result]:
        """Submit ``requests`` and run the loop until every one ends.
        Overflow beyond the queue's capacity waits on the host and feeds in
        as the queue drains. Results come back in submission order;
        requests queued earlier through ``submit()`` decode alongside and
        stay claimable through ``take_result``."""
        stats = ServingStats(num_slots=self.num_slots)
        ids = [r.id for r in requests]
        if len(set(ids)) != len(ids):
            dup = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"duplicate request ids in serve() batch: {dup}")
        for r in requests:
            self._check_settings(r)
        now = time.monotonic()
        for r in requests:
            r.submitted_at = now
            self.tracer.record(r.id, "submitted", t=now)
            if self.journal is not None:
                self.journal.record_submitted(r, version=self.journal_version)
        self._pending = deque(requests)
        self._run_loop(stats)
        self.last_stats = stats
        return [self._results.pop(r.id) for r in requests]

    # -- the loop ------------------------------------------------------------

    def request_drain(self, grace_s: Optional[float] = None) -> None:
        """Programmatic drain (the signal path is ``GracefulDrain``): the
        loop stops admission at its next iteration, finishes what it can
        within ``drain_grace_s`` (or ``grace_s``, for this drain only) and
        preempts the rest to the journal."""
        self._drain_flag = True
        self._drain_grace_override = grace_s

    def _drain_requested(self) -> bool:
        # Own flag or the process-wide one a GracefulDrain handler sets, so
        # that one SIGTERM drains every scheduler in the process.
        return self._drain_flag or drain_requested()

    @property
    def has_work(self) -> bool:
        """Anything still owed a Result: pending overflow, queued, or live."""
        return bool(self._pending or len(self.queue) or self.pool.occupancy)

    def step(self, stats: ServingStats) -> bool:
        """One admission and decode iteration; True when any work moved. A
        pending drain runs instead (and counts as no progress)."""
        if self._drain_requested():
            self._execute_drain(stats)
            return False
        self._apply_degradation()
        # SLO window decay: the burn gauges age out in quiet stretches.
        self.tracer.slo.maybe_evaluate()
        if self.shed_controller is not None:
            # One depth sample an iteration, then a throttled ladder step,
            # after the SLO decay so that the burn it reads is current.
            self.shed_controller.observe_queue_depth(len(self.queue),
                                                     self.serving.queue_capacity)
            self.shed_controller.maybe_evaluate()
        progressed = self._iterate(stats)
        self._feed(stats)
        self._heartbeat.poke(occupancy=self.pool.occupancy, queue_depth=len(self.queue),
                             completed=stats.completed, decoded_tokens=stats.decoded_tokens)
        return progressed

    def finish_stats(self, stats: ServingStats) -> None:
        """Attribute the queue rejections no earlier drain reported,
        including ``submit()`` refusals made between drains."""
        stats.rejected = self.queue.rejected - self._rejected_taken
        self._rejected_taken = self.queue.rejected
        stats.shed += self._shed_untaken
        self._shed_untaken = 0
        stats.publish(labels=self.labels)
        # The live high-water mark is per drain: reset it to the drained
        # depth (the record keeps its own maximum).
        get_registry().gauge("queue_depth_hwm", component="serving",
                             **self.labels).set(len(self.queue))
        # The idle stretch before the next drain's first chunk is no step gap.
        get_timeline().clear_track_cursor(self.track)

    def _run_loop(self, stats: ServingStats) -> None:
        self.last_seconds = {"prefill": 0.0, "decode": 0.0}
        self._feed(stats)
        while self.has_work:
            drained = self._drain_requested()
            if not self.step(stats) and not drained:
                # Nothing moved (rate-limited admission with an empty pool,
                # or an open breaker refusing a stage while work waits):
                # yield instead of spinning. A drain just preempted
                # everything, so the loop ends without sleeping.
                time.sleep(0.002)
        self.finish_stats(stats)

    def _apply_degradation(self) -> None:
        """Make the knobs match the ladder's rung, polled once per loop
        iteration: rung 1 sheds the engine's speculation (the tokens are
        the same either way), rung 2 halves the decode chunk, drops the
        fuse and soft-caps concurrent slots at half the pool. Everything
        comes back as the ladder retreats. Rung 3 (the static engine) is
        ``ServingBackend``'s."""
        if self.breakers is None:
            return
        lvl = self.breakers.ladder.level
        if lvl == self._applied_level:
            return
        # The shed state lives on the ENGINE (idempotent methods), driven by
        # the current level: several schedulers can share one engine.
        if lvl >= 1:
            self.engine.shed_speculation()
        else:
            self.engine.restore_speculation()
        if lvl >= 2:
            self.decode_chunk = max(1, self._base_decode_chunk // 2)
            self.live_cap = max(1, self.num_slots // 2)
            self.fuse_steps = 1
        else:
            self.decode_chunk = self._base_decode_chunk
            self.live_cap = self.num_slots
            self.fuse_steps = self._base_fuse_steps
        self._build_step()
        logger.warning("degradation rung %d (%s) applied: speculation=%s decode_chunk=%d "
                       "fuse_steps=%d live_cap=%d", lvl, self.breakers.ladder.rung,
                       "shed" if self.engine._spec_shed else "kept", self.decode_chunk,
                       self.fuse_steps, self.live_cap)
        self._applied_level = lvl

    def _execute_drain(self, stats: ServingStats) -> None:
        """Stop admission, give live slots ``drain_grace_s`` to finish, and
        preempt everything else. Queued and pending requests never got a
        slot, so they preempt at once."""
        n_queued, n_pending, n_live = len(self.queue), len(self._pending), self.pool.occupancy
        # The signal handler only sets flags; this is the safe context that
        # records which signals asked for the drain.
        take_signal_telemetry()
        logger.warning("draining: admission stopped (%d queued, %d pending, %d live)",
                       n_queued, n_pending, n_live)
        emit_event("drain_started", queued=n_queued, pending=n_pending, live=n_live,
                   **self.labels)
        get_registry().counter("drains_total", component="serving", **self.labels).inc()
        self.queue.close()
        completed_before = stats.completed
        try:
            for req in self._pending:
                self._preempt(req, stats)
            self._pending.clear()
            for req in self.queue.pop(len(self.queue)):
                self._preempt(req, stats)
            grace = (self._drain_grace_override if self._drain_grace_override is not None
                     else self.resilience.drain_grace_s)
            t0 = time.monotonic()
            while self.pool.occupancy and time.monotonic() - t0 < grace:
                if not self._decode(stats):  # a breaker may refuse the stage
                    time.sleep(0.002)
            for slot in self.pool.live_slots():
                self._preempt(self.pool.release(slot).request, stats)
            # A fault during the grace loop requeues its victims (requeue
            # bypasses the closed queue), so sweep the queue again.
            for req in self.queue.pop(len(self.queue)):
                self._preempt(req, stats)
        finally:
            self.queue.reopen()
            # One programmatic drain per request_drain(); the process-wide
            # signal flag stays set (that process is on its way out).
            self._drain_flag = False
            self._drain_grace_override = None
        emit_event("drain_complete", preempted=stats.preempted,
                   completed_during_drain=stats.completed - completed_before, **self.labels)

    def _feed(self, stats: ServingStats) -> None:
        # Top-up from serve()'s overflow: a refusal here retries an accepted
        # request, so it is not a rejection.
        if self.shed_controller is None:
            while self._pending and not self.queue.full:
                if not self.queue.submit(self._pending[0], count_rejection=False):
                    break  # rate-limited; retry next iteration
                self._pending.popleft()
            return
        # QoS mode: the overload gate runs here for serve()'s intake, and a
        # full or quota-bound class must not block the other classes behind
        # it. One pass over the overflow, refused requests kept in order, a
        # class skipped after its first refusal (the pass stops once every
        # class is blocked).
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
            if self._overload_gate(req, stats=stats):
                continue  # shed, its Result recorded
            if not self.queue.submit(req, count_rejection=False):
                blocked.add(req.qos)
                kept.append(req)
        self._pending = kept

    def _iterate(self, stats: ServingStats) -> bool:
        stats.loop_iterations += 1
        depth = len(self.queue)
        stats.queue_depth_sum += depth
        stats.queue_depth_max = max(stats.queue_depth_max, depth)
        get_registry().gauge("queue_depth_hwm", component="serving",
                             **self.labels).set_max(depth)
        now = time.monotonic()
        progressed = False
        for req in self.queue.drain_expired(now):
            self._fail(req, "deadline", "deadline expired in queue", stats)
            progressed = True
        for slot in self.pool.live_slots():
            if self.pool.get(slot).request.expired(now):
                self._finish(slot, "deadline", stats)
                progressed = True
        progressed |= self._admit(stats)
        progressed |= self._decode(stats)
        return progressed

    # -- terminal outcomes ---------------------------------------------------

    def _note_fairness(self, request: Request, outcome: str, row, text: str = "") -> None:
        """A terminal outcome into the fairness monitor's neutrality audit
        and pair watch; a dict miss for untagged traffic."""
        get_fairness_monitor().observe_request(
            request, outcome, queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s, text=text,
            replica=self.replica, rung=(self.breakers.ladder.level if self.breakers is not None else 0))

    def _fail(self, request: Request, reason: str, error: str, stats: ServingStats,
              tokens: Optional[List[int]] = None) -> None:
        tok = self.engine.tokenizer
        ids = list(tokens or [])
        text = tok.decode([t for t in ids if t != tok.eos_id])
        outcome = "expired" if reason == "deadline" else "failed"
        row = self.tracer.finalize(request.id, outcome, tokens=len(ids))
        self._note_fairness(request, outcome, row, text=text)
        self._results[request.id] = Result(
            id=request.id, ok=False, text=text,
            tokens=np.asarray(ids, np.int32), finish_reason=reason, error=error,
            retries=request.retries, latency_s=time.monotonic() - request.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s)
        if self.journal is not None:
            self.journal.record_terminal(request.id, outcome)
        if reason == "deadline":
            stats.expired += 1
        else:
            stats.failed += 1

    def _shed(self, request: Request, reason: str, error: str, retry_after: float,
              stats: Optional[ServingStats] = None, journaled: bool = True) -> None:
        """An overload refusal: a ``finish_reason="shed"`` Result with a
        retry-after hint, never a silent loss. ``journaled`` says whether
        intake already ledgered the request (``serve``'s path); a
        ``submit``-time shed was never accepted and closes nothing."""
        if not self.tracer.events(request.id):
            # A submit-time shed's span still starts at "submitted".
            self.tracer.record(request.id, "submitted", t=request.submitted_at)
        row = self.tracer.finalize(request.id, "shed", tokens=0)
        self._note_fairness(request, "shed", row)
        self._results[request.id] = Result(
            id=request.id, ok=False, finish_reason="shed", error=error, retries=request.retries,
            latency_s=time.monotonic() - request.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s, retry_after_s=retry_after)
        count_shed(request.qos, reason, labels=self.labels)
        # The refusal with its inputs: the rung that shed it, or the
        # estimate that doomed it.
        record_decision("shed", reason,
                        signals={"qos": request.qos, "retry_after_s": retry_after,
                                 "level": (self.shed_controller.level
                                           if self.shed_controller is not None else 0)},
                        request_id=request.id, replica=self.replica)
        if journaled and self.journal is not None:
            self.journal.record_terminal(request.id, "shed")
        if stats is not None:
            stats.shed += 1
        else:
            self._shed_untaken += 1

    def _overload_gate(self, request: Request, stats: Optional[ServingStats] = None,
                       journaled: bool = True) -> bool:
        """True when overload control shed ``request`` (its Result is
        recorded). Two gates in order: the ladder's class admission, then
        deadline feasibility."""
        ctl = self.shed_controller
        if ctl is None:
            return False
        if request.qos == "interactive":
            # Arms the burn signal: a latency-sensitive tenant is here.
            ctl.note_interactive()
        if not ctl.admits(request.qos):
            self._shed(request, "overload",
                       f"overload level {ctl.level} ({ctl.rung}) sheds {request.qos}-class "
                       f"admissions; retry after {ctl.retry_after()}s",
                       ctl.retry_after(), stats=stats, journaled=journaled)
            return True
        if self.deadline_estimator is not None and request.deadline_s is not None:
            # Queued ahead = the depth of the same and higher classes: lower
            # classes may age past the request now and then, but never
            # delay it systematically.
            ahead = sum(d for c, d in self.queue.class_depths().items()
                        if QOS_PRIORITY[c] <= QOS_PRIORITY[request.qos])
            # Slots turn over at the fused call's end, so a wave is
            # decode_chunk x fuse_steps steps wide.
            est = self.deadline_estimator.infeasible(request, ahead, self.num_slots,
                                                     self.decode_chunk * self.fuse_steps)
            if est is not None:
                self._shed(request, "deadline_infeasible",
                           "deadline provably unmeetable at admission (estimated earliest "
                           f"first token {est:.3f}s); not prefilling a doomed request",
                           ctl.retry_after(est), stats=stats, journaled=journaled)
                return True
        return False

    def _preempt(self, request: Request, stats: ServingStats) -> None:
        """A drain's outcome for a request this process will not finish: a
        ``preempted`` Result and NO terminal journal record (the open record
        is what ``resume-serving`` reads)."""
        row = self.tracer.finalize(request.id, "preempted", tokens=0)
        hint = (f"resume with: resume-serving {self.journal.journal_dir}"
                if self.journal is not None
                else "no serving journal configured; request is lost at exit")
        self._results[request.id] = Result(
            id=request.id, ok=False, finish_reason="preempted",
            error=f"drained before completion ({hint})", retries=request.retries,
            latency_s=time.monotonic() - request.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s)
        stats.preempted += 1

    def _note_fault(self, stage: str, kind: str, request_ids: List[str], error) -> None:
        """One contained fault into the incident engine: a ``fault``
        decision naming the riders, and for the kinds with direct evidence
        of a distinct failure (a hang, a non-finite chunk) an incident
        trigger. Plain device or injected faults trigger nothing here; a
        storm of them opens a breaker, whose transition is the trigger."""
        record_decision("fault", f"{stage}:{kind}",
                        signals={"request_ids": list(request_ids), "error": str(error)[:200]},
                        request_id=(request_ids[0] if request_ids else None),
                        replica=self.replica)
        first = request_ids[0] if request_ids else None
        if kind in ("hang", "numerics"):
            cls, what = (("watchdog_hang", "step over budget") if kind == "hang"
                         else ("numerics_fault", "chunk non-finite"))
            maybe_trigger(cls, f"{stage} {what}: {error}", scope=self.replica or "serving",
                          replica=self.replica, request_id=first, stage=stage,
                          request_ids=list(request_ids))

    def _contain(self, e: Exception, stage: str, reqs: List[Request], stats: ServingStats,
                 what: str) -> str:
        """The containment branch of a failed prefill or decode call whose
        slots the caller released: count the fault, note it (before the
        breaker feed, so that a trip's bundle already names the riders),
        feed the breaker, and requeue or fail each rider. A fatal device
        error is recorded and raised instead. Returns the fault's kind."""
        if is_fatal_device_error(e):
            note_fatal_device_error(e, "serving", stage, self.labels)
            raise e
        kind = _fault_kind(e)
        logger.warning("%s failed: %s", what, e)
        get_registry().counter("faults_total", component="serving", kind=kind, stage=stage,
                               **self.labels).inc()
        self._note_fault(stage, kind, [r.id for r in reqs], e)
        if self.breakers is not None:
            self.breakers.record_failure(stage)
        for req in reqs:
            self._requeue_or_fail(req, f"{stage} failed: {e}", stats, cause=kind)
        return kind

    def _requeue_or_fail(self, request: Request, error: str, stats: ServingStats,
                         cause: str = "device") -> None:
        if request.retries < 1:
            request.retries += 1
            stats.requeued += 1
            # Cause breakdown ("injected" = a scripted drill, "device" = a
            # raised call): the bare requeued total cannot tell them apart.
            get_registry().counter("serving_requeues_by_cause_total", component="serving",
                                   cause=cause, **self.labels).inc()
            self.tracer.record(request.id, "requeued")
            # The requeue and its cause, for the pair watch's attribution.
            # tagged= covers a tagged request whose pair registers only at
            # its terminal outcome, after this requeue.
            get_fairness_monitor().note_event(
                request.id, f"requeued:{cause}",
                tagged=request.group is not None or request.pair_id is not None)
            self.queue.requeue(request)
        else:
            self._fail(request, "failed", error, stats)

    def _injected_fault(self, stage: str, req: Request, e: DecodeFault,
                        stats: ServingStats) -> None:
        """A scripted fault, fed to the incident trail and the breaker like
        a real one; the caller released the request's slot, if it had one."""
        self._note_fault(stage, "injected", [req.id], e)
        if self.breakers is not None:
            self.breakers.record_failure(stage)
        self._requeue_or_fail(req, str(e), stats, cause="injected")

    def _finish(self, slot: int, reason: str, stats: ServingStats) -> None:
        state = self.pool.release(slot)
        req = state.request
        tok = self.engine.tokenizer
        ids = []
        for t in state.tokens:
            ids.append(int(t))
            if t == tok.eos_id:
                break
        if reason == "deadline":
            self._fail(req, "deadline", "deadline expired mid-decode", stats, tokens=ids)
            return
        text = tok.decode(ids[:-1] if ids and ids[-1] == tok.eos_id else ids)
        row = self.tracer.finalize(req.id, "completed", tokens=len(ids))
        self._note_fairness(req, "completed", row, text=text)
        self._results[req.id] = Result(
            id=req.id, ok=True, text=text, tokens=np.asarray(ids, np.int32),
            finish_reason=reason, prompt_tokens=state.real_len, retries=req.retries,
            latency_s=time.monotonic() - req.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s)
        if self.journal is not None:
            self.journal.record_terminal(req.id, "completed")
        stats.completed += 1

    def _cap_for(self, request: Request) -> int:
        m = (request.settings or self.settings).max_tokens
        cap = max(1, min(m, self.serving.max_new_tokens))
        if self.shed_controller is not None:
            # Rung 2 and above clamp batch budgets. Greedy output stays a
            # prefix of the uncapped stream; a row already past a freshly
            # shrunk cap finishes "length" at its next eviction sweep.
            cap = self.shed_controller.batch_cap(cap, request.qos)
        return cap

    # -- admission -----------------------------------------------------------

    def _admit(self, stats: ServingStats) -> bool:
        """Backfill free slots from the queue until one side runs dry
        (``prefill_group`` bounds one prefill, not the iteration)."""
        any_admitted = False
        while self._admit_once(stats):
            any_admitted = True
        return any_admitted

    def _admit_once(self, stats: ServingStats) -> bool:
        if self.breakers is not None and not self.breakers.allow("prefill"):
            return False
        free = self.pool.free_count
        if self.live_cap < self.num_slots:
            # Degradation rung 2: admission stops filling the pool past the cap.
            free = min(free, max(0, self.live_cap - self.pool.occupancy))
        n = min(free, self.serving.prefill_group, len(self.queue))
        if n <= 0:
            return False
        tok = self.engine.tokenizer
        now = time.monotonic()
        inj = self.fault_injector
        injected_hang = 0.0
        admitted = []  # (request, ids, bucket)
        for req in self.queue.pop(n):
            if req.expired(now):
                # Most often expired while waiting to be requeued: it ends
                # here, never spending a second prefill.
                self._fail(req, "deadline", "deadline expired before prefill", stats)
                continue
            if self.deadline_estimator is not None and req.deadline_s is not None:
                # Pop-time recheck, the queue wait spent (ahead = 0): a
                # deadline that cannot cover one prefill and one decode step
                # sheds here instead of prefilling and expiring mid-decode.
                est = self.deadline_estimator.infeasible(
                    req, 0, self.num_slots, self.decode_chunk * self.fuse_steps, now=now)
                if est is not None:
                    self._shed(req, "deadline_infeasible",
                               "deadline provably unmeetable at prefill time (estimated "
                               f"earliest first token {est:.3f}s)",
                               self.shed_controller.retry_after(est), stats=stats)
                    continue
            if inj is not None:
                try:
                    inj.maybe_fail(req.id, "prefill")
                except DecodeFault as e:
                    self._injected_fault("prefill", req, e, stats)
                    continue
                injected_hang += inj.maybe_hang(req.id, "prefill")
            ids = tok.encode(req.prompt)
            if len(ids) > self.prompt_budget:
                logger.warning(
                    "request %s: prompt (%d tokens) exceeds the serving budget (%d); "
                    "left-truncating: output will differ from the static engine's for "
                    "this request", req.id, len(ids), self.prompt_budget)
                ids = ids[-self.prompt_budget:]
            P = min(_bucket_len(max(len(ids), 1), self.engine.seq_bucket),
                    self.max_prompt_bucket)
            admitted.append((req, ids, P))
        if not admitted:
            return False
        if self.paged:
            return self._admit_paged(admitted, stats, injected_hang)

        # One prefill per admission batch, at the batch's largest bucket:
        # shorter rows pad up to it (pad keys are masked), and each row's
        # decode writes continue from that bucket (``base``).
        P = max(b for _, _, b in admitted)
        rows = [ids for _, ids, _ in admitted]
        slots = []
        for req, ids, _ in admitted:
            slot = self.pool.alloc(SlotState(request=req, base=P, real_len=min(len(ids), P)))
            assert slot is not None  # admission is bounded by the free count
            slots.append(slot)
            self.tracer.record(req.id, "admitted")
        n = len(admitted)
        nb = _bucket_pow2(n, max(self.serving.prefill_group, n))
        tb = _left_pad(rows, tok.pad_id, max_len=P)
        tokens = np.full((nb, P), tok.pad_id, np.int64)
        valid = np.zeros((nb, P), bool)
        tokens[:n] = tb.tokens
        valid[:n] = tb.valid
        # Batch-bucket pad rows: one valid token so that attention has
        # something to normalise over; they are never written to the pool.
        valid[n:, -1] = True
        dev = self.engine.device
        reqs = [r for r, _, _ in admitted]
        pf_t0 = time.monotonic()
        for req in reqs:
            self.tracer.record(req.id, "prefill_start", t=pf_t0)
        prefill = build_serve_prefill(self.engine.config, self.engine.model, nb=nb, P=P)
        pkey = ("serve_prefill", nb, P, self._guard())
        prog, fresh = self._program_for(pkey, program_label("serve_prefill", tp=self.tp), nb, P,
                                        "call")
        tok_dev, valid_dev = torch.from_numpy(tokens).to(dev), torch.from_numpy(valid).to(dev)
        try:
            self._prefill_call(("serve_prefill", nb, P), injected_hang, lambda: prefill(
                self._cache, self._prev_logits, tok_dev, valid_dev, slots,
                guard=self._guard()), prog, (self._cache, self._prev_logits, tok_dev, valid_dev))
        except Exception as e:  # noqa: BLE001 — containment is the point
            # The written rows belong to these slots only; released, they
            # are invalidated before any reuse.
            for slot in slots:
                self.pool.release(slot)
            self._contain(e, "prefill", reqs, stats, f"prefill batch ({nb}, {P})")
            return True
        self._note_prefill(stats, pf_t0, f"prefill[{nb}x{P}]", n, int(tb.lengths.sum()),
                           prog, pkey, fresh)
        return True

    def _prefill_call(self, key: tuple, injected_hang: float, call, prog: InstrumentedProgram,
                      memory_args) -> None:
        """One prefill under the watchdog, its guard and its breaker:
        ``call()`` runs the prefill (as ``prog``, whose capture counts
        ``memory_args`` as its arguments) and returns its finite flag (None
        unguarded); it is read after the sync, then the step is classified
        (its first use of ``key`` exempt). Raises into the caller's
        containment; records the breaker's success."""
        loads = _build.load_events
        if self.watchdog is not None:
            self.watchdog.arm("prefill")
        finite = prog.run(call, memory_args=memory_args)
        self.engine._sync()
        if finite is not None:
            check_finite(finite, "serving", "prefill")
        if self.watchdog is not None:
            self.watchdog.observe("prefill", extra_s=injected_hang,
                                  classify=not first_use(key, loads))
        if self.breakers is not None:
            self.breakers.record_success("prefill")

    def _note_prefill(self, stats: ServingStats, t0: float, span: str, rows: int,
                      tokens: int, prog: InstrumentedProgram, key: tuple, fresh: bool,
                      **args) -> None:
        """A finished prefill batch: its wall in ``last_seconds``, the
        ``prefill_wall_s`` histogram and a span on the timeline, its
        program's compile and gap accounting, and the drain's counters."""
        wall = time.monotonic() - t0
        self.last_seconds["prefill"] += wall
        get_registry().histogram("prefill_wall_s", component="serving",
                                 **self.labels).observe(wall)
        tl = get_timeline()
        tl.record_span(span, "prefill", self.track, t0, wall, rows=rows, **args)
        tl.note_busy(self.track, t0, wall)
        self._note_program(prog, key, fresh, t0, wall)
        stats.prefill_batches += 1
        stats.prefill_tokens += tokens
        stats.admitted += rows

    def _admit_paged(self, admitted, stats: ServingStats, injected_hang: float) -> bool:
        """Paged admission: radix-match each popped row, claim its blocks
        (a private tail and refs on the shared prefix chain), and prefill
        only the unmatched suffixes, grouped by suffix bucket, so that every
        row's bucketed write window fits its slot's extent.

        Two rules put rows back at the head of the queue (in order) instead
        of admitting them this iteration:

        - intra-batch sharing: a row that shares a full block with a row
          planned in this iteration waits one iteration, so it matches the
          committed blocks instead of prefilling them again (that is how a
          counterfactual pair that arrives together still shares its
          prefix);
        - block exhaustion: when the arena, after evicting unreferenced
          cache, cannot hold a row's private tail, the row and every row
          behind it wait for decode to free blocks, as for a full pool.
        """
        paged = self.pool.paged
        bs = paged.block_size
        planned = []  # (req, ids, slot, plan, real_s)
        deferred: List[Request] = []
        pending_chunks: set = set()
        exhausted = False
        for req, ids, _ in admitted:
            if exhausted:
                deferred.append(req)
                continue
            chunks = {tuple(ids[k * bs:(k + 1) * bs]) for k in range(len(ids) // bs)}
            if chunks & pending_chunks:
                deferred.append(req)
                continue
            slot = self.pool.alloc(SlotState(request=req, base=len(ids), real_len=len(ids)))
            assert slot is not None  # admission is bounded by the free count
            plan = paged.admit(slot, ids)
            if plan is None:
                self.pool.release(slot)
                deferred.append(req)
                exhausted = True
                continue
            pending_chunks |= chunks
            planned.append((req, ids, slot, plan, len(ids) - plan.matched))
            self.tracer.record(req.id, "admitted")
        for req in reversed(deferred):
            self.queue.requeue(req)
        self._note_block_pressure(exhausted, deferred)
        if not planned:
            return False
        groups: Dict[int, list] = {}
        for row in planned:
            S = _bucket_len(row[4], self.engine.seq_bucket)
            if row[3].matched + S > self.cache_len:
                raise RuntimeError(f"suffix write window overflows the slot extent "
                                     f"(matched {row[3].matched} + bucket {S} > "
                                     f"{self.cache_len})")
            groups.setdefault(S, []).append(row)
        for S in sorted(groups):
            self._paged_prefill_group(groups[S], S, stats, injected_hang)
        return True

    def _paged_prefill_group(self, rows, S: int, stats: ServingStats,
                             injected_hang: float) -> None:
        """One suffix prefill for the rows of suffix bucket ``S``, with the
        non-paged prefill's watchdog, guard, breaker and containment. A
        fault releases exactly this group's slots and blocks (nothing was
        committed to the radix index, and a prefill writes no shared block)
        and requeues each rider once."""
        paged = self.pool.paged
        tok = self.engine.tokenizer
        cfg = self.engine.config
        N = paged.num_blocks
        n = len(rows)
        nb = _bucket_pow2(n, max(self.serving.prefill_group, n))
        tokens = np.full((nb, S), tok.pad_id, np.int64)
        valid = np.zeros((nb, S), bool)
        positions = np.zeros((nb, S), np.int64)
        tables = np.zeros((nb, paged.blocks_per_slot), np.int64)
        wtables = np.full((nb, paged.blocks_per_slot), N, np.int64)
        cow_src = np.full((nb,), N, np.int64)
        cow_dst = np.full((nb,), N, np.int64)
        matched = np.zeros((nb,), np.int64)
        last_idx = np.zeros((nb,), np.int64)
        for i, (req, ids, slot, plan, real_s) in enumerate(rows):
            tokens[i, :real_s] = ids[plan.matched:]
            valid[i, :real_s] = True
            # Absolute positions (a prefix at 0.. is what makes it
            # shareable); the pad tail clamps inside the position tables.
            positions[i] = np.minimum(plan.matched + np.arange(S), cfg.max_seq_len - 1)
            tables[i] = plan.table
            wtables[i] = plan.write_table
            cow_src[i], cow_dst[i] = plan.cow_src, plan.cow_dst
            matched[i] = plan.matched
            last_idx[i] = real_s - 1
        # Batch-bucket pad rows: one valid token so that attention has
        # something to normalise over; their write tables are all sink.
        valid[n:, 0] = True
        check_write_offsets(matched, S, self.cache_len)
        dev = self.engine.device

        def put(x):
            return torch.from_numpy(x).to(dev)

        self._tables[:nb].copy_(put(tables))
        self._wtables[:nb].copy_(put(wtables))
        pf_t0 = time.monotonic()
        for req, *_ in rows:
            self.tracer.record(req.id, "prefill_start", t=pf_t0)
        pkey = ("paged_prefill", nb, S, self._guard())
        prog, fresh = self._program_for(pkey, program_label("paged_prefill", tp=self.tp), nb, S,
                                        "call")
        args = (self._arena, self._view, self._prev_logits, put(tokens), put(valid),
                put(positions), self._tables[:nb], self._wtables[:nb], put(cow_src),
                put(cow_dst), put(matched), put(last_idx))
        try:
            self._prefill_call(("paged_prefill", nb, S), injected_hang, lambda: self._paged_prefill(
                *args, [r[2] for r in rows], guard=self._guard()), prog, args)
        except Exception as e:  # noqa: BLE001 — containment is the point
            for _, _, slot, _, _ in rows:
                self.pool.release(slot)
            self._contain(e, "prefill", [r[0] for r in rows], stats,
                          f"paged prefill group ({nb}, {S})")
            return
        reg = get_registry()
        for req, ids, slot, plan, real_s in rows:
            # Commit after the device call: the written full prompt blocks
            # become matchable for the rows deferred above.
            paged.commit(slot, ids)
            reg.histogram("matched_prefix_len", component="paged_kv",
                          **self.labels).observe(plan.matched)
        # Suffix tokens only: the hit and miss counters hold the reuse.
        self._note_prefill(stats, pf_t0, f"prefill[{nb}x{S}]", n, sum(r[4] for r in rows),
                           prog, pkey, fresh, matched_prefix_tokens=int(matched.sum()))

    # -- decode --------------------------------------------------------------

    def _decode(self, stats: ServingStats) -> bool:
        """One decode chunk over the live slots, then eviction. True when
        anything decoded (or a fault was contained)."""
        if self.breakers is not None and not self.breakers.allow("decode"):
            return False
        injected_hang = 0.0
        inj = self.fault_injector
        if inj is not None:
            for slot in self.pool.live_slots():
                req = self.pool.get(slot).request
                try:
                    inj.maybe_fail(req.id, "decode")
                except DecodeFault as e:
                    self.pool.release(slot)
                    self._injected_fault("decode", req, e, stats)
            for slot in self.pool.live_slots():
                injected_hang += inj.maybe_hang(self.pool.get(slot).request.id, "decode")
            for slot in self.pool.live_slots():
                mode = inj.maybe_corrupt(self.pool.get(slot).request.id, "decode")
                if mode is not None:
                    # Scripted silent corruption: poison the slot's carried
                    # logits (what it samples from). With the guard on the
                    # chunk faults as a NumericsFault; without it this is
                    # the garbage decode the guard exists to catch.
                    self._prev_logits[slot] = float("nan") if mode == "nan" else float("inf")
        live_ids = self.pool.live_slots()
        if not live_ids:
            return False
        B = self.num_slots
        live = np.zeros((B,), bool)
        emitted = np.zeros((B,), np.int64)
        base = np.zeros((B,), np.int64)
        caps = np.ones((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        for slot in live_ids:
            st = self.pool.get(slot)
            live[slot] = True
            emitted[slot] = st.emitted
            base[slot] = st.base
            caps[slot] = self._cap_for(st.request)
            seed = st.request.row_seed
            seeds[slot] = (0 if seed is None else seed) & 0xFFFFFFFF
        if self.paged:
            paged = self.pool.paged
            tables = np.zeros((B, paged.blocks_per_slot), np.int64)
            wtables = np.full((B, paged.blocks_per_slot), paged.num_blocks, np.int64)
            for slot in live_ids:
                tables[slot] = paged.table_for(slot)
                wtables[slot] = paged.write_table_for(slot)
            self._tables[:B].copy_(torch.from_numpy(tables))
            self._wtables[:B].copy_(torch.from_numpy(wtables))

            def call():
                return self._step(self._arena, self._view, self._prev_logits,
                                  self._tables[:B], self._wtables[:B], seeds, emitted, base,
                                  caps, live)

            device_args = (self._arena, self._view, self._prev_logits, self._tables[:B],
                           self._wtables[:B])
        else:
            # Released slots are invalidated at the step's entry; a slot
            # released and reused since never enters the mask (its prefill
            # re-initialized the row).
            reset = np.zeros((B,), bool)
            reset[self.pool.take_invalidations()] = True

            def call():
                return self._step(self._cache, self._prev_logits, seeds, emitted, base, caps,
                                  live, reset)

            device_args = (self._cache, self._prev_logits)
        key = (self._program, self.decode_chunk, self.fuse_steps)
        pkey = key + (self._guard(),)
        prog, fresh = self._program_for(pkey, self._program, self.num_slots, 1, "step")
        loads = _build.load_events
        raised = True  # until the device call returns
        dc_t0 = time.monotonic()
        if self.watchdog is not None:
            self.watchdog.arm("decode")
        try:
            # The step's region in a torch.profiler capture (--trace-dir):
            # its device busy share is read over these spans.
            with record_function(self._program):
                out = prog.run(call, memory_args=device_args)
                self.engine._sync()
            raised = False
            if self._guard():
                # The loop's flag, AND-ed over the chunk's steps on the
                # device and read with its tokens: a tripped flag discards
                # the whole chunk, and every rider requeues for a fresh
                # prefill.
                check_finite(out.finite, "serving", "decode")
            if self.watchdog is not None:
                # After the host has the tokens: a chunk past the budget is
                # discarded like a failed one (the fuse scales the budget).
                self.watchdog.observe("decode", extra_s=injected_hang,
                                      classify=not first_use(key, loads),
                                      budget_scale=self.fuse_steps)
        except Exception as e:  # noqa: BLE001 — containment is the point
            reqs = [self.pool.release(slot).request for slot in live_ids]
            self._contain(e, "decode", reqs, stats, "decode chunk")
            if self.paged and raised:
                # The call itself raised, so the arena may be half written:
                # drop its contents and every cached prefix (a node over a
                # zeroed block would serve a blank prefix).
                self._reset_paged()
            return True
        if self.breakers is not None:
            self.breakers.record_success("decode")
        now = time.monotonic()
        dc_wall = now - dc_t0
        self.last_seconds["decode"] += dc_wall
        self._prev_logits = out.logits
        stats.decode_steps += out.steps
        stats.occupancy_sum += out.row_steps
        # The chunk's span (the gap since the previous chunk feeds the
        # step_gap_s histogram), the flight recorder's chunk ring, and the
        # pool-pressure gauges weighted by the steps the chunk ran.
        gap = get_timeline().decode_chunk(self.track, dc_t0, dc_wall, out.steps,
                                          labels=self.labels, rows=len(live_ids),
                                          program=self._program)
        get_flight_recorder().record(
            "chunks", program=self._program, steps=out.steps, wall_s=round(dc_wall, 6),
            gap_s=(round(gap, 6) if gap is not None else None), rows=len(live_ids),
            replica=self.replica, t=dc_t0)
        # The roofline streams the whole pool's KV a step (the step reads
        # every slot, live or not), so its batch is num_slots; the paged
        # view's gather and scatter are amortized over the steps run.
        roof = {"batch": self.num_slots, "cache_slots": self.cache_len, "prefix_len": 0}
        if self.paged:
            roof.update(paged_kv=True, chunk_steps=out.steps)
        observe_decode(self.engine.config, roof, out.steps, dc_wall, program=self._program,
                       labels=self.labels)
        self._note_program(prog, pkey, fresh, dc_t0, dc_wall, steps=out.steps,
                           reason=("decode_chunk" if self.decode_chunk != self._base_decode_chunk
                                   else "shape"))
        self.tracer.sample_step_gauges(occupancy=len(live_ids), queue_depth=len(self.queue),
                                       decode_steps=out.steps)
        eos_id = self.engine.tokenizer.eos_id
        for slot in live_ids:
            st = self.pool.get(slot)
            n = int(out.emitted[slot]) - st.emitted
            new = [int(t) for t in out.toks[slot, :n]]
            if st.emitted == 0 and n > 0:
                # The first host-visible time of the row's first token: the
                # end of the chunk that made it.
                self.tracer.record(st.request.id, "first_token", t=now)
            st.tokens.extend(new)
            st.emitted += n
            stats.decoded_tokens += n
            if eos_id in new:
                self._finish(slot, "eos", stats)
            elif st.emitted >= self._cap_for(st.request):
                self._finish(slot, "length", stats)
            elif st.request.expired(now):
                self._finish(slot, "deadline", stats)
        return True

    def _reset_paged(self) -> None:
        """Zero the arena and the carried logits and make the index forget
        every cached prefix; every slot is free by then."""
        self._arena.zero_()
        self._prev_logits.zero_()
        self.pool.paged.reset()
        self._account_device_state()
