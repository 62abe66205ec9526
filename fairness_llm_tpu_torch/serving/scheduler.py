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

Not ported here, each a later part of ROADMAP A5: fault injection and
containment, breakers, the watchdog, drain and the journal, overload
control and shedding, numerics guards and tensor-parallel meshes. A failed
kernel raises out of ``serve``; a paged decode chunk that fails first drops
the arena's contents, its cached prefixes and its live slots (the arena may
be half written), so the scheduler stays usable.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from fairness_llm_tpu_torch.config import ModelSettings, ServingConfig
from fairness_llm_tpu_torch.models.tokenizer import _left_pad
from fairness_llm_tpu_torch.models.transformer import check_write_offsets, init_cache
from fairness_llm_tpu_torch.runtime.engine import _bucket_len
from fairness_llm_tpu_torch.runtime.sampling import SamplerSettings
from fairness_llm_tpu_torch.runtime.stepbuilder import (
    build_paged_prefill,
    build_serve_prefill,
    build_serve_step,
)
from fairness_llm_tpu_torch.serving.paged import PagedKV, init_arena
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue
from fairness_llm_tpu_torch.serving.request import Request, Result
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState
from fairness_llm_tpu_torch.telemetry import Heartbeat, RequestTracer, get_registry
from fairness_llm_tpu_torch.telemetry.flightrecorder import get_flight_recorder
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline
from fairness_llm_tpu_torch.utils.profiling import ServingStats
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter

logger = logging.getLogger(__name__)


def _bucket_pow2(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class ContinuousScheduler:
    """Serves one ``DecodeEngine``'s model from a fixed slot pool.

    One scheduler samples one way (``settings`` temperature, top_k, top_p)
    under one decode-length cap; ``ServingBackend`` keeps one per settings
    tuple. Direct use:

        sched = ContinuousScheduler(engine, ServingConfig(num_slots=8))
        results = sched.serve([Request(prompt=p) for p in prompts])

    ``last_seconds`` holds the last drain's host-clock seconds of prefill
    and of decode (each ends in a sync with the device).
    """

    def __init__(self, engine, serving: Optional[ServingConfig] = None,
                 settings: Optional[ModelSettings] = None):
        self.engine = engine
        self.serving = serving or ServingConfig(enabled=True)
        # Instrument labels and timeline track of a single-replica scheduler
        # (the reference's fleet replicas add {"replica": name}).
        self.labels: Dict[str, str] = {}
        self.track = "serving"
        self.settings = settings or ModelSettings()
        self.sampler = SamplerSettings(temperature=self.settings.temperature,
                                       top_k=self.settings.top_k, top_p=self.settings.top_p)
        cfg = engine.config
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
                self.num_slots, blocks_per_slot, bs, num_blocks=self.serving.kv_blocks))
        else:
            self.cache_len = self.max_prompt_bucket + cap
            self.pool = SlotPool(self.num_slots)
        rate_limiter = (RateLimiter(self.serving.admission_per_minute)
                        if self.serving.admission_per_minute else None)
        self.queue = AdmissionQueue(capacity=self.serving.queue_capacity,
                                    rate_limiter=rate_limiter)
        # Persistent device state: the pool's KV cache (private rows, or the
        # paged block arena with its view and table buffers) and each slot's
        # carried next-token logits (f32, what the sampler reads).
        if self.paged:
            paged = self.pool.paged
            self._cache = None
            self._arena = init_arena(cfg, paged.num_blocks, paged.block_size, self.num_slots,
                                     device=dev)
            # One view and one pair of table buffers serve the decode step
            # (num_slots rows) and every prefill group (at most the largest
            # batch bucket's rows), each filled in place.
            group = self.serving.prefill_group
            rows = max(self.num_slots,
                       _bucket_pow2(min(self.num_slots, group), max(group, 1)))
            self._view = init_cache(cfg, rows, self.cache_len, device=dev)
            self._tables = torch.zeros((rows, paged.blocks_per_slot), dtype=torch.long,
                                       device=dev)
            self._wtables = torch.full_like(self._tables, paged.num_blocks)
        else:
            self._cache = init_cache(cfg, self.num_slots, self.cache_len, device=dev)
            self._arena = None
        self._prev_logits = torch.zeros((self.num_slots, cfg.vocab_size), dtype=torch.float32,
                                        device=dev)
        # One decode program: decode_chunk x fuse_steps steps a call, or
        # fewer once every live row is done.
        tok = engine.tokenizer
        fuse = max(1, self.serving.fuse_steps)
        self._step = build_serve_step(
            engine.model, self.sampler, tok.pad_id, tok.eos_id, num_slots=self.num_slots,
            chunk=max(1, self.serving.decode_chunk), fuse=fuse, paged=self.paged)
        if self.paged:
            self._paged_prefill = build_paged_prefill(engine.model)
        # The decode program's telemetry name, as the reference labels it.
        self._program = ("paged_step" if self.paged else "serve_step") + \
            ("_fused" if fuse > 1 else "")
        # Request lifecycle spans and their histograms (and SLO burn rates),
        # and a liveness pulse: host-side timestamps only.
        self.tracer = RequestTracer(component="serving", labels=self.labels)
        self._heartbeat = Heartbeat(interval_s=30.0, name="serving")
        # serve()'s overflow beyond the queue's capacity
        self._pending: Deque[Request] = deque()
        self._results: Dict[str, Result] = {}
        # queue rejections already reported by an earlier drain
        self._rejected_taken = 0
        self.last_stats: Optional[ServingStats] = None
        self.last_seconds = {"prefill": 0.0, "decode": 0.0}

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

    def submit(self, request: Request) -> bool:
        """Queue one request; False = backpressure (queue full or rate
        quota). Its deadline and latency clock start here."""
        self._check_settings(request)
        request.submitted_at = time.monotonic()
        accepted = self.queue.submit(request)
        if accepted:
            self.tracer.record(request.id, "submitted", t=request.submitted_at)
        return accepted

    def take_result(self, request_id: str) -> Optional[Result]:
        """Claim (and remove) the Result of a request that ended in an
        earlier ``serve``/``drain``: the way back for ``submit()``-ed
        requests."""
        return self._results.pop(request_id, None)

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
        self._pending = deque(requests)
        self._run_loop(stats)
        self.last_stats = stats
        return [self._results.pop(r.id) for r in requests]

    # -- the loop ------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        """Anything still owed a Result: pending overflow, queued, or live."""
        return bool(self._pending or len(self.queue) or self.pool.occupancy)

    def step(self, stats: ServingStats) -> bool:
        """One admission and decode iteration; True when any work moved."""
        # SLO window decay: the burn gauges age out in quiet stretches.
        self.tracer.slo.maybe_evaluate()
        progressed = self._iterate(stats)
        self._feed()
        self._heartbeat.poke(occupancy=self.pool.occupancy, queue_depth=len(self.queue),
                             completed=stats.completed, decoded_tokens=stats.decoded_tokens)
        return progressed

    def finish_stats(self, stats: ServingStats) -> None:
        """Attribute the queue rejections no earlier drain reported,
        including ``submit()`` refusals made between drains."""
        stats.rejected = self.queue.rejected - self._rejected_taken
        self._rejected_taken = self.queue.rejected
        stats.publish(labels=self.labels)
        # The live high-water mark is per drain: reset it to the drained
        # depth (the record keeps its own maximum).
        get_registry().gauge("queue_depth_hwm", component="serving",
                             **self.labels).set(len(self.queue))
        # The idle stretch before the next drain's first chunk is no step gap.
        get_timeline().clear_track_cursor(self.track)

    def _run_loop(self, stats: ServingStats) -> None:
        self.last_seconds = {"prefill": 0.0, "decode": 0.0}
        self._feed()
        while self.has_work:
            if not self.step(stats):
                # Nothing moved (rate-limited admission with an empty pool):
                # yield instead of spinning.
                time.sleep(0.002)
        self.finish_stats(stats)

    def _feed(self) -> None:
        # Top-up from serve()'s overflow: a refusal here retries an accepted
        # request, so it is not a rejection.
        while self._pending and not self.queue.full:
            if not self.queue.submit(self._pending[0], count_rejection=False):
                break  # rate-limited; retry next iteration
            self._pending.popleft()

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

    def _fail(self, request: Request, reason: str, error: str, stats: ServingStats,
              tokens: Optional[List[int]] = None) -> None:
        tok = self.engine.tokenizer
        ids = list(tokens or [])
        row = self.tracer.finalize(request.id, "expired" if reason == "deadline" else "failed",
                                   tokens=len(ids))
        self._results[request.id] = Result(
            id=request.id, ok=False, text=tok.decode([t for t in ids if t != tok.eos_id]),
            tokens=np.asarray(ids, np.int32), finish_reason=reason, error=error,
            retries=request.retries, latency_s=time.monotonic() - request.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s)
        if reason == "deadline":
            stats.expired += 1
        else:
            stats.failed += 1

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
        self._results[req.id] = Result(
            id=req.id, ok=True, text=text, tokens=np.asarray(ids, np.int32),
            finish_reason=reason, prompt_tokens=state.real_len, retries=req.retries,
            latency_s=time.monotonic() - req.submitted_at,
            queue_wait_s=row.queue_wait_s, ttft_s=row.ttft_s)
        stats.completed += 1

    def _cap_for(self, request: Request) -> int:
        m = (request.settings or self.settings).max_tokens
        return max(1, min(m, self.serving.max_new_tokens))

    # -- admission -----------------------------------------------------------

    def _admit(self, stats: ServingStats) -> bool:
        """Backfill free slots from the queue until one side runs dry
        (``prefill_group`` bounds one prefill, not the iteration)."""
        any_admitted = False
        while self._admit_once(stats):
            any_admitted = True
        return any_admitted

    def _admit_once(self, stats: ServingStats) -> bool:
        n = min(self.pool.free_count, self.serving.prefill_group, len(self.queue))
        if n <= 0:
            return False
        tok = self.engine.tokenizer
        now = time.monotonic()
        admitted = []  # (request, ids, bucket)
        for req in self.queue.pop(n):
            if req.expired(now):
                self._fail(req, "deadline", "deadline expired before prefill", stats)
                continue
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
            return self._admit_paged(admitted, stats)

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
        pf_t0 = time.monotonic()
        for req, _, _ in admitted:
            self.tracer.record(req.id, "prefill_start", t=pf_t0)
        prefill = build_serve_prefill(self.engine.config, self.engine.model, nb=nb, P=P)
        prefill(self._cache, self._prev_logits, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(valid).to(dev), slots)
        self.engine._sync()
        self._note_prefill(stats, pf_t0, f"prefill[{nb}x{P}]", n, int(tb.lengths.sum()))
        return True

    def _note_prefill(self, stats: ServingStats, t0: float, span: str, rows: int,
                      tokens: int, **args) -> None:
        """A finished prefill batch: its wall in ``last_seconds``, the
        ``prefill_wall_s`` histogram and a span on the timeline, and the
        drain's counters."""
        wall = time.monotonic() - t0
        self.last_seconds["prefill"] += wall
        get_registry().histogram("prefill_wall_s", component="serving",
                                 **self.labels).observe(wall)
        tl = get_timeline()
        tl.record_span(span, "prefill", self.track, t0, wall, rows=rows, **args)
        tl.note_busy(self.track, t0, wall)
        stats.prefill_batches += 1
        stats.prefill_tokens += tokens
        stats.admitted += rows

    def _admit_paged(self, admitted, stats: ServingStats) -> bool:
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
            self._paged_prefill_group(groups[S], S, stats)
        return True

    def _paged_prefill_group(self, rows, S: int, stats: ServingStats) -> None:
        """One suffix prefill for the rows of suffix bucket ``S``. If it
        fails, the group's slots and blocks are released (nothing was
        committed to the radix index) and the error propagates."""
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
        try:
            self._paged_prefill(self._arena, self._view, self._prev_logits, put(tokens),
                                put(valid), put(positions), self._tables[:nb],
                                self._wtables[:nb], put(cow_src), put(cow_dst), put(matched),
                                put(last_idx), [r[2] for r in rows])
            self.engine._sync()
        except Exception:
            for _, _, slot, _, _ in rows:
                self.pool.release(slot)
            raise
        reg = get_registry()
        for req, ids, slot, plan, real_s in rows:
            # Commit after the device call: the written full prompt blocks
            # become matchable for the rows deferred above.
            paged.commit(slot, ids)
            reg.histogram("matched_prefix_len", component="paged_kv",
                          **self.labels).observe(plan.matched)
        # Suffix tokens only: the hit and miss counters hold the reuse.
        self._note_prefill(stats, pf_t0, f"prefill[{nb}x{S}]", n, sum(r[4] for r in rows),
                           matched_prefix_tokens=int(matched.sum()))

    # -- decode --------------------------------------------------------------

    def _decode(self, stats: ServingStats) -> bool:
        """One decode chunk over the live slots, then eviction. True when
        anything decoded."""
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
        dc_t0 = time.monotonic()
        if self.paged:
            paged = self.pool.paged
            tables = np.zeros((B, paged.blocks_per_slot), np.int64)
            wtables = np.full((B, paged.blocks_per_slot), paged.num_blocks, np.int64)
            for slot in live_ids:
                tables[slot] = paged.table_for(slot)
                wtables[slot] = paged.write_table_for(slot)
            self._tables[:B].copy_(torch.from_numpy(tables))
            self._wtables[:B].copy_(torch.from_numpy(wtables))
            try:
                out = self._step(self._arena, self._view, self._prev_logits, self._tables[:B],
                                 self._wtables[:B], seeds, emitted, base, caps, live)
                self.engine._sync()
            except Exception:
                self._reset_paged()
                raise
        else:
            # Released slots are invalidated at the step's entry; a slot
            # released and reused since never enters the mask (its prefill
            # re-initialized the row).
            reset = np.zeros((B,), bool)
            reset[self.pool.take_invalidations()] = True
            out = self._step(self._cache, self._prev_logits, seeds, emitted, base, caps, live,
                             reset)
            self.engine._sync()
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
            replica=None, t=dc_t0)
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
        """After a failed paged decode chunk the arena may be half written:
        release every live slot and zero the arena, and make the index
        forget every cached prefix (a node over a zeroed block would serve
        a blank prefix)."""
        for slot in self.pool.live_slots():
            self.pool.release(slot)
        self._arena.zero_()
        self._prev_logits.zero_()
        self.pool.paged.reset()
