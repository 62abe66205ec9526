"""Continuous-batching step loop over a slot pool (counterpart of the core
loop of ``fairness_llm_tpu/serving/scheduler.py``, non-paged).

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

Not ported here, each a later part of ROADMAP A5: fault injection and
containment, breakers, the watchdog, drain and the journal, overload
control and shedding, numerics guards, the paged KV cache, tensor-parallel
meshes, and the telemetry calls. A failed kernel raises out of ``serve``.
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
from fairness_llm_tpu_torch.models.transformer import init_cache
from fairness_llm_tpu_torch.runtime.engine import _bucket_len
from fairness_llm_tpu_torch.runtime.sampling import SamplerSettings
from fairness_llm_tpu_torch.runtime.stepbuilder import build_serve_prefill, build_serve_step
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue
from fairness_llm_tpu_torch.serving.request import Request, Result
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState
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
        self.cache_len = self.max_prompt_bucket + cap
        self.pool = SlotPool(self.num_slots)
        rate_limiter = (RateLimiter(self.serving.admission_per_minute)
                        if self.serving.admission_per_minute else None)
        self.queue = AdmissionQueue(capacity=self.serving.queue_capacity,
                                    rate_limiter=rate_limiter)
        # Persistent device state: the pool's KV cache and each slot's
        # carried next-token logits (f32, what the sampler reads).
        self._cache = init_cache(cfg, self.num_slots, self.cache_len, device=engine.device)
        self._prev_logits = torch.zeros((self.num_slots, cfg.vocab_size), dtype=torch.float32,
                                        device=engine.device)
        # One decode program: decode_chunk x fuse_steps steps a call, or
        # fewer once every live row is done.
        tok = engine.tokenizer
        self._step = build_serve_step(
            engine.model, self.sampler, tok.pad_id, tok.eos_id, num_slots=self.num_slots,
            chunk=max(1, self.serving.decode_chunk), fuse=max(1, self.serving.fuse_steps))
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
        return self.queue.submit(request)

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
        progressed = self._iterate(stats)
        self._feed()
        return progressed

    def finish_stats(self, stats: ServingStats) -> None:
        """Attribute the queue rejections no earlier drain reported,
        including ``submit()`` refusals made between drains."""
        stats.rejected = self.queue.rejected - self._rejected_taken
        self._rejected_taken = self.queue.rejected

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
        self._results[request.id] = Result(
            id=request.id, ok=False, text=tok.decode([t for t in ids if t != tok.eos_id]),
            tokens=np.asarray(ids, np.int32), finish_reason=reason, error=error,
            retries=request.retries, latency_s=time.monotonic() - request.submitted_at)
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
        self._results[req.id] = Result(
            id=req.id, ok=True, text=text, tokens=np.asarray(ids, np.int32),
            finish_reason=reason, prompt_tokens=state.real_len, retries=req.retries,
            latency_s=time.monotonic() - req.submitted_at)
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
        t0 = time.perf_counter()
        prefill = build_serve_prefill(self.engine.config, self.engine.model, nb=nb, P=P)
        prefill(self._cache, self._prev_logits, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(valid).to(dev), slots)
        self.engine._sync()
        self.last_seconds["prefill"] += time.perf_counter() - t0
        stats.prefill_batches += 1
        stats.prefill_tokens += int(tb.lengths.sum())
        stats.admitted += n
        return True

    # -- decode --------------------------------------------------------------

    def _decode(self, stats: ServingStats) -> bool:
        """One decode chunk over the live slots, then eviction. True when
        anything decoded."""
        live_ids = self.pool.live_slots()
        if not live_ids:
            return False
        B = self.num_slots
        # Released slots are invalidated at the step's entry; a slot
        # released and reused since never enters the mask (its prefill
        # re-initialized the row).
        reset = np.zeros((B,), bool)
        reset[self.pool.take_invalidations()] = True
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
        t0 = time.perf_counter()
        out = self._step(self._cache, self._prev_logits, seeds, emitted, base, caps, live,
                         reset)
        self.last_seconds["decode"] += time.perf_counter() - t0
        self._prev_logits = out.logits
        stats.decode_steps += out.steps
        stats.occupancy_sum += out.row_steps
        now = time.monotonic()
        eos_id = self.engine.tokenizer.eos_id
        for slot in live_ids:
            st = self.pool.get(slot)
            n = int(out.emitted[slot]) - st.emitted
            new = [int(t) for t in out.toks[slot, :n]]
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
