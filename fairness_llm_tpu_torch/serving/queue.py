"""Bounded admission queue with backpressure and an optional rate limit
(counterpart of ``AdmissionQueue`` in ``fairness_llm_tpu/serving/queue.py``).

``submit`` never blocks: it returns False (and counts a rejection) when the
queue is at capacity or the ``RateLimiter`` quota says no, and the caller
decides whether to retry. One consumer, the scheduler loop, so this is a
deque with a capacity, not a synchronized queue. ``requeue`` puts a request
back at the front, past capacity and quota. ``close`` refuses every
submission while a drain runs (``resilience/drain.py``). The per-QoS-class
queue (``ClassedAdmissionQueue``) comes with overload control (ROADMAP A5).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from fairness_llm_tpu_torch.serving.request import Request
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter


class AdmissionQueue:
    def __init__(self, capacity: int = 128, rate_limiter: Optional[RateLimiter] = None):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.rate_limiter = rate_limiter
        self._q: Deque[Request] = deque()
        self.rejected = 0  # closed, capacity and rate refusals, for ServingStats
        # A draining server stops ACCEPTING work, not just admitting it to
        # slots: late submissions would sit in a queue nothing pops.
        self.closed = False

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self) >= self.capacity

    def submit(self, request: Request, count_rejection: bool = True) -> bool:
        """Admit ``request`` at the back; False = backpressure, nothing
        enqueued. ``count_rejection=False`` is for retries of an already
        accepted request (the scheduler's overflow top-up): a refusal then
        is not a new rejection."""
        if self.closed or self.full or (self.rate_limiter is not None
                                        and not self.rate_limiter.try_acquire()):
            if count_rejection:
                self.rejected += 1
            return False
        self._q.append(request)
        return True

    def close(self) -> None:
        """Stop accepting submissions (a drain). Queued requests stay
        poppable: the drain decides whether to finish or journal them."""
        self.closed = True

    def reopen(self) -> None:
        self.closed = False

    def requeue(self, request: Request) -> None:
        """Front-of-line reinsertion, past capacity and rate checks: the
        request was admitted once already."""
        self._q.appendleft(request)

    def pop(self, n: int = 1) -> List[Request]:
        """Dequeue up to ``n`` requests, first in first out."""
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out

    def drain_expired(self, now: Optional[float] = None) -> List[Request]:
        """Remove and return every queued request whose deadline has passed."""
        keep, expired = deque(), []
        for r in self._q:
            (expired if r.expired(now) else keep).append(r)
        self._q = keep
        return expired
