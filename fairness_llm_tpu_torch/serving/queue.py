"""Bounded admission queue with backpressure and an optional rate limit
(counterpart of ``AdmissionQueue`` in ``fairness_llm_tpu/serving/queue.py``).

``submit`` never blocks: it returns False (and counts a rejection) when the
queue is at capacity or the ``RateLimiter`` quota says no, and the caller
decides whether to retry. One consumer, the scheduler loop, so this is a
deque with a capacity, not a synchronized queue. ``requeue`` puts a request
back at the front, past capacity and quota; ``submit(front=True)`` puts one
there within them (the fleet's migration path). ``close`` refuses every
submission while a drain runs (``resilience/drain.py``).

``ClassedAdmissionQueue`` is the QoS variant (``serving/overload.py``,
armed by ``OverloadConfig.enabled``): per-class bounded sub-queues with
per-class rate quotas and strict-priority-with-aging dequeue, behind the
same interface. Requests that all share one class are served first in
first out, as by the plain queue.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

from fairness_llm_tpu_torch.config import OverloadConfig
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, Request
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

    def submit(self, request: Request, count_rejection: bool = True,
               front: bool = False) -> bool:
        """Admit ``request`` at the back; False = backpressure, nothing
        enqueued. ``count_rejection=False`` is for retries of an already
        accepted request (the scheduler's overflow top-up): a refusal then
        is not a new rejection. ``front=True`` admits at the head: the
        fleet's migration path (``serving/fleet.py``), for a request that
        already waited through a fenced replica's queue, still subject to
        capacity and quota because this queue never saw it."""
        if self.closed or self.full or (self.rate_limiter is not None
                                        and not self.rate_limiter.try_acquire()):
            if count_rejection:
                self.rejected += 1
            return False
        if front:
            self._q.appendleft(request)
        else:
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


class ClassedAdmissionQueue(AdmissionQueue):
    """Per-QoS-class admission: one bounded sub-queue per class, per-class
    rate quotas, and strict-priority-with-aging dequeue.

    Each class has its own capacity (inside the overall ``capacity``), so a
    batch flood backpressures batch submitters while interactive ones keep
    flowing. ``pop`` serves the highest-priority non-empty class, except
    that a lower-class head that has waited ``aging_s`` competes on age,
    oldest first: a steady interactive stream delays batch by at most
    ``aging_s``. ``requeue`` puts a request back at the head of its own
    class, so a faulted batch request cannot jump the interactive line.
    ``clock`` drives the aging and the default expiry sweep and is handed
    to the class quotas, so that tests age the queue without sleeping.
    """

    def __init__(self, capacity: int = 128, rate_limiter: Optional[RateLimiter] = None,
                 overload: Optional[OverloadConfig] = None, clock=time.monotonic):
        super().__init__(capacity=capacity, rate_limiter=rate_limiter)
        self.overload = overload or OverloadConfig(enabled=True)
        self._clock = clock
        self._classes: Dict[str, Deque[Request]] = {c: deque() for c in QOS_CLASSES}
        o = self.overload
        self._class_caps = {"interactive": o.interactive_capacity,
                            "batch": o.batch_capacity, "probe": o.probe_capacity}
        self._class_limiters: Dict[str, Optional[RateLimiter]] = {
            c: (RateLimiter(q, clock=clock) if q else None)
            for c, q in (("interactive", o.interactive_per_minute),
                         ("batch", o.batch_per_minute), ("probe", o.probe_per_minute))}

    def __len__(self) -> int:
        return sum(len(q) for q in self._classes.values())

    def class_depths(self) -> Dict[str, int]:
        """The depth of each class."""
        return {c: len(q) for c, q in self._classes.items()}

    def class_full(self, qos: str) -> bool:
        return len(self._classes[qos]) >= self._class_caps[qos]

    def submit(self, request: Request, count_rejection: bool = True,
               front: bool = False) -> bool:
        """The plain queue's checks plus the class's bound and quota; False
        = backpressure, nothing enqueued. The shared quota, when set,
        applies after the class's own; ``front`` admits at the head of the
        request's class."""
        qos = request.qos
        limiter = self._class_limiters[qos]
        # Both quotas are peeked before either is spent: spending one and
        # failing the other would burn quota on a refused submission.
        if self.closed or self.full or self.class_full(qos) \
                or (limiter is not None and not limiter.can_acquire()) \
                or (self.rate_limiter is not None and not self.rate_limiter.can_acquire()):
            if count_rejection:
                self.rejected += 1
            return False
        if limiter is not None:
            limiter.try_acquire()
        if self.rate_limiter is not None:
            self.rate_limiter.try_acquire()
        if front:
            self._classes[qos].appendleft(request)
        else:
            self._classes[qos].append(request)
        return True

    def requeue(self, request: Request) -> None:
        """Front of the request's own class, past bounds and quotas."""
        self._classes[request.qos].appendleft(request)

    def _pop_one(self, now: float) -> Optional[Request]:
        aging = self.overload.aging_s
        if aging > 0:
            # Heads that waited aging_s compete on age alone (class rank
            # breaks exact ties).
            aged = [(q[0].submitted_at, rank, c) for rank, c in enumerate(QOS_CLASSES)
                    for q in (self._classes[c],) if q and now - q[0].submitted_at >= aging]
            if aged:
                return self._classes[min(aged)[2]].popleft()
        for c in QOS_CLASSES:  # strict priority
            if self._classes[c]:
                return self._classes[c].popleft()
        return None

    def pop(self, n: int = 1) -> List[Request]:
        """Up to ``n`` requests: strict class priority, aged heads promoted."""
        now = self._clock()
        out: List[Request] = []
        while len(out) < n:
            req = self._pop_one(now)
            if req is None:
                break
            out.append(req)
        return out

    def drain_expired(self, now: Optional[float] = None) -> List[Request]:
        # Expiry ages on the injected clock, as the aging does.
        if now is None:
            now = self._clock()
        expired: List[Request] = []
        for c, q in self._classes.items():
            keep: Deque[Request] = deque()
            for r in q:
                (expired if r.expired(now) else keep).append(r)
            self._classes[c] = keep
        return expired
