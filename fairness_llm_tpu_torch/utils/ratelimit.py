"""Sliding-window rate limiter (counterpart of
``fairness_llm_tpu/utils/ratelimit.py``): at most ``calls_per_minute`` calls
in any trailing ``window_seconds`` window, over one ledger of call times.

- ``try_acquire()`` admits or refuses without sleeping; the serving queue
  (``serving/queue.py``) uses it at admission, where blocking the step loop
  would stall every running request.
- ``can_acquire()`` peeks without recording a call.
- ``wait_if_needed()`` blocks until a call is allowed.

``clock`` is injectable (default ``time.monotonic``) so that tests can age
the window without sleeping.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque


class RateLimiter:
    def __init__(self, calls_per_minute: int = 60, window_seconds: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.calls_per_minute = calls_per_minute
        self.window = window_seconds
        self._clock = clock
        self._times: Deque[float] = deque()

    def _prune(self, now: float) -> None:
        while self._times and now - self._times[0] >= self.window:
            self._times.popleft()

    def try_acquire(self) -> bool:
        """True (and the call is recorded) when the window has room, False
        (nothing recorded) when it does not. Never sleeps."""
        now = self._clock()
        self._prune(now)
        if len(self._times) >= self.calls_per_minute:
            return False
        self._times.append(now)
        return True

    def can_acquire(self) -> bool:
        """Would ``try_acquire`` succeed now? Records nothing."""
        self._prune(self._clock())
        return len(self._times) < self.calls_per_minute

    def wait_if_needed(self) -> float:
        """Block until a call is allowed, record it; returns seconds slept."""
        now = self._clock()
        self._prune(now)
        slept = 0.0
        if len(self._times) >= self.calls_per_minute:
            wait = self.window - (now - self._times[0])
            if wait > 0:
                time.sleep(wait)
                slept = wait
            self._prune(self._clock())
        self._times.append(self._clock())
        return slept
