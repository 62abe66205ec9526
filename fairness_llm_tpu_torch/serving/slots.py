"""Fixed-size KV slot pool: the host-side allocator behind continuous
batching (counterpart of ``fairness_llm_tpu/serving/slots.py``).

The device holds one persistent cache of ``num_slots`` rows, each
``cache_len`` slots long (``scheduler.py``). This module tracks which rows
are live, what request occupies each, and the per-row layout the decode
step needs:

- ``base``: the first decode write offset, the prompt bucket the row was
  prefilled at (its admission batch's largest bucket); decode step t
  writes its KV at slot ``base + emitted``;
- ``real_len``: the real (non-pad) prompt tokens; positions continue from
  here, as a batch-1 ``DecodeEngine.generate`` would;
- ``emitted``: tokens generated so far, a stopping EOS included.

Free slots form a free list, lowest id first. ``release`` returns a slot
and marks it for invalidation: the scheduler clears the row's
``key_valid``/``lengths`` at the next decode step's entry, so a recycled
slot never attends to its previous tenant's keys. A slot allocated again
before that step drops its pending invalidation: its prefill re-initializes
the row.

With ``paged`` (a ``serving/paged.PagedKV``, the paged KV cache) the pool
carries the block manager instead: ``release`` derefs the slot's shared
prefix blocks and frees its private ones, and queues no row invalidation
(a freed block re-enters a table only through a prefill that clears its
``key_valid`` first).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

from fairness_llm_tpu_torch.serving.paged import PagedKV
from fairness_llm_tpu_torch.serving.request import Request


@dataclasses.dataclass
class SlotState:
    request: Request
    base: int  # first decode write offset
    real_len: int  # real prompt tokens (the position origin for decode)
    emitted: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)


class SlotPool:
    def __init__(self, num_slots: int, paged: Optional[PagedKV] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.paged = paged
        self._free: List[int] = list(range(num_slots))
        heapq.heapify(self._free)
        self._live: Dict[int, SlotState] = {}
        # Released since the last flush, in release order (a dict as an
        # ordered set).
        self._pending_invalidation: Dict[int, None] = {}

    def __len__(self) -> int:
        return len(self._live)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return len(self._live)

    @property
    def pending_invalidation(self) -> List[int]:
        """Released slots not yet invalidated, in release order."""
        return list(self._pending_invalidation)

    def live_slots(self) -> List[int]:
        return sorted(self._live)

    def get(self, slot: int) -> SlotState:
        return self._live[slot]

    def alloc(self, state: SlotState) -> Optional[int]:
        """Claim the lowest free slot for ``state``; None when the pool is
        full (the request stays queued)."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._live[slot] = state
        # The new tenant's prefill re-initializes the row; a flush after it
        # would wipe the new prompt.
        self._pending_invalidation.pop(slot, None)
        return slot

    def release(self, slot: int) -> SlotState:
        """Free ``slot`` and queue it for invalidation, or, paged, release
        its blocks. A slot that is not live raises KeyError: a double
        release is a bug."""
        state = self._live.pop(slot)
        heapq.heappush(self._free, slot)
        if self.paged is not None:
            self.paged.release(slot)
        else:
            self._pending_invalidation[slot] = None
        return state

    def take_invalidations(self) -> List[int]:
        out = list(self._pending_invalidation)
        self._pending_invalidation.clear()
        return out
