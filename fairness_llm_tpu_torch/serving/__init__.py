"""Continuous-batching serving core (counterpart of
``fairness_llm_tpu/serving/``).

Layers, bottom up: ``request`` (Request/Result) -> ``queue`` (bounded
admission, rate limit) -> ``paged`` (the block arena and radix prefix
index of the paged KV cache) -> ``slots`` (the KV slot pool allocator) ->
``scheduler`` (the prefill/decode step loop) -> ``backend`` (the
``DecodeBackend`` the phases call). Fault containment, the breakers,
the watchdog, drain and the journal live in ``resilience/`` and
``integrity/``. Overload control, the replica fleet, router, autoscaler,
replay and rollout are later slices (ROADMAP A5).
"""

from fairness_llm_tpu_torch.serving.backend import ServingBackend
from fairness_llm_tpu_torch.serving.paged import PagedKV, RadixIndex
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, Request, Result
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState

__all__ = [
    "AdmissionQueue",
    "ContinuousScheduler",
    "PagedKV",
    "QOS_CLASSES",
    "RadixIndex",
    "Request",
    "Result",
    "ServingBackend",
    "SlotPool",
    "SlotState",
]
