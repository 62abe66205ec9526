"""Continuous-batching serving core (counterpart of
``fairness_llm_tpu/serving/``).

Layers, bottom up: ``request`` (Request/Result, QoS classes) -> ``queue``
(bounded admission, rate limit; per-class sub-queues with overload
control) -> ``overload`` (the shed controller and deadline-feasibility
admission) -> ``paged`` (the block arena and radix prefix index of the
paged KV cache) -> ``slots`` (the KV slot pool allocator) -> ``scheduler``
(the prefill/decode step loop) -> ``backend`` (the ``DecodeBackend`` the
phases call). Fault containment, the breakers, the watchdog, drain and the
journal live in ``resilience/`` and ``integrity/``. The replica fleet,
router, autoscaler, replay and rollout are later slices (ROADMAP A5.4).
"""

from fairness_llm_tpu_torch.serving.backend import ServingBackend
from fairness_llm_tpu_torch.serving.overload import DeadlineEstimator, ShedController
from fairness_llm_tpu_torch.serving.paged import PagedKV, RadixIndex
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue, ClassedAdmissionQueue
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, Request, Result
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState

__all__ = [
    "AdmissionQueue",
    "ClassedAdmissionQueue",
    "ContinuousScheduler",
    "DeadlineEstimator",
    "PagedKV",
    "QOS_CLASSES",
    "RadixIndex",
    "Request",
    "Result",
    "ServingBackend",
    "ShedController",
    "SlotPool",
    "SlotState",
]
