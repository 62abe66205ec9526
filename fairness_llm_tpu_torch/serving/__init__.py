"""Continuous-batching serving stack (counterpart of
``fairness_llm_tpu/serving/``).

Layers, bottom up: ``request`` (Request/Result, QoS classes) -> ``queue``
(bounded admission, rate limit; per-class sub-queues with overload
control) -> ``overload`` (the shed controller and deadline-feasibility
admission) -> ``paged`` (the block arena and radix prefix index of the
paged KV cache) -> ``slots`` (the KV slot pool allocator) -> ``scheduler``
(the prefill/decode step loop) -> ``router``/``fleet`` (health-aware
routing over N replica schedulers, each a fault domain with fence, migrate
and rejoin) -> ``autoscaler`` (elastic membership) and ``rollout`` (the
canary-gated rolling upgrade) -> ``backend`` (the ``DecodeBackend`` the
phases call). ``replay`` sits beside them: a seeded synthetic trace and the
driver that replays it against a fleet. Fault containment, the breakers,
the watchdog, drain and the journal live in ``resilience/`` and
``integrity/``.
"""

from fairness_llm_tpu_torch.serving.autoscaler import Autoscaler
from fairness_llm_tpu_torch.serving.backend import ServingBackend
from fairness_llm_tpu_torch.serving.fleet import Replica, ReplicaSet
from fairness_llm_tpu_torch.serving.overload import DeadlineEstimator, ShedController
from fairness_llm_tpu_torch.serving.paged import BlockArena, PagedKV, RadixIndex, init_arena
from fairness_llm_tpu_torch.serving.queue import AdmissionQueue, ClassedAdmissionQueue
from fairness_llm_tpu_torch.serving.replay import (
    ReplayClock,
    ReplayDriver,
    ReplayReport,
    TraceConfig,
    TraceEvent,
    generate_trace,
    read_trace,
    write_trace,
)
from fairness_llm_tpu_torch.serving.request import QOS_CLASSES, Request, Result
from fairness_llm_tpu_torch.serving.rollout import RolloutController, render_rollout_report
from fairness_llm_tpu_torch.serving.router import HealthRouter
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler
from fairness_llm_tpu_torch.serving.slots import SlotPool, SlotState

__all__ = [
    "AdmissionQueue",
    "Autoscaler",
    "BlockArena",
    "ReplayClock",
    "ReplayDriver",
    "ReplayReport",
    "TraceConfig",
    "TraceEvent",
    "generate_trace",
    "read_trace",
    "write_trace",
    "ClassedAdmissionQueue",
    "ContinuousScheduler",
    "DeadlineEstimator",
    "PagedKV",
    "RadixIndex",
    "init_arena",
    "QOS_CLASSES",
    "ShedController",
    "HealthRouter",
    "Replica",
    "ReplicaSet",
    "RolloutController",
    "render_rollout_report",
    "Request",
    "Result",
    "ServingBackend",
    "SlotPool",
    "SlotState",
]
