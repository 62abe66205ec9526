"""Request/Result dataclasses, the serving subsystem's wire format
(counterpart of ``fairness_llm_tpu/serving/request.py``).

A ``Request`` is one prompt with its own decode budget, sampling seed and
optional deadline; a ``Result`` is its terminal outcome. The scheduler owns
the lifecycle: queued -> admitted (KV slot + prefill) -> decoding ->
completed, failed, expired or preempted (a fault requeues it once).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np

from fairness_llm_tpu_torch.config import ModelSettings

# QoS classes, highest priority first (serving/overload.py): "interactive"
# is user-facing traffic with latency SLOs, "batch" throughput traffic (the
# study's sweeps), "probe" synthetic health traffic (the canary), last in
# dequeue order but shed only at the top brownout rung.
QOS_CLASSES = ("interactive", "batch", "probe")
QOS_PRIORITY = {name: rank for rank, name in enumerate(QOS_CLASSES)}

_ids = itertools.count()


def _auto_id() -> str:
    return f"req_{next(_ids):06d}"


@dataclasses.dataclass
class Request:
    """One serving request.

    ``settings.max_tokens`` is the request's decode budget, clamped to the
    server's ``ServingConfig.max_new_tokens``. Its sampler fields
    (temperature, top_k, top_p) must equal the scheduler's: one scheduler
    samples one way (``ServingBackend`` keeps one per settings tuple).

    ``row_seed`` keys the row's sampling stream on the request's identity,
    so the same (prompt, row_seed, settings) decodes the same text whatever
    shares the slot pool, as the engine's ``row_seeds`` do.

    ``deadline_s`` is a wall-clock budget from submission; an expired
    request fails with finish_reason "deadline", queued or mid-decode.
    ``submitted_at`` is stamped again when the scheduler takes the request
    (``submit``/``serve``).

    ``qos`` is the request's priority class; it matters only with overload
    control armed (per-class queues, strict priority with aging, the
    brownout ladder refusing lower classes first). ``group``,
    ``attribute`` and ``pair_id`` are optional study tags for the fairness
    monitor (``telemetry/fairness.py``): which demographic group of which
    attribute the prompt stands for, and which counterfactual pair it is in.
    They change nothing about scheduling, and the journal keeps them.
    """

    prompt: str
    id: str = dataclasses.field(default_factory=_auto_id)
    settings: Optional[ModelSettings] = None
    row_seed: Optional[int] = None
    deadline_s: Optional[float] = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    retries: int = 0
    qos: str = "interactive"
    group: Optional[str] = None
    attribute: Optional[str] = None
    pair_id: Optional[str] = None

    def __post_init__(self) -> None:
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"request {self.id!r}: qos {self.qos!r} not in {QOS_CLASSES}")

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        return (now if now is not None else time.monotonic()) \
            >= self.submitted_at + self.deadline_s


@dataclasses.dataclass
class Result:
    """Terminal outcome of one request.

    ``tokens`` follows the engine's per-row convention: the generated ids,
    including the EOS that stopped the row, nothing after.
    ``finish_reason``: "eos" | "length" | "deadline" | "failed" (a second
    fault after the one requeue; ``error`` says which) | "preempted" (a
    drain; the journal keeps it open for ``resume-serving``) | "shed"
    (overload control refused it; ``retry_after_s`` is the earliest the
    client should resubmit, set only then). ``latency_s`` is the wall time
    from submission.
    """

    id: str
    ok: bool
    text: str = ""
    tokens: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,), np.int32))
    finish_reason: str = "length"
    error: Optional[str] = None
    prompt_tokens: int = 0
    latency_s: float = 0.0
    retries: int = 0
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    retry_after_s: Optional[float] = None
