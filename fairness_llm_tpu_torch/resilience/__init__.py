"""Resilience subsystem: hang detection, circuit breaking, preemption-safe
drain (the port's copy of ``fairness_llm_tpu/resilience/``).

The serving and engine stack already contains *transient* faults
(requeue-once, chunk retry, deadlines, phase resume checkpoints); this
package handles the three failure shapes those mechanisms cannot:

- ``watchdog``: a step that never returns (or returns absurdly late),
  classified against ``max_step_seconds`` from the liveness timestamps the
  loops stamp into telemetry, surfaced as a containable ``HangFault``.
- ``breaker``: a stage that fails PERSISTENTLY. Per-stage closed/open/
  half-open circuit breakers stop hammering it, and each trip advances a
  degradation ladder (drop speculation -> shrink the serving footprint ->
  fall back to the static engine) that sheds throughput features before
  correctness ones.
- ``drain``: the process itself dying (a preempted host) — a SIGTERM/SIGINT
  graceful drain plus a crash-safe ``journal.jsonl`` of accepted-but-
  unfinished requests, and the ``resume_serving`` path that finishes them
  with greedy parity in a successor process.

A fatal CUDA error is outside all three: it is re-raised, never contained
(``utils/failures.is_fatal_device_error``).
"""

from fairness_llm_tpu_torch.resilience.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    STAGES,
    BreakerBoard,
    CircuitBreaker,
    DegradationLadder,
)
from fairness_llm_tpu_torch.resilience.drain import (
    JOURNAL_FILENAME,
    GracefulDrain,
    ServingJournal,
    drain_requested,
    resume_serving,
    take_signal_telemetry,
)
from fairness_llm_tpu_torch.resilience.watchdog import (
    LAST_STEP_GAUGE,
    StepWatchdog,
    mark_step_completed,
)

__all__ = [
    "BreakerBoard",
    "CircuitBreaker",
    "CLOSED",
    "DegradationLadder",
    "drain_requested",
    "GracefulDrain",
    "HALF_OPEN",
    "JOURNAL_FILENAME",
    "LAST_STEP_GAUGE",
    "mark_step_completed",
    "OPEN",
    "resume_serving",
    "ServingJournal",
    "STAGES",
    "StepWatchdog",
    "take_signal_telemetry",
]
