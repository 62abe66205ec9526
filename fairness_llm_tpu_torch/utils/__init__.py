"""Decode counters, the phase timer and the per-phase device trace."""

from fairness_llm_tpu_torch.utils.profiling import (
    TraceSummary,
    maybe_trace,
    phase_timer,
    summarize_trace,
)

__all__ = ["TraceSummary", "maybe_trace", "phase_timer", "summarize_trace"]
