"""Decode and serving counters and the phase timer (counterpart of
``SpeculationStats``, ``ServingStats`` and ``phase_timer`` in
``fairness_llm_tpu/utils/profiling.py``). Each stats object ``publish``es
its counters into the telemetry registry (``telemetry/registry.py``), so
the registry's totals equal the merged records. The reference's
``maybe_trace``/``summarize_trace`` read XProf traces and are not ported."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SpeculationStats:
    """Prompt-lookup speculation counters for one decode call, or a sweep
    (``merge``). ``GenerateOutput.stats["speculation"]`` holds ``as_dict()``;
    ``EngineBackend.spec_totals`` merges them over a sweep.

    - ``drafted``: draft tokens proposed, over verify steps x live rows;
    - ``accepted``: drafted tokens emitted (each saves one decode step);
    - ``verify_steps``: verify forwards run; the batch moves in lockstep,
      so this replaces plain decode's step count (the most tokens of a row);
    - ``emitted``: real tokens produced over all rows, each step's greedy
      token included; ``tokens_per_step`` = emitted / verify_steps is
      summed over the batch.
    """

    drafted: int = 0
    accepted: int = 0
    verify_steps: int = 0
    emitted: int = 0
    draft_len: int = 0
    ngram_max: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / self.verify_steps if self.verify_steps else 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "SpeculationStats":
        """Inverse of ``as_dict``; the derived keys are dropped."""
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def merge(self, other: "SpeculationStats") -> "SpeculationStats":
        return SpeculationStats(
            drafted=self.drafted + other.drafted,
            accepted=self.accepted + other.accepted,
            verify_steps=self.verify_steps + other.verify_steps,
            emitted=self.emitted + other.emitted,
            draft_len=other.draft_len or self.draft_len,
            ngram_max=other.ngram_max or self.ngram_max,
        )

    def as_dict(self) -> dict:
        return {
            "drafted": self.drafted,
            "accepted": self.accepted,
            "verify_steps": self.verify_steps,
            "emitted": self.emitted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "tokens_per_step": round(self.tokens_per_step, 3),
            "draft_len": self.draft_len,
            "ngram_max": self.ngram_max,
        }

    def publish(self, registry=None, component: str = "engine") -> None:
        """Mirror this object's counters into the telemetry registry; the
        engine publishes each call's stats once, so the registry's totals
        equal the merged sweep totals."""
        from fairness_llm_tpu_torch.telemetry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter("spec_drafted_total", component=component).inc(self.drafted)
        reg.counter("spec_accepted_total", component=component).inc(self.accepted)
        reg.counter("spec_verify_steps_total", component=component).inc(self.verify_steps)
        reg.counter("spec_emitted_total", component=component).inc(self.emitted)


@dataclasses.dataclass
class ServingStats:
    """Continuous-batching counters for one ``ContinuousScheduler`` drain,
    or a sweep (``merge``). ``ServingBackend.serve_totals`` merges them; the
    phase records hold ``as_dict()`` under ``serving``.

    - ``admitted``: requests admitted into KV slots;
    - ``completed`` / ``failed`` / ``expired``: terminal outcomes
      (``expired``: the deadline passed first);
    - ``preempted`` (a drain), ``shed`` (overload control refused it) and
      ``requeued`` (a contained fault, retried once);
    - ``rejected``: submissions refused at the queue (capacity or rate);
    - ``prefill_batches`` / ``prefill_tokens``: prefill forwards and the
      real prompt tokens they processed;
    - ``decode_steps`` / ``decoded_tokens``: decode-step forwards and the
      real tokens emitted (tokens per step at most ``num_slots``);
    - ``occupancy_sum``: live rows summed over decode steps (mean occupancy
      = occupancy_sum / decode_steps);
    - ``queue_depth_sum`` / ``queue_depth_max`` / ``loop_iterations``: the
      admission queue's depth over the scheduler loop.
    """

    num_slots: int = 0
    admitted: int = 0
    completed: int = 0
    failed: int = 0
    expired: int = 0
    preempted: int = 0
    shed: int = 0
    rejected: int = 0
    requeued: int = 0
    prefill_batches: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decoded_tokens: int = 0
    occupancy_sum: int = 0
    queue_depth_sum: int = 0
    queue_depth_max: int = 0
    loop_iterations: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.decoded_tokens / self.decode_steps if self.decode_steps else 0.0

    @property
    def avg_occupancy(self) -> float:
        return self.occupancy_sum / self.decode_steps if self.decode_steps else 0.0

    @property
    def avg_queue_depth(self) -> float:
        return self.queue_depth_sum / self.loop_iterations if self.loop_iterations else 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "ServingStats":
        """Inverse of ``as_dict``; the derived keys are dropped."""
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def merge(self, other: "ServingStats") -> "ServingStats":
        summed = {f.name: getattr(self, f.name) + getattr(other, f.name)
                  for f in dataclasses.fields(self)}
        summed["num_slots"] = other.num_slots or self.num_slots
        summed["queue_depth_max"] = max(self.queue_depth_max, other.queue_depth_max)
        return ServingStats(**summed)

    def as_dict(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        out["tokens_per_step"] = round(self.tokens_per_step, 3)
        out["avg_occupancy"] = round(self.avg_occupancy, 3)
        out["avg_queue_depth"] = round(self.avg_queue_depth, 3)
        return out

    def publish(self, registry=None, component: str = "serving", labels=None) -> None:
        """Mirror one drain's counters into the telemetry registry (call once
        per drain, so the registry carries process totals). ``num_slots``
        and ``queue_depth_max`` are levels, not event counts, so they
        publish as gauges; ``labels`` adds instrument labels."""
        from fairness_llm_tpu_torch.telemetry import get_registry

        reg = registry if registry is not None else get_registry()
        lbl = dict(labels or {})
        for name in ("admitted", "completed", "failed", "expired", "preempted", "shed",
                     "rejected", "requeued", "prefill_batches", "prefill_tokens",
                     "decode_steps", "decoded_tokens", "loop_iterations"):
            reg.counter(f"serving_{name}_total", component=component,
                        **lbl).inc(getattr(self, name))
        reg.gauge("serving_num_slots", component=component, **lbl).set(self.num_slots)
        reg.gauge("serving_queue_depth_max", component=component,
                  **lbl).set_max(self.queue_depth_max)


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock phase timing, logged, with an optional dict sink for
    machine-readable timings."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.info("%s took %.2fs", name, dt)
        if sink is not None:
            sink[name] = dt
