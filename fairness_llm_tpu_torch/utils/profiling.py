"""Decode counters (counterpart of ``SpeculationStats`` in
``fairness_llm_tpu/utils/profiling.py``; the reference's ``publish`` to the
telemetry registry waits for the port's telemetry slice)."""

from __future__ import annotations

import dataclasses


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
