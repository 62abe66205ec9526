"""Per-model decode settings and the speculation knobs (counterpart of
``fairness_llm_tpu/config.py``: ``ModelSettings``, the ``model_settings``
table and ``SpeculationConfig`` only)."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    """Per-model decode settings."""

    temperature: float = 0.7
    max_tokens: int = 500
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Prompt-lookup speculative decoding (``runtime/speculative.py``): each
    step drafts ``draft_len`` tokens by matching the last ``ngram_max``
    tokens against the row's prompt and output, then verifies all of them
    in one forward. Greedy only: with temperature > 0 the engine takes the
    plain sampled path."""

    enabled: bool = False
    ngram_max: int = 3  # longest suffix n-gram tried first (falls back to 1)
    draft_len: int = 8  # drafted tokens verified per step (k; step width k+1)


MODEL_SETTINGS: Dict[str, ModelSettings] = {
    "tiny-test": ModelSettings(temperature=0.7, max_tokens=128),
    "tiny-gpt2": ModelSettings(temperature=0.7, max_tokens=128),
    "tiny-llama-study": ModelSettings(temperature=0.7, max_tokens=64),
    "tiny-gpt2-study": ModelSettings(temperature=0.7, max_tokens=64),
    "gpt2-small": ModelSettings(temperature=0.7, max_tokens=256),
    "llama32-1b": ModelSettings(temperature=0.7, max_tokens=500),
    "llama32-3b": ModelSettings(temperature=0.7, max_tokens=500),
    "llama3-8b": ModelSettings(temperature=0.7, max_tokens=500),
    "llama3-70b": ModelSettings(temperature=0.7, max_tokens=500),
    "mistral-7b": ModelSettings(temperature=0.7, max_tokens=500),
    "gemma-7b": ModelSettings(temperature=0.7, max_tokens=500),
    "qwen2-0.5b": ModelSettings(temperature=0.7, max_tokens=500),
    "qwen2-7b": ModelSettings(temperature=0.7, max_tokens=500),
}

