"""Per-model decode settings (counterpart of ``fairness_llm_tpu/config.py``:
``ModelSettings`` and the ``model_settings`` table only)."""

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

