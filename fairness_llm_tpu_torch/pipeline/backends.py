"""The decode backend the phase code calls (counterpart of
``EngineBackend``, ``shared_prefix_ids`` and ``_stable_hash`` in
``fairness_llm_tpu/pipeline/backends.py``)."""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

from fairness_llm_tpu_torch.config import ModelSettings
from fairness_llm_tpu_torch.runtime.engine import _token_lcp
from fairness_llm_tpu_torch.utils.profiling import SpeculationStats


class EngineBackend:
    """Real in-framework decode through a ``DecodeEngine``. ``last_stats``
    holds the stats of the most recent ``generate`` call.

    ``speculation`` (a ``SpeculationConfig``) turns on prompt-lookup
    speculative decoding for greedy sweeps; sampled settings take the plain
    path, so it is always safe to set. The speculative calls' counters add
    up in ``spec_totals`` (a ``SpeculationStats``)."""

    def __init__(self, engine, name: Optional[str] = None, speculation=None):
        self.engine = engine
        self.name = name or engine.config.name
        self.speculation = speculation
        self.spec_totals: Optional[SpeculationStats] = None
        self.last_stats: Optional[Dict[str, Any]] = None

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,
    ) -> List[str]:
        row_seeds = None
        if keys is not None:
            # Per-row sampling streams keyed on stable identity, so resumed /
            # re-chunked sweeps decode identical text for the same profile.
            row_seeds = [(_stable_hash(k) ^ seed) & 0xFFFFFFFF for k in keys]
        out = self.engine.generate(
            prompts, settings, seed=seed, row_seeds=row_seeds,
            prefix_ids=prefix_ids,
            # sweeps pass an explicit sweep-wide prefix; never auto-detect per
            # chunk (composition-dependent)
            share_prefix=None if prefix_ids is not None else False,
            speculation=self.speculation,
        )
        self.last_stats = out.stats
        sp = (out.stats or {}).get("speculation")
        if sp is not None:
            chunk = SpeculationStats.from_dict(sp)
            self.spec_totals = chunk if self.spec_totals is None else self.spec_totals.merge(chunk)
        return out.texts


def shared_prefix_ids(backend, prompts: Sequence[str]) -> Optional[List[int]]:
    """Sweep-wide shared prefix for reproducible prefix-cached decode: the
    longest common token prefix over ALL the sweep's prompts, floored to a
    multiple of 64. None for non-engine backends or short prefixes."""
    engine = getattr(backend, "engine", None)
    if engine is None or len(prompts) < 2:
        return None
    rows = [engine.tokenizer.encode(p) for p in prompts]
    common = (_token_lcp(rows) // 64) * 64
    return list(rows[0][:common]) if common >= 64 else None


def _stable_hash(*parts: object) -> int:
    h = hashlib.sha256("||".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little")
