"""``ServingBackend``: the continuous-batching server behind the
``DecodeBackend`` protocol (counterpart of
``fairness_llm_tpu/serving/backend.py``), so that phases 1-3 run through
the server unchanged: ``backend_for`` returns one when
``Config.serving.enabled`` (CLI ``--continuous``).

How it differs from ``EngineBackend``:

- each row decodes on its own in a KV slot; the sweep-wide shared prefix
  (``prefix_ids``) is accepted and ignored (``use_shared_prefix`` is False,
  so ``shared_prefix_ids`` does not compute it). Greedy output equals
  ``EngineBackend`` with ``share_prefix=False`` token for token;
- the serving counters add up in ``serve_totals`` (a ``ServingStats``), as
  ``EngineBackend.spec_totals`` do, and the last call's ``GenerateOutput``
  (with ``stats["serving"]``) is kept in ``last_output``.

The reference's replica fleet, canary probe, breakers and static-engine
fallback are later slices (ROADMAP A5); a failed kernel raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from fairness_llm_tpu_torch.config import ModelSettings, ServingConfig
from fairness_llm_tpu_torch.serving.request import Request
from fairness_llm_tpu_torch.serving.scheduler import ContinuousScheduler


class ServingBackend:
    # shared_prefix_ids skips the sweep-wide prefix for this backend
    use_shared_prefix = False

    def __init__(self, engine, serving: Optional[ServingConfig] = None,
                 name: Optional[str] = None):
        self.engine = engine
        self.serving = serving or ServingConfig(enabled=True)
        self.name = name or engine.config.name
        self.serve_totals = None  # Optional[ServingStats]
        self.last_output = None  # GenerateOutput of the most recent call
        self._schedulers: dict = {}

    def scheduler_for(self, settings: ModelSettings) -> ContinuousScheduler:
        """One scheduler per sampler tuple. Each holds a KV pool, so at most
        two are kept (least recently used first out)."""
        key = (settings.temperature, settings.top_k, settings.top_p)
        sched = self._schedulers.pop(key, None)
        if sched is None:
            sched = ContinuousScheduler(self.engine, self.serving, settings=settings)
            while len(self._schedulers) >= 2:
                del self._schedulers[next(iter(self._schedulers))]
        self._schedulers[key] = sched
        return sched

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,  # accepted, unused
    ) -> List[Optional[str]]:
        """Texts in prompt order; None for a request that did not complete
        (a deadline), so that a sweep retries it."""
        from fairness_llm_tpu_torch.pipeline.backends import _stable_hash
        from fairness_llm_tpu_torch.runtime.engine import GenerateOutput

        settings = settings or ModelSettings()
        if not prompts:
            self.last_output = GenerateOutput(texts=[], tokens=np.zeros((0, 0), np.int32),
                                              steps=0)
            return []
        sched = self.scheduler_for(settings)
        requests = []
        for i, p in enumerate(prompts):
            if keys is not None:
                # EngineBackend's row-seed formula: stable identity
                rid, row_seed = keys[i], (_stable_hash(keys[i]) ^ seed) & 0xFFFFFFFF
            else:
                rid, row_seed = f"call{seed}_{i:05d}", (seed * 1_000_003 + i) & 0xFFFFFFFF
            requests.append(Request(prompt=p, id=rid, settings=settings, row_seed=row_seed,
                                    qos="batch"))
        results = sched.serve(requests)
        stats = sched.last_stats
        self.serve_totals = stats if self.serve_totals is None else self.serve_totals.merge(stats)
        cap = max((len(r.tokens) for r in results), default=0)
        toks = np.full((len(results), cap), self.engine.tokenizer.pad_id, np.int32)
        for i, r in enumerate(results):
            toks[i, : len(r.tokens)] = r.tokens
        self.last_output = GenerateOutput(
            texts=[r.text if r.ok else "" for r in results],
            tokens=toks,
            steps=sched.serving.max_new_tokens,
            stats={
                "batch": sched.num_slots,
                "prompt_len": sched.max_prompt_bucket,
                "prefix_len": 0,
                "cache_slots": sched.cache_len,
                "decode_kernel": bool(self.engine.config.use_decode_attention_kernel),
                "prefill_s": sched.last_seconds["prefill"],
                "decode_s": sched.last_seconds["decode"],
                "serving": stats.as_dict(),
            },
        )
        return [r.text if r.ok else None for r in results]
