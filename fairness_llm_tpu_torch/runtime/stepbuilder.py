"""The engine's decode programs as plain functions (counterpart of
``fairness_llm_tpu/runtime/stepbuilder.py``: ``make_batch_entry``,
``make_greedy_loop``, ``build_engine_decode`` and ``build_prefix``).

PyTorch runs eagerly, so the reference's compiled ``while_loop`` becomes a
Python loop that stops once every live row is done. Each step reads the new
tokens back to the host (a few bytes) to decide that, and to advance each
row's ``(row_seed, emitted)`` sampling stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fairness_llm_tpu_torch.models.transformer import init_cache
from fairness_llm_tpu_torch.runtime.sampling import (
    SamplerSettings,
    make_sampler,
    row_gumbel,
)

SharedLayers = Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def _live_finite(logits: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Device bool: every logit of a live row is finite (no host sync)."""
    return (torch.isfinite(logits) | ~live[:, None]).all()


def make_batch_entry(cfg, model, *, batch: int, cache_len: int, prefix_len: int = 0):
    """The left-padded batch prefill: positions from the valid cumsum
    (prefix-offset, pad slots clamped), a fresh cache of ``cache_len`` slots,
    one forward with ``last_only`` logits. Returns ``entry(tokens, valid,
    shared_layers) -> (last_logits [B, V], cache)``."""

    def entry(tokens, valid, shared_layers: SharedLayers):
        positions = prefix_len + (torch.cumsum(valid.long(), dim=1) - 1).clamp_min(0)
        cache = init_cache(cfg, batch, cache_len, device=tokens.device)
        logits, cache = model(tokens, positions, valid, cache, left_padded=True,
                              last_only=True, shared_layers=shared_layers)
        return logits[:, -1, :], cache

    return entry


def make_greedy_loop(model, sample, pad_id: int, eos_id: int, *, batch: int,
                     steps: int, prefix_len: int = 0, greedy: bool = True):
    """The decode loop. Per iteration: sample from the carried logits with
    the row's own ``(row_seed, emitted)`` stream, record the token, forward
    one token under the row's live mask, carry the new logits, advance
    ``emitted``/``done`` (EOS or the cap of ``steps``). Stops when every live
    row is done.

    Returns ``loop(cache, prev_logits, row_seeds, live0, shared_layers) ->
    (toks [batch, steps] int32 numpy, steps_run, logits_finite)``.
    ``logits_finite`` says whether every logit a live row sampled from was
    finite."""
    B, T = batch, steps

    def loop(cache, prev_logits, row_seeds: Sequence[int], live0: np.ndarray,
             shared_layers: SharedLayers):
        dev = prev_logits.device
        toks = np.full((B, T), pad_id, np.int32)
        done = ~live0
        emitted = np.zeros(B, np.int64)
        gens: List[torch.Generator] = [] if greedy else [
            torch.Generator(device=dev) for _ in range(B)]
        finite = _live_finite(prev_logits, torch.from_numpy(live0).to(dev))
        t = 0
        while t < T and not done.all():
            live = ~done
            live_dev = torch.from_numpy(live).to(dev)
            gumbel = None if greedy else row_gumbel(
                row_seeds, emitted, prev_logits.shape[-1], dev, gens)
            tok = sample(prev_logits, gumbel)
            tok = torch.where(live_dev, tok, torch.full_like(tok, pad_id))
            pos = prefix_len + cache.lengths[:, None]
            logits, cache = model(tok[:, None], pos, live_dev[:, None], cache,
                                  shared_layers=shared_layers)
            prev_logits = torch.where(live_dev[:, None], logits[:, -1, :], prev_logits)
            finite = finite & _live_finite(logits[:, -1], live_dev)
            tok_host = tok.cpu().numpy()
            toks[:, t] = tok_host
            emitted += live
            done = done | (tok_host == eos_id) | (emitted >= T)
            t += 1
        return toks, t, bool(finite)

    return loop


def build_engine_decode(cfg, model, sampler: SamplerSettings, pad_id: int,
                        eos_id: int, *, batch: int, prompt_len: int, max_new: int,
                        prefix_len: int):
    """Batch entry + the decode loop with a uniform cap of ``max_new``.
    Returns ``(entry, loop)``: the engine times the two apart."""
    entry = make_batch_entry(cfg, model, batch=batch, cache_len=prompt_len + max_new,
                             prefix_len=prefix_len)
    loop = make_greedy_loop(model, make_sampler(sampler), pad_id, eos_id,
                            batch=batch, steps=max_new, prefix_len=prefix_len,
                            greedy=sampler.greedy)
    return entry, loop


def build_prefix(cfg, model, *, prefix_len: int):
    """Forward over the shared prompt prefix [1, Pc] -> per-layer (k, v)
    tensors [Pc, Hkv, D] that every batch row reads (but never copies)."""

    def run(tokens):
        positions = torch.arange(prefix_len, device=tokens.device)[None, :]
        cache = init_cache(cfg, 1, prefix_len, device=tokens.device)
        valid = torch.ones((1, prefix_len), dtype=torch.bool, device=tokens.device)
        model(tokens, positions, valid, cache, left_padded=True, last_only=True)
        return [(layer.k[0], layer.v[0]) for layer in cache.layers]

    return run
