"""Prompt-lookup drafting for speculative decoding (counterpart of
``fairness_llm_tpu/runtime/speculative.py``).

Instead of a draft model, match the last ``n`` tokens of a row's history
against the row's own prompt and output, and propose the ``k`` tokens that
followed the match. The engine verifies all ``k + 1`` positions (the greedy
next token and the drafts) in one forward and keeps the longest prefix that
matches greedy argmax, so the tokens equal plain greedy decode by
construction; the drafts decide only how many tokens a step yields.

``ngram_draft`` runs as tensor ops on the context's device, at fixed
shapes, with no host round trip.
"""

from __future__ import annotations

import torch

from fairness_llm_tpu_torch.config import SpeculationConfig

__all__ = ["SpeculationConfig", "ngram_draft"]


def _shift_right(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x [B, C] moved ``shift`` places along C, False filling the front."""
    return torch.cat([torch.zeros_like(x[:, :shift]), x[:, :x.shape[1] - shift]], dim=1)


def ngram_draft(ctx: torch.Tensor, ctx_valid: torch.Tensor, hist_end: torch.Tensor,
                draft_len: int, ngram_max: int, pad_id: int) -> torch.Tensor:
    """[B, draft_len] drafts by suffix n-gram lookup.

    ``ctx`` [B, C] holds each row's tokens (prompt layout and output, pad
    gaps anywhere), ``ctx_valid`` [B, C] where they are real, ``hist_end``
    [B] one past each row's last history token. For each row: take the last
    ``n`` history tokens, find the EARLIEST other window of n valid history
    tokens equal to them, and return the tokens that followed it. The
    longest n (``ngram_max``) is tried first, then shorter ones. A window
    that touches an invalid position never matches; a row with no match,
    and a draft past the history or on a pad, gets ``pad_id``.
    """
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    if ngram_max < 1:
        raise ValueError(f"ngram_max must be >= 1, got {ngram_max}")
    B, C = ctx.shape
    dev = ctx.device
    hist_end = hist_end.long()
    pos = torch.arange(C, device=dev)[None, :]
    hist_valid = ctx_valid.bool() & (pos < hist_end[:, None])

    best_end = torch.full((B,), C, dtype=torch.long, device=dev)  # match-window end
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    for n in range(ngram_max, 0, -1):
        # The row's suffix: history positions hist_end-n .. hist_end-1.
        idx = hist_end[:, None] - n + torch.arange(n, device=dev)[None, :]
        safe = idx.clamp(0, C - 1)
        suf = ctx.gather(1, safe)
        suf_ok = ((idx >= 0) & hist_valid.gather(1, safe)).all(dim=1)
        # match[b, p]: the n valid history tokens ending at p equal the suffix.
        match = torch.ones(B, C, dtype=torch.bool, device=dev)
        for i in range(n):
            eq = (ctx == suf[:, i:i + 1]) & hist_valid
            shift = n - 1 - i  # window token i sits at p - shift
            match &= _shift_right(eq, shift) if shift else eq
        # Not the suffix's own end (the trivial self-match).
        match &= pos <= hist_end[:, None] - 2
        match &= suf_ok[:, None]
        m_end = torch.where(match, pos, torch.full_like(pos, C)).amin(dim=1)  # earliest
        newly = (m_end < C) & ~found
        best_end = torch.where(newly, m_end, best_end)
        found = found | (m_end < C)

    didx = best_end[:, None] + 1 + torch.arange(draft_len, device=dev)[None, :]
    safe_d = didx.clamp(0, C - 1)
    drafts = ctx.gather(1, safe_d)
    ok = found[:, None] & (didx < C) & hist_valid.gather(1, safe_d)
    return torch.where(ok, drafts, torch.full_like(drafts, pad_id))
