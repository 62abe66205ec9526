"""Batched sequence scoring: per-token log-likelihoods under a model
(counterpart of ``fairness_llm_tpu/runtime/scoring.py``).

The decode engine answers "what would the model say"; scoring answers "how
likely is this text". Phase 2 ranks items by it and reports corpus
perplexity; phase 3's ``model`` and ``model-conditional`` calibrations take
their confidences from it.

One teacher-forced forward per chunk of rows: the rows left-padded to a
bucketed [batch, s], ``Transformer.forward(tokens, positions, valid,
left_padded=True)`` with no cache and full logits (so K1 runs over whole
rows and, with int8 weights, the K4 GEMM computes the lm_head at M = batch
x s with an f32 output), then the target logit gathered and ``logsumexp``
taken over the vocabulary, with no ``log_softmax`` copy of the logits.

On an engine with a dp mesh each rank forwards its contiguous block of a
chunk's rows (``parallel.batch_sharding``; the chunk bucketed to a dp
multiple) and the per-row sums are all-gathered over the dp group, so
every rank returns every row's scores; the logits budget is per device.

On an engine with an sp mesh (A8(b)) each sp rank forwards its contiguous
block of the bucketed sequence (the bucket a multiple of sp, left-padded
further where it is not) with ring attention over the sp group
(``parallel/ring.py``; the model attends through the ring whenever it has
an sp group and no cache), scores the targets of its block's positions,
and the per-row sums are all-reduced over the sp group: the reference's
sequence-sharded forward, with the collectives written out.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Sequence

import numpy as np
import torch

from fairness_llm_tpu_torch.parallel.sharding import (
    axis_group,
    axis_rank,
    axis_size,
    batch_sharding,
    gather_rows,
)
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine, _bucket_batch, _bucket_len

logger = logging.getLogger(__name__)

# Cap on the [batch, s, vocab] f32 logits one scoring forward may hold;
# larger sweeps halve and recurse. The reference's value, so the chunks are
# the reference's; module-level so tests can shrink it.
LOGITS_BUDGET_BYTES = 4e9


@dataclasses.dataclass
class ScoreOutput:
    log_likelihoods: np.ndarray  # [N] sum log p(token | prefix) over scored tokens
    token_counts: np.ndarray  # [N] number of scored tokens
    mean_logprobs: np.ndarray  # [N] log_likelihood / token_count


def _score_batch(
    engine: DecodeEngine, texts: Sequence[str], prefix_counts: np.ndarray
) -> ScoreOutput:
    """Encode and left-truncate ``texts``, then score them. The first
    ``prefix_counts[i]`` real tokens of row i are conditioning context:
    their log-probabilities are left out."""
    tb = engine.tokenizer.encode_batch(texts)
    max_len = engine.config.max_seq_len
    if tb.tokens.shape[1] > max_len:
        # Position tables hold max_seq_len slots: keep each row's most recent
        # tokens, as the decode path does.
        logger.warning("scoring texts longer than max_seq_len=%d; left-truncating", max_len)
        # Truncation drops the earliest tokens, the prefix first: shrink each
        # row's prefix count by what was dropped (positions restart at 0
        # inside the kept window).
        orig_lens = tb.valid.sum(axis=1)
        tb = engine.tokenizer.encode_batch(texts, max_len=max_len)
        dropped = np.maximum(orig_lens - tb.valid.sum(axis=1), 0)
        prefix_counts = np.maximum(prefix_counts - dropped, 0)
    # Encoded and adjusted once; chunks are cut from the encoded rows.
    return _score_encoded(engine, tb.tokens, tb.valid, np.asarray(prefix_counts))


def _score_encoded(
    engine: DecodeEngine, row_tokens: np.ndarray, row_valid: np.ndarray,
    prefix_counts: np.ndarray,
) -> ScoreOutput:
    """Forward and reduce over encoded rows, halving while the logits would
    exceed ``LOGITS_BUDGET_BYTES``."""
    n = len(row_tokens)
    # Drop the columns that are padding in every row, so that a chunk of
    # short rows buckets to its own length.
    lead = int(np.argmax(row_valid.any(axis=0))) if row_valid.any() else 0
    row_tokens, row_valid = row_tokens[:, lead:], row_valid[:, lead:]
    s = min(_bucket_len(max(row_tokens.shape[1], 1), engine.seq_bucket),
            engine.config.max_seq_len)
    batch = _bucket_batch(n, engine.mesh)
    # The budget is a device's: each holds its dp share of the rows.
    logits_bytes = batch * s * engine.config.vocab_size * 4 // axis_size(engine.mesh, "dp")
    if logits_bytes > LOGITS_BUDGET_BYTES and n <= 8:
        # Rows are the only axis that chunks: a few long rows over a large
        # vocabulary can pass the budget with nothing left to halve.
        logger.warning(
            "scoring %d row(s) of bucketed length %d x vocab %d needs ~%.1f GB "
            "of logits (> %.1f GB budget) and cannot chunk further on the "
            "batch axis — may OOM; shorten rows or reduce max_seq_len",
            n, s, engine.config.vocab_size, logits_bytes / 1e9,
            LOGITS_BUDGET_BYTES / 1e9,
        )
    if logits_bytes > LOGITS_BUDGET_BYTES and n > 8:
        half = n // 2
        a = _score_encoded(engine, row_tokens[:half], row_valid[:half], prefix_counts[:half])
        b = _score_encoded(engine, row_tokens[half:], row_valid[half:], prefix_counts[half:])
        return ScoreOutput(
            log_likelihoods=np.concatenate([a.log_likelihoods, b.log_likelihoods]),
            token_counts=np.concatenate([a.token_counts, b.token_counts]),
            mean_logprobs=np.concatenate([a.mean_logprobs, b.mean_logprobs]),
        )
    # Rows past n pad the batch to its bucket: they hold no valid token.
    tokens = np.full((batch, s), engine.tokenizer.pad_id, dtype=np.int64)
    valid = np.zeros((batch, s), dtype=bool)
    prefixes = np.zeros((batch,), dtype=np.int64)
    w = row_tokens.shape[1]
    tokens[:n, s - w:] = row_tokens
    valid[:n, s - w:] = row_valid
    prefixes[:n] = prefix_counts
    mine = batch_sharding(engine.mesh, batch)
    ll, counts = _forward(engine, torch.from_numpy(tokens[mine]).to(engine.device),
                          torch.from_numpy(valid[mine]).to(engine.device),
                          torch.from_numpy(prefixes[mine]).to(engine.device))
    if axis_size(engine.mesh, "dp") > 1:
        ll = gather_rows(engine.mesh, ll, engine.device)
        counts = gather_rows(engine.mesh, counts, engine.device)
    ll = ll[:n].cpu().numpy()
    counts = counts[:n].cpu().numpy()
    return ScoreOutput(
        log_likelihoods=ll,
        token_counts=counts,
        mean_logprobs=np.where(counts > 0, ll / np.maximum(counts, 1), 0.0),
    )


def _forward(engine: DecodeEngine, tokens: torch.Tensor, valid: torch.Tensor,
             prefixes: torch.Tensor):
    """One teacher-forced forward over [batch, s]: each row's summed
    log-probability of its scored targets (f32) and their count. Under an
    sp mesh, this rank's block of the sequence (see the module
    docstring)."""
    sp = axis_size(engine.mesh, "sp")
    if sp > 1 and tokens.shape[1] % sp:
        pad = sp - tokens.shape[1] % sp
        tokens = torch.nn.functional.pad(tokens, (pad, 0), value=engine.tokenizer.pad_id)
        valid = torch.nn.functional.pad(valid, (pad, 0), value=False)
    positions = torch.clamp(torch.cumsum(valid.long(), dim=1) - 1, min=0)
    s = tokens.shape[1]
    lo, hi = 0, s
    if sp > 1:
        lo = axis_rank(engine.mesh, "sp") * (s // sp)
        hi = lo + s // sp
    # The whole bucketed length runs (this rank's block of it); position t
    # predicts token t + 1, the last position nothing.
    logits, _ = engine.model(tokens[:, lo:hi], positions[:, lo:hi], valid[:, lo:hi],
                             left_padded=True)
    end = min(hi, s - 1)
    lg = logits[:, :end - lo]
    targets = tokens[:, lo + 1:end + 1]
    # Targets that are real tokens past the row's prefix.
    tvalid = (valid[:, lo:end] & valid[:, lo + 1:end + 1]
              & (positions[:, lo + 1:end + 1] >= prefixes[:, None]))
    picked_logit = torch.gather(lg, -1, targets[..., None])[..., 0]
    lse = torch.logsumexp(lg, dim=-1)
    # where, not a product: a row with no valid token must not add NaN * 0
    picked = torch.where(tvalid, picked_logit - lse, torch.zeros_like(lse))
    ll, counts = picked.sum(dim=1), tvalid.sum(dim=1)
    if sp > 1:
        import torch.distributed as dist

        both = torch.stack([ll.double(), counts.double()])
        dist.all_reduce(both, group=axis_group(engine.mesh, "sp"))
        ll, counts = both[0].float(), both[1].long()
    return ll, counts


def score_texts(engine: DecodeEngine, texts: Sequence[str], seed: int = 0) -> ScoreOutput:
    """Score each text's tokens under the engine's model (teacher-forced).
    ``seed`` is accepted as the reference's is; scoring is deterministic."""
    return _score_batch(engine, texts, np.zeros(len(texts), dtype=np.int64))


def score_prompted_continuations(
    engine: DecodeEngine, prompts: Sequence[str], continuations: Sequence[str]
) -> ScoreOutput:
    """Row i scores log p(continuations[i] | prompts[i]); all rows in one
    sweep of chunked forwards."""
    if len(prompts) != len(continuations):
        raise ValueError("prompts and continuations must align")
    # Sweeps repeat a few prompts over many rows: encode each once.
    plen: Dict[str, int] = {}
    for p in prompts:
        if p not in plen:
            plen[p] = len(engine.tokenizer.encode(p))
    prefix_counts = np.array([plen[p] for p in prompts], dtype=np.int64)
    texts = [p + c for p, c in zip(prompts, continuations)]
    return _score_batch(engine, texts, prefix_counts)


def score_continuations(
    engine: DecodeEngine, prompt: str, continuations: Sequence[str]
) -> ScoreOutput:
    """log p(continuation | prompt) for each continuation. Only tokens whose
    real-token index is at least the prompt's token count are scored, so
    ``log p(prompt + c) = log p(prompt) + score_continuations(...)`` holds
    where concatenation composes token by token (the byte tokenizer; BPE may
    merge across the boundary). Rows longer than max_seq_len lose the prompt
    first, and the boundary moves with it."""
    prefix_len = len(engine.tokenizer.encode(prompt))
    texts = [prompt + c for c in continuations]
    return _score_batch(engine, texts, np.full(len(texts), prefix_len, dtype=np.int64))


def perplexity_by_model(
    engines: Dict[str, DecodeEngine], texts: Sequence[str]
) -> Dict[str, float]:
    """Corpus perplexity per model."""
    out = {}
    for name, engine in engines.items():
        sc = score_texts(engine, texts)
        total_lp = float(sc.log_likelihoods.sum())
        total_tok = int(sc.token_counts.sum())
        out[name] = float(np.exp(-total_lp / max(total_tok, 1)))
    return out
