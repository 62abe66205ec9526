"""FACTER post-processing: conformal filtering and balanced re-ranking
(counterpart of ``fairness_llm_tpu/pipeline/facter.py``).

The reference writes the math as fixed-shape ``jax.jit`` functions over
interned item ids; here ``conformal_thresholds_kernel``,
``conformal_filter_mask`` and ``balanced_rerank_kernel`` are the same
functions as plain torch ops, and the calibration helpers stay numpy.

Semantics:
- calibration: simulated confidence ``1 - 0.05*rank``, simulated actual =
  clip(conf + N(0, 0.1), 0, 1), nonconformity = |conf - actual|, seeded;
- per-group conformal threshold: the sorted nonconformity at index
  ceil((n+1)(1-alpha)) - 1 (computed in float32, as the reference does),
  clamped; an empty group gets 0.5;
- filtering keeps items with confidence >= the group's threshold, with a
  floor of 3;
- smart balance: items recommended to both groups with a cross-group count
  ratio > 0.5 are "balanced" (> 0.3 when fewer than 20 qualify); each list
  is rebuilt balanced first, then its own items, then balanced backfill,
  capped at 10.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fairness_llm_tpu_torch.metrics.encode import (
    PAD,
    Vocab,
    count_matrix,
    encode_rec_lists,
    one_hot_membership,
)

# ---------------------------------------------------------------------------
# Conformal prediction
# ---------------------------------------------------------------------------


def simulate_calibration(
    num_items_per_profile: Sequence[int], seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-record (confidence, nonconformity) of the flattened (profile,
    rank) calibration set."""
    ranks = (
        np.concatenate([np.arange(n) for n in num_items_per_profile])
        if len(num_items_per_profile)
        else np.zeros(0)
    )
    conf = 1.0 - 0.05 * ranks
    return conf.astype(np.float32), nonconformity_from_confidence(conf, seed)


def nonconformity_from_confidence(conf: np.ndarray, seed: int) -> np.ndarray:
    """|conf - simulated actual| with seeded N(0, 0.1) noise, for both
    calibration modes (neither has ground truth)."""
    rng = np.random.default_rng(seed)
    actual = np.clip(conf + rng.normal(0.0, 0.1, size=conf.shape), 0.0, 1.0)
    return np.abs(conf - actual).astype(np.float32)


def model_confidences(
    mean_logprobs: np.ndarray, mapping: str = "percentile", temperature: float = 1.0
) -> np.ndarray:
    """Map per-title mean log-probabilities onto the [0, 1] scale the
    conformal thresholds live on.

    ``"percentile"``: the title at global rank r of n gets r / (n - 1)
    (ties in stable-argsort order). ``"probability"``: ``exp(mean_logprob /
    temperature)``, min-max normalised over the batch (0.5 everywhere when
    they are all equal)."""
    lp = np.asarray(mean_logprobs, np.float64)
    if lp.size == 0:
        return np.zeros(0, np.float32)
    if mapping == "percentile":
        order = np.argsort(np.argsort(lp, kind="stable"), kind="stable")
        return (order / max(lp.size - 1, 1)).astype(np.float32)
    if mapping == "probability":
        if temperature <= 0:
            raise ValueError("temperature must be positive")
        p = np.exp(lp / temperature)
        lo, hi = p.min(), p.max()
        if hi - lo < 1e-12:
            return np.full(lp.shape, 0.5, np.float32)
        return ((p - lo) / (hi - lo)).astype(np.float32)
    raise ValueError(f"unknown confidence mapping '{mapping}' (percentile|probability)")


def conformal_thresholds_kernel(
    nonconformity: torch.Tensor,  # [N] float32
    group_ids: torch.Tensor,  # [N] int
    num_groups: int,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Per-group (1 - alpha) conformal quantile of the nonconformity scores
    -> [G] float32. Each group sorts the whole [N] vector with the other
    groups' entries at +inf and takes its own clamped quantile index."""
    dev = nonconformity.device
    onehot = group_ids.long()[None, :] == torch.arange(num_groups, device=dev)[:, None]
    inf = torch.full((), float("inf"), dtype=nonconformity.dtype, device=dev)
    sorted_scores = torch.sort(torch.where(onehot, nonconformity[None, :], inf), dim=-1).values
    n_g = onehot.sum(dim=-1)  # [G]
    # float32, as the reference: float64 can move the index at a boundary
    level = 1.0 - torch.tensor(alpha, dtype=torch.float32, device=dev)
    idx = torch.ceil((n_g + 1).to(torch.float32) * level).long() - 1
    idx = torch.minimum(torch.clamp(idx, min=0), torch.clamp(n_g - 1, min=0))
    if sorted_scores.shape[1] == 0:
        got = torch.zeros(num_groups, dtype=nonconformity.dtype, device=dev)
    else:
        got = torch.gather(sorted_scores, 1, idx[:, None])[:, 0]
    return torch.where(n_g > 0, got, torch.full_like(got, 0.5))


def conformal_filter_mask(
    confidences: torch.Tensor,  # [N, K] float32, NaN-padded
    thresholds: torch.Tensor,  # [N] per-profile (group) thresholds
    floor: int = 3,
) -> torch.Tensor:
    """Keep items whose confidence is at least the row's threshold; where
    fewer than ``floor`` survive, keep the ``floor`` most confident instead
    (ties in their order in the row; a row shorter than ``floor`` keeps all
    of it). For confidences that need not fall with rank, as model-derived
    ones. -> [N, K] bool."""
    valid = ~torch.isnan(confidences)
    conf = torch.where(valid, confidences, torch.full_like(confidences, float("-inf")))
    keep = valid & (conf >= thresholds[:, None])
    n_keep = keep.sum(dim=1)
    order = torch.argsort(-conf, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)  # each item's rank by confidence
    top_floor = valid & (ranks < floor)
    use_floor = n_keep < floor
    return torch.where(use_floor[:, None], top_floor, keep)


def conformal_keep_counts(
    list_lengths: np.ndarray, thresholds_per_profile: np.ndarray
) -> np.ndarray:
    """How many leading items each profile keeps under the simulated
    confidence ``1 - 0.05*rank``, which falls with rank, so the filter keeps
    a prefix (at least 3 where the list had 3)."""
    # 1 - 0.05*r >= t  <=>  r <= (1-t)/0.05; the epsilon absorbs (1-0.8)/0.05
    # evaluating to 3.999...
    max_rank = np.floor((1.0 - thresholds_per_profile) / 0.05 + 1e-9).astype(np.int64) + 1
    keep = np.minimum(np.maximum(max_rank, 0), list_lengths)
    floor = np.minimum(list_lengths, 3)
    return np.where(keep < 3, floor, keep)


# ---------------------------------------------------------------------------
# Balanced re-ranking ("smart_balance")
# ---------------------------------------------------------------------------


def balanced_rerank_kernel(
    rows: torch.Tensor,  # [N, K] item ids, PAD = -1
    counts_g1: torch.Tensor,  # [V] float32
    counts_g2: torch.Tensor,  # [V] float32
    top_k: int = 10,
    threshold: float = 0.5,
    relaxed_threshold: float = 0.3,
    relax_below: int = 20,
    backfill_first: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rebuild each row: its balanced items first (in their order), then, in
    the "smart" order, the rest of the row and then balanced backfill; the
    "aggressive" order (``backfill_first=True``) puts the backfill before
    the row's own unbalanced items. -> ([N, top_k] ids, balanced mask [V])."""
    dev = rows.device
    v = counts_g1.shape[0]
    f32 = counts_g1.dtype
    both = (counts_g1 > 0) & (counts_g2 > 0)
    ratio = torch.minimum(counts_g1, counts_g2) / torch.clamp(
        torch.maximum(counts_g1, counts_g2), min=1.0)
    strict = both & (ratio > torch.tensor(threshold, dtype=f32, device=dev))
    relaxed = both & (ratio > torch.tensor(relaxed_threshold, dtype=f32, device=dev))
    balanced = relaxed if int(strict.sum()) < relax_below else strict  # [V]

    n, k = rows.shape
    rows = rows.long()
    safe_rows = torch.clamp(rows, min=0)
    row_valid = rows != PAD
    row_balanced = balanced[safe_rows] & row_valid  # [N, K]

    # Sort keys over the row's own items: balanced first, stable by position.
    pos = torch.arange(k, device=dev)[None, :]
    own_rest_base = 2 * k + v if backfill_first else k
    own_key = torch.where(
        row_valid, torch.where(row_balanced, pos, own_rest_base + pos), 10 * k + v + pos)

    # Backfill candidates: every balanced item not already in the row.
    vocab_ids = torch.arange(v, device=dev)
    in_row = torch.zeros((n, v), dtype=torch.bool, device=dev)
    in_row[torch.arange(n, device=dev)[:, None].expand(n, k)[row_valid],
           safe_rows[row_valid]] = True
    backfill = balanced[None, :] & ~in_row  # [N, V]
    backfill_base = k if backfill_first else 2 * k
    backfill_key = torch.where(backfill, backfill_base + vocab_ids,
                               10 * k + 2 * v + vocab_ids)

    all_ids = torch.cat([rows, vocab_ids[None, :].expand(n, v)], dim=1)
    all_keys = torch.cat([own_key, backfill_key], dim=1)
    order = torch.argsort(all_keys, dim=1, stable=True)[:, :top_k]
    picked = torch.gather(all_ids, 1, order)
    picked_keys = torch.gather(all_keys, 1, order)
    # Valid keys are < 2k + v; both sentinels are >= 10k + v.
    picked = torch.where(picked_keys < 10 * k + v, picked, torch.full_like(picked, PAD))
    return picked, balanced


def smart_balance(
    recs_by_group: Dict[str, List[List[str]]],
    top_k: int = 10,
    aggressive: bool = False,
) -> Dict[str, List[List[str]]]:
    """Balance the first two groups' lists; pass the others through.

    ``aggressive``: the reference's harsher variant: threshold 0.3 with no
    relaxing, and cross-group backfill before the user's own unbalanced
    items."""
    groups = list(recs_by_group.keys())
    if len(groups) < 2:
        return recs_by_group
    g1, g2 = groups[0], groups[1]

    def _dedup(lists):  # the kernel keeps in-row duplicates; the reference dedupes
        return [list(dict.fromkeys(row)) for row in lists]

    vocab = Vocab()
    ids1, vocab = encode_rec_lists(_dedup(recs_by_group[g1]), vocab)
    ids2, vocab = encode_rec_lists(_dedup(recs_by_group[g2]), vocab)
    # One V over both groups (g1's rows were encoded before the vocab grew).
    v = len(vocab)
    c1 = count_matrix(ids1, v).sum(axis=0)
    c2 = count_matrix(ids2, v).sum(axis=0)

    kwargs = (
        dict(threshold=0.3, relaxed_threshold=0.3, relax_below=0, backfill_first=True)
        if aggressive
        else {}
    )
    out: Dict[str, List[List[str]]] = {}
    for g, ids in ((g1, ids1), (g2, ids2)):
        reranked, _ = balanced_rerank_kernel(
            torch.from_numpy(ids), torch.from_numpy(c1), torch.from_numpy(c2),
            top_k=top_k, **kwargs)
        out[g] = [[vocab.items[i] for i in row if i >= 0] for row in reranked.tolist()]
    for g in groups[2:]:
        out[g] = recs_by_group[g]
    return out


# ---------------------------------------------------------------------------
# Blended fairness score
# ---------------------------------------------------------------------------


def blended_group_fairness(recs_by_group: Dict[str, List[List[str]]]) -> float:
    """0.6 * mean pairwise cross-group Jaccard + 0.4 * the Jaccard of the
    two groups' unions (the reference study's final measure)."""
    groups = list(recs_by_group.keys())
    if len(groups) < 2:
        return 1.0
    g1, g2 = groups[0], groups[1]
    lists1, lists2 = recs_by_group[g1], recs_by_group[g2]
    if not lists1 or not lists2:
        return 0.0
    ids, vocab = encode_rec_lists(lists1 + lists2)
    member = one_hot_membership(ids, max(len(vocab), 1))
    m1, m2 = member[: len(lists1)], member[len(lists1):]

    inter = (m1[:, None, :] & m2[None, :, :]).sum(-1)
    union = (m1[:, None, :] | m2[None, :, :]).sum(-1)
    pair_j = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    u1, u2 = m1.any(0), m2.any(0)
    gu = (u1 | u2).sum()
    global_j = (u1 & u2).sum() / gu if gu > 0 else 0.0
    return float(0.6 * pair_j.mean() + 0.4 * global_j)
