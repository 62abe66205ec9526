"""Fairness metric kernels and their wrappers (the port's counterpart of
``fairness_llm_tpu/metrics/fairness.py``).

Each metric has two faces:

- a ``*_kernel`` on fixed-shape tensors (counts, one-hot membership, id
  rows), in float32 as the reference's jitted kernels compute; plain torch
  ops, since the reference's are ``jnp`` functions and not Pallas kernels;
- a wrapper with the reference's dict-of-strings signature and its score
  and detail dict.

The wrappers intern on the host and reduce the [N, V] counts there by
default (CPU tensors: a few hundred titles wide); a dp-sharded study passes
``metrics/sharded.py``'s reduction as ``group_counts_fn``, and the kernels
then run where its [G, V] result lives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from fairness_llm_tpu_torch.metrics.divergence import pairwise_js_matrix
from fairness_llm_tpu_torch.metrics.encode import (
    Vocab,
    count_matrix,
    encode_rec_lists,
    one_hot_membership,
)

# ---------------------------------------------------------------------------
# Demographic parity: 1 - mean pairwise JS distance between group distributions
# ---------------------------------------------------------------------------


def demographic_parity_kernel(group_counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, V] per-group item counts -> (parity score, [G, G] JS matrix).
    Pairs where either group has no items are left out of the mean."""
    js = pairwise_js_matrix(group_counts)
    totals = group_counts.sum(-1)
    g = group_counts.shape[0]
    iu, ju = torch.triu_indices(g, g, offset=1, device=group_counts.device)
    valid = (totals[iu] > 0) & (totals[ju] > 0)
    n = valid.sum()
    pair_js = torch.where(valid, js[iu, ju], torch.zeros_like(js[iu, ju]))
    avg = pair_js.sum() / torch.clamp_min(n, 1)
    avg = torch.where(n > 0, avg, torch.zeros_like(avg))
    return 1.0 - avg, js


def _flatten_groups(recommendations_by_group, groups):
    """Per-profile rec rows and the index of the group that owns each."""
    flat: List[List[str]] = []
    owners: List[int] = []
    for gi, g in enumerate(groups):
        for recs in recommendations_by_group[g]:
            flat.append(list(recs))
            owners.append(gi)
    return flat, owners


def _group_counts(per_list: np.ndarray, owners: Sequence[int], num_groups: int) -> np.ndarray:
    """The default [N, V] per-list counts -> [G, V] per-group counts, on the
    host. The dp-sharded study swaps in ``metrics/sharded.py``'s reduction
    through the wrappers' ``group_counts_fn``; everything around it
    (interning, kernels, the detail dicts) is shared."""
    out = np.zeros((num_groups, per_list.shape[1]), dtype=np.float32)
    np.add.at(out, np.asarray(owners, np.int64), per_list)
    return out


def demographic_parity(recommendations_by_group: Dict[str, List[List[str]]],
                       group_counts_fn=None) -> Tuple[float, Dict]:
    """Group -> list of rec lists -> (score, {divergences, distributions,
    avg_divergence}). ``group_counts_fn(per_list [N, V], owners [N],
    num_groups) -> [G, V]`` (an array or a tensor) replaces the count
    reduction (``_group_counts``)."""
    groups = list(recommendations_by_group.keys())
    flat, owners = _flatten_groups(recommendations_by_group, groups)
    if not flat:
        # No comparable pairs: average divergence 0, parity 1.0.
        return 1.0, {"divergences": [], "distributions": {}, "avg_divergence": 0.0}
    ids, vocab = encode_rec_lists(flat)
    reduce = group_counts_fn or _group_counts
    counts = torch.as_tensor(reduce(count_matrix(ids, len(vocab)),
                                    np.asarray(owners, np.int32), len(groups)))
    score, js = demographic_parity_kernel(counts)
    # One host copy, for the detail dicts below.
    group_counts = counts.cpu().numpy()
    js = js.cpu().numpy()
    totals = group_counts.sum(axis=-1)
    divergences = []
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            if totals[i] > 0 and totals[j] > 0:
                divergences.append(float(js[i, j]))
    distributions = {}
    for gi, g in enumerate(groups):
        t = totals[gi]
        distributions[g] = (
            {vocab.items[v]: float(group_counts[gi, v] / t) for v in np.nonzero(group_counts[gi])[0]}
            if t > 0 else {}
        )
    avg = float(np.mean(divergences)) if divergences else 0.0
    return float(score), {
        "divergences": divergences,
        "distributions": distributions,
        "avg_divergence": avg,
    }


# ---------------------------------------------------------------------------
# Individual fairness: mean Jaccard over counterfactual profile pairs
# ---------------------------------------------------------------------------


def jaccard_pairs_kernel(membership: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """[P, V] bool membership + [M, 2] index pairs -> [M] Jaccard
    similarities; an empty-against-empty pair scores 1.0."""
    a = membership[pairs[:, 0]]
    b = membership[pairs[:, 1]]
    inter = (a & b).sum(-1)
    union = (a | b).sum(-1)
    return torch.where(union > 0, inter / torch.clamp_min(union, 1),
                       torch.ones((), dtype=torch.float32, device=membership.device))


def individual_fairness(
    profile_pairs: Sequence[Tuple[str, str]],
    recommendations: Dict[str, List[str]],
) -> Tuple[float, List[float]]:
    """(pid, pid) pairs + pid -> rec list -> (mean similarity, similarities)."""
    pids = list(recommendations.keys())
    pid_index = {p: i for i, p in enumerate(pids)}
    valid_pairs = [
        (pid_index[a], pid_index[b])
        for a, b in profile_pairs
        if a in pid_index and b in pid_index
    ]
    if not valid_pairs:
        return 0.0, []
    ids, vocab = encode_rec_lists([recommendations[p] for p in pids])
    membership = one_hot_membership(ids, max(len(vocab), 1))
    sims = jaccard_pairs_kernel(torch.from_numpy(membership),
                                torch.tensor(valid_pairs, dtype=torch.long))
    sims_list = [float(s) for s in sims.numpy()]
    return float(np.mean(sims_list)), sims_list


# ---------------------------------------------------------------------------
# Equal opportunity: 1 / (1 + var(per-group hit rate))
# ---------------------------------------------------------------------------


def equal_opportunity_kernel(
    group_counts: torch.Tensor, relevant_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, V] counts + [V] relevant mask -> (score, [G] per-group hit rates).
    Hit rate = |unique recommended ∩ relevant| / total recommended."""
    unique_hits = ((group_counts > 0) & relevant_mask[None, :]).sum(-1)
    totals = group_counts.sum(-1)
    rates = torch.where(totals > 0, unique_hits / torch.clamp_min(totals, 1.0),
                        torch.zeros_like(totals))
    variance = torch.var(rates, correction=0)
    return 1.0 / (1.0 + variance), rates


def equal_opportunity(
    recommendations_by_group: Dict[str, List[List[str]]],
    relevant_items: Set[str],
    group_counts_fn=None,
) -> Tuple[float, Dict[str, float]]:
    """Group -> list of rec lists + the relevant items -> (score, group ->
    hit rate); ``group_counts_fn`` as in ``demographic_parity`` (the hit
    rates need only the summed [G, V] counts)."""
    groups = list(recommendations_by_group.keys())
    if not groups:
        return 1.0, {}
    flat, owners = _flatten_groups(recommendations_by_group, groups)
    ids, vocab = encode_rec_lists(flat) if flat else (np.zeros((0, 1), np.int32), Vocab())
    for item in relevant_items:
        vocab.add(item)
    per_list = count_matrix(ids, len(vocab)) if flat else np.zeros((0, len(vocab)), np.float32)
    reduce = group_counts_fn or _group_counts
    counts = torch.as_tensor(reduce(per_list, np.asarray(owners, np.int32), len(groups)))
    relevant_mask = np.zeros(len(vocab), dtype=bool)
    for item in relevant_items:
        relevant_mask[vocab[item]] = True
    score, rates = equal_opportunity_kernel(counts,
                                            torch.from_numpy(relevant_mask).to(counts.device))
    return float(score), {g: float(r) for g, r in zip(groups, rates.cpu().numpy())}


# ---------------------------------------------------------------------------
# Exposure ratio: min/max of group-mean positional exposure 1/log2(pos+2)
# ---------------------------------------------------------------------------


def exposure_ratio_kernel(
    position_groups: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] group index per ranked position (PAD = -1 ignored) -> (ratio, [G]
    group means, NaN for a group with no position)."""
    n = position_groups.shape[0]
    dev = position_groups.device
    exposure = 1.0 / torch.log2(torch.arange(n, device=dev, dtype=torch.float32) + 2.0)
    valid = position_groups >= 0
    g = torch.where(valid, position_groups, torch.zeros_like(position_groups)).long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sums = torch.zeros(num_groups, dtype=torch.float32, device=dev).index_add_(
        0, g, torch.where(valid, exposure, zero))
    counts = torch.zeros(num_groups, dtype=torch.float32, device=dev).index_add_(
        0, g, valid.float())
    means = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                        torch.full_like(sums, float("nan")))
    present = counts > 0
    mx = torch.where(present, means, torch.full_like(means, -float("inf"))).max()
    mn = torch.where(present, means, torch.full_like(means, float("inf"))).min()
    ratio = torch.where((present.sum() > 0) & (mx > 0), mn / torch.clamp_min(mx, 1e-30),
                        torch.ones((), dtype=torch.float32, device=dev))
    return ratio, means


def exposure_ratio(
    ranked_groups: Sequence[str], group_order: Optional[List[str]] = None
) -> Tuple[float, Dict[str, float]]:
    """Group label per ranked position, top first -> (ratio, group -> mean
    exposure). Labels outside ``group_order`` are ignored."""
    if not ranked_groups:
        return 1.0, {}
    groups = group_order or sorted(set(ranked_groups))
    gidx = {g: i for i, g in enumerate(groups)}
    arr = np.array([gidx.get(g, -1) for g in ranked_groups], dtype=np.int64)
    ratio, means = exposure_ratio_kernel(torch.from_numpy(arr), len(groups))
    means = means.numpy()
    return float(ratio), {
        g: float(means[i]) for g, i in gidx.items() if not np.isnan(means[i])
    }


# ---------------------------------------------------------------------------
# SNSR / SNSV (Zhang et al., FaiRLLM): sensitive-to-neutral similarity range
# and spread
# ---------------------------------------------------------------------------


def snsr_snsv_kernel(
    neutral_membership: torch.Tensor, group_membership: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[V] neutral one-hot + [G, V] per-group one-hot -> (snsr, snsv, [G]
    sims): Jaccard of each group's recommendations against the neutral ones;
    SNSR = max - min, SNSV = population std over groups."""
    inter = (group_membership & neutral_membership[None, :]).sum(-1)
    union = (group_membership | neutral_membership[None, :]).sum(-1)
    sims = torch.where(union > 0, inter / torch.clamp_min(union, 1),
                       torch.ones((), dtype=torch.float32, device=group_membership.device))
    return sims.max() - sims.min(), torch.std(sims, correction=0), sims


def snsr_snsv(
    neutral_recs: List[str], recs_by_group: Dict[str, List[str]]
) -> Tuple[float, float, Dict[str, float]]:
    """SNSR/SNSV from a neutral rec list and per-sensitive-value rec lists."""
    groups = list(recs_by_group.keys())
    if not groups:
        return 0.0, 0.0, {}
    rows = [neutral_recs] + [recs_by_group[g] for g in groups]
    ids, vocab = encode_rec_lists(rows)
    membership = torch.from_numpy(one_hot_membership(ids, max(len(vocab), 1)))
    snsr, snsv, sims = snsr_snsv_kernel(membership[0], membership[1:])
    return float(snsr), float(snsv), {g: float(s) for g, s in zip(groups, sims.numpy())}
