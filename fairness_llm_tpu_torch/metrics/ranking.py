"""Ranking-quality metrics (counterpart of
``fairness_llm_tpu/metrics/ranking.py``): NDCG, precision and recall at k,
F1 and catalog coverage. ``ndcg_kernel`` is a plain torch function on
float32 tensors, as the reference's is a jnp one."""

from __future__ import annotations

from typing import Dict, Sequence, Set

import numpy as np
import torch


def ndcg_kernel(relevances: torch.Tensor, ideal_relevances: torch.Tensor) -> torch.Tensor:
    """DCG(rel) / DCG(ideal) with rel_i / log2(i + 2) discounting; 0 when
    the ideal DCG is 0."""
    positions = torch.arange(relevances.shape[0], dtype=torch.float32,
                             device=relevances.device)
    discount = 1.0 / torch.log2(positions + 2.0)
    dcg = torch.sum(relevances * discount)
    idcg = torch.sum(ideal_relevances * discount)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-30), torch.zeros_like(dcg))


def ndcg(rankings: Sequence[str], ground_truth: Dict[str, float], k: int = 10) -> float:
    rels = np.array([ground_truth.get(item, 0.0) for item in rankings[:k]], dtype=np.float32)
    ideal = np.array(sorted(ground_truth.values(), reverse=True)[:k], dtype=np.float32)
    n = max(len(rels), len(ideal), 1)
    rels = np.pad(rels, (0, n - len(rels)))
    ideal = np.pad(ideal, (0, n - len(ideal)))
    return float(ndcg_kernel(torch.from_numpy(rels), torch.from_numpy(ideal)))


def precision_at_k(recommendations: Sequence[str], relevant_items: Set[str], k: int = 10) -> float:
    top_k = set(recommendations[:k])
    return len(top_k & relevant_items) / k if k > 0 else 0.0


def recall_at_k(recommendations: Sequence[str], relevant_items: Set[str], k: int = 10) -> float:
    top_k = set(recommendations[:k])
    return len(top_k & relevant_items) / len(relevant_items) if relevant_items else 0.0


def f1_score(precision: float, recall: float) -> float:
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def catalog_coverage(all_recommendations: Sequence[Sequence[str]], catalog_size: int) -> float:
    unique = {item for recs in all_recommendations for item in recs}
    return len(unique) / catalog_size * 100 if catalog_size > 0 else 0.0
