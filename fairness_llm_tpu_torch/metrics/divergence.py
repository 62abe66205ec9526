"""Jensen-Shannon and Kullback-Leibler divergence on torch tensors (the
port's counterpart of ``fairness_llm_tpu/metrics/divergence.py``).

The reference's demographic parity uses ``scipy.spatial.distance.
jensenshannon``: the JS *distance* (square root of the divergence, natural
log). Over a pair of count vectors, the support is the union of the items
either side has; an item missing from one side counts ``EPS = 1e-10``
there, and both sides are renormalised over the support. Inputs are
float32, as the reference's kernels compute.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def _safe_xlogx_over_y(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """rel_entr(x, y) = x * log(x / y), with 0 * log(0 / y) = 0."""
    ratio = torch.where((x > 0) & (y > 0), x / torch.where(y > 0, y, torch.ones_like(y)),
                        torch.ones_like(x))
    return torch.where(x > 0, x * torch.log(ratio), torch.zeros_like(x))


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over probability vectors (natural log), inputs renormalised."""
    p = p / p.sum()
    q = q / q.sum()
    return _safe_xlogx_over_y(p, q).sum()


def js_distance(p_counts: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    """JS distance between count vectors over a shared vocabulary [..., V];
    leading axes broadcast."""
    support = (p_counts > 0) | (q_counts > 0)
    one = torch.ones((), dtype=p_counts.dtype, device=p_counts.device)
    eps = torch.full((), EPS, dtype=p_counts.dtype, device=p_counts.device)
    zero = torch.zeros((), dtype=p_counts.dtype, device=p_counts.device)
    p_tot = p_counts.sum(-1, keepdim=True)
    q_tot = q_counts.sum(-1, keepdim=True)
    p = torch.where(support, torch.where(p_counts > 0, p_counts / torch.maximum(p_tot, one), eps),
                    zero)
    q = torch.where(support, torch.where(q_counts > 0, q_counts / torch.maximum(q_tot, one), eps),
                    zero)
    p = p / p.sum(-1, keepdim=True)
    q = q / q.sum(-1, keepdim=True)
    m = 0.5 * (p + q)
    js_div = 0.5 * (_safe_xlogx_over_y(p, m).sum(-1) + _safe_xlogx_over_y(q, m).sum(-1))
    return torch.sqrt(torch.clamp_min(js_div, 0.0))


def pairwise_js_matrix(group_counts: torch.Tensor) -> torch.Tensor:
    """All-pairs JS distance over [G, V] group count rows -> [G, G]."""
    return js_distance(group_counts[:, None, :], group_counts[None, :, :])
