"""Token samplers: greedy / temperature / top-k / top-p (counterpart of
``fairness_llm_tpu/runtime/sampling.py``).

Sampling is Gumbel-argmax over the filtered logits, as
``jax.random.categorical`` computes it. The noise comes from explicit per-row
``torch.Generator``s seeded from ``(row_seed, emitted)``, so a row's tokens
do not depend on which other prompts share the batch. The two frameworks'
generators give different numbers from one seed, so the sampler takes its
noise as an argument: tests hand both sides the same uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    temperature: float = 0.7
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def speculation_applicable(settings: SamplerSettings) -> bool:
    """Speculative decoding verifies drafts against greedy argmax, so it is
    exact only for temperature <= 0; sampled decode takes the plain path."""
    return settings.greedy


def greedy_accept_length(drafts: torch.Tensor, greedy: torch.Tensor) -> torch.Tensor:
    """[B] count of leading drafts accepted by speculative verification.

    ``drafts`` [B, k] are the proposed tokens; ``greedy`` [B, k] the model's
    argmax at each verify position (``greedy[:, i]`` is the token it would
    emit after input position i, the check for ``drafts[:, i]``). One
    mismatch rejects everything after it."""
    return torch.cumprod((drafts == greedy).long(), dim=1).sum(dim=1)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _mix64(x: int) -> int:
    """splitmix64 finaliser. The CPU generator keeps only the low 32 bits of
    its seed, so (row_seed, emitted) is mixed into all 64 before seeding."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def row_gumbel(row_seeds: Sequence[int], emitted: Sequence[int], vocab: int,
               device: torch.device, generators: Optional[List[torch.Generator]] = None
               ) -> torch.Tensor:
    """[B, vocab] Gumbel noise; row b draws from a generator seeded from
    ``(row_seeds[b], emitted[b])``, the counterpart of the reference's
    ``fold_in(key(row_seed), emitted)`` stream. ``generators`` (one per row)
    are reseeded and reused when given."""
    rows = []
    for b, (seed, n) in enumerate(zip(row_seeds, emitted)):
        gen = generators[b] if generators is not None else torch.Generator(device=device)
        gen.manual_seed(_mix64((int(seed) & 0xFFFFFFFF) << 32 | (int(n) & 0xFFFFFFFF)))
        rows.append(torch.rand(vocab, generator=gen, device=device))
    return gumbel_from_uniform(torch.stack(rows))


def make_sampler(settings: SamplerSettings) -> Callable[..., torch.Tensor]:
    """Build ``sample(logits[B, V], gumbel[B, V] | None) -> tokens[B]``.
    Greedy ignores the noise."""
    if settings.greedy:
        return lambda logits, gumbel=None: torch.argmax(logits, dim=-1)

    def sample(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
        return torch.argmax(filtered_logits(settings, logits) + gumbel, dim=-1)

    return sample


def filtered_logits(settings: SamplerSettings, logits: torch.Tensor) -> torch.Tensor:
    """Temperature-scale then top-k/top-p filter (-inf on dropped tokens),
    with the reference's two pinned conventions:

    - top-k ties at the k-th logit: ALL tokens tying the k-th value survive.
    - top-p boundary: the token whose probability crosses the threshold
      stays (exclusive-cumsum test); tokens value-tied with the boundary
      token all stay.
    """
    x = logits.float() / settings.temperature
    neg_inf = torch.tensor(-float("inf"), device=x.device)
    if settings.top_k > 0:
        k = min(settings.top_k, x.shape[-1])
        kth = torch.topk(x, k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg_inf, x)
    if settings.top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < settings.top_p
        cutoff = torch.where(keep_sorted, sorted_x,
                             torch.tensor(float("inf"), device=x.device)
                             ).amin(dim=-1, keepdim=True)
        x = torch.where(x < cutoff, neg_inf, x)
    return x
