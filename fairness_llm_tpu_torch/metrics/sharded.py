"""The fairness metrics' count reduction over a dp-sharded sweep
(counterpart of ``fairness_llm_tpu/metrics/sharded.py``).

Each rank holds a contiguous shard of the per-profile [N, V] count rows,
segment-sums it into [G, V] (``index_add_``) on its device and
``all_reduce``s the sum over the mesh's dp group, so every rank holds the
same group counts and runs the (tiny) divergence kernels itself. The
reference's ``psum`` inside a ``shard_map`` becomes that explicit
collective. Under gloo the sum travels through the CPU
(``multihost.collective_device``); the counts are whole numbers in
float32, so the result equals the host reduction exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from fairness_llm_tpu_torch.metrics.fairness import demographic_parity_kernel
from fairness_llm_tpu_torch.parallel.multihost import collective_device
from fairness_llm_tpu_torch.parallel.sharding import axis_group, axis_size, batch_sharding


def sharded_group_counts(mesh, per_profile_counts: torch.Tensor, group_ids: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """[N, V] per-profile counts (the whole sweep's, on every rank) -> [G, V]
    group counts, the same on every rank. This rank sums its contiguous
    ``N / dp`` rows; N must be a multiple of dp (``_pad_to_dp``)."""
    rows = batch_sharding(mesh, per_profile_counts.shape[0])
    counts = per_profile_counts[rows]
    local = torch.zeros((num_groups, counts.shape[1]), dtype=counts.dtype,
                        device=counts.device)
    local.index_add_(0, group_ids[rows].long(), counts)
    if axis_size(mesh, "dp") > 1:
        wire = local.to(collective_device(local.device))
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=axis_group(mesh, "dp"))
        local = wire.to(local.device)
    return local


def sharded_demographic_parity(mesh, per_profile_counts: torch.Tensor, group_ids: torch.Tensor,
                               num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Demographic parity with the group counts reduced over dp: (score,
    [G, G] JS matrix), the same on every rank."""
    return demographic_parity_kernel(
        sharded_group_counts(mesh, per_profile_counts, group_ids, num_groups))


def _pad_to_dp(mesh, counts: np.ndarray, owners: Sequence[int]):
    """Zero rows (owner 0, no counts: they add nothing) up to a dp
    multiple."""
    pad = (-counts.shape[0]) % axis_size(mesh, "dp")
    if pad:
        counts = np.concatenate([counts, np.zeros((pad, counts.shape[1]), counts.dtype)])
        owners = list(owners) + [0] * pad
    return counts, np.asarray(owners, np.int32)


def mesh_group_counts_fn(mesh, device: Optional[Union[str, torch.device]] = None):
    """A ``group_counts_fn`` for ``metrics.fairness`` that reduces [N, V] to
    [G, V] on ``device`` (default the CPU) over the mesh's dp group."""
    dev = torch.device(device or "cpu")

    def reduce(per_list: np.ndarray, owners: np.ndarray, num_groups: int) -> torch.Tensor:
        per_list, owners = _pad_to_dp(mesh, per_list, list(owners))
        return sharded_group_counts(mesh, torch.from_numpy(per_list).to(dev),
                                    torch.from_numpy(owners).to(dev), num_groups)

    return reduce


def demographic_parity_on_mesh(mesh, recommendations_by_group: Dict[str, List[List[str]]]
                               ) -> Tuple[float, Dict]:
    """``metrics.fairness.demographic_parity`` with the count reduction
    over dp."""
    from fairness_llm_tpu_torch.metrics.fairness import demographic_parity

    return demographic_parity(recommendations_by_group,
                              group_counts_fn=mesh_group_counts_fn(mesh))


def equal_opportunity_on_mesh(mesh, recommendations_by_group: Dict[str, List[List[str]]],
                              relevant_items: Set[str]) -> Tuple[float, Dict[str, float]]:
    """``metrics.fairness.equal_opportunity`` with the count reduction over
    dp."""
    from fairness_llm_tpu_torch.metrics.fairness import equal_opportunity

    return equal_opportunity(recommendations_by_group, relevant_items,
                             group_counts_fn=mesh_group_counts_fn(mesh))
