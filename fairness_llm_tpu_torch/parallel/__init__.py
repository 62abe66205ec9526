"""The ranks' mesh and the sharding rules (counterpart of
``fairness_llm_tpu/parallel/``): a ``("dp", "tp", "sp")``
``torch.distributed`` device mesh over one process a rank, the reference's
logical-axis rules, and the per-device byte counts. The collectives are
written out where they run (``runtime/engine.py``, ``runtime/scoring.py``,
``metrics/sharded.py``); ``parallel/multihost.py`` joins the process
group from ``torchrun``'s environment."""

from fairness_llm_tpu_torch.parallel.sharding import (
    batch_sharding,
    kv_heads_sharded,
    kv_tree_shardings,
    logits_sharding,
    make_axis_rules,
    make_mesh,
    param_shardings,
    per_device_kv_cache_bytes,
    per_device_param_bytes,
    shard_params,
)

__all__ = [
    "make_mesh",
    "make_axis_rules",
    "param_shardings",
    "shard_params",
    "batch_sharding",
    "kv_heads_sharded",
    "kv_tree_shardings",
    "logits_sharding",
    "per_device_param_bytes",
    "per_device_kv_cache_bytes",
]
