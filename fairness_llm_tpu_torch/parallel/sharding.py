"""The ranks' mesh and the sharding rules (counterpart of
``fairness_llm_tpu/parallel/sharding.py``).

The reference annotates every weight with logical axes ("embed",
"q_heads", "kv_heads", "ff", "vocab") and every activation with ("batch",
"seq", ...), maps them onto a ``("dp", "tp", "sp")`` ``jax.sharding.Mesh``
and lets GSPMD insert the collectives. The port runs one process a rank
and writes its collectives out with ``torch.distributed``: its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ``("dp", "tp",
"sp")`` over the world, in rank order.

The rules themselves are the reference's (``make_axis_rules``): "batch" to
"dp", "seq" to "sp", heads, MLP width and vocabulary to "tp" where they
divide it, "embed" replicated. ``param_shardings`` resolves each of the
port's parameter names (``runtime/weights``: the flax paths joined by dots,
in the same [in, out] layout) to a spec tuple, one mesh-axis name or None
per dimension. The byte counts (``per_device_param_bytes``,
``per_device_kv_cache_bytes``) take a ``MeshConfig`` or a mesh: they need
no world.

This slice runs ``dp`` only: ``shard_params`` places the parameters on the
rank's device (dp replicates them) and raises at tp > 1 (ROADMAP A5.5);
``batch_sharding`` is the rank's contiguous row slice of a batch bucketed
to a dp multiple, the reference's ``P("dp")`` layout.

Not ported, because the collectives are explicit: ``compat_shard_map``
(``jax.shard_map`` across jax versions), ``current_mesh`` (the mesh of the
enclosing ``with mesh:`` block) and ``resolve_logical_axis`` (a logical
axis under the enclosing flax rules). They exist for GSPMD's tracing; a
rank here knows its mesh and its slice directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from fairness_llm_tpu_torch.config import MeshConfig
from fairness_llm_tpu_torch.models.configs import ModelConfig

AxisRules = Tuple[Tuple[str, Optional[str]], ...]
Spec = Tuple[Optional[str], ...]
MeshLike = Union[MeshConfig, Any]  # a MeshConfig or a DeviceMesh


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a ``MeshConfig`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: Optional[MeshLike], axis: str) -> int:
    return 1 if mesh is None else mesh_shape(mesh).get(axis, 1)


def axis_group(mesh: Any, axis: str):
    """The process group of this rank's ``axis`` line."""
    return mesh.get_group(axis)


def make_mesh(mesh_config: MeshConfig):
    """A ``DeviceMesh`` with dims ``("dp", "tp", "sp")`` over the world, in
    rank order, of device type "cuda" under NCCL and "cpu" under gloo. The
    world must be exactly the mesh: launch ``mesh_config.num_devices`` ranks
    with ``torchrun`` (and ``parallel.multihost.initialize_distributed``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = mesh_config.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n or not dist.is_initialized():
        raise ValueError(
            f"mesh {mesh_config.shape} needs {n} ranks, have {world}: launch it with "
            f"torchrun --nproc-per-node {n} (one process a rank)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(mesh_config.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh_config.axis_names)


def make_axis_rules(model_config: ModelConfig, mesh: MeshLike) -> AxisRules:
    """Logical -> mesh axis rules, a mapping dropped where the size does not
    divide the mesh axis: heads shard at head granularity, and a GQA model
    with fewer KV heads than tp replicates its KV."""
    shape = mesh_shape(mesh)
    tp = shape.get("tp", 1)
    sp = shape.get("sp", 1)

    def fits(size: int) -> bool:
        return tp > 1 and size % tp == 0

    return (
        ("batch", "dp"),
        ("seq", "sp" if sp > 1 else None),
        ("embed", None),
        ("q_heads", "tp" if fits(model_config.num_heads) else None),
        ("kv_heads", "tp" if fits(model_config.num_kv_heads) else None),
        ("ff", "tp" if fits(model_config.d_ff) else None),
        ("vocab", "tp" if fits(model_config.vocab_size) else None),
    )


_PROJ_AXES = {
    "q_proj": ("embed", "q_heads"),
    "k_proj": ("embed", "kv_heads"),
    "v_proj": ("embed", "kv_heads"),
    "o_proj": ("q_heads", "embed"),
    "gate_proj": ("embed", "ff"),
    "up_proj": ("embed", "ff"),
    "down_proj": ("ff", "embed"),
}


def logical_axes(model_config: ModelConfig, name: str) -> Spec:
    """The reference's logical partitioning of parameter ``name``: a
    projection's kernel (float or ``kernel_q``) over (in, out) and its
    ``kernel_scale`` over out; RMSNorm scales over "embed"; LayerNorm and
    biases unannotated (``()``)."""
    parts = name.split(".")
    if name == "embedding":
        return ("vocab", "embed")
    if name == "pos_embedding":
        return (None, "embed")
    if parts[0] == "lm_head":
        axes = ("embed", "vocab")
    elif len(parts) >= 3 and parts[-2] in _PROJ_AXES:
        axes = _PROJ_AXES[parts[-2]]
    elif parts[-2].endswith("norm"):
        return ("embed",) if parts[-1] == "scale" and model_config.norm == "rmsnorm" else ()
    else:
        raise KeyError(f"no logical axes for parameter {name!r}")
    leaf = parts[-1]
    if leaf == "kernel_scale":
        return (axes[1],)
    if leaf == "bias":
        return ()
    return axes


def _resolve(spec: Spec, rules: AxisRules) -> Spec:
    table = dict(rules)
    return tuple(table.get(axis) if axis is not None else None for axis in spec)


def param_shardings(model_config: ModelConfig, mesh: MeshLike,
                    rules: Optional[AxisRules] = None) -> Dict[str, Spec]:
    """{parameter name: spec tuple} for every parameter of the port's
    model, resolved through the rules."""
    from fairness_llm_tpu_torch.runtime.weights import param_shapes

    if rules is None:
        rules = make_axis_rules(model_config, mesh)
    return {name: _resolve(logical_axes(model_config, name), rules)
            for name in param_shapes(model_config)}


def shard_params(params: Mapping[str, torch.Tensor], shardings: Mapping[str, Spec],
                 device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """Place the parameters on this rank's device. Every spec must be
    replicated (dp replicates the weights); a tp- or sp-sharded spec raises
    ``NotImplementedError`` (tensor-parallel serving is ROADMAP A5.5)."""
    sharded = sorted(n for n, spec in shardings.items() if any(a is not None for a in spec))
    if sharded:
        raise NotImplementedError(
            f"sharded parameters ({sharded[0]}, ...): tensor parallelism is not ported yet "
            "(ROADMAP A5.5)")
    return {name: t.to(device) for name, t in params.items()}


def batch_sharding(mesh: Optional[Any], batch: int) -> slice:
    """This rank's rows of a batch bucketed to a dp multiple: the
    contiguous block of ``batch // dp`` rows at its dp coordinate (the
    reference's ``P("dp")``)."""
    dp = axis_size(mesh, "dp")
    if batch % dp:
        raise ValueError(f"batch {batch} is not a multiple of dp={dp}")
    per = batch // dp
    lo = 0 if mesh is None else mesh.get_local_rank("dp") * per
    return slice(lo, lo + per)


def gather_rows(mesh: Any, local: torch.Tensor, compute: torch.device) -> torch.Tensor:
    """``batch_sharding``'s inverse: every dp rank's block of a per-row
    tensor, concatenated in rank order (an ``all_gather`` over the dp
    group, on ``compute`` under NCCL and through the CPU under gloo)."""
    import torch.distributed as dist

    from fairness_llm_tpu_torch.parallel.multihost import collective_device

    wire = local.to(collective_device(compute))
    parts = [torch.empty_like(wire) for _ in range(axis_size(mesh, "dp"))]
    dist.all_gather(parts, wire, group=axis_group(mesh, "dp"))
    return torch.cat(parts)


def kv_heads_sharded(model_config: ModelConfig, mesh: MeshLike) -> bool:
    """Whether the KV head axis shards under the mesh's rules."""
    tp = mesh_shape(mesh).get("tp", 1)
    return tp > 1 and model_config.num_kv_heads % tp == 0


def kv_tree_shardings(model_config: ModelConfig, mesh: MeshLike, tree: Any) -> Any:
    """Spec tuples for a serving KV container (``models.transformer.
    KVCache`` or ``serving.paged.BlockArena``), in its structure
    (dataclasses as dicts of their fields): a tensor of rank >= 3 whose axis
    2 is the KV heads, ``[rows, slots, n_kv, ...]`` cache rows,
    ``[blocks, block_size, n_kv, ...]`` blocks and the int8 path's scales,
    shards that axis on "tp" where it divides; every other leaf replicates
    (``()``). Row and block axes never shard."""
    shard_heads = kv_heads_sharded(model_config, mesh)
    n_kv = model_config.num_kv_heads

    def walk(node):
        if isinstance(node, torch.Tensor):
            if shard_heads and node.ndim >= 3 and node.shape[2] == n_kv:
                return (None, None, "tp") + (None,) * (node.ndim - 3)
            return ()
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return {f.name: walk(getattr(node, f.name)) for f in dataclasses.fields(node)}
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return ()

    return walk(tree)


def logits_sharding(model_config: ModelConfig, mesh: MeshLike) -> Spec:
    """The carried ``[num_slots, vocab]`` logits: vocab over tp where it
    divides, else replicated."""
    tp = mesh_shape(mesh).get("tp", 1)
    if tp > 1 and model_config.vocab_size % tp == 0:
        return (None, "tp")
    return ()


def per_device_param_bytes(model_config: ModelConfig, mesh: MeshLike,
                           rules: Optional[AxisRules] = None,
                           itemsize: Optional[int] = None) -> int:
    """Parameter bytes a device holds under the rules: each tensor's bytes
    over the product of its mapped mesh axes. ``itemsize`` is the storage
    width of float tensors (default: 2 for a bf16 config, else 4); int8
    kernels count one byte whatever it says."""
    from fairness_llm_tpu_torch.runtime.weights import _fixed_dtype, param_shapes

    shape = mesh_shape(mesh)
    if rules is None:
        rules = make_axis_rules(model_config, mesh)
    if itemsize is None:
        itemsize = 2 if model_config.dtype == "bfloat16" else 4
    total = 0
    for name, size in param_shapes(model_config).items():
        div = 1
        for axis in _resolve(logical_axes(model_config, name), rules):
            if axis is not None:
                div *= shape.get(axis, 1)
        item = 1 if _fixed_dtype(name) == torch.int8 else itemsize
        total += size.numel() * item // div
    return total


def per_device_kv_cache_bytes(model_config: ModelConfig, mesh: MeshLike, batch: int,
                              max_len: int, rules: Optional[AxisRules] = None) -> int:
    """KV-cache bytes a device holds for ``batch`` rows of ``max_len``
    slots: k and v over every layer, rows split over dp (rounded up, as
    the engine pads) and KV heads over tp where the rules shard them; the
    int8 cache holds one byte a value and an f32 scale a (slot, head)."""
    shape = mesh_shape(mesh)
    if rules is None:
        rules = make_axis_rules(model_config, mesh)
    kv_axis = dict(rules).get("kv_heads")
    kv_div = shape.get(kv_axis, 1) if kv_axis else 1
    rows_per_device = -(-batch // shape.get("dp", 1))
    slots = rows_per_device * max_len * (model_config.num_kv_heads // kv_div)
    if model_config.kv_cache_quant:
        per_slot = model_config.head_dim + 4
    else:
        per_slot = model_config.head_dim * (2 if model_config.dtype == "bfloat16" else 4)
    return 2 * model_config.num_layers * slots * per_slot
