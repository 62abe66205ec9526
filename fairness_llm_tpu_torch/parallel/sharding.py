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

``shard_params`` places the parameters on the rank's device, each tensor
cut to the rank's block along every dimension its spec shards on "tp"
(dp and sp replicate the weights); ``tp_layout`` says which heads, MLP
columns and vocabulary rows a tp rank holds, and ``local_params`` turns
the spec's shards into the tensors the rank's model computes with (the
replicated q/k/v and gate/up biases cut to its columns, and, where q
heads shard but kv heads do not, the kv heads its q heads read).
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
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

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


def axis_rank(mesh: Optional[Any], axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None or axis_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


def shard_params(params: Mapping[str, torch.Tensor], shardings: Mapping[str, Spec],
                 device: Union[str, torch.device], mesh: Optional[Any] = None,
                 ) -> Dict[str, torch.Tensor]:
    """Place the parameters on this rank's device, each cut to the rank's
    block along the dimensions its spec shards (the rank's tp coordinate of
    ``mesh``; a dimension must divide its axis). Replicated tensors are
    moved, not copied; a shard is a contiguous copy. A sharded spec needs
    ``mesh``."""
    out = {}
    for name, t in params.items():
        spec = shardings.get(name, ())
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            if mesh is None:
                raise ValueError(f"parameter {name} shards on {axis!r}: pass the mesh")
            n = axis_size(mesh, axis)
            if t.shape[dim] % n:
                raise ValueError(f"parameter {name} dim {dim} ({t.shape[dim]}) does not "
                                 f"divide {axis}={n}")
            size = t.shape[dim] // n
            t = t.narrow(dim, axis_rank(mesh, axis) * size, size)
        out[name] = t.to(device).contiguous() if t is not params[name] else t.to(device)
    return out


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """What one tp rank holds of a model under the rules (global indices):
    its q heads ``[q_lo, q_hi)`` of ``num_heads``; the kv heads its
    attention reads, in order (``kv_heads``: its own block when kv heads
    shard; every head when attention replicates; where q heads shard and kv
    heads do not, the heads its q heads map to, once each when each maps to
    an equal run of its q heads, else one per q head); its MLP columns
    ``[ff_lo, ff_hi)`` of ``d_ff`` and its vocabulary rows ``[vocab_lo,
    vocab_hi)`` of ``vocab_size``. An o or down projection whose input
    shards is summed over the tp group."""

    tp: int
    rank: int
    num_heads: int
    q_lo: int
    q_hi: int
    kv_heads: Tuple[int, ...]
    kv_sharded: bool
    d_ff: int
    ff_lo: int
    ff_hi: int
    vocab_size: int
    vocab_lo: int
    vocab_hi: int

    @property
    def attn_sharded(self) -> bool:
        return self.q_hi - self.q_lo < self.num_heads

    @property
    def ff_sharded(self) -> bool:
        return self.ff_hi - self.ff_lo < self.d_ff

    @property
    def vocab_sharded(self) -> bool:
        return self.vocab_hi - self.vocab_lo < self.vocab_size

    def local_config(self, cfg: ModelConfig) -> ModelConfig:
        """``cfg`` at this rank's widths: its q and kv heads, MLP columns and
        vocabulary rows (what the rank's model and KV cache hold)."""
        return dataclasses.replace(
            cfg, num_heads=self.q_hi - self.q_lo, num_kv_heads=len(self.kv_heads),
            d_ff=self.ff_hi - self.ff_lo, vocab_size=self.vocab_hi - self.vocab_lo)


def tp_layout(model_config: ModelConfig, mesh: MeshLike, rank: Optional[int] = None) -> TPLayout:
    """The tp rank's layout under ``make_axis_rules`` (each axis gated on its
    own divisibility). ``rank`` defaults to this process's tp coordinate
    of ``mesh``; with a ``MeshConfig`` it must be given."""
    cfg = model_config
    tp = axis_size(mesh, "tp")
    if rank is None:
        rank = 0 if isinstance(mesh, MeshConfig) and tp == 1 else axis_rank(mesh, "tp")
    rules = dict(make_axis_rules(cfg, mesh))

    def block(size: int, axis: str) -> Tuple[int, int]:
        if rules.get(axis) != "tp":
            return 0, size
        per = size // tp
        return rank * per, (rank + 1) * per

    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q_lo, q_hi = block(H, "q_heads")
    kv_sharded = rules.get("kv_heads") == "tp"
    if kv_sharded or (q_lo, q_hi) == (0, H):
        kv_heads = tuple(range(*block(Hkv, "kv_heads")))
    else:
        rep = H // Hkv
        needed = [h // rep for h in range(q_lo, q_hi)]
        distinct = sorted(set(needed))
        runs = {needed.count(k) for k in distinct}
        kv_heads = tuple(distinct) if len(runs) == 1 else tuple(needed)
    ff_lo, ff_hi = block(cfg.d_ff, "ff")
    v_lo, v_hi = block(cfg.vocab_size, "vocab")
    return TPLayout(tp=tp, rank=rank, num_heads=H, q_lo=q_lo, q_hi=q_hi, kv_heads=kv_heads,
                    kv_sharded=kv_sharded, d_ff=cfg.d_ff, ff_lo=ff_lo, ff_hi=ff_hi,
                    vocab_size=cfg.vocab_size, vocab_lo=v_lo, vocab_hi=v_hi)


def _head_columns(heads: Sequence[int], head_dim: int) -> torch.Tensor:
    return torch.cat([torch.arange(h * head_dim, (h + 1) * head_dim) for h in heads])


def local_params(model_config: ModelConfig, params: Mapping[str, torch.Tensor],
                 layout: TPLayout) -> Dict[str, torch.Tensor]:
    """``shard_params``'s output -> the tensors of the rank's model
    (``layout.local_config``): the replicated column biases (q/k/v,
    gate/up) cut to the rank's columns, and where q heads shard but kv
    heads do not, the k/v projections (kernel, int8 scales, bias) cut to
    ``layout.kv_heads``. Everything else is the shard itself; the o and
    down biases stay whole (added once, after the sum)."""
    D = model_config.head_dim
    out = dict(params)
    kv_cut = layout.attn_sharded and not layout.kv_sharded
    kv_cols = _head_columns(layout.kv_heads, D) if kv_cut else None
    for name, t in params.items():
        parts = name.split(".")
        if len(parts) < 3:
            continue
        proj, leaf = parts[-2], parts[-1]
        if proj == "q_proj" and leaf == "bias" and layout.attn_sharded:
            out[name] = t[layout.q_lo * D:layout.q_hi * D].contiguous()
        elif proj in ("k_proj", "v_proj") and kv_cut:
            cols = kv_cols.to(t.device)
            out[name] = t.index_select(t.dim() - 1, cols).contiguous()
        elif proj in ("k_proj", "v_proj") and leaf == "bias" and layout.kv_sharded:
            lo, hi = layout.kv_heads[0] * D, (layout.kv_heads[-1] + 1) * D
            out[name] = t[lo:hi].contiguous()
        elif proj in ("gate_proj", "up_proj") and leaf == "bias" and layout.ff_sharded:
            out[name] = t[layout.ff_lo:layout.ff_hi].contiguous()
    return out


@dataclasses.dataclass
class ModelParallel:
    """The process groups a rank's model computes over: its tp group and
    ``layout`` (tensor-parallel forward), its sp group (the ring of the
    no-cache forward). None where the axis has one rank."""

    tp_group: Any = None
    layout: Optional[TPLayout] = None
    sp_group: Any = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the tp group in place (returns it); under a cost
        walk it is charged to ``collectives`` at the ring's bytes."""
        import torch.distributed as dist

        from fairness_llm_tpu_torch.telemetry import costmodel

        n = self.layout.tp
        with costmodel.kernel_cost("collectives", lambda: costmodel.collective_cost(
                t.numel() * t.element_size(), n)):
            dist.all_reduce(t, group=self.tp_group)
        return t


def model_parallel(model_config: ModelConfig, mesh: Optional[Any]) -> Optional[ModelParallel]:
    """The ``ModelParallel`` of this rank under ``mesh``, or None when
    neither tp nor sp has more than one rank."""
    tp, sp = axis_size(mesh, "tp"), axis_size(mesh, "sp")
    if tp == 1 and sp == 1:
        return None
    return ModelParallel(
        tp_group=axis_group(mesh, "tp") if tp > 1 else None,
        layout=tp_layout(model_config, mesh) if tp > 1 else None,
        sp_group=axis_group(mesh, "sp") if sp > 1 else None)


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
