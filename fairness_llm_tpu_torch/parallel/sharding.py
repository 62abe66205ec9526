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
cut to the rank's block along every dimension its spec shards (dp and sp
replicate the weights). ``tp_layout`` says which heads, MLP columns and
vocabulary rows a tp rank holds, and ``rank_params`` cuts the full
parameters to the tensors the rank's model computes with: the spec's tp
blocks, the replicated q/k/v and gate/up biases cut to its columns, and,
where q heads shard but kv heads do not, the kv heads its q heads read.
The tp engine and the tp train state both take their tensors from it.
``batch_sharding`` is the rank's contiguous row slice of a batch bucketed
to a dp multiple, the reference's ``P("dp")`` layout.

Training at tp > 1 (``train/step.py``): ``gather_params`` puts a rank's
tensors, or their gradients and moments, back together (``rank_params``'s
inverse); ``ModelParallel.reduce`` and ``copy`` are the tensor-parallel
forward's collectives with the gradients Megatron-LM gives them (g: a sum
whose gradient passes through; f: the identity whose gradient is summed
over tp); ``sum_kv_copy_grads`` completes the gradient of a kv head that
several tp ranks hold; ``replica_group`` is the dp x sp plane a rank's
loss and gradients are summed over, built once a mesh.

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


def rank_params(model_config: ModelConfig, params: Mapping[str, torch.Tensor],
                layout: TPLayout, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """What the tp rank of ``layout`` holds of the full ``params``, on
    ``device``: the tensors of the rank's model (``layout.local_config``).
    A tensor whose spec shards on "tp" is cut to the rank's block; the
    replicated column biases (q/k/v, gate/up) to the rank's columns; where
    q heads shard but kv heads do not, the k/v projections (kernel, int8
    scales, bias) to ``layout.kv_heads``. Everything else, the o and down
    biases among them (added once, after the sum), stays whole.
    ``gather_params`` is its inverse."""
    shardings = param_shardings(model_config, MeshConfig(tp=layout.tp))
    out = {}
    for name, t in params.items():
        cut = _global_columns(model_config, name, t.shape, shardings.get(name, ()), layout)
        if cut is not None:
            dim, cols = cut
            t = t.index_select(dim, cols.to(t.device))
        out[name] = t.to(device)
    return out


def _global_columns(model_config: ModelConfig, name: str, shape: Sequence[int], spec: Spec,
                    layout: TPLayout) -> Optional[Tuple[int, torch.Tensor]]:
    """``rank_params``'s cut of parameter ``name`` (full ``shape``) as
    (dimension, the global indices along it that the rank's tensor holds,
    in order), or None where the rank holds the tensor whole."""
    D = model_config.head_dim
    for dim, axis in enumerate(spec):
        if axis == "tp":
            if shape[dim] % layout.tp:
                raise ValueError(f"parameter {name} dim {dim} ({shape[dim]}) does not "
                                 f"divide tp={layout.tp}")
            n = shape[dim] // layout.tp
            return dim, torch.arange(layout.rank * n, (layout.rank + 1) * n)
    parts = name.split(".")
    if len(parts) < 3:
        return None
    proj, leaf = parts[-2], parts[-1]
    if proj == "q_proj" and leaf == "bias" and layout.attn_sharded:
        return 0, torch.arange(layout.q_lo * D, layout.q_hi * D)
    if proj in ("k_proj", "v_proj") and (
            (layout.attn_sharded and not layout.kv_sharded)
            or (leaf == "bias" and layout.kv_sharded)):
        return len(shape) - 1, _head_columns(layout.kv_heads, D)
    if proj in ("gate_proj", "up_proj") and leaf == "bias" and layout.ff_sharded:
        return 0, torch.arange(layout.ff_lo, layout.ff_hi)
    return None


def _kv_owners(model_config: ModelConfig, tp: int) -> Dict[int, int]:
    """{kv head: the lowest tp rank that holds it}."""
    owners: Dict[int, int] = {}
    for r in range(tp):
        for h in tp_layout(model_config, MeshConfig(tp=tp), r).kv_heads:
            owners.setdefault(h, r)
    return owners


def gather_params(model_config: ModelConfig, params: Mapping[str, torch.Tensor],
                  layout: TPLayout, group: Any = None) -> Dict[str, torch.Tensor]:
    """``rank_params``'s inverse over the tp group: the full tensors from
    every tp rank's ``params`` (the rank's parameters, or any tensors of
    their shapes, such as their gradients or AdamW moments). A tensor the
    rank holds whole is returned as it is (detached); a cut one is written
    into a zero-filled tensor of the full shape at its global indices and
    summed over ``group`` (an all-reduce, which gloo takes on CUDA tensors
    where its all-gather does not). A kv head that several ranks hold is
    written by the lowest of them only, and a head a rank holds twice once.
    Every rank of the group must call it on the same names."""
    import torch.distributed as dist

    from fairness_llm_tpu_torch.runtime.weights import param_shapes

    shapes = param_shapes(model_config)
    shardings = param_shardings(model_config, MeshConfig(tp=layout.tp))
    owners = _kv_owners(model_config, layout.tp)
    D = model_config.head_dim
    out = {}
    for name, t in params.items():
        t = t.detach()
        cut = _global_columns(model_config, name, shapes[name], shardings.get(name, ()), layout)
        if cut is None:
            out[name] = t
            continue
        dim, cols = cut
        keep = torch.ones(len(cols), dtype=torch.bool)
        parts = name.split(".")
        if len(parts) >= 3 and parts[-2] in ("k_proj", "v_proj") and not layout.kv_sharded:
            seen = set()
            for i, h in enumerate(layout.kv_heads):
                mine = owners[h] == layout.rank and h not in seen
                seen.add(h)
                keep[i * D:(i + 1) * D] = mine
        full = t.new_zeros(tuple(shapes[name]))
        pos = torch.nonzero(keep)[:, 0].to(t.device)
        full.index_copy_(dim, cols.to(t.device)[pos], t.index_select(dim, pos))
        dist.all_reduce(full, group=group)
        out[name] = full
    return out


def sum_kv_copy_grads(model_config: ModelConfig, params: Mapping[str, torch.Tensor],
                      layout: TPLayout, group: Any = None) -> None:
    """Where q heads shard and kv heads do not, each rank's k/v projection
    (kernel and bias) holds copies of the kv heads its q heads read, and a
    copy's gradient is only those q heads' share. Sum the shares over the
    tp group by global kv head (``index_add`` into a zero-filled buffer of
    the full kv width, an all-reduce, then the rank's columns back), so
    every copy gets the whole gradient and the copies stay equal. Every
    other parameter a tp rank holds whole (norms, ``pos_embedding``, the o
    and down biases, all of attention where it replicates) already has its
    whole gradient on every rank through the tp forward's collectives
    (``ModelParallel.reduce`` and ``copy``): a sum over tp would multiply
    it by tp."""
    import torch.distributed as dist

    if not layout.attn_sharded or layout.kv_sharded:
        return
    width = model_config.num_kv_heads * model_config.head_dim
    for name, p in params.items():
        parts = name.split(".")
        if len(parts) < 3 or parts[-2] not in ("k_proj", "v_proj") or p.grad is None:
            continue
        g = p.grad
        cols = _head_columns(layout.kv_heads, model_config.head_dim).to(g.device)
        buf = g.new_zeros(*g.shape[:-1], width)
        buf.index_add_(g.dim() - 1, cols, g)
        dist.all_reduce(buf, group=group)
        g.copy_(buf.index_select(g.dim() - 1, cols))


class _ReduceFromTP(torch.autograd.Function):
    """Megatron-LM's g: the forward sums over the tp group (into a fresh
    tensor: autograd may hold the input), the backward passes the gradient
    through, since every tp rank computes the same loss from the sum."""

    @staticmethod
    def forward(ctx, t, par):
        return par.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    """Megatron-LM's f: the forward is the identity, the backward sums the
    gradient over the tp group (each rank's is only its own columns'
    share). ``torch.distributed.nn.functional.all_reduce`` is not this: its
    backward sums the gradient as well, which would count the loss tp
    times."""

    @staticmethod
    def forward(ctx, t, par):
        ctx.par = par
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.par.all_reduce(grad.clone()), None


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

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the tp group (g). Without autograd (the
        serving paths) it is ``all_reduce`` itself, in place; under autograd
        a fresh tensor whose gradient passes through."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _ReduceFromTP.apply(t, self)
        return self.all_reduce(t)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` at the input of a projection whose output the layout
        shards (f): the identity, whose gradient is summed over the tp group
        under autograd; without autograd ``t`` itself."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _CopyToTP.apply(t, self)
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


def replica_group(mesh: Any):
    """The process group of the ranks that share this rank's tp coordinate
    (its dp x sp plane), over which training sums its loss and gradients;
    None for the default group when tp has one rank. The first call on a
    mesh makes one group for every tp coordinate (``dist.new_group`` is
    collective: every rank calls it in the same order), so call it on every
    rank; the mesh keeps the group, and later calls return it."""
    import torch.distributed as dist

    if axis_size(mesh, "tp") == 1:
        return None
    cached = getattr(mesh, "_fairness_replica_group", None)
    if cached is not None:
        return cached
    ranks = mesh.mesh.movedim(list(mesh.mesh_dim_names).index("tp"), 0)
    mine = axis_rank(mesh, "tp")
    group = None
    for t in range(ranks.shape[0]):
        g = dist.new_group(ranks[t].flatten().tolist())
        if t == mine:
            group = g
    mesh._fairness_replica_group = group
    return group


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
