"""Configurable decoder-only transformer (counterpart of
``fairness_llm_tpu/models/transformer.py``).

One forward path for every family: ``ModelConfig`` flags choose RoPE or
learned positions, RMSNorm or LayerNorm, gated or plain MLP, sliding window
and the GQA ratio. Batches are **left-padded**, so the KV write index is the
same for every row. Parameters keep the reference's names and its ``[in,
out]`` kernel layout (``layer_{i}.attn.q_proj.kernel``, ...), so a flax tree
maps onto them one to one (``runtime/weights.params_from_jax``). Matrix
products run in the config dtype; norms and the softmax in float32, and the
logits product sums its config-dtype operands into float32 (``_logits``).

Under ``weight_quant == "int8"`` every projection and an untied ``lm_head``
is a ``QuantDense``: an int8 kernel ``kernel_q`` [in, out] with f32
per-output-channel ``kernel_scale`` [out], multiplied by the hand-written
int8-weight kernel (``ops/quant_matmul``); no float copy of the weight is
made. The projections that read the same x (q/k/v, gate/up) go through one
grouped call (``_project``). The embedding and the norms stay float.

Unlike the reference's functional cache, the KV cache here is updated in
place: the forward writes the new keys and values into the preallocated
tensors and advances ``index``/``lengths``, which saves a copy of the cache
per step. New tokens fill slots ``[index, index + S)`` of every row, or,
with ``write_offsets`` [B] (a speculative verify step, where rows advance at
their own rates), slots ``[off[b], off[b] + S)`` of row b; the causal rule
follows the same slots. Under ``kv_cache_quant`` the cache holds int8 k/v
with f32 per-(slot, head) scales (``_quantize_kv``), and attention outside
the decode kernel reads their dequantized round trip.

Attention routes as the reference's does, minus its TPU, VMEM and tile-shape
conditions:

- the hand-written flash kernel (``ops/flash_attention``) takes a left-padded
  prefill (S > 1) with no shared prefix when ``use_flash_attention`` is set
  (over an int8 cache it attends to the round trip of the new keys, which is
  what later steps read back);
- the hand-written decode kernel (``ops/decode_attention``) takes a cached
  step of one token, or of at most 16 tokens at ``write_offsets`` (the
  verify window), when ``use_decode_attention_kernel`` is set and there is
  no sliding window; over an int8 cache it reads the int8 values and scales;
- everything else (the shared-prefix joint-softmax prefill, sliding-window
  decode, the flags off) takes the dense branch, which the reference also
  computes outside its kernels;
- ``attention_impl="ring"``, or a model with an sp group, takes ring
  attention (``parallel/ring.py``) on the no-cache path, over the
  sequence block each sp rank holds; a cache with "ring" raises, as in
  the reference.

Tensor parallelism (``set_parallel`` with a ``parallel.sharding.
ModelParallel`` whose ``layout`` is the rank's ``TPLayout``): the model is
built at the rank's widths (``TPLayout.local_config``), so attention runs
over its local heads (the kernels take the local head counts) and the MLP
over its local columns. The collectives are explicit, over the tp group:
one all-reduce after the o projection where the q heads shard and one
after the down projection where the MLP columns shard, each of the
partial products in float32 before the cast to the model dtype (an int8
projection's kernel writes float32 for it), the bias added once after;
where the vocabulary shards, the embedding rows outside the rank's block
read zero and one all-reduce completes the lookup, and the logits are
summed into a zero-filled full-vocabulary buffer (an all-reduce, which
gloo takes on CUDA tensors, where its all-gather does not).

The forward runs under autograd when a parameter requires a gradient
(``train/step.py``); the serving paths' parameters do not, so they build
no graph. A training forward passes no cache and ``left_padded=False``,
so it takes the dense (or ring) branch: the kernels have no backward. At
tp > 1 the sums above are ``ModelParallel.reduce`` (Megatron-LM's g: the
gradient passes through) and the input of each projection whose output
the layout shards (q/k/v, gate/up or up, the head) goes through
``ModelParallel.copy`` (f: its gradient is summed over the tp group).
Without autograd both are what they were: one in-place all-reduce a sum,
and nothing at the inputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.ops import decode_attention as decode_ops
from fairness_llm_tpu_torch.ops import flash_attention as flash_ops
from fairness_llm_tpu_torch.ops import quant_matmul as quant_ops
from fairness_llm_tpu_torch.telemetry import costmodel


def dtype_of(config: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# KV cache (preallocated, written in place)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerCache:
    """k/v in the model dtype, or int8 with per-(slot, head) f32 scales
    under ``kv_cache_quant``."""

    k: torch.Tensor  # [B, max_len, n_kv, head_dim]
    v: torch.Tensor  # [B, max_len, n_kv, head_dim]
    k_scale: Optional[torch.Tensor] = None  # [B, max_len, n_kv] float32
    v_scale: Optional[torch.Tensor] = None


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] -> (int8 values, [B, S, H] f32 scales), symmetric per
    vector: ``amax / 127`` floored at 1e-8, round half to even, clip to
    +-127 (the reference's arithmetic, bit for bit)."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(x32 / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, index: int,
                 write_offsets: Optional[torch.Tensor]) -> None:
    """Write ``upd`` [B, S, ...] into ``buf`` [B, L, ...] in place: slots
    ``[index, index + S)`` of every row, or ``[off[b], off[b] + S)`` of row
    b when ``write_offsets`` is given."""
    S = upd.shape[1]
    with costmodel.component("kv_rw"):
        if write_offsets is None:
            buf[:, index:index + S] = upd
            return
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        slots = write_offsets.long()[:, None] + torch.arange(S, device=buf.device)[None, :]
        buf[rows, slots] = upd.to(buf.dtype)


def check_write_offsets(offsets, S: int, max_len: int) -> None:
    """Raise unless writing ``S`` tokens at each of ``offsets`` (host
    integers: a list or a numpy array) stays inside a cache of ``max_len``
    slots. The forward checks its own uniform ``cache.index``; the loops
    that pass ``write_offsets`` call this on their host copy first."""
    lo, hi = int(min(offsets)), int(max(offsets))
    if lo < 0 or S > max_len - hi:
        raise ValueError(f"writing {S} tokens at slots {lo}..{hi} into a "
                         f"cache of max_len {max_len}")


@dataclasses.dataclass
class KVCache:
    """Decode state shared across layers: ``index`` is the uniform next-write
    slot; ``key_valid`` marks real cached keys; ``key_positions`` holds their
    positions (for the sliding window); ``lengths`` counts real tokens per
    row (the next position)."""

    layers: List[LayerCache]
    key_valid: torch.Tensor  # [B, max_len] bool
    key_positions: torch.Tensor  # [B, max_len] int64
    index: int
    lengths: torch.Tensor  # [B] int64

    @property
    def max_len(self) -> int:
        return self.layers[0].k.shape[1]


def init_cache(config: ModelConfig, batch_size: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None) -> KVCache:
    """A zeroed cache: k/v in ``dtype`` (default the config's), or int8 with
    f32 scales under ``kv_cache_quant`` (``dtype`` is then unused)."""
    dtype = dtype or dtype_of(config)
    shape = (batch_size, max_len, config.num_kv_heads, config.head_dim)

    def layer():
        if config.kv_cache_quant:
            return LayerCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
                v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device))
        return LayerCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device))

    layers = [layer() for _ in range(config.num_layers)]
    return KVCache(
        layers=layers,
        key_valid=torch.zeros((batch_size, max_len), dtype=torch.bool, device=device),
        key_positions=torch.zeros((batch_size, max_len), dtype=torch.long, device=device),
        index=0,
        lengths=torch.zeros((batch_size,), dtype=torch.long, device=device),
    )


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` with the kernel stored ``[in, out]``, computed
    in ``dtype`` (flax ``DenseGeneral``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class QuantDense(nn.Module):
    """``x @ dequant(kernel_q, kernel_scale) (+ bias)``: the int8 kernel
    stored ``[in, out]`` with f32 per-output-channel scales, x cast to
    ``dtype`` first, the result in ``out_dtype`` (default ``dtype``), the
    bias added after (the reference's ``QuantDense``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype, out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = out_dtype or dtype
        self.kernel_q = nn.Parameter(torch.empty(in_features, out_features, dtype=torch.int8),
                                     requires_grad=False)
        self.kernel_scale = nn.Parameter(torch.empty(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        lead = x.shape[:-1]
        y = quant_ops.quant_matmul(x.reshape(-1, x.shape[-1]).to(self.dtype), self.kernel_q,
                                   self.kernel_scale, out_dtype=self.out_dtype)
        y = y.reshape(*lead, y.shape[-1])
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _project(projs, x):
    """Each projection of ``projs`` applied to the same x (q/k/v, gate/up).
    int8 ones go through one ``quant_matmul_group`` call: the products the
    reference's separate ``QuantDense`` calls compute, each bias added after
    its own."""
    p0 = projs[0]
    if not isinstance(p0, QuantDense):
        return [p(x) for p in projs]
    lead = x.shape[:-1]
    ys = quant_ops.quant_matmul_group(x.reshape(-1, x.shape[-1]).to(p0.dtype),
                                      [(p.kernel_q, p.kernel_scale) for p in projs],
                                      out_dtype=p0.out_dtype)
    out = []
    for p, y in zip(projs, ys):
        y = y.reshape(*lead, y.shape[-1])
        out.append(y if p.bias is None else y + p.bias.to(y.dtype))
    return out


def _row_parallel(proj, x, par):
    """``proj(x)`` where x's features (the projection's input rows) are
    split over the tp group: each rank's partial product in float32, summed
    over the group, then cast to the projection's dtype, the bias added
    once."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(proj, QuantDense):
        y = quant_ops.quant_matmul(x2.to(proj.dtype), proj.kernel_q, proj.kernel_scale,
                                   out_dtype=torch.float32)
        dtype = proj.out_dtype
    else:
        y = _logits(x2.to(proj.dtype), proj.kernel)
        dtype = proj.dtype
    y = par.reduce(y.contiguous()).to(dtype).reshape(*lead, y.shape[-1])
    if proj.bias is not None:
        y = y + proj.bias.to(dtype)
    return y


def _projection(config: ModelConfig, in_features: int, out_features: int, bias: bool) -> nn.Module:
    """The projection ``weight_quant`` asks for: ``QuantDense`` or ``Dense``."""
    if config.weight_quant == "int8":
        return QuantDense(in_features, out_features, bias, dtype_of(config))
    return Dense(in_features, out_features, bias, dtype_of(config))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics by the fast variance
    ``E[x^2] - E[x]^2`` (clipped at 0) and a float32 output."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale.float())
        return y + self.bias.float()


def _norm(config: ModelConfig) -> nn.Module:
    if config.norm == "rmsnorm":
        return RMSNorm(config.d_model, config.norm_eps)
    return LayerNorm(config.d_model, config.norm_eps)


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin), each [B, S, 1, d/2] float32, for ``apply_rope``. The
    forward computes them once and every layer reuses them."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding on split halves (not interleaved)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding. x: [B, S, H, D], positions: [B, S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _activation(name: str):
    if name == "silu":
        return F.silu
    if name in ("gelu", "gelu_tanh"):
        # flax nn.gelu is the tanh approximation by default, for both names.
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


class Attention(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.weight_quant not in ("none", "int8"):
            raise NotImplementedError(f"weight_quant={cfg.weight_quant!r} is not ported")
        if cfg.attention_impl not in ("xla", "ring"):
            raise NotImplementedError(f"attention_impl={cfg.attention_impl!r} is not ported")
        self.par = None  # a parallel.sharding.ModelParallel (Transformer.set_parallel)
        qkv_bias = cfg.use_bias or cfg.qkv_bias
        self.q_proj = _projection(cfg, cfg.d_model, cfg.q_dim, qkv_bias)
        self.k_proj = _projection(cfg, cfg.d_model, cfg.kv_dim, qkv_bias)
        self.v_proj = _projection(cfg, cfg.d_model, cfg.kv_dim, qkv_bias)
        self.o_proj = _projection(cfg, cfg.q_dim, cfg.d_model, cfg.use_bias)

    def forward(self, x, positions, cache_layer: Optional[LayerCache],
                cache_index: Optional[int], key_valid, key_positions,
                left_padded: bool = False,
                shared_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                write_offsets: Optional[torch.Tensor] = None):
        # shared_kv: (k, v) each [Pc, Hkv, D], a prompt prefix common to every
        # row at positions 0..Pc-1, always visible; read once per step.
        # rope_cs: rope_tables(positions) when the caller computed them.
        # write_offsets: [B] per-row first slot of the new tokens; replaces
        # cache_index for the writes and the causal rule.
        cfg = self.config
        dtype = dtype_of(cfg)
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        layout = None if self.par is None else self.par.layout
        if layout is not None and layout.attn_sharded:
            x = self.par.copy(x)
        q, k, v = _project((self.q_proj, self.k_proj, self.v_proj), x)
        q = q.reshape(B, S, H, D)
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
        if cfg.pos_emb == "rope":
            cos, sin = rope_cs or rope_tables(positions, D, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        ring = cfg.attention_impl == "ring" or (self.par is not None
                                                 and self.par.sp_group is not None)
        if cfg.attention_impl == "ring" and cache_layer is not None:
            raise ValueError("attention_impl='ring' supports only the no-cache path")
        quant = cache_layer is not None and cfg.kv_cache_quant
        if quant:
            qk, k_sc = _quantize_kv(k)
            qv, v_sc = _quantize_kv(v)
            for buf, upd in ((cache_layer.k, qk), (cache_layer.v, qv),
                             (cache_layer.k_scale, k_sc), (cache_layer.v_scale, v_sc)):
                _cache_write(buf, upd, cache_index, write_offsets)
        elif cache_layer is not None:
            _cache_write(cache_layer.k, k.to(dtype), cache_index, write_offsets)
            _cache_write(cache_layer.v, v.to(dtype), cache_index, write_offsets)

        if ring and cache_layer is None:
            from fairness_llm_tpu_torch.parallel.ring import ring_attention

            out = ring_attention(q, k, v, positions, positions, key_valid,
                                 group=None if self.par is None else self.par.sp_group,
                                 window=cfg.sliding_window).to(dtype)
        elif (shared_kv is None and cfg.use_flash_attention and left_padded
                and S > 1):
            # First prefill (or no cache): the new k/v are the whole key set;
            # over an int8 cache, their round trip, which later steps read.
            if quant:
                k, v = _dequantize_kv(qk, k_sc, dtype), _dequantize_kv(qv, v_sc, dtype)
            lengths = key_valid[:, :S].sum(dim=1, dtype=torch.int32)
            out = flash_ops.flash_attention(
                q.transpose(1, 2), k.to(dtype).transpose(1, 2),
                v.to(dtype).transpose(1, 2), lengths, causal=True,
                window=cfg.sliding_window,
            ).transpose(1, 2)
        elif (cfg.use_decode_attention_kernel and cache_layer is not None
              and cfg.sliding_window is None
              and (S == 1 or (write_offsets is not None and S <= 16))):
            # One token: key_valid alone is the mask (slots past the write
            # index are invalid, so causality is already encoded). A verify
            # window adds the causal rule j <= off[b] + i over its own slots.
            sh = None if shared_kv is None else (
                shared_kv[0].to(dtype), shared_kv[1].to(dtype))
            kq = q[:, 0] if S == 1 else q
            scales = ((cache_layer.k_scale, cache_layer.v_scale) if quant else (None, None))
            out = decode_ops.decode_attention(
                kq, cache_layer.k, cache_layer.v, key_valid, shared_kv=sh,
                k_scale=scales[0], v_scale=scales[1], q_offsets=write_offsets,
            ).reshape(B, S, cfg.num_heads, cfg.head_dim)
        else:
            if cache_layer is None:
                keys, values = k, v
            elif quant:
                keys = _dequantize_kv(cache_layer.k, cache_layer.k_scale, dtype)
                values = _dequantize_kv(cache_layer.v, cache_layer.v_scale, dtype)
            else:
                keys, values = cache_layer.k, cache_layer.v
            out = self._dense(q, keys, values, positions, cache_index,
                              key_valid, key_positions, shared_kv,
                              cached=cache_layer is not None, write_offsets=write_offsets)
        out = out.reshape(B, S, cfg.q_dim)
        if layout is not None and layout.attn_sharded:
            return _row_parallel(self.o_proj, out, self.par)
        return self.o_proj(out)

    def _dense(self, q, keys, values, positions, cache_index, key_valid,
               key_positions, shared_kv, cached: bool,
               write_offsets: Optional[torch.Tensor] = None):
        cfg = self.config
        dtype = dtype_of(cfg)
        S = q.shape[1]
        dev = q.device
        if cached:
            # new query i (global slot index+i, or off[b]+i for row b) sees
            # key slot j iff j <= that slot
            j_idx = torch.arange(keys.shape[1], device=dev)[None, None, :]
            q_idx = torch.arange(S, device=dev)[None, :, None]
            q_idx = (q_idx + cache_index if write_offsets is None
                     else q_idx + write_offsets.long()[:, None, None])
            causal = j_idx <= q_idx  # [1 or B, S, K]
        else:
            causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None]
        allowed = causal & key_valid[:, None, :]  # [B, S, K]
        if cfg.sliding_window is not None:
            delta = positions[:, :, None] - key_positions[:, None, :]
            allowed = allowed & (delta < cfg.sliding_window)

        rep = cfg.num_heads // cfg.num_kv_heads
        dense_keys = keys.repeat_interleave(rep, dim=2) if rep > 1 else keys
        dense_values = values.repeat_interleave(rep, dim=2) if rep > 1 else values
        scale = cfg.head_dim ** -0.5
        scores = torch.einsum("bqhd,bkhd->bhqk", q, dense_keys).float() * scale
        scores = scores.masked_fill(~allowed[:, None], -1e30)
        if shared_kv is None:
            probs = torch.softmax(scores, dim=-1).to(dtype)
            return torch.einsum("bhqk,bkhd->bqhd", probs, dense_values)
        sk, sv = shared_kv  # [Pc, Hkv, D]
        if rep > 1:
            sk = sk.repeat_interleave(rep, dim=1)
            sv = sv.repeat_interleave(rep, dim=1)
        s_sh = torch.einsum("bqhd,khd->bhqk", q, sk.to(q.dtype)).float() * scale
        if cfg.sliding_window is not None:
            sh_pos = torch.arange(sk.shape[0], device=dev)
            sh_allowed = (positions[:, :, None] - sh_pos[None, None, :]) < cfg.sliding_window
            s_sh = s_sh.masked_fill(~sh_allowed[:, None], -1e30)
        probs = torch.softmax(torch.cat([s_sh, scores], dim=-1), dim=-1).to(dtype)
        p_sh, p_own = probs[..., :sk.shape[0]], probs[..., sk.shape[0]:]
        out = torch.einsum("bhqk,khd->bqhd", p_sh, sv.to(dtype))
        return out + torch.einsum("bhqk,bkhd->bqhd", p_own, dense_values)


class MLP(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        self.act = _activation(cfg.activation)
        if cfg.mlp == "glu":
            self.gate_proj = _projection(cfg, cfg.d_model, cfg.d_ff, cfg.use_bias)
        self.up_proj = _projection(cfg, cfg.d_model, cfg.d_ff, cfg.use_bias)
        self.down_proj = _projection(cfg, cfg.d_ff, cfg.d_model, cfg.use_bias)
        self.par = None  # a parallel.sharding.ModelParallel (Transformer.set_parallel)

    def forward(self, x):
        sharded = self.par is not None and self.par.layout is not None \
            and self.par.layout.ff_sharded
        if sharded:
            x = self.par.copy(x)
        if self.config.mlp == "glu":
            gate, up = _project((self.gate_proj, self.up_proj), x)
            h = self.act(gate) * up
        else:
            h = self.act(self.up_proj(x))
        if sharded:
            return _row_parallel(self.down_proj, h, self.par)
        return self.down_proj(h)


class Block(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.attn_norm = _norm(config)
        self.attn = Attention(config)
        self.mlp_norm = _norm(config)
        self.mlp = MLP(config)

    def forward(self, x, positions, cache_layer, cache_index, key_valid,
                key_positions, left_padded=False, shared_kv=None, rope_cs=None,
                write_offsets=None):
        x = x + self.attn(self.attn_norm(x), positions, cache_layer, cache_index,
                          key_valid, key_positions, left_padded=left_padded,
                          shared_kv=shared_kv, rope_cs=rope_cs,
                          write_offsets=write_offsets)
        return x + self.mlp(self.mlp_norm(x))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ head [D, V] as float32 logits, the products of operands
    in x's dtype summed in float32, as the reference's
    ``preferred_element_type=jnp.float32`` head product. A bf16 product on
    the card is one ``torch.mm`` with a float32 output (``aten::mm.dtype``,
    cuBLAS), so the [D, V] head is read at 2 bytes per element and no f32
    copy of it is made; on the CPU, which has no kernel for that op, the
    bf16 operands are widened to f32 first (the same function: widening is
    exact)."""
    head = head.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ head
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and not (x.requires_grad or head.requires_grad):
        # aten::mm.dtype has no backward: a training forward widens instead.
        out = torch.mm(x2, head, out_dtype=torch.float32)
    else:
        out = x2.float() @ head.float()
    return out.reshape(*x.shape[:-1], head.shape[-1])


class Transformer(nn.Module):
    """Decoder-only LM.

    Call patterns (as the reference's ``Transformer.__call__``):
      - no cache: ``logits, None = model(tokens, positions, token_valid)``
      - prefill/decode: ``logits, cache = model(..., cache=cache)``, where
        ``tokens`` fill cache slots ``[cache.index, cache.index + S)``, or
        ``[off[b], off[b] + S)`` of row b with ``write_offsets=off`` (whose
        bounds the caller checks: ``check_write_offsets``); the cache is
        updated in place and returned.
    Logits are float32, ``[B, S, V]``; ``[B, 1, V]`` with ``last_only`` (the
    last position) or ``last_idx`` (``[B]``, row b's position
    ``last_idx[b]``, as a right-padded batch needs: the hidden state there is
    taken before the final norm and the head, which are per position, so the
    function is the same and the head reads B rows, not B * S).
    """

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        if cfg.pos_emb == "learned":
            self.pos_embedding = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", Block(cfg))
        self.final_norm = _norm(cfg)
        if not cfg.tie_embeddings and cfg.weight_quant == "int8":
            self.lm_head = QuantDense(cfg.d_model, cfg.vocab_size, False, dtype_of(cfg),
                                      out_dtype=torch.float32)
        elif not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size))
        self.par = None

    def blocks(self) -> List[Block]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_layers)]

    def set_parallel(self, par) -> None:
        """Run over ``par`` (a ``parallel.sharding.ModelParallel``, or None):
        its tp group and layout (the model must have been built at
        ``par.layout.local_config``'s widths) and its sp group."""
        self.par = par
        for block in self.blocks():
            block.attn.par = par
            block.mlp.par = par

    def _embed(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The embedding rows of ``tokens``; with the vocabulary split over
        the tp group, rows outside the rank's block read zero and the sum
        over the group (exact: one rank holds each row) completes them."""
        layout = None if self.par is None else self.par.layout
        if layout is None or not layout.vocab_sharded:
            return self.embedding[tokens].to(dtype)
        local = tokens - layout.vocab_lo
        mine = (local >= 0) & (local < self.embedding.shape[0])
        rows = self.embedding[local.clamp(0, self.embedding.shape[0] - 1)].float()
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return self.par.reduce(rows).to(dtype)

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary logits from the rank's block (an all-reduce into
        a zero-filled buffer)."""
        layout = None if self.par is None else self.par.layout
        if layout is None or not layout.vocab_sharded:
            return logits
        full = logits.new_zeros(*logits.shape[:-1], layout.vocab_size)
        full[..., layout.vocab_lo:layout.vocab_hi] = logits
        return self.par.reduce(full)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                token_valid: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, left_padded: bool = False,
                last_only: bool = False,
                last_idx: Optional[torch.Tensor] = None,
                shared_layers: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                write_offsets: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        cfg = self.config
        dtype = dtype_of(cfg)
        B, S = tokens.shape
        if token_valid is None:
            token_valid = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
        positions = positions.long()

        x = self._embed(tokens, dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        if cfg.pos_emb == "learned":
            # Out-of-range positions clamp, as the reference's gather does (a
            # verify window's last slots may run past the table; their logits
            # are never emitted).
            x = x + self.pos_embedding[positions.clamp(0, cfg.max_seq_len - 1)].to(dtype)

        if cache is not None:
            # Per-row offsets are checked by the caller, which holds them on
            # the host (check_write_offsets): reading them back here would
            # sync the host with the device on every step.
            if write_offsets is None:
                check_write_offsets([cache.index], S, cache.max_len)
            _cache_write(cache.key_valid, token_valid, cache.index, write_offsets)
            _cache_write(cache.key_positions, positions, cache.index, write_offsets)
            key_valid, key_positions = cache.key_valid, cache.key_positions
        else:
            key_valid, key_positions = token_valid, positions

        rope_cs = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
                   if cfg.pos_emb == "rope" else None)
        for i, block in enumerate(self.blocks()):
            x = block(
                x, positions, cache.layers[i] if cache is not None else None,
                cache.index if cache is not None else None, key_valid,
                key_positions, left_padded=left_padded,
                shared_kv=shared_layers[i] if shared_layers is not None else None,
                rope_cs=rope_cs, write_offsets=write_offsets,
            )

        if last_idx is not None:
            x = x[torch.arange(B, device=x.device), last_idx][:, None, :]
        x = self.final_norm(x)
        if last_only:
            x = x[:, -1:, :]
        if self.par is not None and self.par.layout is not None \
                and self.par.layout.vocab_sharded:
            x = self.par.copy(x)
        if not cfg.tie_embeddings and cfg.weight_quant == "int8":
            logits = self.lm_head(x)  # f32 out
        else:
            logits = _logits(x, self.embedding.t() if cfg.tie_embeddings else self.lm_head)
        logits = self._gather_vocab(logits)

        if cache is not None:
            # As the reference: a verify step's caller resets lengths to the
            # tokens it accepted.
            cache.index += S
            cache.lengths += token_valid.sum(dim=1)
        return logits, cache
