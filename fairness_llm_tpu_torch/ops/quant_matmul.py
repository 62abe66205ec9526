"""int8 weight-only matrix product (counterpart of
``fairness_llm_tpu/ops/quant_matmul.py``: ``quantize_weight``,
``dequantize_weight`` and ``quant_matmul``).

Symmetric per-output-channel quantization: ``w ~ wq * scale[None, :]`` with
``wq`` int8 [K, N] (the flax ``[in, out]`` layout) and ``scale`` f32 [N].
The scale is constant along the contraction axis, so it commutes with the
product: ``x @ (wq * scale) == (x @ wq) * scale``, and it is applied once to
the f32 sum.

``quant_matmul`` launches the hand-written CUDA kernels
(``csrc/quant_matmul.cu``, replacing the Pallas kernel
``_quant_matmul_pallas`` -> ``_matmul_kernel``) for a CUDA tensor and takes
the plain version, ``quant_matmul_reference``, only for a CPU tensor.
``quant_matmul_group`` computes up to three products that share x (q/k/v,
gate/up) in one launch; its plain version is ``quant_matmul_group_reference``.
The kernels convert the weight a tile at a time, so the device never holds
a float copy of an int8 weight. Two regimes, picked by M:

- ``gemv`` (M <= 64, the decode step). Bound by the weight's bytes (it does
  2*M operations per byte). One persistent launch a call, the weights'
  tiles cut into equal runs, one a block (``gemv_plan``), the split-K
  reduce inside the kernel, its partials and arrival counters kept per
  device and stream; what a call needs of its weights (their TMA maps, the
  plan) is made once per set of weights: ``gemv_stream_tc`` for bf16 x,
  ``gemv_stream_tf32`` for float32 x. Launches are counted in
  ``gemv_launches``, grouped ones also in ``group_launches``.
- ``gemm`` (M > 64, prefill). Bound by operations. bf16 x runs on
  ``wgmma`` fed by TMA, each int8 tile converted to bf16 by warps of its own
  while earlier tiles are multiplied; float32 x on ``tf32_gemm_kernel``,
  K split across blocks for a deep, narrow weight (``tf32_gemm_plan``).
  A group makes one call a weight. Launches are counted in
  ``gemm_launches``.

bf16 x runs on the bf16 tensor cores. float32 x runs on the TF32 tensor
cores in two passes, ``x_hi @ wq + x_lo @ wq`` with ``x_hi = tf32(x)`` and
``x_lo = tf32(x - x_hi)`` (``tf32_split``): an int8 weight is exact in TF32,
each product of a TF32 value and an int8 one is exact in float32, and the
one rounding left, x_lo's, is at most 2^-22 |x|, so the result is
float32's (``quant_matmul_two_pass_reference`` is that product in plain
PyTorch). The weight is never rounded. ``tf32_gemv_launches`` and
``tf32_gemm_launches`` count the float32 launches by the kernel the C
entry reports it ran.

The kernels take any M, K and N. Where x's rows or the weight's rows are not
16-byte aligned (an odd K or N), the wrapper copies them zero-padded first,
as the attention wrappers do; no main-path shape needs that.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.telemetry import costmodel

#: Largest M that takes the GEMV regime.
GEMV_MAX_M = 64
#: Most weights one grouped launch takes.
GROUP_MAX = 3
#: gemv_stream_tc's k tiles, and about the most blocks a column tile is
#: split across (the block that arrives last reads all their partials).
STREAM_BK = 64
STREAM_MAX_SPLITS = 8
#: A group whose runs over 256-column tiles would be at most this many tile
#: steps (128 KB of weight a block, o_proj of llama3-8b) takes 128-column
#: tiles: there the split-K reduce, not the stream, sets the time, and
#: narrower tiles halve the splits and quarter a tile's partials. Longer runs
#: stream faster in tiles of 256.
STREAM_SHORT_RUN = 8
#: tf32_gemm_kernel's output tile (x rows, weight columns) and k tile; it
#: splits K for a deep, narrow weight in at most TF32_MAX_SPLITS, each at
#: least TF32_MIN_SPLIT_TILES k tiles long (``tf32_gemm_plan``).
TF32_BM, TF32_BN, TF32_BK = 64, 256, 32
TF32_MAX_SPLITS = 4
TF32_MIN_SPLIT_TILES = 16

#: Kernel launches of each regime since the counts were last set to 0;
#: ``group_launches`` counts the GEMV launches of ``quant_matmul_group``,
#: ``f32_launches`` the launches of either regime over float32 x (one a
#: call, a grouped GEMV call one), ``tf32_gemv_launches`` and
#: ``tf32_gemm_launches`` those the C entry reports it ran on
#: gemv_stream_tf32 and on tf32_gemm_kernel.
gemv_launches = 0
group_launches = 0
gemm_launches = 0
f32_launches = 0
tf32_gemv_launches = 0
tf32_gemm_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (x dtype, out dtype) pairs the kernel takes.
COMBOS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32))
# xdtype, odtype; x, wq, scale, out; M, K, N, ldx, splits, k_per_split; ws,
# counters, stream; out: the kernel launched
_GEMM_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int)])
# ngroups, K; wq x3, scale x3; N x3, bn, blocks; group record
_PREPARE_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
# xdtype, odtype; group record, x; M, ldx; out, ws, counters, stream; out: the
# kernel launched
_STREAM_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)])


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], f32 scale [N]), symmetric per channel.
    ``axis`` is the contraction axis; the scales live on the other one.
    ``amax / 127`` floored at 1e-12, round half to even, clip to +-127."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=axis) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_weight(wq: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (wq.float() * scale[None, :].float()).to(dtype)


def quant_matmul_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version, in the reference's XLA order: the weight cast
    to x's dtype, the product accumulated in f32, times the scale in f32,
    cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    y = torch.matmul(x.float(), wq.to(x.dtype).float())
    return (y * scale[None, :].float()).to(out_dtype)


def quant_matmul_group_reference(x: torch.Tensor, mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                                 out_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Plain version of ``quant_matmul_group``: the plain product a weight."""
    return [quant_matmul_reference(x, wq, scale, out_dtype) for wq, scale in mats]


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (x_hi, x_lo), both float32: ``x_hi`` is x rounded to
    TF32 (10 mantissa bits; to nearest, ties away from zero, as the
    kernels' ``cvt.rna.tf32.f32``) and ``x_lo = x - x_hi``, exact, so
    ``x_hi + x_lo == x`` bit for bit. The kernels multiply ``tf32(x_lo)``."""
    x = x.float().contiguous()
    # Half an ulp of TF32 added to the magnitude bits (the sign bit is
    # apart), then the low 13 bits cleared; a carry into the exponent is the
    # rounding up it stands for, for subnormals too.
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = x - hi
    # A zero x_lo takes x's sign, so that -0.0 splits into -0.0 + -0.0.
    return hi, torch.where(lo == 0, x * 0, lo)


def quant_matmul_two_pass_reference(x: torch.Tensor, wq: torch.Tensor,
                                    scale: torch.Tensor) -> torch.Tensor:
    """The float32 route's product in plain PyTorch: ``(x_hi @ wq +
    tf32(x_lo) @ wq) * scale`` in float32, each of the two products of TF32
    values and int8 weights (``tf32_split``). It differs from
    ``quant_matmul_reference`` only by x_lo's rounding (at most 2^-22 |x| an
    element) and summation order."""
    hi, lo = tf32_split(x)
    lo, _ = tf32_split(lo)
    w = wq.float()
    return (torch.matmul(hi, w) + torch.matmul(lo, w)) * scale[None, :].float()


def _check(x, wq, scale, out_dtype):
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"expected x [M,K], wq [K,N], scale [N]; got {tuple(x.shape)}, "
                         f"{tuple(wq.shape)}, {tuple(scale.shape)}")
    if x.shape[1] != wq.shape[0] or scale.shape[0] != wq.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, wq {tuple(wq.shape)} and scale "
                         f"{tuple(scale.shape)} disagree")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"wq must be int8 and scale float32, got {wq.dtype}, {scale.dtype}")
    if (x.dtype, out_dtype) not in COMBOS:
        raise ValueError(f"(x, out) dtypes {(x.dtype, out_dtype)} not in {COMBOS}")


def tf32_gemm_plan(K: int, N: int) -> Tuple[int, int]:
    """(splits, k_per_split) of tf32_gemm_kernel over a weight [K, N]: the
    largest power of two at most K / N (a deep, narrow weight gives few
    output tiles, each a long walk over k: down 2, k/v 4), at most
    ``TF32_MAX_SPLITS`` and each at least ``TF32_MIN_SPLIT_TILES`` k tiles
    long; split s sums k in [s * k_per_split, (s + 1) * k_per_split), a
    multiple of ``TF32_BK``, none empty. It does not depend on M, so a
    row's sums are the same whatever rows share its call (a served row
    replays bit for bit in a batch of another size). Every split count of
    llama3-8b's weights was timed at M = 128-3,584 on an H100
    (tools/torch_k4_f32_ab.py --plans): splitting a wide weight costs
    10-30% at M = 3,584, and a deep narrow one gains 20-65% below
    M = 1,536."""
    k_tiles = -(-K // TF32_BK)
    want = 1
    while want * 2 <= min(K // N, TF32_MAX_SPLITS, k_tiles // TF32_MIN_SPLIT_TILES):
        want *= 2
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per * TF32_BK


@functools.lru_cache(maxsize=1024)
def gemv_plan(K: int, Ns: Tuple[int, ...], sms: int) -> Tuple[int, int, int, int]:
    """(blocks, column tiles, tile steps, column-tile width) of
    gemv_stream_tc over weights [K, N] for N in ``Ns``. The width is 256, or
    128 where runs of 256 would be short (``STREAM_SHORT_RUN``). The tile
    steps (column tile, k tile of STREAM_BK), column tiles numbered across
    the weights, are cut into ``blocks`` equal contiguous runs, one a block
    (``gemv_units``). A run is as short as one wave of ``sms`` blocks
    allows, but at least 1/STREAM_MAX_SPLITS of a column tile's k tiles, and
    ``blocks`` is the fewest that take runs of that length."""
    kt = -(-K // STREAM_BK)
    for bn in (256, 128):
        tiles = sum(-(-n // bn) for n in Ns)
        work = tiles * kt
        run = max(-(-work // sms), -(-kt // STREAM_MAX_SPLITS))
        if run > STREAM_SHORT_RUN:
            break
    return -(-work // run), tiles, work, bn


def gemv_units(blocks: int, k_tiles: int, work: int) -> List[List[Tuple[int, ...]]]:
    """What each block of gemv_stream_tc computes, as the kernel derives it
    (``gs_start``, ``gs_block``): per block, its units in order, each
    (column tile, first k tile, end k tile, split, splits, workspace slot).
    A column tile's splits are the blocks whose runs cover it, numbered
    first to last; the slot (2b for block b's first unit, 2b + 1 for its
    last) is None for a tile one unit covers whole."""
    def start(b):
        return b * work // blocks

    def block_of(i):
        return -(-(i + 1) * blocks // work) - 1

    out = []
    for b in range(blocks):
        units, i, end = [], start(b), start(b + 1)
        while i < end:
            t = i // k_tiles
            j = min(end, (t + 1) * k_tiles)
            first, last = block_of(t * k_tiles), block_of((t + 1) * k_tiles - 1)
            slot = None if first == last else 2 * b + (0 if i == start(b) else 1)
            units.append((t, i - t * k_tiles, j - t * k_tiles, b - first, last - first + 1,
                          slot))
            i = j
        out.append(units)
    return out


# gemv_stream_tc's f32 partials and int32 arrival counters by (device,
# stream), grown to the largest call so far (``_build.grown``). The counters
# start at 0 and every launch leaves them at 0.
_partials: dict = {}
_counters: dict = {}


class _Group:
    """What a call over one set of weights needs, made once: the C group
    record (the weights' TMA maps, scales and widths, the plan's block count,
    each weight's first column in the one output buffer), the plan's
    workspace needs and the widths."""

    __slots__ = ("buf", "addr", "blocks", "tiles", "bn", "Ns", "total")

    def __init__(self, mats, K: int, device: torch.device):
        self.Ns = [wq.shape[1] for wq, _ in mats]
        self.total = sum(self.Ns)
        self.blocks, self.tiles, _, self.bn = gemv_plan(K, tuple(self.Ns),
                                                        _build.sm_count(device))
        self.buf = ctypes.create_string_buffer(
            _build.function("quant_matmul", "quant_matmul_stream_group_bytes", [])())
        self.addr = ctypes.addressof(self.buf)
        pad = GROUP_MAX - len(mats)
        prepare = _build.function("quant_matmul", "quant_matmul_stream_prepare",
                                  _PREPARE_ARGTYPES)
        status = prepare(len(mats), K, *(wq.data_ptr() for wq, _ in mats), *[None] * pad,
                         *(scale.data_ptr() for _, scale in mats), *[None] * pad,
                         *self.Ns, *[0] * pad, self.bn, self.blocks, self.addr)
        _build.check(status, "quant_matmul_stream_prepare")


# Group records by the weights' and scales' addresses and the weights'
# shapes: a record depends on nothing else, so one made for an address stays
# right for it.
_groups: dict = {}


def _group(mats, K: int, device: torch.device) -> Optional[_Group]:
    """The record of ``mats`` (1-3 weights [K, N]); None where a weight
    would need a padded copy (N not a multiple of 16 or an unaligned
    start), which the caller then makes."""
    key = (K, *[(wq.data_ptr(), scale.data_ptr(), wq.shape) for wq, scale in mats])
    rec = _groups.get(key)
    if rec is not None:
        return rec
    for wq, scale in mats:
        if wq.dim() != 2 or scale.dim() != 1 or wq.shape[0] != K or scale.shape[0] != wq.shape[1]:
            raise ValueError(f"x [M, {K}], wq {tuple(wq.shape)} and scale "
                             f"{tuple(scale.shape)} disagree")
        if wq.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(f"wq must be int8 and scale float32, got {wq.dtype}, {scale.dtype}")
        if wq.device != device or scale.device != device:
            raise ValueError("quant_matmul: all inputs must lie on one CUDA device")
    if not all(wq.is_contiguous() and scale.is_contiguous() and wq.shape[1] % 16 == 0
               and wq.data_ptr() % 16 == 0 for wq, scale in mats):
        return None
    if len(_groups) >= 4096:
        _groups.clear()
    rec = _groups[key] = _Group(mats, K, device)
    return rec


def _aligned_x(x: torch.Tensor) -> torch.Tensor:
    """x with 16-byte aligned rows: contiguous rows start 16-byte aligned iff
    the base does and a row's bytes are a multiple of 16."""
    x = x.contiguous()
    K = x.shape[1]
    if x.data_ptr() % 16 or K * x.element_size() % 16:
        ve = 16 // x.element_size()
        x = _build.pad_last_dim(x, -(-K // ve) * ve)
    return x


def _aligned_weight(wq: torch.Tensor, scale: torch.Tensor):
    wq, scale = wq.contiguous(), scale.contiguous()
    N = wq.shape[1]
    if N % 16 or wq.data_ptr() % 16:
        # A copy of the weight: only for shapes no model here has.
        Np = -(-N // 16) * 16
        return _build.pad_last_dim(wq, Np), _build.pad_last_dim(scale, Np)
    return wq, scale


def _count(kernel: int) -> None:
    """Counts a launch of the kernel the C entry reported: 0 gemv_stream_tc,
    1 wg_gemm_kernel, 2 gemv_stream_tf32, 3 tf32_gemm_kernel."""
    global gemv_launches, gemm_launches, f32_launches, tf32_gemv_launches, tf32_gemm_launches
    gemv_launches += kernel in (0, 2)
    gemm_launches += kernel in (1, 3)
    f32_launches += kernel in (2, 3)
    tf32_gemv_launches += kernel == 2
    tf32_gemm_launches += kernel == 3


def _gemv(x: torch.Tensor, mats, out_dtype: torch.dtype) -> Sequence[torch.Tensor]:
    """One launch of the stream kernel (gemv_stream_tc for bf16 x,
    gemv_stream_tf32 for float32 x): x [M, K] (0 < M <= 64) on a CUDA
    device times 1-3 weights, each output [M, N_i] a column view of one
    [M, sum N_i] buffer (the whole buffer for one weight)."""
    if x.dim() != 2:
        raise ValueError(f"expected x [M,K], got {tuple(x.shape)}")
    if (x.dtype, out_dtype) not in COMBOS:
        raise ValueError(f"(x, out) dtypes {(x.dtype, out_dtype)} not in {COMBOS}")
    K = x.shape[1]
    rec = _group(mats, K, x.device)
    if rec is None:  # a padded copy of some weight, then its columns cut back
        mats_p = [_aligned_weight(wq, scale) for wq, scale in mats]
        outs = _gemv(x, mats_p, out_dtype)
        return [o[:, :wq.shape[1]] for o, (wq, _) in zip(outs, mats)]
    x = _aligned_x(x)
    M = x.shape[0]
    stream = _build.current_stream(x.device)
    key = (x.device, stream)
    ws = _build.grown(_partials, key, 2 * rec.blocks * M * rec.bn, torch.float32, x.device)
    counters = _build.grown(_counters, key, rec.tiles, torch.int32, x.device, zero=True)
    out = torch.empty(M, rec.total, dtype=out_dtype, device=x.device)
    fn = _build.function("quant_matmul", "quant_matmul_stream", _STREAM_ARGTYPES)
    kernel = ctypes.c_int(-1)
    status = fn(_DTYPES[x.dtype], _DTYPES[out_dtype], rec.addr, x.data_ptr(), M, x.shape[1],
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(), stream, ctypes.byref(kernel))
    _build.check(status, "quant_matmul_stream")
    _count(kernel.value)
    return [out] if len(mats) == 1 else out.split(rec.Ns, 1)


def quant_matmul_cost(x: torch.Tensor, mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      out_dtype: torch.dtype) -> Tuple[int, int]:
    """(bytes, operations) of ``x [M, K]`` against the int8 weights of
    ``mats``: the weights, their f32 scales, x and the outputs each moved
    once; 2*M*K*N operations. The counts behind the kernel's bound, which
    the cost ledger charges for a call (``telemetry/costmodel.
    kernel_cost``)."""
    M, K = x.shape[0], x.shape[-1]
    N = sum(int(wq.shape[1]) for wq, _ in mats)
    out_item = torch.finfo(out_dtype).bits // 8
    return K * N + 4 * N + M * K * x.element_size() + M * N * out_item, 2 * M * K * N


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [M, K] @ dequant(wq [K, N], scale [N]) -> [M, N]`` in
    ``out_dtype`` (default x's); see the module docstring. Under a cost
    walk the call charges ``quant_matmul_cost`` to ``matmuls``."""
    out_dtype = out_dtype or x.dtype
    if costmodel.walk_active():
        with costmodel.kernel_cost("matmuls",
                                   lambda: quant_matmul_cost(x, ((wq, scale),), out_dtype)):
            return _quant_matmul(x, wq, scale, out_dtype)
    return _quant_matmul(x, wq, scale, out_dtype)


def _quant_matmul(x, wq, scale, out_dtype) -> torch.Tensor:
    if x.device.type == "cuda" and x.dim() == 2 and 0 < x.shape[0] <= GEMV_MAX_M:
        return _gemv(x, ((wq, scale),), out_dtype)[0]
    _check(x, wq, scale, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, wq, scale, out_dtype)
    if x.device.type != "cuda" or wq.device != x.device or scale.device != x.device:
        raise ValueError("quant_matmul: all inputs must lie on one CUDA device")
    M, K = x.shape
    N = wq.shape[1]
    if M == 0:
        return x.new_empty(0, N, dtype=out_dtype)
    x = _aligned_x(x)
    wq, scale = _aligned_weight(wq, scale)
    Np = wq.shape[1]
    out = torch.empty(M, Np, dtype=out_dtype, device=x.device)
    stream = _build.current_stream(x.device)
    splits, k_per_split, ws, counters = 1, K, None, None
    if x.dtype == torch.float32:
        splits, k_per_split = tf32_gemm_plan(K, Np)
        if splits > 1:
            key = (x.device, stream)
            ws = _build.grown(_partials, key, splits * M * Np, torch.float32, x.device)
            tiles = -(-M // TF32_BM) * -(-Np // TF32_BN)
            counters = _build.grown(_counters, key, tiles, torch.int32, x.device, zero=True)
    fn = _build.function("quant_matmul", "quant_matmul_gemm", _GEMM_ARGTYPES)
    kernel = ctypes.c_int(-1)
    status = fn(_DTYPES[x.dtype], _DTYPES[out_dtype], x.data_ptr(), wq.data_ptr(),
                scale.data_ptr(), out.data_ptr(), M, K, Np, x.shape[1], splits, k_per_split,
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), stream, ctypes.byref(kernel))
    _build.check(status, "quant_matmul_gemm")
    _count(kernel.value)
    return out if Np == N else out[:, :N]


def quant_matmul_group(x: torch.Tensor, mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       out_dtype: Optional[torch.dtype] = None) -> Sequence[torch.Tensor]:
    """``[quant_matmul(x, wq, scale, out_dtype) for wq, scale in mats]`` for
    1-3 weights with one K (q/k/v, gate/up). In the GEMV regime it is one
    launch of the stream kernel (gemv_stream_tc for bf16 x,
    gemv_stream_tf32 for float32 x) whose tile steps span every weight, the
    outputs column views of one buffer; else one ``quant_matmul`` call a
    weight. The weights stay separate tensors. Under a cost walk the call
    charges ``quant_matmul_cost`` to ``matmuls``, once for the group."""
    out_dtype = out_dtype or x.dtype
    if costmodel.walk_active():
        with costmodel.kernel_cost("matmuls", lambda: quant_matmul_cost(x, mats, out_dtype)):
            return _quant_matmul_group(x, mats, out_dtype)
    return _quant_matmul_group(x, mats, out_dtype)


def _quant_matmul_group(x, mats, out_dtype) -> Sequence[torch.Tensor]:
    if not 1 <= len(mats) <= GROUP_MAX:
        raise ValueError(f"quant_matmul_group takes 1 to {GROUP_MAX} weights, got {len(mats)}")
    if x.device.type == "cuda" and x.dim() == 2 and 0 < x.shape[0] <= GEMV_MAX_M:
        global group_launches
        outs = _gemv(x, mats, out_dtype)
        group_launches += 1
        return outs
    for wq, scale in mats:
        _check(x, wq, scale, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_group_reference(x, mats, out_dtype)
    return [quant_matmul(x, wq, scale, out_dtype=out_dtype) for wq, scale in mats]
