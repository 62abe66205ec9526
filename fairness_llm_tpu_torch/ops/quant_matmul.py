"""int8 weight-only matrix product (counterpart of
``fairness_llm_tpu/ops/quant_matmul.py``: ``quantize_weight``,
``dequantize_weight`` and ``quant_matmul``).

Symmetric per-output-channel quantization: ``w ~ wq * scale[None, :]`` with
``wq`` int8 [K, N] (the flax ``[in, out]`` layout) and ``scale`` f32 [N].
The scale is constant along the contraction axis, so it commutes with the
product: ``x @ (wq * scale) == (x @ wq) * scale``, and it is applied once to
the f32 sum.

``quant_matmul`` launches the hand-written CUDA kernel
(``csrc/quant_matmul.cu``, replacing the Pallas kernel
``_quant_matmul_pallas`` -> ``_matmul_kernel``) for a CUDA tensor and takes
the plain version, ``quant_matmul_reference``, only for a CPU tensor. The
kernel converts the weight a tile at a time inside the kernel, so the device
never holds a float copy of an int8 weight. Two regimes, picked by M:

- ``gemv`` (M <= 64, the decode step). Bound by the weight's bytes (it does
  2*M operations per byte); K is split across blocks where N alone gives
  too few of them. Launches are counted in ``gemv_launches``.
- ``gemm`` (M > 64, prefill). Bound by operations. bf16 x runs on
  ``wgmma`` fed by TMA, each int8 tile converted to bf16 by warps of its own
  while earlier tiles are multiplied. Launches are counted in
  ``gemm_launches``.

In both, bf16 x runs on the tensor cores (``mma.sync`` in the GEMV regime)
and f32 x on f32 FMAs (the weight never goes to TF32 or bf16).

The kernel takes any M, K and N. Where x's rows or the weight's rows are not
16-byte aligned (an odd K or N), the wrapper copies them zero-padded first,
as the attention wrappers do; no main-path shape needs that.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fairness_llm_tpu_torch.ops import _build

#: Largest M that takes the GEMV regime.
GEMV_MAX_M = 64
#: Blocks the GEMV regime aims for (two per SM of a 132-SM H100).
_GEMV_TARGET_BLOCKS = 264
_GEMV_BN, _GEMV_BK = 128, 64

#: Kernel launches of each regime since the counts were last set to 0.
gemv_launches = 0
gemm_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (x dtype, out dtype) pairs the kernel takes.
COMBOS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32))
# xdtype, odtype; x, wq, scale, out, partial; M, K, N, ldx, splits, k_per_split; stream
_GEMV_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
# xdtype, odtype; x, wq, scale, out; M, K, N, ldx; stream
_GEMM_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


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


def gemv_splits(M: int, K: int, N: int) -> Tuple[int, int]:
    """(splits, k_per_split) of the GEMV regime: split K across blocks until
    the column tiles times the splits reach the target block count."""
    n_tiles = -(-N // _GEMV_BN)
    k_tiles = -(-K // _GEMV_BK)
    want = min(k_tiles, max(1, -(-_GEMV_TARGET_BLOCKS // n_tiles)))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per * _GEMV_BK


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [M, K] @ dequant(wq [K, N], scale [N]) -> [M, N]`` in
    ``out_dtype`` (default x's); see the module docstring."""
    out_dtype = out_dtype or x.dtype
    _check(x, wq, scale, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, wq, scale, out_dtype)
    if x.device.type != "cuda" or wq.device != x.device or scale.device != x.device:
        raise ValueError("quant_matmul: all inputs must lie on one CUDA device")
    M, K = x.shape
    N = wq.shape[1]
    if M == 0:
        return x.new_empty(0, N, dtype=out_dtype)
    # Contiguous rows start 16-byte aligned iff the base does and a row's
    # bytes are a multiple of 16.
    x = x.contiguous()
    if x.data_ptr() % 16 or K * x.element_size() % 16:
        ve = 16 // x.element_size()
        x = _build.pad_last_dim(x, -(-K // ve) * ve)
    wq = wq.contiguous()
    scale = scale.contiguous()
    Np = N
    if N % 16 or wq.data_ptr() % 16:
        # A copy of the weight: only for shapes no model here has.
        Np = -(-N // 16) * 16
        wq = _build.pad_last_dim(wq, Np)
        scale = _build.pad_last_dim(scale, Np)
    out = torch.empty(M, Np, dtype=out_dtype, device=x.device)
    stream = _build.current_stream(x.device)
    global gemv_launches, gemm_launches
    if M <= GEMV_MAX_M:
        splits, k_per_split = gemv_splits(M, K, Np)
        partial = (torch.empty(splits, M, Np, dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        fn = _build.function("quant_matmul", "quant_matmul_gemv", _GEMV_ARGTYPES)
        status = fn(_DTYPES[x.dtype], _DTYPES[out_dtype], x.data_ptr(), wq.data_ptr(),
                    scale.data_ptr(), out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    M, K, Np, x.shape[1], splits, k_per_split, stream)
        _build.check(status, "quant_matmul_gemv")
        gemv_launches += 1
    else:
        fn = _build.function("quant_matmul", "quant_matmul_gemm", _GEMM_ARGTYPES)
        status = fn(_DTYPES[x.dtype], _DTYPES[out_dtype], x.data_ptr(), wq.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), M, K, Np, x.shape[1], stream)
        _build.check(status, "quant_matmul_gemm")
        gemm_launches += 1
    return out if Np == N else out[:, :N]
