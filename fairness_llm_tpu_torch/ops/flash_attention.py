"""Causal GQA prefill attention on a left-padded batch.

Counterpart of ``fairness_llm_tpu/ops/flash_attention.py``. Layout contract,
as there: q [B, H, S, D], k/v [B, Hkv, S, D], lengths [B] int32; row b's valid
keys are ``S - lengths[b] ..< S``; optional sliding window ``q_idx - k_idx <
window``. An all-masked query row (a left-pad row) gives 0.

``flash_attention`` launches a hand-written CUDA kernel
(``csrc/flash_attention.cu``) for a CUDA tensor and takes the plain version,
``flash_attention_reference``, only for a CPU tensor. bfloat16 goes to the
tensor-core kernel (``mma.sync``; P goes to P.V as two bf16 terms), built
for head widths ``TC_WIDTHS``: q/k/v with another D are copied with D
zero-padded to the next width (zero columns add nothing to q.k, and the
output columns they give are cut off). float32 goes to the scalar f32
kernel (``flash_fwd``, no TF32), built for head widths ``F32_WIDTHS`` (D
zero-padded to the next, as for bf16), whose query rows a block
``flash_f32_rows`` plans from the shape and the SM count (a plan is
checked here, ``check_rows``, as the kernel checks it, and refused with a
``KernelError``). q/k/v may be head-major views of [B, S, H, D] tensors:
the kernels take strides, so no copy is made where rows are 16-byte
aligned and D is a width the kernel takes; otherwise q/k/v are copied,
zero-padded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.telemetry import costmodel

NEG_INF = -1e30

#: Kernel launches since the counts were last set to 0: all of them, and
#: those the C entry reports as flash_fwd_tc (the bf16 tensor-core kernel).
launches = 0
tc_launches = 0
_TC_KERNEL = 1  # flash_attention_fwd's *kernel for flash_fwd_tc

#: Head widths the bf16 tensor-core kernel is instantiated for.
TC_WIDTHS = (64, 128, 256)
#: Head widths the float32 kernel is instantiated for.
F32_WIDTHS = (32, 64, 128, 256)

#: Query rows a block of the float32 kernel may take: 8 warps of 8 rows,
#: rows / 8 row groups times 64 / rows key groups.
F32_ROWS = (16, 32, 64)
#: Resident blocks an SM the float32 plan counts on (the kernel's launch
#: bound), fewer where shared memory allows fewer.
F32_BLOCKS_PER_SM = 2
#: A float32 block's own cost in the plan, in key steps: its launch, its
#: query rows and its fold (fitted to the study's prefill and scoring
#: shapes on an H100 80GB HBM3 at 700 W, tools/torch_f32_attention_ab.py).
F32_BLOCK_STEPS = 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype; q, k, v, o, lengths; B, H, Hkv, S, D, rows; 12 strides; causal,
# window, scale, stream; out: the kernel launched
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int)])


def flash_attention_reference(q, k, v, lengths, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version, in f32, with the kernel's masking and its
    ``acc / max(l, 1e-30)`` normalisation."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5, kk)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j[None] >= (S - lengths.to(q.device).long())[:, None, None]  # [B, 1|S, S]
    if causal:
        mask = mask & (j <= i)[None]
    if window is not None:
        mask = mask & ((i - j) < window)[None]
    mask = mask[:, None]  # [B, 1, S, S]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv) / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,S,D], k/v [B,Hkv,S,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v must share a dtype of {list(_DTYPES)}")


def flash_f32_smem(rows: int, D: int) -> int:
    """Shared memory of a float32 block of ``rows`` query rows at head
    width D (of ``F32_WIDTHS``): two ring stages of 64 / rows pairs of a k
    and a v tile of 32 rows (D + 4 floats apart)."""
    return 2 * (64 // rows) * 2 * (4 * 32 * (D + 4))


@functools.lru_cache(maxsize=256)  # planned on every call's host path: once per shape
def flash_f32_rows(B: int, H: int, S: int, D: int, sms: int) -> int:
    """Query rows a float32 block takes (``F32_ROWS``), D the padded head
    width. A block of R rows has 64 / R key groups, so its longest walk is
    ceil(ceil(S / 32) / (64 / R)) steps, and the grid is B * H * ceil(S / R)
    blocks, in waves of ``F32_BLOCKS_PER_SM`` blocks (fewer where shared
    memory allows fewer) on each of ``sms`` SMs. The plan takes the R of the
    fewest waves times (steps + ``F32_BLOCK_STEPS``), a block's own cost
    (its launch, query rows and fold) counted as that many steps; a tie
    goes to the larger R. R whose shared memory no block can hold is never
    taken."""
    tiles = -(-S // 32)
    best = None
    for rows in F32_ROWS:
        smem = flash_f32_smem(rows, D)
        if smem > _build.SMEM_PER_BLOCK:
            continue
        wave = sms * min(F32_BLOCKS_PER_SM, _build.SMEM_PER_SM // (smem + 1024))
        cost = -(-B * H * -(-S // rows) // wave) * (-(-tiles // (64 // rows)) + F32_BLOCK_STEPS)
        if best is None or cost <= best[0]:
            best = (cost, rows)
    return best[1]


def check_rows(rows: int, D: int) -> None:
    """Refuse a float32 plan the kernel refuses: rows not in ``F32_ROWS``,
    or a block's shared memory past what one block may take."""
    if rows not in F32_ROWS or flash_f32_smem(rows, D) > _build.SMEM_PER_BLOCK:
        raise _build.KernelError(f"flash_attention: a block of {rows} query rows at D={D} "
                                 f"does not fit the float32 kernel")


def flash_cost(q: torch.Tensor, k: torch.Tensor, lengths: torch.Tensor, causal: bool = True,
               window: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) this input needs: q, and k/v at the valid
    positions, read once, the output written whole, the lengths; 4*D
    operations per visible (query, key) pair per head. The counts behind
    the kernel's bound, which the cost ledger charges for a call
    (``telemetry/costmodel.kernel_cost``)."""
    B, H, S, D = q.shape
    pairs = 0
    lens = [int(n) for n in lengths.tolist()]
    for n in lens:
        if not causal:
            pairs += n * (n if window is None else min(n, window))
        elif window is None or n <= window:
            pairs += n * (n + 1) // 2
        else:
            pairs += window * (window + 1) // 2 + (n - window) * window
    nbytes = (sum(lens) * (H + 2 * k.shape[1]) * D + q.numel()) * q.element_size() + 4 * B
    return nbytes, 4 * D * H * pairs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """[B, H, S, D] attention output; see the module docstring. Under a
    cost walk the call charges ``flash_cost`` to ``attention``."""
    if costmodel.walk_active():
        with costmodel.kernel_cost("attention",
                                   lambda: flash_cost(q, k, lengths, causal, window)):
            return _flash_attention(q, k, v, lengths, causal, window)
    return _flash_attention(q, k, v, lengths, causal, window)


def _flash_attention(q, k, v, lengths, causal, window) -> torch.Tensor:
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, causal, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    B, H, S, D = q.shape
    if D > 256:
        raise ValueError(f"flash_attention kernel supports D <= 256, got {D}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    Dk = next(w for w in (TC_WIDTHS if q.dtype == torch.bfloat16 else F32_WIDTHS) if w >= D)
    aligned = all(_build.rows_aligned16(t) for t in (q, k, v))
    if Dk != D or not aligned:
        # Zero columns add nothing to q.k and give output columns cut off below.
        q, k, v = (_build.pad_last_dim(t, Dk) for t in (q, k, v))
    rows = 0  # the bf16 kernel's tiles are fixed
    if q.dtype == torch.float32:
        rows = flash_f32_rows(B, H, S, Dk, _build.sm_count(q.device))
        check_rows(rows, Dk)
    out = torch.empty_like(q)  # keeps q's strides (head-major view or not)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    kernel = ctypes.c_int(-1)
    status = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), B, H, k.shape[1], S, Dk, rows, *strides,
        int(causal), 0 if window is None else int(window), D ** -0.5,
        _build.current_stream(q.device), ctypes.byref(kernel),
    )
    _build.check(status, "flash_attention")
    global launches, tc_launches
    launches += 1
    tc_launches += kernel.value == _TC_KERNEL
    return out if Dk == D else out[..., :D]
