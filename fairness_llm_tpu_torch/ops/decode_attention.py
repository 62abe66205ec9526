"""Decode attention with a shared-prefix seed: one-token steps, the int8
cache, and the speculative verify window.

Counterpart of ``fairness_llm_tpu/ops/decode_attention.py``. q [B, H, D]
(one query per row), or q [B, Q, H, D] with ``q_offsets`` [B] (a verify
window: query i of row b sits in cache slot ``q_offsets[b] + i`` and sees
own slot j only where ``j <= q_offsets[b] + i``), attends to the shared
prefix k/v [P, Hkv, D] (common to every row, always visible) and the row's
own cache k/v [B, L, Hkv, D] under ``valid`` [B, L], in one joint softmax;
head h reads kv head ``h // rep``. With ``k_scale``/``v_scale`` [B, L, Hkv]
f32 the cache is int8: the k-scale multiplies the scores, the v-scale the
probabilities after the normaliser's sum, as the reference folds them. The
shared prefix stays float.

``decode_attention`` launches the hand-written CUDA kernels
(``csrc/decode_attention.cu``, ``decode_attention_f32.cu`` and
``decode_verify_f32.cu``) for CUDA tensors and takes the plain version,
``decode_attention_reference``, only for CPU tensors; any other mix raises.
Every route splits the keys across blocks, each split a run of whole tiles
of one kind (prefix or own cache), and folds the splits' partials in a
second launch of the same call (``combine_splits``); the workspace for them
is allocated here, once per device and stream, and kept for the calls that
follow (``_workspace``). bfloat16 goes to the tensor-core kernels
(mma.sync; P goes to P.V as two bf16 terms): a verify window (4-D q) to
``decode_verify_tc``, planned by ``verify_splits``; one query per row (K2,
K2q) to ``decode_split_tc``, planned by ``decode_splits``, whose prefix
splits take every batch row's queries of a kv head together, so each prefix
tile is read once per kv head and not once per row; head widths
``TC_WIDTHS``. float32 runs on scalar f32 FMAs: one query per row (K2, K2q)
on ``decode_split_f32``, planned by ``decode_splits_f32``, a block one warp;
the verify window (K3, over a float or an int8 cache) on
``verify_split_f32``, planned by ``verify_splits_f32`` (key splits and the
query rows a block, by a cost formula), a block 4 warps over register
tiles; head widths ``F32_WIDTHS``. q/k/v with another D, or a tensor that
does not start on a 16-byte boundary, are copied with D zero-padded to the
next width. Each of the four modes counts its launches;
``multi_tc_launches``, ``decode_tc_launches``, ``decode_f32_launches`` and
``verify_f32_launches`` count the calls the C entry reports it ran on
decode_verify_tc, decode_split_tc, decode_split_f32 and verify_split_f32.
Every split plan is checked here (``check_splits``, ``check_verify_rows``)
as the kernel checks it, and refused with a ``KernelError``; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.telemetry import costmodel

NEG_INF = -1e30

#: Kernel launches of each mode since the counts were last set to 0: one
#: query per row over a float cache (K2), over an int8 cache (K2q), and the
#: verify window over a float cache (K3) and over an int8 cache; then the
#: calls (either cache) that ran on each kernel, as the C entry reports:
#: verify windows on decode_verify_tc (bf16) and verify_split_f32
#: (float32), one-query calls on decode_split_tc (bf16) and
#: decode_split_f32 (float32).
launches = 0
quant_launches = 0
multi_launches = 0
multi_quant_launches = 0
multi_tc_launches = 0
decode_tc_launches = 0
decode_f32_launches = 0
verify_f32_launches = 0
# The C entries' *kernel for decode_verify_tc, decode_split_tc,
# decode_split_f32 and verify_split_f32
_VERIFY_TC, _DECODE_TC, _DECODE_F32, _VERIFY_F32 = 1, 2, 3, 4

#: Head widths the bf16 tensor-core kernels are instantiated for.
TC_WIDTHS = (32, 64, 128, 256)
#: Head widths the float32 kernels are instantiated for.
F32_WIDTHS = (32, 64, 128, 256)
#: Keys per tile of the tensor-core kernels (their BK).
TILE_KEYS = 32
#: Resident blocks per SM the verify split plan fills: four of 3 warps (36
#: query rows per kv head) at D = 128, as registers allow.
SPLIT_BLOCKS_PER_SM = 4
#: Resident blocks per SM of decode_split_tc by head width: four of 4 warps
#: at D <= 128 (128 registers a thread, 52-54 KB of shared memory at D =
#: 128), two at D = 256 (shared memory).
DECODE_BLOCKS_PER_SM = {32: 4, 64: 4, 128: 4, 256: 2}
#: Query rows of a decode_split_f32 prefix block (one warp): 8 of the
#: batch's rows of one kv head. A cache block takes the rep rows of one
#: (batch row, kv head) in chunks of at most 8.
F32_PREFIX_ROWS = 8
#: Resident one-warp blocks an SM the float32 plan counts on: up to 255
#: registers a thread fit eight, fewer where shared memory allows fewer.
F32_DECODE_BLOCKS_PER_SM = 8
#: Query rows a verify_split_f32 block may take; at D = 256 not 64 (a
#: thread holds rows x D / 128 accumulators, at most 64).
VERIFY_F32_ROWS = (16, 32, 64)
#: Resident verify_split_f32 blocks an SM by rows a block, as registers
#: allow (255, 164 and 128 registers a thread at D = 128, ``-Xptxas -v`` on
#: the card), fewer where shared memory allows fewer.
VERIFY_F32_BLOCKS_PER_SM = {16: 4, 32: 3, 64: 2}
#: The verify plan's cost formula, in SM clocks, fitted to the times of
#: every plan at phase 13's and the study's shapes (``tools/
#: torch_f32_attention_ab.py --plans``, H100 80GB HBM3 at 700 W). A
#: block-tile's 64 * rows * D FMAs run at ``VERIFY_F32_FMAS_PER_CLOCK`` an SM
#: a clock (128 at peak), shared by the blocks on the SM; its own chain
#: (block barriers, the softmax, the loads its warps wait on) costs
#: ``VERIFY_F32_TILE_CLOCKS`` and overlaps with the other resident blocks'.
#: A split costs twice its partials' bytes (written, then read by the
#: combine) at ``HBM_BYTES_PER_CLOCK`` (3.35 TB/s at 1.98 GHz), and a plan
#: of more than one split ``VERIFY_F32_COMBINE_CLOCKS`` for combine_splits'
#: launch.
VERIFY_F32_FMAS_PER_CLOCK = 48
VERIFY_F32_TILE_CLOCKS = 1600
VERIFY_F32_COMBINE_CLOCKS = 4000
HBM_BYTES_PER_CLOCK = 1692

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype, kv_int8; q, k, v, valid, sk, sv, ks, vs, q_offsets, o, ws;
# B, Q, H, Hkv, L, D, P, splits_prefix, splits_cache; scale, stream; out: the route
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
# kv_int8; q, k, v, valid, sk, sv, ks, vs, q_offsets, o, ws; B, Q, H, Hkv, L,
# D, P, rows_per_block, splits_prefix, splits_cache; scale, stream; out: the route
_VERIFY_F32_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])

SharedKV = Optional[Tuple[torch.Tensor, torch.Tensor]]


def decode_attention_reference(q, k, v, valid, shared_kv: SharedKV = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               q_offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, in f32: the joint softmax over [prefix; cache]
    with the kernel's ``acc / max(l, 1e-30)`` normalisation and the
    reference's scale folding for an int8 cache."""
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, Q, H, D = q4.shape
    L, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q4.float() * D ** -0.5
    s = torch.einsum("bqhd,blhd->bhql", qf, k.float().repeat_interleave(rep, dim=2))
    vv = v.float()
    if k_scale is not None:
        s = s * k_scale.float().repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    mask = valid.bool()[:, None, :].expand(B, Q, L)
    if multi:
        j = torch.arange(L, device=q.device)
        qi = torch.arange(Q, device=q.device)
        mask = mask & (j[None, None, :] <= (q_offsets.long()[:, None, None] + qi[None, :, None]))
    mask = mask[:, None].expand(B, H, Q, L)
    P = 0 if shared_kv is None else shared_kv[0].shape[0]
    if P:
        sk = shared_kv[0].float().repeat_interleave(rep, dim=1)
        s = torch.cat([torch.einsum("bqhd,phd->bhqp", qf, sk), s], dim=-1)
        mask = torch.cat([torch.ones(B, H, Q, P, dtype=torch.bool, device=q.device), mask],
                         dim=-1)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p_sh, p_own = p[..., :P], p[..., P:]
    if v_scale is not None:
        # The v-scale multiplies the probabilities after the normaliser's sum.
        p_own = p_own * v_scale.float().repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhql,blhd->bqhd", p_own / l, vv.repeat_interleave(rep, dim=2))
    if P:
        sv = shared_kv[1].float().repeat_interleave(rep, dim=1)
        out = out + torch.einsum("bhqp,phd->bqhd", p_sh / l, sv)
    out = out.to(q.dtype)
    return out if multi else out[:, 0]


def _check(q, k, v, valid, shared_kv, k_scale, v_scale, q_offsets) -> None:
    """The reference's argument errors, then shapes and dtypes."""
    multi = q.dim() == 4
    if multi and q_offsets is None:
        raise ValueError("multi-query decode attention needs q_offsets")
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 cache mode needs both k_scale and v_scale")
    if q.dim() not in (3, 4) or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,D] or [B,Q,H,D], k/v [B,L,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    L, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if valid.shape != (B, L):
        raise ValueError(f"valid must be [B, L], got {tuple(valid.shape)}")
    if multi and (q_offsets.shape != (B,) or q_offsets.is_floating_point()):
        raise ValueError(f"q_offsets must be integer [B], got {tuple(q_offsets.shape)}")
    if quant:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError(f"k/v_scale come with an int8 cache, got {k.dtype}/{v.dtype}")
        for sc in (k_scale, v_scale):
            if sc.shape != (B, L, Hkv) or sc.dtype != torch.float32:
                raise ValueError(f"k/v_scale must be float32 [B, L, Hkv], got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    elif k.dtype == torch.int8 or v.dtype == torch.int8:
        raise ValueError("an int8 cache needs k_scale and v_scale")
    dtypes = {q.dtype} | ({k.dtype, v.dtype} if not quant else set())
    if shared_kv is not None:
        sk, sv = shared_kv
        if sk.dim() != 3 or sv.shape != sk.shape or sk.shape[1:] != k.shape[2:]:
            raise ValueError(f"shared k/v must be [P, Hkv, D], got {tuple(sk.shape)}")
        dtypes |= {sk.dtype, sv.dtype}
    if len(dtypes) != 1 or q.dtype not in _DTYPES:
        raise ValueError(f"q, float k/v and shared k/v must share a dtype of {list(_DTYPES)}")


def _plan(prefix_blocks: int, cache_blocks: int, P: int, L: int, wave: int) -> Tuple[int, int]:
    """(splits_prefix, splits_cache) for a grid of ``prefix_blocks`` blocks
    a prefix split and ``cache_blocks`` a cache split: the shortest run of
    whole tiles (the most splits), the same for both kinds, whose grid still
    fits ``wave`` blocks, and one split of each kind where nothing fits."""
    ntp, ntc = -(-P // TILE_KEYS), -(-L // TILE_KEYS)
    for run in range(1, max(ntp, ntc) + 1):
        sp, sc = -(-ntp // run), -(-ntc // run)
        if sp * prefix_blocks + sc * cache_blocks <= wave:
            break
    return sp, sc


def verify_splits(B: int, Hkv: int, rows: int, P: int, L: int, sms: int) -> Tuple[int, int]:
    """How many key splits decode_verify_tc walks the prefix and the own
    cache in: (splits_prefix, splits_cache). Every split is a run of whole
    tiles of one kind, of every batch row: B * Hkv * ceil(rows / 64) blocks
    a split of either kind, in one wave of ``SPLIT_BLOCKS_PER_SM`` blocks on
    each of ``sms`` SMs (``_plan``)."""
    per_split = B * Hkv * -(-rows // 64)
    return _plan(per_split, per_split, P, L, SPLIT_BLOCKS_PER_SM * sms)


@functools.lru_cache(maxsize=256)  # planned on every call's host path: once per shape
def decode_splits(B: int, Hkv: int, rep: int, P: int, L: int, D: int,
                  sms: int) -> Tuple[int, int]:
    """The same for decode_split_tc (one query per row, head width D of
    ``TC_WIDTHS``). A prefix split is shared by the batch: Hkv *
    ceil(B * rep / 64) blocks, each over up to 64 of the B * rep query rows
    of one kv head. A cache split is B * Hkv blocks, one per (batch row, kv
    head). The wave is ``DECODE_BLOCKS_PER_SM[D]`` blocks on each of
    ``sms`` SMs."""
    return _plan(Hkv * -(-B * rep // 64), B * Hkv, P, L, DECODE_BLOCKS_PER_SM[D] * sms)


def f32_decode_smem(D: int) -> int:
    """Shared memory of a decode_split_f32 block at head width D (of
    ``F32_WIDTHS``) at most, without the mask words of its run: two ring
    slots of a k and a v tile of 32 float rows (D + 4 floats apart) and 64
    scales, then up to 8 query rows."""
    tile = -(-4 * 32 * (D + 4) // 16) * 16
    return 2 * (2 * tile + 256) + -(-4 * F32_PREFIX_ROWS * D // 16) * 16


@functools.lru_cache(maxsize=256)  # planned on every call's host path: once per shape
def decode_splits_f32(B: int, Hkv: int, rep: int, P: int, L: int, D: int,
                      sms: int) -> Tuple[int, int]:
    """The same for decode_split_f32 (float32, one query per row; D the
    padded head width). A block is one warp: a prefix split is Hkv *
    ceil(B * rep / 8) blocks (``F32_PREFIX_ROWS``), shared by the batch; a
    cache split B * Hkv * ceil(rep / 8). The wave is
    ``F32_DECODE_BLOCKS_PER_SM`` blocks an SM, or fewer where the blocks'
    shared memory allows fewer."""
    rows = F32_PREFIX_ROWS
    per_sm = min(F32_DECODE_BLOCKS_PER_SM, _build.SMEM_PER_SM // (f32_decode_smem(D) + 1024))
    return _plan(Hkv * -(-B * rep // rows), B * Hkv * -(-rep // rows), P, L, per_sm * sms)


def verify_f32_smem(rows: int, D: int) -> int:
    """Shared memory of a verify_split_f32 block of ``rows`` query rows at
    head width D (of ``F32_WIDTHS``), without the mask words of its run:
    the ring (two slots of a float k and v tile of 32 rows, D + 4 floats
    apart, or two int8 slots and the float tile they convert into), the
    query rows, P (40 floats a row) and two floats a row."""
    tile = 4 * 32 * (D + 4)
    slot8 = -(-(2 * 32 * (D + 16) + 256) // 16) * 16
    return max(4 * tile, 2 * slot8 + 2 * tile) + 4 * rows * (D + 4) + 4 * rows * 40 + 8 * rows


@functools.lru_cache(maxsize=256)  # planned on every call's host path: once per shape
def verify_splits_f32(B: int, Hkv: int, rows: int, P: int, L: int, D: int,
                      sms: int) -> Tuple[int, int, int]:
    """(rows a block, splits_prefix, splits_cache) of verify_split_f32 (the
    float32 verify window; ``rows`` = rep * Q query rows of a (batch row, kv
    head), D the padded head width). A prefix split is Hkv * ceil(B * rows /
    R) blocks of R rows, shared by the batch; a cache split B * Hkv *
    ceil(rows / R). For each R of ``VERIFY_F32_ROWS`` whose block fits and
    each run of whole tiles (the same for both kinds, as ``_plan``), the
    cost of the busiest SM is its share of the plan's block-tiles (ceil(work
    / sms)) times a block-tile's FMA clocks, plus the tile chain of its
    longest resident block (ceil(work / (k * sms)), k resident blocks an
    SM, or one block's run, whichever is longer) times the chain's clocks,
    plus the splits' (the constants above). The cheapest plan is taken, a
    tie going to fewer splits, then to more rows. It may take more than one
    wave of resident blocks: at llama3-8b's gate shapes two waves of runs of
    11 tiles beat one of 22."""
    ntp, ntc = -(-P // TILE_KEYS), -(-L // TILE_KEYS)
    split = 2 * (B * Hkv * rows * (D + 2) * 8) // HBM_BYTES_PER_CLOCK  # one split's partials
    best = None
    for rb in sorted(VERIFY_F32_ROWS, reverse=True):
        if rb * D > 8192 or verify_f32_smem(rb, D) > _build.SMEM_PER_BLOCK:
            continue
        pre, cache = Hkv * -(-B * rows // rb), B * Hkv * -(-rows // rb)
        k = min(VERIFY_F32_BLOCKS_PER_SM[rb],
                _build.SMEM_PER_SM // (verify_f32_smem(rb, D) + 1024))
        work = pre * ntp + cache * ntc  # block-tiles, whatever the splits
        fma = -(-work // sms) * (64 * rb * D // VERIFY_F32_FMAS_PER_CLOCK)
        for run in range(max(ntp, ntc), 0, -1):
            sp, sc = -(-ntp // run), -(-ntc // run)
            cost = fma + max(-(-work // (k * sms)), run) * VERIFY_F32_TILE_CLOCKS
            if sp + sc > 1:
                cost += (sp + sc) * split + VERIFY_F32_COMBINE_CLOCKS
            if best is None or cost < best[0]:
                best = (cost, rb, sp, sc)
    return best[1:]


@functools.lru_cache(maxsize=64)  # on every call's host path: a refusal raises, uncached
def check_verify_rows(rows: int, D: int) -> None:
    """Refuse a row count verify_split_f32 does not take at head width D."""
    if (rows not in VERIFY_F32_ROWS or rows * D > 8192
            or verify_f32_smem(rows, D) > _build.SMEM_PER_BLOCK):
        raise _build.KernelError(f"decode_attention: a verify block of {rows} query rows at "
                                 f"D={D} does not fit verify_split_f32")


@functools.lru_cache(maxsize=256)  # on every call's host path: a refusal raises, uncached
def check_splits(sp: int, sc: int, P: int, L: int) -> None:
    """Refuse a split plan the split kernels refuse: between one split and
    one tile a split of each kind present (none of a kind absent)."""
    ntp, ntc = -(-P // TILE_KEYS), -(-L // TILE_KEYS)
    if not ((ntp > 0) <= sp <= ntp and (ntc > 0) <= sc <= ntc):
        raise _build.KernelError(f"decode_attention: the plan of {sp} prefix and {sc} cache "
                                 f"splits does not fit {ntp} prefix and {ntc} cache tiles")


# The split kernels' f32 workspace by (device, stream), grown to the largest
# call so far (``_build.grown``).
_workspaces: dict = {}


def _workspace(numel: int, device: torch.device, stream: int) -> torch.Tensor:
    return _build.grown(_workspaces, (device, stream), numel, torch.float32, device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, shared_kv: SharedKV = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     q_offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, D] (3-D q) or [B, Q, H, D] (4-D q) attention output; see the
    module docstring. ``q_offsets`` is read only for 4-D q, as the
    reference reads it. Under a cost walk the call charges
    ``decode_cost`` to ``attention``."""
    if costmodel.walk_active():
        with costmodel.kernel_cost("attention", lambda: decode_cost(
                q, k, valid, shared_kv, k_scale, q_offsets)):
            return _decode_attention(q, k, v, valid, shared_kv, k_scale, v_scale, q_offsets)
    return _decode_attention(q, k, v, valid, shared_kv, k_scale, v_scale, q_offsets)


def decode_cost(q, k, valid, shared_kv: SharedKV = None, k_scale=None,
                q_offsets=None) -> Tuple[int, int]:
    """(bytes, operations) this input needs: q and the output; k/v (and
    their int8 scales) of every cache slot some query sees; the prefix; the
    validity mask; the offsets. 4*D operations per visible (query, key)
    pair per head. The counts behind the kernels' bound, which the cost
    ledger charges for a call (``telemetry/costmodel.kernel_cost``)."""
    multi, quant = q.dim() == 4, k_scale is not None
    B, D, H = q.shape[0], q.shape[-1], q.shape[-2]
    Q = q.shape[1] if multi else 1
    L, Hkv = k.shape[1], k.shape[2]
    P = 0 if shared_kv is None else shared_kv[0].shape[0]
    sees = valid.bool()[:, None, :].expand(B, Q, L)
    if multi:
        dev = valid.device
        last = q_offsets.long()[:, None, None] + torch.arange(Q, device=dev)[None, :, None]
        sees = sees & (torch.arange(L, device=dev)[None, None, :] <= last)
    needed = int(sees.any(1).sum())
    pairs = int(sees.sum()) + B * Q * P
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * needed * Hkv * D * k.element_size()
              + (2 * needed * Hkv * 4 if quant else 0) + 2 * P * Hkv * D * item + B * L
              + (4 * B if multi else 0))
    return nbytes, 4 * D * H * pairs


def _decode_attention(q, k, v, valid, shared_kv, k_scale, v_scale, q_offsets) -> torch.Tensor:
    _check(q, k, v, valid, shared_kv, k_scale, v_scale, q_offsets)
    multi = q.dim() == 4
    quant = k_scale is not None
    if not multi:
        q_offsets = None
    tensors = [t for t in (q, k, v, valid, k_scale, v_scale, q_offsets, *(shared_kv or ()))
               if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_reference(q, k, v, valid, shared_kv, k_scale, v_scale,
                                          q_offsets)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must lie on the CPU or on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    B, D = q.shape[0], q.shape[-1]
    Q = q.shape[1] if multi else 1
    H = q.shape[-2]
    L, Hkv = k.shape[1], k.shape[2]
    if D > 256 or H // Hkv > 32 or Q > 64:
        raise ValueError(f"decode_attention kernel supports D <= 256, rep <= 32 and Q <= 64, "
                         f"got D={D}, rep={H // Hkv}, Q={Q}")
    P = 0 if shared_kv is None else shared_kv[0].shape[0]
    if P + L == 0:
        raise ValueError("decode_attention: no keys")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be bool or uint8, got {valid.dtype}")
    tc = q.dtype == torch.bfloat16
    Dk = next(w for w in (TC_WIDTHS if tc else F32_WIDTHS) if w >= D)
    # Contiguous rows of an instantiated width are whole 16-byte chunks; only
    # where a tensor starts can be off.
    aligned = all(t.data_ptr() % 16 == 0 for t in [q, k, v] + list(shared_kv or ()))
    if Dk != D or not aligned:
        # Zero columns add nothing to q.k and give output columns cut off below.
        q, k, v = (_build.pad_last_dim(t, Dk) for t in (q, k, v))
        if shared_kv is not None:
            shared_kv = tuple(_build.pad_last_dim(t, Dk) for t in shared_kv)
    if multi:
        q_offsets = q_offsets.to(torch.int32).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    out = torch.empty_like(q)
    stream = _build.current_stream(q.device)
    sms = _build.sm_count(q.device)
    rows = 0
    if multi and tc:
        sp, sc = verify_splits(B, Hkv, (H // Hkv) * Q, P, L, sms)
    elif multi:
        rows, sp, sc = verify_splits_f32(B, Hkv, (H // Hkv) * Q, P, L, Dk, sms)
        check_verify_rows(rows, Dk)
    elif tc:
        sp, sc = decode_splits(B, Hkv, H // Hkv, P, L, Dk, sms)
    else:
        sp, sc = decode_splits_f32(B, Hkv, H // Hkv, P, L, Dk, sms)
    check_splits(sp, sc, P, L)
    ws = _workspace((sp + sc) * B * Q * H * (Dk + 2), q.device, stream) if sp + sc > 1 else None
    tensors = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
               ptr(shared_kv[0]) if P else None, ptr(shared_kv[1]) if P else None,
               ptr(k_scale), ptr(v_scale), ptr(q_offsets), out.data_ptr(), ptr(ws))
    kernel = ctypes.c_int(-1)
    if multi and not tc:
        fn = _build.function("decode_verify_f32", "decode_verify_f32_fwd", _VERIFY_F32_ARGTYPES)
        status = fn(int(quant), *tensors, B, Q, H, Hkv, L, Dk, P, rows, sp, sc, D ** -0.5,
                    stream, ctypes.byref(kernel))
    else:
        fn = (_build.function("decode_attention", "decode_attention_fwd", _ARGTYPES) if tc else
              _build.function("decode_attention_f32", "decode_attention_f32_fwd", _ARGTYPES))
        status = fn(_DTYPES[q.dtype], int(quant), *tensors, B, Q, H, Hkv, L, Dk, P, sp, sc,
                    D ** -0.5, stream, ctypes.byref(kernel))
    _build.check(status, "decode_attention")
    global launches, quant_launches, multi_launches, multi_quant_launches
    global multi_tc_launches, decode_tc_launches, decode_f32_launches, verify_f32_launches
    if multi and quant:
        multi_quant_launches += 1
    elif multi:
        multi_launches += 1
    elif quant:
        quant_launches += 1
    else:
        launches += 1
    multi_tc_launches += kernel.value == _VERIFY_TC
    decode_tc_launches += kernel.value == _DECODE_TC
    decode_f32_launches += kernel.value == _DECODE_F32
    verify_f32_launches += kernel.value == _VERIFY_F32
    return out if Dk == D else out[..., :D]
