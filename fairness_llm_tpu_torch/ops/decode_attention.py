"""Single-token decode attention with a shared-prefix seed.

Counterpart of ``fairness_llm_tpu/ops/decode_attention.py`` for 3-D q and a
float cache: q [B, H, D] against the shared prefix k/v [P, Hkv, D] (common to
every row, always visible) and the row's own cache k/v [B, L, Hkv, D] under
``valid`` [B, L], in one joint softmax; head h reads kv head ``h // rep``.

``decode_attention`` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for a CUDA tensor and takes the plain version,
``decode_attention_reference``, only for a CPU tensor. The int8 cache (k/v
scales) and the 4-D speculative verify window are not ported: the wrapper
refuses both. Where k/v rows are not 16-byte aligned (a D of odd byte size,
an odd offset), the inputs are copied with D zero-padded before the launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fairness_llm_tpu_torch.ops import _build

NEG_INF = -1e30

#: Kernel launches since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype; q, k, v, valid, sk, sv, o; B, H, Hkv, L, D, P; scale; stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def decode_attention_reference(q, k, v, valid,
                               shared_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version, in f32: the joint softmax over [prefix; cache]
    with the kernel's ``acc / max(l, 1e-30)`` normalisation."""
    B, H, D = q.shape
    rep = H // k.shape[2]
    qf = q.float() * D ** -0.5
    kk = k.float().repeat_interleave(rep, dim=2)
    vv = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,blhd->bhl", qf, kk)
    mask = valid.bool()[:, None, :].expand(B, H, -1)
    if shared_kv is not None and shared_kv[0].shape[0]:
        sk = shared_kv[0].float().repeat_interleave(rep, dim=1)
        sv = shared_kv[1].float().repeat_interleave(rep, dim=1)
        s = torch.cat([torch.einsum("bhd,phd->bhp", qf, sk), s], dim=-1)
        mask = torch.cat([torch.ones(B, H, sk.shape[0], dtype=torch.bool,
                                     device=q.device), mask], dim=-1)
        vv = torch.cat([sv[None].expand(B, -1, -1, -1), vv], dim=1)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhl,blhd->bhd", p / l.clamp_min(1e-30), vv)
    return out.to(q.dtype)


def _check(q, k, v, valid, shared_kv):
    if q.dim() == 4:
        raise NotImplementedError(
            "multi-query (speculative verify) decode attention is not ported")
    if k.dtype == torch.int8 or v.dtype == torch.int8:
        raise NotImplementedError("int8 KV-cache decode attention is not ported")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,D], k/v [B,L,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if valid.shape != (B, k.shape[1]):
        raise ValueError(f"valid must be [B, L], got {tuple(valid.shape)}")
    dtypes = {q.dtype, k.dtype, v.dtype}
    if shared_kv is not None:
        sk, sv = shared_kv
        if sk.dim() != 3 or sv.shape != sk.shape or sk.shape[1:] != k.shape[2:]:
            raise ValueError(f"shared k/v must be [P, Hkv, D], got {tuple(sk.shape)}")
        dtypes |= {sk.dtype, sv.dtype}
    if len(dtypes) != 1 or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v (and shared k/v) must share a dtype of {list(_DTYPES)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor,
                     shared_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """[B, H, D] attention output; see the module docstring."""
    _check(q, k, v, valid, shared_kv)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, valid, shared_kv)
    tensors = [q, k, v, valid] + list(shared_kv or ())
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must lie on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if D > 256 or H // Hkv > 32:
        raise ValueError(f"decode_attention kernel supports D <= 256 and rep <= 32, "
                         f"got D={D}, rep={H // Hkv}")
    P = 0 if shared_kv is None else shared_kv[0].shape[0]
    if P + L == 0:
        raise ValueError("decode_attention: no keys")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be bool or uint8, got {valid.dtype}")
    Dk = D
    if not all(_build.rows_aligned16(t) for t in [k, v] + list(shared_kv or ())):
        # Zero columns add nothing to q.k and give output columns cut off below.
        ve = 16 // q.element_size()
        Dk = -(-D // ve) * ve
        q, k, v = (_build.pad_last_dim(t, Dk) for t in (q, k, v))
        if shared_kv is not None:
            shared_kv = tuple(_build.pad_last_dim(t, Dk) for t in shared_kv)
    sk_ptr = shared_kv[0].data_ptr() if P else None
    sv_ptr = shared_kv[1].data_ptr() if P else None
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    status = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), sk_ptr, sv_ptr, out.data_ptr(),
        B, H, Hkv, L, Dk, P, D ** -0.5,
        _build.current_stream(q.device),
    )
    _build.check(status, "decode_attention")
    global launches
    launches += 1
    return out if Dk == D else out[..., :D]
