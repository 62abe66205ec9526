"""Ring attention: exact attention over a sequence split across the sp ranks
(counterpart of ``fairness_llm_tpu/parallel/ring.py``).

Each sp rank holds a contiguous block of the sequence: its queries, keys,
values, their global positions and validity. ``ring_attention`` runs ``sp``
steps. In each, the rank attends its queries to the k/v block it holds now,
folding the result into an online-softmax accumulator in float32 (running
max ``m``, denominator ``l``, unnormalised output ``o``), and passes the
block with its positions and validity to the next rank of the ring (rank
``i`` sends to ``i + 1`` and receives from ``i - 1``, with
``torch.distributed`` point-to-point ops posted together, so the transfer
overlaps the step). After ``sp`` steps every query has seen every key once:
the same function as dense attention, to float32 rounding.

The reference runs it under ``shard_map`` with ``lax.ppermute``; here the
group is an explicit process group, and a group of one rank (or None) is
plain attention over the local block. The hop is an autograd function
whose backward sends the cotangent back around the ring, which is what
``ppermute``'s transpose does, so the sequence-parallel training step
(``train/step.py``) differentiates through it. Under gloo the blocks travel
through the CPU (its point-to-point ops take no CUDA tensor); under NCCL
they stay on the card.

GQA: k/v keep their ``Hkv`` heads on the ring (``Hkv/H`` of the bytes of
expanded heads) and in the products: the queries are viewed as ``[B, S,
Hkv, H/Hkv, D]`` against each kv head, with no repeated copy of k or v.
The sliding window is over global positions.

This is plain torch, as the reference's is plain jnp: it brings no kernel.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch


def _group_size(group: Any) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _ring_send_recv(tensors: Sequence[torch.Tensor], group: Any, forward: bool
                    ) -> Tuple[torch.Tensor, ...]:
    """Send each tensor one hop round the ring of ``group`` (to the next
    rank when ``forward``, else to the previous) and return what arrives
    from the other side, on the tensors' devices."""
    import torch.distributed as dist

    from fairness_llm_tpu_torch.parallel.multihost import collective_device

    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    dst, src = (nxt, prv) if forward else (prv, nxt)
    ops, bufs = [], []
    for i, t in enumerate(tensors):
        wire_dev = collective_device(t.device)
        wire = t.detach().to(wire_dev).contiguous()
        if wire.dtype == torch.bool:
            wire = wire.to(torch.uint8)
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, dst, group=group, tag=i))
        ops.append(dist.P2POp(dist.irecv, buf, src, group=group, tag=i))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(b.to(device=t.device, dtype=t.dtype) for b, t in zip(bufs, tensors))


class _RingHop(torch.autograd.Function):
    """One hop of a float tensor round the ring; its backward sends the
    gradient the other way."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return _ring_send_recv((t,), group, forward=True)[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _ring_send_recv((grad,), ctx.group, forward=False)[0], None


def _hop(blocks: Tuple[torch.Tensor, ...], group: Any) -> Tuple[torch.Tensor, ...]:
    """k, v (differentiable) and their positions and validity, one hop on."""
    k, v, kpos, kval = blocks
    if k.requires_grad or v.requires_grad:
        return (_RingHop.apply(k, group), _RingHop.apply(v, group),
                *_ring_send_recv((kpos, kval), group, forward=True))
    return _ring_send_recv(blocks, group, forward=True)


def _block_attn(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                scale: float):
    """One block's (row max, exp sum, unnormalised output) in float32.
    ``qg`` [B, Sq, Hkv, rep, D], k/v [B, Sk, Hkv, D], mask [B, Sq, Sk].
    A row with no visible key keeps a neutral accumulator (max 0, sum 0)."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
    allowed = mask[:, None, None]
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1)  # [B, Hkv, rep, Sq]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(allowed, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return m_safe, l, o


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   kv_valid: torch.Tensor, group: Any = None, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """Exact attention of this rank's queries ``q`` [B, Sq, H, D] over the
    k/v blocks [B, Sk, Hkv, D] of every rank of ``group`` (the sp ring;
    None or one rank: the local block alone). ``q_positions`` [B, Sq] and
    ``kv_positions`` [B, Sk] are global positions, ``kv_valid`` [B, Sk]
    the padding mask. Returns [B, Sq, H, D] in q's dtype."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, Hkv, rep, D)
    n = _group_size(group)

    def mask_for(kpos, kval):
        m = kval.bool()[:, None, :]
        if causal:
            m = m & (kpos[:, None, :] <= q_positions[:, :, None])
        if window is not None:
            m = m & ((q_positions[:, :, None] - kpos[:, None, :]) < window)
        return m

    m_acc = torch.full((B, Hkv, rep, Sq), float("-inf"), dtype=torch.float32, device=q.device)
    l_acc = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=q.device)
    o_acc = torch.zeros((B, Sq, Hkv, rep, D), dtype=torch.float32, device=q.device)
    blocks = (k, v, kv_positions, kv_valid)
    for step in range(n):
        kb, vb, kpos, kval = blocks
        m_blk, l_blk, o_blk = _block_attn(qg, kb.float(), vb.float(), mask_for(kpos, kval),
                                          scale)
        m_new = torch.maximum(m_acc, m_blk)
        a = torch.exp(m_acc - m_new)
        b = torch.exp(m_blk - m_new)
        l_acc = l_acc * a + l_blk * b
        o_acc = (o_acc * a.permute(0, 3, 1, 2)[..., None]
                 + o_blk * b.permute(0, 3, 1, 2)[..., None])
        m_acc = m_new
        if step < n - 1:
            blocks = _hop(blocks, group)
    denom = l_acc.permute(0, 3, 1, 2)[..., None].clamp_min(1e-30)
    return (o_acc / denom).reshape(B, Sq, H, D).to(q.dtype)


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def ring_attention_sharded(mesh: Any, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           positions: torch.Tensor, valid: torch.Tensor, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """The reference's ``shard_map`` wrapper: global [B, S, H, D] inputs on
    every rank, batch over "dp", sequence over "sp" and heads (q and kv)
    over "tp". Each rank runs ``ring_attention`` over its block on its sp
    ring; the blocks are summed into the global output over the world (each
    block has one owner), so every rank returns the whole [B, S, H, D]."""
    import torch.distributed as dist

    from fairness_llm_tpu_torch.parallel.multihost import collective_device
    from fairness_llm_tpu_torch.parallel.sharding import axis_group, axis_rank, axis_size

    coords = {a: (axis_size(mesh, a), axis_rank(mesh, a)) for a in ("dp", "sp", "tp")}
    (dp, di), (sp, si), (tp, ti) = coords["dp"], coords["sp"], coords["tp"]
    qb = _block(_block(_block(q, 0, dp, di), 1, sp, si), 2, tp, ti)
    kb = _block(_block(_block(k, 0, dp, di), 1, sp, si), 2, tp, ti)
    vb = _block(_block(_block(v, 0, dp, di), 1, sp, si), 2, tp, ti)
    pos = _block(_block(positions, 0, dp, di), 1, sp, si)
    val = _block(_block(valid, 0, dp, di), 1, sp, si)
    out_b = ring_attention(qb, kb, vb, pos, pos, val,
                           group=axis_group(mesh, "sp") if sp > 1 else None,
                           causal=causal, window=window)
    full = torch.zeros(q.shape, dtype=torch.float32, device=collective_device(q.device))
    B, S, H = q.shape[0] // dp, q.shape[1] // sp, q.shape[2] // tp
    full[di * B:(di + 1) * B, si * S:(si + 1) * S, ti * H:(ti + 1) * H] = \
        out_b.float().to(full.device)
    if dist.is_initialized() and dp * sp * tp > 1:
        dist.all_reduce(full)
    return full.to(device=q.device, dtype=q.dtype)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             positions: torch.Tensor, valid: torch.Tensor,
                             causal: bool = True, window: Optional[int] = None
                             ) -> torch.Tensor:
    """Dense attention with the same masks, on one device (the test
    oracle): scores in float32, a row with no visible key gives zeros. GQA
    k/v are repeated to the q heads."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = valid.bool()[:, None, :]
    if causal:
        mask = mask & (positions[:, None, :] <= positions[:, :, None])
    if window is not None:
        mask = mask & ((positions[:, :, None] - positions[:, None, :]) < window)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
