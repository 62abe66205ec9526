"""The engine's and the server's decode programs as plain functions
(counterpart of ``fairness_llm_tpu/runtime/stepbuilder.py``:
``make_batch_entry``, ``make_greedy_loop``, ``build_engine_decode``,
``build_spec_decode``, ``build_prefix``, the serving programs
``build_serve_step``, ``build_serve_prefill`` and ``build_paged_prefill``,
and the mesh axis of ``program_label`` and ``compile_key``: ``tp_key``).

PyTorch runs eagerly, so the reference's compiled ``while_loop`` becomes a
Python loop that stops once every live row is done. Each step reads a few
bytes back to the host to decide that: the new tokens of the plain loop
(which also advance each row's ``(row_seed, emitted)`` sampling stream), or
the accepted counts of the speculative loop. Both hold their per-row write
offsets on the host and check them there (``check_write_offsets``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fairness_llm_tpu_torch.integrity.numerics import masked_finite
from fairness_llm_tpu_torch.models.transformer import (
    _dequantize_kv,
    check_write_offsets,
    dtype_of,
    init_cache,
)
from fairness_llm_tpu_torch.runtime.sampling import (
    SamplerSettings,
    greedy_accept_length,
    make_sampler,
    row_gumbel,
)
from fairness_llm_tpu_torch.runtime.speculative import ngram_draft
from fairness_llm_tpu_torch.telemetry import costmodel

SharedLayers = Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def program_label(base: str, fuse: int = 1, tp: int = 1) -> str:
    """A step program's telemetry name, as the reference's: ``<base>_fused``
    for a fused dispatch, and ``@tp<k>`` after it on a tp mesh; unchanged at
    ``fuse=1, tp=1``."""
    label = base if fuse <= 1 else f"{base}_fused"
    return label if tp <= 1 else f"{label}@tp{tp}"


def tp_key(key: tuple, tp: int) -> tuple:
    """A program key on a tp mesh: the reference's tagged ``("tp", k)``
    element appended, so it never equals a single-device key; unchanged at
    ``tp=1``."""
    return key if tp <= 1 else key + (("tp", tp),)


def make_batch_entry(cfg, model, *, batch: int, cache_len: int, prefix_len: int = 0):
    """The left-padded batch prefill: positions from the valid cumsum
    (prefix-offset, pad slots clamped), a fresh cache of ``cache_len`` slots,
    one forward with ``last_only`` logits. Returns ``entry(tokens, valid,
    shared_layers) -> (last_logits [B, V], cache)``."""

    def entry(tokens, valid, shared_layers: SharedLayers):
        positions = prefix_len + (torch.cumsum(valid.long(), dim=1) - 1).clamp_min(0)
        cache = init_cache(model.config, batch, cache_len, device=tokens.device)
        logits, cache = model(tokens, positions, valid, cache, left_padded=True,
                              last_only=True, shared_layers=shared_layers)
        return logits[:, -1, :], cache

    return entry


class LoopOut(NamedTuple):
    """What a decode loop returns."""

    toks: np.ndarray  # [batch, steps] int32, pad where a row emitted nothing
    steps: int  # steps run
    finite: bool  # every logit a live row sampled from was finite
    emitted: np.ndarray  # [batch] tokens emitted per row, emitted0 included
    row_steps: int  # live rows summed over the steps run
    logits: torch.Tensor  # [batch, V] the carried logits after the last step


def make_greedy_loop(model, sample, pad_id: int, eos_id: int, *, batch: int,
                     steps: int, prefix_len: int = 0, greedy: bool = True):
    """The decode loop of the engine and of the serve step. Per iteration:
    sample from the carried logits with the row's own ``(row_seed,
    emitted)`` stream, record the token, forward one token under the row's
    live mask, carry the new logits, advance ``emitted``/``done`` (EOS or
    the row's cap). Stops when every live row is done or after ``steps``.

    Returns ``loop(cache, prev_logits, row_seeds, live0, shared_layers,
    emitted0=None, base=None, caps=None) -> LoopOut``; ``emitted0``
    (default 0), ``base`` and ``caps`` (default ``steps``) are per-row numpy
    arrays. With ``base`` row b writes its token at cache slot ``base[b] +
    emitted[b]`` (the serving slot layout), the offsets checked on the host
    before each forward, and a row that is done writes an invalid key at
    its next offset, held inside the cache; without it the cache writes at
    its own index (the engine layout)."""
    B, T = batch, steps

    def loop(cache, prev_logits, row_seeds: Sequence[int], live0: np.ndarray,
             shared_layers: SharedLayers, emitted0: Optional[np.ndarray] = None,
             base: Optional[np.ndarray] = None, caps: Optional[np.ndarray] = None) -> LoopOut:
        dev = prev_logits.device
        toks = np.full((B, T), pad_id, np.int32)
        done = ~live0
        emitted = (np.zeros(B, np.int64) if emitted0 is None
                   else np.asarray(emitted0, np.int64).copy())
        caps = np.full(B, T, np.int64) if caps is None else np.asarray(caps, np.int64)
        gens: List[torch.Generator] = [] if greedy else [
            torch.Generator(device=dev) for _ in range(B)]
        finite = masked_finite(prev_logits, torch.from_numpy(live0).to(dev))
        t = row_steps = 0
        # The cost ledger charges the first iteration as the step
        # (telemetry/costmodel.decode_loop).
        with costmodel.decode_loop() as mark:
            while t < T and not done.all():
                with mark(t):
                    live = ~done
                    live_dev = torch.from_numpy(live).to(dev)
                    gumbel = None if greedy else row_gumbel(
                        row_seeds, emitted, prev_logits.shape[-1], dev, gens)
                    tok = sample(prev_logits, gumbel)
                    tok = torch.where(live_dev, tok, torch.full_like(tok, pad_id))
                    pos = prefix_len + cache.lengths[:, None]
                    kw = {}
                    if base is not None:
                        off = base + emitted
                        off = np.where(live, off, np.minimum(off, cache.max_len - 1))
                        check_write_offsets(off, 1, cache.max_len)
                        kw["write_offsets"] = torch.from_numpy(off).to(dev)
                    logits, cache = model(tok[:, None], pos, live_dev[:, None], cache,
                                          shared_layers=shared_layers, **kw)
                    prev_logits = torch.where(live_dev[:, None], logits[:, -1, :], prev_logits)
                    finite = finite & masked_finite(logits[:, -1], live_dev)
                    tok_host = tok.cpu().numpy()
                toks[:, t] = tok_host
                row_steps += int(live.sum())
                emitted += live
                done = done | (tok_host == eos_id) | (emitted >= caps)
                t += 1
        return LoopOut(toks, t, bool(finite), emitted, row_steps, prev_logits)

    return loop


def build_engine_decode(cfg, model, sampler: SamplerSettings, pad_id: int,
                        eos_id: int, *, batch: int, prompt_len: int, max_new: int,
                        prefix_len: int):
    """Batch entry + the decode loop with a uniform cap of ``max_new``.
    Returns ``(entry, loop)``: the engine times the two apart."""
    entry = make_batch_entry(cfg, model, batch=batch, cache_len=prompt_len + max_new,
                             prefix_len=prefix_len)
    loop = make_greedy_loop(model, make_sampler(sampler), pad_id, eos_id,
                            batch=batch, steps=max_new, prefix_len=prefix_len,
                            greedy=sampler.greedy)
    return entry, loop


def build_spec_decode(cfg, model, pad_id: int, eos_id: int, *, batch: int,
                      prompt_len: int, max_new: int, prefix_len: int,
                      ngram_max: int, draft_len: int):
    """Greedy draft-and-verify decode. Each iteration runs ONE forward over
    ``S = draft_len + 1`` positions per row (the greedy next token and the
    prompt-lookup drafts) and keeps the longest prefix that matches greedy
    argmax: 1 to S tokens a step, equal to plain greedy decode by
    construction.

    Rows advance at their own rates, so the forward writes at per-row
    ``write_offsets`` (slot = prompt_len + tokens emitted), the rejected
    window slots are marked invalid again afterwards (the next window
    starts inside them and overwrites them), and ``lengths`` advances by the
    emitted count, not by S. The cache carries ``draft_len`` spare slots, so
    the last window of a nearly finished row still fits. A failed step
    raises (the engine retries the call on the plain path when its
    speculate breaker is armed).

    Returns ``(entry, loop)``: ``entry`` as ``make_batch_entry`` gives it,
    and ``loop(cache, prev_logits, tokens, valid, live0, shared_layers,
    prefix_toks) -> (toks [batch, max_new] int32 numpy, out_len [batch]
    numpy, counters (drafted, accepted, verify_steps), logits_finite)``.
    """
    k = draft_len
    S = k + 1
    cache_len = prompt_len + max_new + k
    gen_len = max_new + k  # room for a whole window past max_new; cut on return
    gen_start = prefix_len + prompt_len
    entry = make_batch_entry(cfg, model, batch=batch, cache_len=cache_len,
                             prefix_len=prefix_len)

    def loop(cache, prev_logits, tokens, valid, live0: np.ndarray,
             shared_layers: SharedLayers, prefix_toks: torch.Tensor):
        dev = prev_logits.device
        B = batch
        # Lookup context: [shared prefix | left-padded remainder | output];
        # ctx_valid masks the pad gaps out of the n-gram matches.
        ctx_prompt = torch.cat([prefix_toks.long()[None].expand(B, -1), tokens], dim=1)
        ctx_prompt_valid = torch.cat(
            [torch.ones(B, prefix_len, dtype=torch.bool, device=dev), valid], dim=1)
        gpos = torch.arange(gen_len, device=dev)[None, :]
        step_iota = torch.arange(S, device=dev)
        slot = torch.arange(cache_len, device=dev)[None, :]
        rows = torch.arange(B, device=dev)
        gen = torch.full((B, gen_len), pad_id, dtype=torch.long, device=dev)
        out_len = np.zeros(B, np.int64)
        done = ~live0
        drafted = accepted = steps = 0
        finite = masked_finite(prev_logits, torch.from_numpy(live0).to(dev))
        # The cost ledger charges the first verify step as the step.
        with costmodel.decode_loop() as mark:
            while steps < max_new and not done.all():
                with mark(steps):
                    live = ~done
                    live_dev = torch.from_numpy(live).to(dev)
                    out_len_dev = torch.from_numpy(out_len).to(dev)
                    # The step's sure token: greedy argmax of the carried logits.
                    t0 = torch.where(live_dev, prev_logits.argmax(dim=-1),
                                     torch.full((B,), pad_id, dtype=torch.long, device=dev))
                    # Drafts from the history including t0.
                    gen_t0 = torch.where((gpos == out_len_dev[:, None]) & live_dev[:, None],
                                         t0[:, None], gen)
                    ctx = torch.cat([ctx_prompt, gen_t0], dim=1)
                    ctx_valid = torch.cat([ctx_prompt_valid, gpos <= out_len_dev[:, None]], dim=1)
                    drafts = ngram_draft(ctx, ctx_valid, gen_start + out_len_dev + 1, k, ngram_max,
                                         pad_id)
                    inp = torch.cat([t0[:, None], drafts], dim=1)  # [B, S]

                    # Verify all S positions in one forward at per-row slots.
                    off_host = np.minimum(prompt_len + out_len, cache_len - S)
                    check_write_offsets(off_host, S, cache.max_len)
                    off = torch.from_numpy(off_host).to(dev)
                    lengths0 = cache.lengths.clone()
                    pos = prefix_len + lengths0[:, None] + step_iota[None, :]
                    logits, cache = model(inp, pos, live_dev[:, None].expand(B, S), cache,
                                          shared_layers=shared_layers, write_offsets=off)
                    finite = finite & masked_finite(logits, live_dev)
                    g = logits.argmax(dim=-1)  # g[:, i]: the token after input position i
                    a = greedy_accept_length(drafts, g[:, :k])
                    eos_first = torch.where(inp == eos_id, step_iota[None, :],
                                            torch.full_like(inp, S)).amin(dim=1)
                    a_host, eos_host = torch.stack([a, eos_first]).cpu().numpy()
                    # Emitted: the accepted prefix, cut after the first EOS and at
                    # the max_new cap; 0 for done rows.
                    e = np.minimum(np.minimum(a_host + 1, eos_host + 1), max_new - out_len)
                    e = np.where(live, e, 0)
                    e_dev = torch.from_numpy(e).to(dev)

                    widx = gpos - out_len_dev[:, None]
                    wtok = inp.gather(1, widx.clamp(0, S - 1))
                    gen = torch.where((widx >= 0) & (widx < e_dev[:, None]), wtok, gen)
                    # Carry the logits after the last emitted token.
                    nl = logits[rows, (e_dev - 1).clamp(0, S - 1)]
                    prev_logits = torch.where(live_dev[:, None], nl, prev_logits)
                    # Rejected window slots become invalid; lengths advance by e.
                    wpos = slot - off[:, None]
                    cache.key_valid &= ~((wpos >= 0) & (wpos < S) & (wpos >= e_dev[:, None]))
                    cache.lengths = lengths0 + e_dev

                    out_len += e
                    done = done | (live & (eos_host < e)) | (out_len >= max_new)
                    drafted += k * int(live.sum())
                    accepted += int(np.maximum(e - 1, 0).sum())
                    steps += 1
        toks = gen[:, :max_new].to(torch.int32).cpu().numpy()
        return toks, out_len, (drafted, accepted, steps), bool(finite)

    return entry, loop


def build_prefix(cfg, model, *, prefix_len: int):
    """Forward over the shared prompt prefix [1, Pc] -> per-layer (k, v)
    tensors [Pc, Hkv, D] that every batch row reads (but never copies).
    Under ``kv_cache_quant`` they are the dequantized round trip of the int8
    prefix cache, in the model dtype: the prefix stays float."""

    def run(tokens):
        positions = torch.arange(prefix_len, device=tokens.device)[None, :]
        cache = init_cache(model.config, 1, prefix_len, device=tokens.device)
        valid = torch.ones((1, prefix_len), dtype=torch.bool, device=tokens.device)
        model(tokens, positions, valid, cache, left_padded=True, last_only=True)
        if cfg.kv_cache_quant:
            dtype = dtype_of(cfg)
            return [(_dequantize_kv(layer.k, layer.k_scale, dtype)[0],
                     _dequantize_kv(layer.v, layer.v_scale, dtype)[0])
                    for layer in cache.layers]
        return [(layer.k[0], layer.v[0]) for layer in cache.layers]

    return run


def build_serve_step(model, sampler: SamplerSettings, pad_id: int, eos_id: int, *,
                     num_slots: int, chunk: int, fuse: int = 1, paged: bool = False):
    """The serving decode step over the slot pool: the decode loop with
    per-row write offsets (``base + emitted``), per-row caps and the slots'
    own sampling streams, for up to ``chunk * fuse`` steps (it stops sooner
    once every live row is done, so the tokens do not depend on ``fuse``).

    Contiguous (``paged=False``): released slots are invalidated at entry:
    rows in the ``reset`` mask lose their ``key_valid`` and ``lengths``
    before any attention reads them. Returns ``run(cache, prev_logits,
    row_seeds, emitted0, base, caps, live0, reset) -> LoopOut``; the cache
    is updated in place, the carried logits come back in ``LoopOut.logits``.

    Paged (``paged=True``, ``serving/paged.py``): the block tables gather
    the arena into the view buffer once at entry, the same loop runs over
    the view, and the rows' private blocks scatter back once at exit (the
    write tables send shared blocks and dead rows to the sink). The view's
    ``lengths`` is the arena's own tensor, so the loop advances it in place.
    No reset mask: a released block re-enters a table only through a
    prefill that cleared its ``key_valid`` first. Returns ``run(arena,
    view, prev_logits, tables, wtables, row_seeds, emitted0, base, caps,
    live0) -> LoopOut``."""
    loop = make_greedy_loop(model, make_sampler(sampler), pad_id, eos_id, batch=num_slots,
                            steps=chunk * fuse, greedy=sampler.greedy)

    if paged:
        from fairness_llm_tpu_torch.serving.paged import gather_view, scatter_view

        def run_paged(arena, view, prev_logits, tables, wtables, row_seeds,
                      emitted0: np.ndarray, base: np.ndarray, caps: np.ndarray,
                      live0: np.ndarray) -> LoopOut:
            cache = gather_view(arena, tables, arena.lengths, view)
            out = loop(cache, prev_logits, row_seeds, live0, None, emitted0=emitted0,
                       base=base, caps=caps)
            scatter_view(arena, cache, wtables)
            return out

        return run_paged

    def run(cache, prev_logits, row_seeds, emitted0: np.ndarray, base: np.ndarray,
            caps: np.ndarray, live0: np.ndarray, reset: np.ndarray) -> LoopOut:
        if reset.any():
            idx = torch.from_numpy(np.flatnonzero(reset)).to(cache.lengths.device)
            cache.key_valid[idx] = False
            cache.lengths[idx] = 0
        return loop(cache, prev_logits, row_seeds, live0, None, emitted0=emitted0,
                    base=base, caps=caps)

    return run


def build_serve_prefill(cfg, model, *, nb: int, P: int):
    """``[nb, P]`` prompt prefill with its rows scattered into the pool.

    Numerically the engine's batch entry: left-padded tokens, positions from
    the valid cumsum, ``last_only`` logits, into a fresh ``[nb, P]`` cache.
    The first ``len(slots)`` rows are the real admissions: their k/v (and
    int8 scales), ``key_valid``, ``key_positions``, ``lengths`` and last
    logits are written into the pool's cache and carried logits at
    ``slots``, and their slots ``[P, cache_len)`` are invalidated, so a
    recycled slot never shows its previous tenant's keys. The batch-bucket
    pad rows after them are never written anywhere.

    Returns ``run(cache, prev_logits, tokens, valid, slots, guard=False)``,
    which updates ``cache`` and ``prev_logits`` in place and returns, with
    ``guard``, the device bool that the real rows' last logits are finite
    (the numerics guard), else None."""

    def run(cache, prev_logits, tokens, valid, slots: Sequence[int],
            guard: bool = False) -> Optional[torch.Tensor]:
        dev = tokens.device
        positions = (torch.cumsum(valid.long(), dim=1) - 1).clamp_min(0)
        small = init_cache(model.config, nb, P, device=dev)
        logits, small = model(tokens, positions, valid, small, left_padded=True,
                              last_only=True)
        n = len(slots)
        idx = torch.tensor(list(slots), dtype=torch.long, device=dev)
        for big, sm in zip(cache.layers, small.layers):
            big.k[idx, :P] = sm.k[:n]
            big.v[idx, :P] = sm.v[:n]
            if big.k_scale is not None:
                big.k_scale[idx, :P] = sm.k_scale[:n]
                big.v_scale[idx, :P] = sm.v_scale[:n]
        cache.key_valid[idx, :P] = small.key_valid[:n]
        cache.key_valid[idx, P:] = False
        cache.key_positions[idx, :P] = small.key_positions[:n]
        cache.lengths[idx] = small.lengths[:n]
        prev_logits[idx] = logits[:n, -1]
        return masked_finite(logits[:n, -1]) if guard else None

    return run


def build_paged_prefill(model):
    """``[nb, S]`` suffix prefill through block tables (paged KV); one
    function serves every group shape.

    Each row's cached prefix (``matched`` tokens: the shared full blocks and
    the copy-on-write lead of one partly shared block) is already in the
    arena. The function:

    1. copies each copy-on-write source block into the row's private block
       at the divergence (the shared source is never written; rows with no
       copy name the sink on both sides);
    2. clears ``key_valid`` of every block the batch's write tables name,
       so a recycled block is unreadable before its new tenant writes it;
    3. gathers each row's table into the view buffer, its validity set to
       ``position < matched`` (the prefix visible, the rest dark);
    4. forwards the right-padded suffix at ``write_offsets = matched``:
       suffix query i sees slot j iff j <= matched + i, the whole prefix and
       its own earlier suffix; the logits only at each row's last real
       token (``last_idx``);
    5. scatters the view back through the write tables, and writes the real
       rows' ``lengths`` and logits at their ``slots``.

    Numerically the engine's forward over the same tokens at the same
    positions. Returns ``run(arena, view, prev_logits, tokens, valid,
    positions, tables, wtables, cow_src, cow_dst, matched, last_idx,
    slots, guard=False)``: device tensors but for ``slots``, the ``n <= nb``
    real rows' slot ids (the rows after them are batch-bucket pads, whose
    write tables are all sink). With ``guard`` it returns the device bool
    that the real rows' last logits are finite, else None."""
    from fairness_llm_tpu_torch.serving.paged import gather_view, scatter_view

    def run(arena, view, prev_logits, tokens, valid, positions, tables, wtables, cow_src,
            cow_dst, matched, last_idx, slots: Sequence[int],
            guard: bool = False) -> Optional[torch.Tensor]:
        for big in arena.tensors():
            big.index_copy_(0, cow_dst, big.index_select(0, cow_src))
        arena.key_valid.index_fill_(0, wtables.reshape(-1), False)
        v = gather_view(arena, tables, matched.clone(), view)
        L = v.key_valid.shape[1]
        torch.lt(torch.arange(L, device=matched.device)[None, :], matched[:, None],
                 out=v.key_valid)
        logits, v = model(tokens, positions, valid, v, write_offsets=matched,
                          last_idx=last_idx)
        scatter_view(arena, v, wtables)
        n = len(slots)
        idx = torch.tensor(list(slots), dtype=torch.long, device=tokens.device)
        arena.lengths[idx] = v.lengths[:n]
        prev_logits[idx] = logits[:n, 0]
        return masked_finite(logits[:n, 0]) if guard else None

    return run
