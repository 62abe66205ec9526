"""The port's attention ops against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as their own tests run
them; the port's wrappers take their plain PyTorch versions for CPU tensors.
Inputs are float32, made with numpy from a seed and fed to both sides.
Tolerance: 2e-5 absolute, a few float32 ulps of sums over at most a few
hundred keys of unit-scale values.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu.ops.decode_attention import decode_attention as jax_decode  # noqa: E402
from fairness_llm_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from fairness_llm_tpu_torch.models.transformer import _quantize_kv  # noqa: E402
from fairness_llm_tpu_torch.ops import decode_attention as dec_mod  # noqa: E402
from fairness_llm_tpu_torch.ops import flash_attention as flash_mod  # noqa: E402

ATOL = 2e-5


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hkv", [2, 4])
def test_flash_reference_matches_pallas(hkv, window):
    rng = np.random.default_rng(0)
    B, H, S, D = 2, 4, 128, 64
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    lengths = np.array([S, S - 37], np.int32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lengths), causal=True, window=window,
                                interpret=True))
    got = flash_mod.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=True, window=window).numpy()
    valid_q = (np.arange(S)[None, :] >= (S - lengths)[:, None])[:, None, :, None]
    np.testing.assert_allclose(got * valid_q, want * valid_q, atol=ATOL)
    # left-pad query rows come out exactly 0, as from the kernel
    assert not np.any(got * ~valid_q)


@pytest.mark.parametrize("shared_p", [None, 96, 128])
@pytest.mark.parametrize("hkv", [2, 4])
@pytest.mark.parametrize("L", [128, 256])
def test_decode_reference_matches_pallas(L, hkv, shared_p):
    rng = np.random.default_rng(1)
    B, H, D = 8, 8, 64
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    valid = rng.random((B, L)) < 0.5
    valid[:, 0] = True
    shared_np = None
    if shared_p:
        shared_np = (rng.normal(size=(shared_p, hkv, D)).astype(np.float32),
                     rng.normal(size=(shared_p, hkv, D)).astype(np.float32))
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        None if shared_np is None else tuple(jnp.asarray(a) for a in shared_np),
        interpret=True))
    got = dec_mod.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid),
        None if shared_np is None else tuple(torch.from_numpy(a) for a in shared_np),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _flash_inputs(seed=2, B=2, H=4, Hkv=2, S=40, D=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, S, D, generator=g)
    k = torch.randn(B, Hkv, S, D, generator=g)
    v = torch.randn(B, Hkv, S, D, generator=g)
    return q, k, v, torch.tensor([S, S - 9], dtype=torch.int32)


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, lengths = _flash_inputs()
    before = flash_mod.launches
    out = flash_mod.flash_attention(q, k, v, lengths, window=8)
    assert torch.equal(out, flash_mod.flash_attention_reference(q, k, v, lengths, window=8))
    assert flash_mod.launches == before  # no kernel launched for a CPU tensor

    g = torch.Generator().manual_seed(3)
    qd = torch.randn(3, 4, 16, generator=g)
    kd = torch.randn(3, 24, 2, 16, generator=g)
    vd = torch.randn(3, 24, 2, 16, generator=g)
    valid = torch.rand(3, 24, generator=g) < 0.7
    sh = (torch.randn(5, 2, 16, generator=g), torch.randn(5, 2, 16, generator=g))
    before = dec_mod.launches
    out = dec_mod.decode_attention(qd, kd, vd, valid, sh)
    assert torch.equal(out, dec_mod.decode_attention_reference(qd, kd, vd, valid, sh))
    assert dec_mod.launches == before


def test_flash_reference_accepts_head_major_views():
    """The transformer hands the op transposed views of [B, S, H, D]."""
    q, k, v, lengths = _flash_inputs()
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qv.is_contiguous()
    torch.testing.assert_close(
        flash_mod.flash_attention(qv, k, v, lengths),
        flash_mod.flash_attention(q, k, v, lengths), rtol=0, atol=0)


def test_decode_wrapper_refuses_unported_modes():
    """Both modes are ported now; the wrapper keeps the reference's argument
    errors for them: the int8 cache needs both scales, 4-D q (the verify
    window) needs q_offsets, and int8 k/v come only with scales."""
    q = torch.zeros(2, 4, 16)
    k8 = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    scale = torch.ones(2, 8, 2)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        dec_mod.decode_attention(q, k8, k8, valid, k_scale=scale)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        dec_mod.decode_attention(q, k8, k8, valid, v_scale=scale)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        dec_mod.decode_attention(q, k8, k8, valid)
    kf = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="q_offsets"):
        dec_mod.decode_attention(torch.zeros(2, 3, 4, 16), kf, kf, valid)
    assert dec_mod.decode_attention(q, k8, k8, valid, k_scale=scale, v_scale=scale).shape == q.shape


def test_wrappers_validate_shapes():
    q, k, v, lengths = _flash_inputs()
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, k, v, lengths[:1])
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, k[:, :, :-1], v[:, :, :-1], lengths)
    with pytest.raises(ValueError):
        dec_mod.decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 8, 3, 16),
                                 torch.zeros(2, 8, 3, 16), torch.ones(2, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# The split algebra of the card's one-query kernel (decode_split_tc)
# ---------------------------------------------------------------------------


def _split_partial(q, k, v, sees, ks=None, vs=None):
    """One split's partials as decode_split_tc keeps them, in f32: scores in
    log2 units (times the k-scale), m their max over the keys the row sees
    (-1e30 where it sees none), l the sum of the unscaled p, acc the sum of
    p times the v-scale times v. q [B, H, D] (scaled), k/v [B, n, H, D],
    sees [B, n] (ks/vs [B, n, H])."""
    s = torch.einsum("bhd,bnhd->bhn", q, k) * 1.4426950408889634
    if ks is not None:
        s = s * ks.permute(0, 2, 1)
    mask = sees[:, None, :].expand_as(s)
    s = torch.where(mask, s, torch.full_like(s, dec_mod.NEG_INF))
    m = s.amax(-1)
    m = torch.where(mask.any(-1), m, torch.full_like(m, dec_mod.NEG_INF))
    p = torch.where(mask, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    pv = p if vs is None else p * vs.permute(0, 2, 1)
    return m, p.sum(-1), torch.einsum("bhn,bnhd->bhd", pv, v)


def _split_route(q, k, v, valid, shared, ks, vs, sp, sc):
    """decode_split_tc's function in plain PyTorch: prefix splits over every
    batch row, cache splits per row, each a run of whole 32-key tiles, then
    combine_splits's fold in split order, which skips a split where the row
    saw no key (l = 0). All f32; int8 k/v with their scales."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    T = dec_mod.TILE_KEYS
    P = 0 if shared is None else shared[0].shape[0]
    qs = q * D ** -0.5
    parts = []
    for n_keys, n_splits, kind in ((P, sp, "prefix"), (L, sc, "cache")):
        ntiles = -(-n_keys // T)
        per = -(-ntiles // n_splits) if n_splits else 0
        for s in range(n_splits):
            lo, hi = min(s * per * T, n_keys), min((s + 1) * per * T, n_keys)
            if kind == "prefix":
                kk = shared[0][lo:hi].repeat_interleave(rep, 1)[None].expand(B, -1, -1, -1)
                vv = shared[1][lo:hi].repeat_interleave(rep, 1)[None].expand(B, -1, -1, -1)
                parts.append(_split_partial(qs, kk, vv, torch.ones(B, hi - lo, dtype=torch.bool)))
            else:
                sc_ = [None if x is None else x[:, lo:hi].repeat_interleave(rep, 2)
                       for x in (ks, vs)]
                parts.append(_split_partial(qs, k[:, lo:hi].repeat_interleave(rep, 2),
                                            v[:, lo:hi].repeat_interleave(rep, 2),
                                            valid[:, lo:hi], *sc_))
    mx = torch.full((B, H), dec_mod.NEG_INF)
    for m, l_, _ in parts:
        mx = torch.where(l_ > 0, torch.maximum(mx, m), mx)
    lsum, acc = torch.zeros(B, H), torch.zeros(B, H, D)
    for m, l_, a in parts:
        w = torch.where(l_ > 0, torch.exp2(m - mx), torch.zeros_like(m))
        lsum, acc = lsum + w * l_, acc + w[..., None] * a
    return acc / lsum.clamp_min(1e-30)[..., None]


def _split_plans(P, L):
    """Every plan of one run for both kinds, and the two lopsided ones."""
    ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
    plans = {(-(-ntp // run), -(-ntc // run)) for run in range(1, max(ntp, ntc) + 1)}
    return sorted(plans | {(ntp, int(ntc > 0)), (int(ntp > 0), ntc)})


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("P", [0, 96, 704])
def test_split_route_algebra_matches_reference(P, cache):
    """Partials over prefix splits shared by the batch and per-row cache
    splits, folded in split order, equal the joint softmax to f32 summation
    order (1e-5) under every plan: L = 150 is not a tile multiple, row 1
    has no valid slot (with P = 0 its output is 0), row 0 every slot."""
    rng = np.random.default_rng(31)
    B, H, Hkv, L, D = 3, 8, 2, 150, 16
    bf = lambda a: torch.from_numpy(a).bfloat16().float()  # noqa: E731  values of bf16
    q = bf(rng.normal(size=(B, H, D)).astype(np.float32))
    k = bf(rng.normal(size=(B, L, Hkv, D)).astype(np.float32))
    v = bf(rng.normal(size=(B, L, Hkv, D)).astype(np.float32))
    ks = vs = None
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
    shared = None
    if P:
        shared = (bf(rng.normal(size=(P, Hkv, D)).astype(np.float32)),
                  bf(rng.normal(size=(P, Hkv, D)).astype(np.float32)))
    valid = torch.from_numpy(rng.random((B, L)) < 0.6)
    valid[0], valid[1] = True, False
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, ks, vs)
    for sp, sc in _split_plans(P, L):
        got = _split_route(q, k.float(), v.float(), valid, shared, ks, vs, sp, sc)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"plan ({sp}, {sc})")
    if P == 0:
        assert not want[1].any()


def test_split_workspace_is_kept_per_device_and_stream(monkeypatch):
    """The split kernels' workspace is allocated once per (device, stream)
    and grown only when a call needs more: a smaller call reuses it, another
    stream gets its own."""
    monkeypatch.setattr(dec_mod, "_workspaces", {})
    cpu = torch.device("cpu")
    first = dec_mod._workspace(1000, cpu, 0)
    assert first.dtype == torch.float32 and first.numel() == 1000
    assert dec_mod._workspace(10, cpu, 0) is first
    grown = dec_mod._workspace(5000, cpu, 0)
    assert grown.numel() == 5000 and dec_mod._workspace(1000, cpu, 0) is grown
    other = dec_mod._workspace(10, cpu, 7)
    assert other is not grown and dec_mod._workspace(10, cpu, 0) is grown


def _pv_terms(p, v, terms):
    """P.V with P in ``terms`` bf16 terms, as flash_fwd_tc feeds the tensor
    cores: its bf16 rounding, then (two terms) the remainder rounded to
    bf16 (csrc/mma_fragments.cuh, split_bf16x2); f32 sums."""
    hi = p.bfloat16().float()
    out = hi @ v
    if terms == 2:
        out = out + (p - hi).bfloat16().float() @ v
    return out


@pytest.mark.parametrize("v_scale", [1.0, 4.0])
def test_flash_tc_p_in_two_bf16_terms_holds_the_allowance(v_scale):
    """The bf16 prefill kernel's P.V arithmetic (C8): with P in two bf16
    terms its outputs hold chip_smoke.py's bf16 allowance (4e-3 + 1e-2 *
    |plain|) against the f32 plain version at v of scale 1 and 4 (a causal
    row of 256 keys, so early rows average a few values and some outputs
    near cancellation). P in one bf16 term moves an output by up to 2^-9 of
    the largest |v| averaged, which at scale 4 misses the allowance."""
    torch.manual_seed(0)
    H, S, D = 8, 256, 128
    q, k = torch.randn(H, S, D).bfloat16().float(), torch.randn(H, S, D).bfloat16().float()
    v = (torch.randn(H, S, D) * v_scale).bfloat16().float()
    s = (q * D ** -0.5) @ k.transpose(-1, -2)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    lsum = p.sum(-1, keepdim=True)
    want = ((p @ v) / lsum).bfloat16().float()
    tol = 4e-3 + 1e-2 * want.abs()

    def ratio(terms):
        got = (_pv_terms(p, v, terms) / lsum).bfloat16().float()
        return float(((got - want).abs() / tol).max())

    assert ratio(2) <= 1
    if v_scale > 1:
        assert ratio(1) > 1


@pytest.mark.parametrize("at", ["offset0", "offset_end"])
@pytest.mark.parametrize("cache", ["float", "int8"])
def test_verify_reference_matches_pallas_at_72_rows_a_kv_head(cache, at):
    """llama3-70b's verify window: 9 rows a row times 8 q heads a kv head,
    72 query rows a kv head, past one 64-row block of decode_verify_tc (two
    blocks, the second of 8 rows). The port's plain version, which the card
    kernel is held to, must match the Pallas kernel there, over a float and
    an int8 cache, every window at slot 0 or at the cache's end."""
    rng = np.random.default_rng(72)
    B, Q, rep, hkv, D, L, P = 8, 9, 8, 1, 64, 128, 96
    q = rng.normal(size=(B, Q, rep * hkv, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    offs = np.full(B, 0 if at == "offset0" else L - Q, np.int32)
    valid = rng.random((B, L)) < 0.8
    valid[:, offs[0]] = True
    shared = tuple(rng.normal(size=(P, hkv, D)).astype(np.float32) for _ in range(2))
    scales = {}
    if cache == "int8":
        (kq, ks), (vq, vs) = _quantize_kv(torch.from_numpy(k)), _quantize_kv(torch.from_numpy(v))
        k, v = kq.numpy(), vq.numpy()
        scales = {"k_scale": ks.numpy(), "v_scale": vs.numpy()}
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in shared), q_offsets=jnp.asarray(offs), interpret=True,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    got = dec_mod.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(valid),
        tuple(torch.from_numpy(a) for a in shared), q_offsets=torch.from_numpy(offs),
        **{n: torch.from_numpy(a) for n, a in scales.items()}).numpy()
    assert got.shape == (B, Q, rep * hkv, D)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# The main path's decode (Q = 1) and verify (Q = 9) calls at llama3-8b's and
# llama3-70b's heads: (B, Q, H, Hkv), head width 128.
DECODE_SHAPES = {"llama3-8b_decode": (16, 1, 32, 8), "llama3-8b_verify": (4, 9, 32, 8),
                 "llama3-70b_decode": (16, 1, 64, 8), "llama3-70b_verify": (4, 9, 64, 8)}


def _decode_tc_ratio(B, Q, H, Hkv, P, keys, terms, seed=0):
    """The largest error over the bf16 allowance (4e-3 + 1e-2 * |plain|)
    of decode_split_tc's and decode_verify_tc's arithmetic, emulated, on
    bf16 q and k and v of scale 4 (as in test_flash_tc_p_in_two_bf16_terms_
    holds_the_allowance): scores and the softmax in float32, P into P.V in
    ``terms`` bf16 terms (``_pv_terms``), the normaliser summed unrounded,
    the output rounded to bf16; against the f32 plain version,
    decode_attention_reference. Each row sees the prefix of P keys and
    ``keys`` own slots (a verify window ends at the newest)."""
    D, L = 128, 224
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Q, H, D, generator=g).bfloat16()
    k = torch.randn(B, L, Hkv, D, generator=g).bfloat16()
    v = (torch.randn(B, L, Hkv, D, generator=g) * 4).bfloat16()
    sk = torch.randn(P, Hkv, D, generator=g).bfloat16()
    sv = (torch.randn(P, Hkv, D, generator=g) * 4).bfloat16()
    valid = torch.arange(L)[None, :] < keys[:, None]
    offs = (keys - Q).to(torch.int32)
    want = dec_mod.decode_attention_reference(
        q[:, 0] if Q == 1 else q, k, v, valid, (sk, sv) if P else None,
        q_offsets=None if Q == 1 else offs).float().reshape(B, Q, H, D)
    rep = H // Hkv
    kk = torch.cat([sk[None].expand(B, -1, -1, -1), k], 1).float().repeat_interleave(rep, 2)
    vv = torch.cat([sv[None].expand(B, -1, -1, -1), v], 1).float().repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bnhd->bhqn", q.float() * D ** -0.5, kk)
    own = torch.arange(L)[None, None, :] <= (offs[:, None, None] + torch.arange(Q)[None, :, None])
    sees = torch.cat([torch.ones(B, Q, P, dtype=torch.bool), valid[:, None, :] & own], -1)
    s = s.masked_fill(~sees[:, None], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    got = (_pv_terms(p, vv.transpose(1, 2), terms) / p.sum(-1, keepdim=True))
    got = got.bfloat16().float().permute(0, 2, 1, 3)
    return float(((got - want).abs() / (4e-3 + 1e-2 * want.abs())).max())


@pytest.mark.parametrize("rows", ["sweep", "short"])
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_decode_tc_p_in_two_bf16_terms_holds_the_allowance(shape, rows):
    """K2's and K3's bf16 kernels (decode_split_tc, decode_verify_tc) at
    llama3-8b's and llama3-70b's decode and verify shapes with v of scale 4
    (C9). Rows as the phase-1 sweep gives them (the 640-key prefix and 100
    to 224 own slots) hold the allowance with P in one bf16 term too, at
    about half of it. Rows of 12 keys (a short prompt, no prefix) miss it
    with one term, as K1's early rows did (C8), and hold it with two."""
    B, Q, H, Hkv = DECODE_SHAPES[shape]
    if rows == "sweep":
        P, keys = 640, torch.randint(100, 225, (B,), generator=torch.Generator().manual_seed(1))
    else:
        P, keys = 0, torch.full((B,), 12)
    assert _decode_tc_ratio(B, Q, H, Hkv, P, keys, terms=2) <= 1
    one = _decode_tc_ratio(B, Q, H, Hkv, P, keys, terms=1)
    assert one <= 1 if rows == "sweep" else one > 1
