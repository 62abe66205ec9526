"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (sm_90a) and skip elsewhere.
They import nothing of JAX, so the card's machine runs them with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 outputs agree to 1e-4 (sums in another order). bfloat16
outputs agree elementwise to 4e-3 + 1e-2 * |plain|. The plain versions
compute in float32 and round the output once. The kernels sum in float32
too and round the output once; the decode kernels and the int8-weight
matmul differ from the plain version by summation order and that one
rounding (at most one bf16 ulp, 2^-7 of the value). The bf16 flash kernel
feeds the softmax weights P to the tensor cores as two bf16 terms, their
rounding and the remainder, which carry P to about 2^-17: one term moved
an output by up to 2^-9 of the largest |v| it averaged, past the allowance
where an output nearly cancels (ROADMAP C8,
test_flash_tc_kernel_at_large_values; chip_smoke.py reports the share of
the allowance used at the main path's prefill shapes). A kernel that drops or adds one key
moves outputs by far more than that, which the shifted-mask tests check; for the
int8-weight matmul, dropping the last 32 columns of x must fail the same
tolerance. Its bf16 GEMV regime (gemv_stream_tc) sums a column tile's k
splits in a fixed order inside the kernel, so repeated calls agree bit for
bit, and a grouped call (q/k/v, gate/up in one launch) gives each weight's
product.
Its float32 outputs (the two-pass TF32 route: gemv_stream_tf32 for
M <= 64, grouped calls one launch, and tf32_gemm_kernel) are held to
1e-4 + 3e-5 * |plain|: the route drops at most 2^-22 |x| of each x value
(x_lo's TF32 rounding), and the tensor cores' f32 accumulation rounds
otherwise than cuBLAS's f32 FMA chain; over K = 14336 products the two
were seen 1.3e-5 of the value apart (outputs up to ~12). Its repeats agree
bit for bit and its arrival counters return to 0.
The decode kernel's int8-cache mode (K2q) and verify window (K3, over a
float or an int8 cache) take the attention tolerances above; their blind
checks mask the newest slot (K2q) or lower every q_offset by one (K3, so
each query loses its own slot). A bf16 verify window runs on the
tensor-core kernel (decode_verify_tc), which, as the bf16 flash kernel,
feeds P (times the v-scale over an int8 cache) to P.V as two bf16 terms, and
splits the keys across blocks; its partials are combined in a fixed order,
so repeated calls agree bit for bit. A bf16 one-query call (K2, K2q) runs
on decode_split_tc the same way, with prefix splits shared by the batch. A
float32 one-query call (K2, K2q) runs on decode_split_f32, split and
combined the same way on scalar f32 FMAs (a block one warp, empty cache
tiles skipped), held to the float32 tolerance under every split plan, with
its repeats bit for bit; a float32 verify window (K3, either cache) runs
on verify_split_f32, split and combined the same way over register tiles
of 4-warp blocks of 16, 32 or 64 query rows, held to the float32 tolerance
under every row count and split plan, with its repeats bit for bit. The
float32 flash kernel (flash_fwd) takes 16, 32 or 64 query rows a block,
whose key groups it folds in a fixed order: every row plan is held to the
float32 tolerance with left pads and a window, and repeats bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu_torch.models.transformer import _quantize_kv  # noqa: E402
from fairness_llm_tpu_torch.ops import decode_attention as dec_mod  # noqa: E402
from fairness_llm_tpu_torch.ops import flash_attention as flash_mod  # noqa: E402
from fairness_llm_tpu_torch.ops import quant_matmul as qmm  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=0, atol=1e-4), torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,window", [
    (2, 4, 2, 128, 64, None),
    (3, 8, 8, 77, 80, None),   # ragged S, D not a multiple of 32
    (2, 32, 8, 200, 128, 48),  # llama head layout, sliding window
    (1, 4, 1, 64, 256, None),
    (2, 4, 2, 70, 99, None),   # rows of odd byte size: D padded by the wrapper
    (1, 4, 2, 128, 32, None),  # the study checkpoints' prefix (tiny-llama's heads)
    (184, 4, 4, 128, 32, None),  # phase 3's scoring forward (tiny-gpt2's heads)
    (8, 4, 2, 640, 32, None),  # phase 2's listwise query: 20 key tiles a row
])
def test_flash_kernel_matches_plain(dev, dtype, B, H, Hkv, S, D, window):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, S, H, D, generator=g, device=dev, dtype=dtype).transpose(1, 2)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    before, tc = flash_mod.launches, flash_mod.tc_launches
    got = flash_mod.flash_attention(q, k, v, lengths, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert flash_mod.tc_launches == tc + (dtype == torch.bfloat16)
    want = flash_mod.flash_attention_reference(q, k, v, lengths, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("B,H,Hkv,S,D,window,lens", [
    (2, 4, 4, 77, 16, None, "rand"),     # tiny-test's D, padded to 64; rep 1
    (2, 8, 2, 200, 32, None, "rand"),    # the study checkpoints' D; rep 4
    (3, 12, 12, 128, 64, None, "rand"),  # gpt2's D
    (2, 4, 2, 77, 80, None, "rand"),     # padded to 128
    (2, 32, 4, 897, 128, None, "one"),   # rep 8; S one past a tile; a row of length 1
    (2, 4, 2, 200, 256, None, "rand"),   # 32-key tiles
    (2, 4, 2, 70, 99, None, "rand"),     # odd byte rows: copied, padded to 128
    (2, 32, 8, 200, 128, 48, "rand"),    # window inside the causal band
    (2, 8, 2, 300, 128, None, "pad"),    # q tiles wholly in the left padding
    (3, 8, 2, 150, 64, 70, "one"),       # window and a row of length 1
])
def test_flash_tc_kernel_matches_plain(dev, B, H, Hkv, S, D, window, lens):
    """The bf16 tensor-core kernel, q a head-major view of [B, S, H, D], on
    every width it pads to and the masks' edge cases."""
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=g, device=dev, dtype=dtype).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=dtype).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=dtype).transpose(1, 2)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    if lens == "one":
        lengths[0] = 1
    elif lens == "pad":
        lengths[:] = torch.tensor([S // 4, 5] + [S] * (B - 2), dtype=torch.int32)
    before, tc = flash_mod.launches, flash_mod.tc_launches
    got = flash_mod.flash_attention(q, k, v, lengths, causal=True, window=window)
    torch.cuda.synchronize()
    assert (flash_mod.launches, flash_mod.tc_launches) == (before + 1, tc + 1)
    assert got.shape == q.shape
    want = flash_mod.flash_attention_reference(q, k, v, lengths, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    pad_rows = torch.arange(S, device=dev)[None, :] < (S - lengths.long())[:, None]
    assert not got.transpose(1, 2)[pad_rows].any()  # left-pad rows are exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D,P", [
    (8, 8, 2, 128, 64, 96),
    (5, 32, 8, 160, 128, 0),   # no prefix, L not a multiple of 32
    (3, 32, 8, 77, 128, 37),   # prefix tile straddles the cache
    (2, 64, 2, 40, 96, 10),    # rep 32
    (4, 8, 2, 50, 99, 20),     # rows of odd byte size: D padded by the wrapper
    (16, 4, 2, 160, 32, 128),  # the study sweep's step (tiny-llama's heads)
    (8, 4, 4, 768, 32, 0),     # the served study pool (tiny-gpt2's heads)
])
def test_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, L, D, P):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, H, D, generator=g, device=dev, dtype=dtype)
    k = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    valid = torch.rand(B, L, generator=g, device=dev) < 0.6
    valid[:, -1] = True
    shared = None
    if P:
        shared = (torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype),
                  torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype))
    before, tc, f32 = dec_mod.launches, dec_mod.decode_tc_launches, dec_mod.decode_f32_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    assert dec_mod.decode_tc_launches == tc + (dtype == torch.bfloat16)
    assert dec_mod.decode_f32_launches == f32 + (dtype == torch.float32)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _outside_tolerance(got, want, dtype):
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tolerance_sees_one_dropped_key(dev, dtype):
    """The kernel with every row's first valid key masked out must fail the
    tolerance against the plain version with the true mask, on the query
    rows valid under both masks."""
    B, H, Hkv, S, D = 2, 32, 8, 200, 128
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, H, S, D, generator=g, device=dev, dtype=dtype)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    lengths = torch.tensor([S, S - 37], device=dev, dtype=torch.int32)
    want = flash_mod.flash_attention_reference(q, k, v, lengths)
    got = flash_mod.flash_attention(q, k, v, lengths - 1)
    for b in range(B):
        rows = slice(S - int(lengths[b]) + 1, S)
        _outside_tolerance(got[b, :, rows], want[b, :, rows], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tolerance_sees_one_dropped_key(dev, dtype):
    """The kernel with each row's newest valid slot masked out must fail
    the tolerance against the plain version with the true mask."""
    B, H, Hkv, L, D, P = 16, 32, 8, 160, 128, 704
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, H, D, generator=g, device=dev, dtype=dtype)
    k = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    shared = (torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype),
              torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype))
    valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
    valid[:, 20:97] = True
    dropped = valid.clone()
    dropped[:, 96] = False
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared)
    _outside_tolerance(dec_mod.decode_attention(q, k, v, dropped, shared), want, dtype)


def _cache(g, dev, dtype, B, L, Hkv, D, P, int8):
    """(k, v, scales kwargs, shared) on the card: a float cache in dtype, or
    an int8 one quantized from it; a float prefix of P slots."""
    k = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, L, Hkv, D, generator=g, device=dev, dtype=dtype)
    shared = None
    if P:
        shared = (torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype),
                  torch.randn(P, Hkv, D, generator=g, device=dev, dtype=dtype))
    if not int8:
        return k, v, {}, shared
    (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
    return k, v, dict(k_scale=ks, v_scale=vs), shared


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D,P", [
    (8, 8, 2, 128, 64, 96),
    (16, 32, 8, 160, 128, 704),  # llama3-8b's sweep shape with the prefix
    (5, 32, 8, 960, 128, 0),     # and without it
    (3, 32, 8, 77, 128, 37),     # the prefix ends mid-tile
    (2, 4, 2, 40, 16, 10),       # tiny-test's D: 16-byte int8 rows
    (4, 8, 2, 50, 99, 20),       # rows of odd byte size: D padded by the wrapper
])
def test_int8_cache_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, L, D, P):
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, H, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=True)
    valid = torch.rand(B, L, generator=g, device=dev) < 0.6
    valid[:, -1] = True
    before, tc, f32 = (dec_mod.quant_launches, dec_mod.decode_tc_launches,
                       dec_mod.decode_f32_launches)
    got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    torch.cuda.synchronize()
    assert dec_mod.quant_launches == before + 1
    assert dec_mod.decode_tc_launches == tc + (dtype == torch.bfloat16)
    assert dec_mod.decode_f32_launches == f32 + (dtype == torch.float32)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _window(g, dev, B, L, Q):
    """Per-row window offsets and a valid mask holding every slot up to the
    window's end, with holes below it."""
    offs = torch.randint(0, L - Q + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    slots = torch.arange(L, device=dev)[None, :]
    valid = (slots <= offs[:, None] + Q - 1) & (torch.rand(B, L, generator=g, device=dev) < 0.9)
    valid[:, 0] = True
    return offs, valid


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Q,H,Hkv,L,D,P", [
    (8, 4, 8, 2, 128, 64, 96),
    (16, 9, 32, 8, 168, 128, 704),  # llama3-8b's verify window: 36 rows per kv head
    (3, 3, 4, 2, 77, 16, 37),       # tiny-test's D; the prefix ends mid-tile
    (2, 16, 64, 2, 60, 96, 10),     # 512 rows per kv head: 16 chunks of 32
    (4, 5, 8, 2, 50, 99, 0),        # D padded by the wrapper, no prefix
])
def test_multi_query_kernel_matches_plain(dev, dtype, int8, B, Q, H, Hkv, L, D, P):
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, Q, H, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=int8)
    offs, valid = _window(g, dev, B, L, Q)
    counter = "multi_quant_launches" if int8 else "multi_launches"
    before, tc = getattr(dec_mod, counter), dec_mod.multi_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert getattr(dec_mod, counter) == before + 1
    assert dec_mod.multi_tc_launches == tc + (dtype == torch.bfloat16)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_query_tolerance_sees_each_query_lose_its_slot(dev, dtype, int8):
    """The kernel with every q_offset lowered by one (each query loses its
    own slot) must fail the tolerance against the plain version."""
    B, Q, H, Hkv, L, D, P = 16, 9, 32, 8, 168, 128, 704
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, Q, H, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=int8)
    offs, valid = _window(g, dev, B, L, Q)
    offs = offs.clamp_min(1)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs - 1, **scales)
    _outside_tolerance(got, want, dtype)


def _verify_inputs(dev, seed, B, Q, rep, Hkv, L, D, P, int8, dtype=torch.bfloat16):
    """Verify-window inputs (bf16 unless ``dtype``) with the offset edges:
    row 0's window at slot 0, row 1's at L - Q, row 2 with no valid own slot
    (with P = 0 its output is 0), the rest drawn as _window draws them; in
    float32, row 3 (where B > 3) also has a whole tile with no valid slot."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Q, rep * Hkv, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=int8)
    offs, valid = _window(g, dev, B, L, Q)
    offs[0], offs[1] = 0, L - Q
    valid[0] = torch.arange(L, device=dev) < Q
    valid[1] = True
    valid[2] = False
    if dtype == torch.float32 and B > 3:
        valid[3, 32:64] = False
    return q, k, v, valid, shared, offs, scales


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("P", [0, 96, 704])
@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("rep,Q", [(1, 9), (8, 2), (4, 9), (7, 9), (4, 16)],
                         ids=["rows9", "rows16", "rows36", "rows63", "rows64"])
def test_verify_tc_kernel_matches_plain(dev, rep, Q, D, P, int8):
    """decode_verify_tc over a bf16 and an int8 cache, at rep * Q of 9 to 64
    query rows per kv head (one to four m-tiles), head widths 32-256 (80 is
    padded to 128), no prefix, a prefix ending mid-tile and the sweep's,
    and L = 150, not a multiple of the 32-key tile."""
    B, Hkv, L = 4, 2, 150
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 10, B, Q, rep, Hkv, L, D, P, int8)
    before, tc = dec_mod.launches + dec_mod.quant_launches, dec_mod.multi_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert dec_mod.multi_tc_launches == tc + 1
    assert dec_mod.launches + dec_mod.quant_launches == before
    assert got.shape == q.shape
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    if P == 0:
        assert not got[2].any()  # no key at all: exactly 0


def _plans(P, L):
    """Key-split plans from one split of each kind to one tile a split."""
    ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
    return sorted({(-(-ntp // run), -(-ntc // run)) for run in range(1, max(ntp, ntc) + 1)})


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("P,L,D", [(100, 150, 128), (0, 300, 128), (704, 168, 128),
                                   (40, 100, 256)])
def test_verify_tc_every_split_plan_matches_plain(dev, monkeypatch, P, L, D, int8):
    """Every split plan, the one-split case (no combine) included: a prefix
    that ends mid-tile followed by the cache, which splits of their own
    walk, and splits left with no tile or no visible key for some rows."""
    B, Q, rep, Hkv = 4, 9, 4, 2
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 11, B, Q, rep, Hkv, L, D, P, int8)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    for plan in _plans(P, L):
        monkeypatch.setattr(dec_mod, "verify_splits", lambda *a, _p=plan: _p)
        got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
        torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16],
                                   msg=lambda m, _p=plan: f"plan {_p}: {m}")


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
def test_verify_tc_refuses_a_bad_plan(dev, monkeypatch, int8):
    """No fallback: a plan the kernel cannot take raises; nothing else runs."""
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 12, 4, 9, 4, 2, 150, 128, 96,
                                                          int8)
    monkeypatch.setattr(dec_mod, "verify_splits", lambda *a: (4, 1))  # 96 keys: 3 tiles
    before = (dec_mod.multi_launches, dec_mod.multi_quant_launches, dec_mod.multi_tc_launches)
    with pytest.raises(RuntimeError, match="decode_attention"):
        dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    assert (dec_mod.multi_launches, dec_mod.multi_quant_launches,
            dec_mod.multi_tc_launches) == before


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
def test_verify_tc_repeats_bit_for_bit(dev, int8):
    """50 calls at llama3-8b's verify shape (split keys, combined in a fixed
    order) agree bit for bit."""
    B, Q, rep, Hkv, L, D, P = 16, 9, 4, 8, 168, 128, 704
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 13, B, Q, rep, Hkv, L, D, P, int8)
    first = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    for i in range(50):
        got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
        assert torch.equal(got, first), f"call {i} differs from the first"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_cache_tolerance_sees_one_dropped_key(dev, dtype):
    """K2q with each row's newest valid slot masked out must fail the
    tolerance against the plain version with the true mask."""
    B, H, Hkv, L, D, P = 16, 32, 8, 160, 128, 704
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, H, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=True)
    valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
    valid[:, 20:97] = True
    dropped = valid.clone()
    dropped[:, 96] = False
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    _outside_tolerance(dec_mod.decode_attention(q, k, v, dropped, shared, **scales), want, dtype)


def _decode_inputs(dev, seed, B, rep, Hkv, L, D, P, int8, dtype=torch.bfloat16):
    """One-query inputs (bf16 unless ``dtype``): row 0 sees every slot, row
    1 (where B > 1) no slot (with P = 0 its output is 0), the rest about 60%
    of theirs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, rep * Hkv, D, generator=g, device=dev, dtype=dtype)
    k, v, scales, shared = _cache(g, dev, dtype, B, L, Hkv, D, P, int8=int8)
    valid = torch.rand(B, L, generator=g, device=dev) < 0.6
    valid[0] = True
    if B > 1:
        valid[1] = False
    return q, k, v, valid, shared, scales


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("P", [0, 96, 704])
@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("rep", [1, 4, 8, 32])
def test_decode_tc_kernel_matches_plain(dev, rep, D, B, P, int8):
    """decode_split_tc (K2 over a bf16 cache, K2q over an int8 cache) at rep
    1-32 (B * rep query rows a kv head: prefix chunks of 64, cache blocks of
    one or two live warps), head widths 32-256 (96 padded to 128), batch
    1, 16 and the study's 48, no prefix, a prefix ending mid-tile and the
    sweep's, and L = 150, not a multiple of the 32-key tile."""
    Hkv, L = 2, 150
    q, k, v, valid, shared, scales = _decode_inputs(dev, rep + D + B + P, B, rep, Hkv, L, D, P,
                                                    int8)
    counter = "quant_launches" if int8 else "launches"
    before, tc = getattr(dec_mod, counter), dec_mod.decode_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    torch.cuda.synchronize()
    assert (getattr(dec_mod, counter), dec_mod.decode_tc_launches) == (before + 1, tc + 1)
    assert got.shape == q.shape
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    if P == 0 and B > 1:
        assert not got[1].any()  # no key at all: exactly 0


def _decode_plans(P, L):
    """_plans and the two lopsided plans (every prefix tile its own split,
    one cache split; and the other way round)."""
    ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
    return sorted(set(_plans(P, L)) | {(ntp, int(ntc > 0)), (int(ntp > 0), ntc)})


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("B,rep,P,L,D", [(4, 4, 100, 150, 128), (16, 4, 0, 300, 128),
                                         (16, 4, 704, 160, 128), (48, 4, 704, 160, 128),
                                         (3, 32, 40, 100, 256), (5, 8, 96, 0, 64),
                                         (48, 2, 704, 160, 32)])
def test_decode_tc_every_split_plan_matches_plain(dev, monkeypatch, B, rep, P, L, D, int8):
    """Every split plan, the one-split case (no combine) included: prefix
    splits shared by the batch, cache splits per row, runs left with no
    tile, tiles with no valid slot (skipped), and a row with no valid slot."""
    Hkv = 2
    q, k, v, valid, shared, scales = _decode_inputs(dev, 14, B, rep, Hkv, L, D, P, int8)
    if L:
        valid[-1, : L // 2] = False  # whole tiles with no valid slot
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    for plan in _decode_plans(P, L):
        monkeypatch.setattr(dec_mod, "decode_splits", lambda *a, _p=plan: _p)
        got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
        torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16],
                                   msg=lambda m, _p=plan: f"plan {_p}: {m}")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_decode_tc_refuses_a_bad_plan(dev, monkeypatch, int8):
    """No fallback: a plan the kernel cannot take raises; nothing else runs."""
    q, k, v, valid, shared, scales = _decode_inputs(dev, 15, 4, 4, 2, 150, 128, 96, int8)
    monkeypatch.setattr(dec_mod, "decode_splits", lambda *a: (4, 1))  # 96 keys: 3 tiles
    counts = lambda: (dec_mod.launches, dec_mod.quant_launches,  # noqa: E731
                      dec_mod.decode_tc_launches)
    before = counts()
    with pytest.raises(RuntimeError, match="decode_attention"):
        dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    assert counts() == before


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_decode_tc_workspace_outlives_shapes(dev, int8):
    """The split workspace kept between calls: a small call, one that grows
    it, the small one again and a verify window over the same cache, each
    against its plain version, all queued before one synchronize."""
    calls = []
    for seed, B in ((17, 4), (18, 48), (17, 4)):
        q, k, v, valid, shared, scales = _decode_inputs(dev, seed, B, 4, 8, 160, 128, 704, int8)
        calls.append((dec_mod.decode_attention(q, k, v, valid, shared, **scales),
                      dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)))
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 19, 16, 9, 4, 8, 168, 128, 704,
                                                          int8)
    calls.append((dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales),
                  dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs,
                                                     **scales)))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(calls):
        torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16],
                                   msg=lambda m, _i=i: f"call {_i}: {m}")


@pytest.mark.parametrize("B", [16, 48])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_decode_tc_repeats_bit_for_bit(dev, int8, B):
    """50 calls at llama3-8b's sweep shape (split keys, combined in a fixed
    order) agree bit for bit."""
    q, k, v, valid, shared, scales = _decode_inputs(dev, 16, B, 4, 8, 160, 128, 704, int8)
    first = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    for i in range(50):
        got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
        assert torch.equal(got, first), f"call {i} differs from the first"


F32 = torch.float32


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("P", [0, 40, 128])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("D", [16, 32, 100, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 32])
def test_decode_f32_kernel_matches_plain(dev, rep, D, B, P, int8):
    """decode_split_f32 (K2 over a float32 cache, K2q over an int8 cache) at
    rep 1-32 (one or four row chunks of a cache block; prefix chunks of 8
    of the B * rep rows), head widths 16-256 (16 and 100 padded to 32 and
    128 by the wrapper), batch 1 and the sweep's 16, no
    prefix, one ending mid-tile and the study's 128, and L = 150, not a
    multiple of the 32-key tile."""
    Hkv, L = 2, 150
    q, k, v, valid, shared, scales = _decode_inputs(dev, rep + D + B + P, B, rep, Hkv, L, D, P,
                                                    int8, dtype=F32)
    counter = "quant_launches" if int8 else "launches"
    before, f32 = getattr(dec_mod, counter), dec_mod.decode_f32_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    torch.cuda.synchronize()
    assert (getattr(dec_mod, counter), dec_mod.decode_f32_launches) == (before + 1, f32 + 1)
    assert got.shape == q.shape
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    torch.testing.assert_close(got, want, **TOL[F32])
    if P == 0 and B > 1:
        assert not got[1].any()  # no key at all: exactly 0


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("B,rep,Hkv,P,L,D", [(16, 2, 2, 128, 160, 32), (16, 1, 4, 128, 160, 32),
                                             (8, 2, 2, 0, 768, 32), (4, 4, 2, 100, 150, 128),
                                             (3, 32, 1, 40, 100, 64), (5, 8, 2, 96, 0, 64)])
def test_decode_f32_every_split_plan_matches_plain(dev, monkeypatch, B, rep, Hkv, P, L, D,
                                                   int8):
    """Every split plan of decode_split_f32, the one-split case (no
    combine) included, at the study sweep's and the served pool's shapes
    among others: prefix splits shared by the batch, cache splits per row,
    whole tiles with no valid slot (skipped), and a row with no valid slot."""
    q, k, v, valid, shared, scales = _decode_inputs(dev, 24, B, rep, Hkv, L, D, P, int8,
                                                    dtype=F32)
    if L:
        valid[-1, : L // 2] = False  # whole tiles with no valid slot
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    for plan in _decode_plans(P, L):
        monkeypatch.setattr(dec_mod, "decode_splits_f32", lambda *a, _p=plan: _p)
        got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
        torch.testing.assert_close(got, want, **TOL[F32], msg=lambda m, _p=plan: f"plan {_p}: {m}")
        if P == 0 and B > 1:
            assert not got[1].any()


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_decode_f32_refuses_a_bad_plan(dev, monkeypatch, int8):
    """No fallback: a plan the kernel cannot take raises; nothing else runs."""
    q, k, v, valid, shared, scales = _decode_inputs(dev, 25, 4, 2, 2, 150, 32, 96, int8,
                                                    dtype=F32)
    monkeypatch.setattr(dec_mod, "decode_splits_f32", lambda *a: (4, 1))  # 96 keys: 3 tiles
    counts = lambda: (dec_mod.launches, dec_mod.quant_launches,  # noqa: E731
                      dec_mod.decode_f32_launches)
    before = counts()
    with pytest.raises(RuntimeError, match="decode_attention"):
        dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    assert counts() == before


@pytest.mark.parametrize("B,rep,Hkv,P,L", [(16, 2, 2, 128, 160), (8, 1, 4, 0, 768)],
                         ids=["study_sweep", "served_pool"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_decode_f32_repeats_bit_for_bit(dev, int8, B, rep, Hkv, P, L):
    """50 calls at the study sweep's and the served pool's shapes (split
    keys, combined in a fixed order) agree bit for bit."""
    q, k, v, valid, shared, scales = _decode_inputs(dev, 26, B, rep, Hkv, L, 32, P, int8,
                                                    dtype=F32)
    first = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    for i in range(50):
        got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
        assert torch.equal(got, first), f"call {i} differs from the first"


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("P", [0, 40, 704])
@pytest.mark.parametrize("D", [16, 32, 100, 128, 256])
@pytest.mark.parametrize("rep,Q", [(1, 9), (2, 9), (4, 9), (8, 2)],
                         ids=["rows9", "rows18", "rows36", "rows16"])
def test_verify_f32_kernel_matches_plain(dev, rep, Q, D, P, int8):
    """verify_split_f32 (K3 over a float32 and an int8 cache) at rep * Q of
    9 (tiny-gpt2-study), 18 (tiny-llama-study), 36 (llama3-8b) and 16 query
    rows a (batch row, kv head), head widths 16-256 (16 and 100 padded to 32
    and 128), no prefix, one ending mid-tile and llama3-8b's, L = 150 (not a
    tile multiple), with a window at slot 0, one at L - Q, a row with no
    valid slot (its queries see no cache key) and a tile with no valid
    slot."""
    B, Hkv, L = 4, 2, 150
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 40 + D + P, B, Q, rep, Hkv, L, D,
                                                          P, int8, dtype=F32)
    counter = "multi_quant_launches" if int8 else "multi_launches"
    before = (getattr(dec_mod, counter), dec_mod.verify_f32_launches, dec_mod.multi_tc_launches)
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert (getattr(dec_mod, counter), dec_mod.verify_f32_launches,
            dec_mod.multi_tc_launches) == (before[0] + 1, before[1] + 1, before[2])
    assert got.shape == q.shape
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got, want, **TOL[F32])
    if P == 0:
        assert not got[2].any()  # no key at all: exactly 0


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("B,Q,rep,Hkv,L,D,P", [
    (16, 9, 4, 8, 168, 128, 704),  # phase 13's float32 gates (llama3-8b)
    (16, 9, 2, 2, 168, 32, 128),   # the study's speculative sweep, tiny-llama-study
    (16, 9, 1, 4, 200, 32, 160),   # and tiny-gpt2-study
], ids=["gate", "study_llama", "study_gpt2"])
def test_verify_f32_main_path_shapes_match_plain(dev, B, Q, rep, Hkv, L, D, P, int8):
    """The shapes the main path gives the float32 verify window, under the
    wrapper's own plan."""
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 41, B, Q, rep, Hkv, L, D, P, int8,
                                                          dtype=F32)
    before = dec_mod.verify_f32_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert dec_mod.verify_f32_launches == before + 1
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got, want, **TOL[F32])


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("P,L,D", [(100, 150, 128), (0, 300, 128), (704, 168, 128),
                                   (40, 100, 256), (128, 168, 32)])
def test_verify_f32_every_plan_matches_plain(dev, monkeypatch, P, L, D, int8):
    """Every row count and split plan of verify_split_f32, the one-split case
    (no combine) included: prefix splits shared by the batch, cache splits
    per row, splits left with no tile or no visible key for some rows."""
    B, Q, rep, Hkv = 4, 9, 4, 2
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 42, B, Q, rep, Hkv, L, D, P, int8,
                                                          dtype=F32)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    for rows in dec_mod.VERIFY_F32_ROWS:
        if rows * D > 8192:
            continue
        for sp, sc in _plans(P, L):
            plan = (rows, sp, sc)
            monkeypatch.setattr(dec_mod, "verify_splits_f32", lambda *a, _p=plan: _p)
            got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
            torch.testing.assert_close(got, want, **TOL[F32],
                                       msg=lambda m, _p=plan: f"plan {_p}: {m}")
            if P == 0:
                assert not got[2].any()


@pytest.mark.parametrize("plan,D", [((64, 4, 1), 128), ((48, 1, 1), 128), ((64, 1, 1), 256)],
                         ids=["splits", "rows", "rows_at_256"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_verify_f32_refuses_a_bad_plan(dev, monkeypatch, int8, plan, D):
    """No fallback: more splits than tiles (96 prefix keys: 3 tiles), or a
    row count the kernel does not take, raises; nothing else runs."""
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 43, 4, 9, 4, 2, 150, D, 96, int8,
                                                          dtype=F32)
    monkeypatch.setattr(dec_mod, "verify_splits_f32", lambda *a: plan)
    counts = lambda: (dec_mod.multi_launches, dec_mod.multi_quant_launches,  # noqa: E731
                      dec_mod.verify_f32_launches)
    before = counts()
    with pytest.raises(RuntimeError, match="decode_attention"):
        dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    assert counts() == before


@pytest.mark.parametrize("B,Q,rep,Hkv,L,D,P", [(16, 9, 4, 8, 168, 128, 704),
                                               (16, 9, 2, 2, 168, 32, 128)],
                         ids=["gate", "study"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_verify_f32_repeats_bit_for_bit(dev, int8, B, Q, rep, Hkv, L, D, P):
    """50 calls at phase 13's and the study's verify shapes (split keys,
    combined in a fixed order) agree bit for bit."""
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 44, B, Q, rep, Hkv, L, D, P, int8,
                                                          dtype=F32)
    first = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    for i in range(50):
        got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
        assert torch.equal(got, first), f"call {i} differs from the first"


def _flash_f32_inputs(dev, seed, B, H, Hkv, S, D, lens):
    """float32 prefill inputs, q a head-major view of [B, S, H, D]; lens
    "rand" (lengths in [1, S]), "one" (row 0 of length 1) or "pad" (row 0
    at S / 4, row 1 at 5: query tiles wholly in the left padding)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device=dev, dtype=F32).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=F32).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=F32).transpose(1, 2)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    if lens == "one":
        lengths[0] = 1
    elif lens == "pad":
        lengths[:2] = torch.tensor([S // 4, 5], dtype=torch.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("B,H,Hkv,S,D,window,lens", [
    (1, 4, 2, 128, 32, None, "rand"),   # the study's prefix
    (8, 4, 2, 640, 32, None, "pad"),    # the listwise query: 20 key tiles a row
    (3, 4, 4, 128, 32, 48, "one"),      # a window, a row of length 1
    (2, 8, 2, 200, 64, None, "rand"),   # S ragged against every row plan
    (2, 4, 2, 150, 100, 70, "pad"),     # D padded to 128, a window, left pads
    (2, 4, 2, 96, 128, None, "one"),
])
def test_flash_f32_every_row_plan_matches_plain(dev, monkeypatch, B, H, Hkv, S, D, window,
                                                lens):
    """flash_fwd under every row plan that fits (16, 32, 64 query rows a
    block; 4, 2, 1 key groups folded at the end) against the plain version:
    left pads, query tiles wholly in the padding (exactly 0), a sliding
    window, and rows of length 1."""
    q, k, v, lengths = _flash_f32_inputs(dev, S + D, B, H, Hkv, S, D, lens)
    want = flash_mod.flash_attention_reference(q, k, v, lengths, causal=True, window=window)
    pad_rows = torch.arange(S, device=dev)[None, :] < (S - lengths.long())[:, None]
    Dk = next(w for w in flash_mod.F32_WIDTHS if w >= D)
    plans = [r for r in flash_mod.F32_ROWS
             if flash_mod.flash_f32_smem(r, Dk) <= flash_mod._build.SMEM_PER_BLOCK]
    for rows in plans:
        monkeypatch.setattr(flash_mod, "flash_f32_rows", lambda *a, _r=rows: _r)
        before, tc = flash_mod.launches, flash_mod.tc_launches
        got = flash_mod.flash_attention(q, k, v, lengths, causal=True, window=window)
        torch.cuda.synchronize()
        assert (flash_mod.launches, flash_mod.tc_launches) == (before + 1, tc)
        torch.testing.assert_close(got, want, **TOL[F32],
                                   msg=lambda m, _r=rows: f"{_r} rows a block: {m}")
        assert not got.transpose(1, 2)[pad_rows].any()  # left-pad rows are exactly 0


def test_flash_f32_refuses_a_bad_plan(dev, monkeypatch):
    """No fallback: a row count the float32 kernel does not take raises;
    nothing else runs."""
    q, k, v, lengths = _flash_f32_inputs(dev, 27, 2, 4, 2, 128, 32, "rand")
    monkeypatch.setattr(flash_mod, "flash_f32_rows", lambda *a: 48)
    before = flash_mod.launches
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_mod.flash_attention(q, k, v, lengths)
    assert flash_mod.launches == before


@pytest.mark.parametrize("B,S", [(1, 128), (8, 640), (184, 128)],
                         ids=["study_prefix", "listwise", "scoring"])
def test_flash_f32_repeats_bit_for_bit(dev, B, S):
    """20 calls at the study's prefill shapes agree bit for bit (the key
    groups are folded in a fixed order)."""
    q, k, v, lengths = _flash_f32_inputs(dev, 28, B, 4, 2, S, 32, "rand")
    first = flash_mod.flash_attention(q, k, v, lengths)
    for i in range(20):
        got = flash_mod.flash_attention(q, k, v, lengths)
        assert torch.equal(got, first), f"call {i} differs from the first"


# llama3-8b's (K, N) pairs: q/o, k/v, gate/up, down, lm_head; then ragged
# pairs: K = 100 (x rows padded by the wrapper), N = 90 (the weight padded),
# K = 4096 + 48 (a last k tile of 48 in the GEMM regime's 64).
QMM_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256), (100, 96),
          (72, 90), (4144, 4096)]
QMM_M = [1, 16, 45, 48, 65, 129, 704, 1536]
QMM_TOL = {torch.float32: dict(rtol=3e-5, atol=1e-4), torch.bfloat16: TOL[torch.bfloat16]}


def _qmm_weight(dev, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev) * 0.02
    return qmm.quantize_weight(w)


@pytest.fixture(scope="module")
def qmm_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return {kn: _qmm_weight(torch.device("cuda"), *kn, seed=i) for i, kn in enumerate(QMM_KN)}


@pytest.mark.parametrize("x_dtype,out_dtype", qmm.COMBOS, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("K,N", QMM_KN)
@pytest.mark.parametrize("M", QMM_M)
def test_quant_matmul_kernel_matches_plain(dev, qmm_weights, M, K, N, x_dtype, out_dtype):
    wq, scale = qmm_weights[(K, N)]
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=dev).to(x_dtype)
    gemv, gemm, f32 = qmm.gemv_launches, qmm.gemm_launches, qmm.f32_launches
    tf32 = (qmm.tf32_gemv_launches, qmm.tf32_gemm_launches)
    got = qmm.quant_matmul(x, wq, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    small = M <= qmm.GEMV_MAX_M
    assert (qmm.gemv_launches - gemv, qmm.gemm_launches - gemm) == ((1, 0) if small else (0, 1))
    is_f32 = x_dtype == torch.float32
    assert qmm.f32_launches - f32 == is_f32
    # float32 x: the two-pass TF32 kernels, as the C entry reports
    assert (qmm.tf32_gemv_launches - tf32[0], qmm.tf32_gemm_launches - tf32[1]) == (
        is_f32 and small, is_f32 and not small)
    assert got.dtype == out_dtype and got.shape == (M, N)
    want = qmm.quant_matmul_reference(x, wq, scale, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])


@pytest.mark.parametrize("x_dtype,out_dtype", qmm.COMBOS, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("M", [16, 129, 704])
def test_quant_matmul_tolerance_sees_a_dropped_k_tile(dev, qmm_weights, M, x_dtype, out_dtype):
    """The kernel on x with its last 32 columns zeroed (a kernel that dropped
    its last k tile, 32 or 64 wide, would drop at least these) must fail the
    tolerance against the plain version on the true x."""
    wq, scale = qmm_weights[(4096, 4096)]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(M, 4096, generator=g, device=dev).to(x_dtype)
    cut = x.clone()
    cut[:, -32:] = 0
    want = qmm.quant_matmul_reference(x, wq, scale, out_dtype)
    got = qmm.quant_matmul(cut, wq, scale, out_dtype=out_dtype)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])


@pytest.fixture(scope="module")
def qmm_groups(qmm_weights):
    """llama3-8b's q/k/v and gate/up as the decode step groups them, each
    weight its own tensor (k and v, gate and up from distinct seeds)."""
    dev = torch.device("cuda")
    return {"qkv": [qmm_weights[(4096, 4096)], qmm_weights[(4096, 1024)],
                    _qmm_weight(dev, 4096, 1024, seed=101)],
            "gate_up": [qmm_weights[(4096, 14336)], _qmm_weight(dev, 4096, 14336, seed=102)]}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("group", ["qkv", "gate_up"])
@pytest.mark.parametrize("M", [1, 16, 45, 48, 64])
def test_quant_matmul_group_matches_plain(dev, qmm_groups, M, group, out_dtype):
    """One launch for the weights that share x, each output against the
    plain product of its own weight."""
    mats = qmm_groups[group]
    g = torch.Generator(device=dev).manual_seed(M + 7)
    x = torch.randn(M, 4096, generator=g, device=dev).bfloat16()
    before = (qmm.gemv_launches, qmm.group_launches, qmm.gemm_launches)
    got = qmm.quant_matmul_group(x, mats, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (qmm.gemv_launches - before[0], qmm.group_launches - before[1],
            qmm.gemm_launches - before[2]) == (1, 1, 0)
    assert len(got) == len(mats)
    for i, (out, (wq, scale)) in enumerate(zip(got, mats)):
        assert out.dtype == out_dtype and out.shape == (M, wq.shape[1])
        want = qmm.quant_matmul_reference(x, wq, scale, out_dtype)
        torch.testing.assert_close(out.float(), want.float(), **QMM_TOL[out_dtype],
                                   msg=lambda m, _i=i: f"weight {_i}: {m}")


@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 4096)], ids=["k_v", "down"])
def test_quant_matmul_gemv_repeats_bit_for_bit(dev, qmm_weights, K, N):
    """gemv_stream_tc splits these weights' column tiles across 4-8 blocks
    and the block that arrives last sums the partials in split order. 50
    calls at M=16, each beside memory traffic on a second stream that shifts
    the blocks' timing, must agree bit for bit."""
    wq, scale = qmm_weights[(K, N)]
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(16, K, generator=g, device=dev).bfloat16()
    first = qmm.quant_matmul(x, wq, scale, out_dtype=torch.bfloat16)
    noise = torch.zeros(64 << 20, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for i in range(50):
        with torch.cuda.stream(side):
            noise.add_(1.0)
        got = qmm.quant_matmul(x, wq, scale, out_dtype=torch.bfloat16)
        assert torch.equal(got, first), f"call {i} differs from the first"
    torch.cuda.synchronize()


def test_quant_matmul_gemv_counters_return_to_zero(dev, qmm_weights, qmm_groups):
    """Every launch leaves its arrival counters at 0: calls of several plans
    queued on the default stream and on a second one, each against its plain
    version, then every workspace's counters read back."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(16, 4096, generator=g, device=dev).bfloat16()
    calls = []
    for stream in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(stream):
            for mats in (qmm_groups["qkv"], [qmm_weights[(4096, 1024)]], qmm_groups["gate_up"],
                         [qmm_weights[(4096, 128256)]]):
                calls.append((qmm.quant_matmul_group(x, mats), mats))
    torch.cuda.synchronize()
    for outs, mats in calls:
        for out, (wq, scale) in zip(outs, mats):
            want = qmm.quant_matmul_reference(x, wq, scale)
            torch.testing.assert_close(out.float(), want.float(), **QMM_TOL[torch.bfloat16])
    keys = [k for k in qmm._counters if k[0] == x.device]
    assert len(keys) >= 2
    for key in keys:
        assert int(qmm._counters[key].abs().sum()) == 0, key


def test_quant_matmul_gemv_refuses_a_bad_plan(dev, qmm_weights, monkeypatch):
    """A plan the kernel cannot take (more blocks than tile steps) raises;
    nothing falls back and nothing is counted."""
    wq, scale = qmm_weights[(4096, 1024)]
    x = torch.ones(16, 4096, device=dev, dtype=torch.bfloat16)
    plan = qmm.gemv_plan

    def bad(K, Ns, sms):
        blocks, tiles, work, bn = plan(K, Ns, sms)
        return work + 1, tiles, work, bn

    monkeypatch.setattr(qmm, "gemv_plan", bad)
    monkeypatch.setattr(qmm, "_groups", {})  # records hold their plan
    before = qmm.gemv_launches
    with pytest.raises(RuntimeError, match="quant_matmul_stream"):
        qmm.quant_matmul(x, wq, scale)
    assert qmm.gemv_launches == before


def test_quant_matmul_gemm_repeats_bit_for_bit(dev, qmm_weights):
    """The GEMM regime's two consumer warpgroups share a ring of converted
    weight tiles; a buffer rewritten while the other warpgroup still reads
    it would make repeated calls differ. 50 calls on one input, each beside
    memory traffic on a second stream that shifts the warpgroups' timing,
    must agree bit for bit."""
    wq, scale = qmm_weights[(4096, 14336)]
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1536, 4096, generator=g, device=dev).bfloat16()
    first = qmm.quant_matmul(x, wq, scale, out_dtype=torch.bfloat16)
    noise = torch.zeros(64 << 20, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for i in range(50):
        with torch.cuda.stream(side):
            noise.add_(1.0)
        got = qmm.quant_matmul(x, wq, scale, out_dtype=torch.bfloat16)
        assert torch.equal(got, first), f"call {i} differs from the first"
    torch.cuda.synchronize()


# K4's float32 route at the shapes chip_smoke.py's phase 18 gives it
# (llama3-8b's weights; decode at M = 4 and 16, the prefix's M = 704, 16
# suffixes' M = 1536, the 4 x 896 prefill's M = 3584) and tp=2's shards at
# M = 3584: (M, K, N).
TF32_SHAPES = [(m, k, n) for m in (4, 16, 704, 1536, 3584)
               for k, n in ((4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024))]
TF32_SHAPES += [(16, 4096, 128256), (4, 4096, 128256), (1, 4096, 128256)]
TF32_SHAPES += [(8, 4096, 14336), (8, 14336, 4096), (9, 4096, 1024)]
TF32_SHAPES += [(3584, k, n) for k, n in ((4096, 2048), (4096, 512), (2048, 4096),
                                          (4096, 7168), (7168, 4096))]


@pytest.fixture(scope="module")
def tf32_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    kns = sorted({(k, n) for _, k, n in TF32_SHAPES})
    return {kn: _qmm_weight(torch.device("cuda"), *kn, seed=200 + i) for i, kn in enumerate(kns)}


@pytest.mark.parametrize("M,K,N", TF32_SHAPES)
def test_tf32_route_matches_plain_at_main_path_shapes(dev, tf32_weights, M, K, N):
    """gemv_stream_tf32 (M <= 64) and tf32_gemm_kernel against the plain
    version within 1e-4 + 3e-5 * |plain| (K = 14,336 among them: the tensor
    cores' accumulation over the longest sums), and x with its last 32
    columns zeroed outside it."""
    wq, scale = tf32_weights[(K, N)]
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=dev)
    before = (qmm.tf32_gemv_launches, qmm.tf32_gemm_launches)
    got = qmm.quant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    small = M <= qmm.GEMV_MAX_M
    assert (qmm.tf32_gemv_launches - before[0], qmm.tf32_gemm_launches - before[1]) == (
        (1, 0) if small else (0, 1))
    want = qmm.quant_matmul_reference(x, wq, scale)
    torch.testing.assert_close(got, want, **QMM_TOL[torch.float32])
    cut = x.clone()
    cut[:, -32:] = 0
    with pytest.raises(AssertionError):
        torch.testing.assert_close(qmm.quant_matmul(cut, wq, scale), want,
                                   **QMM_TOL[torch.float32])


@pytest.mark.parametrize("group", ["qkv", "gate_up"])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 45, 64])
def test_tf32_group_is_one_launch(dev, qmm_groups, M, group):
    """float32 x in the GEMV regime: one gemv_stream_tf32 launch for the
    weights that share x, each output against its own plain product."""
    mats = qmm_groups[group]
    g = torch.Generator(device=dev).manual_seed(M + 17)
    x = torch.randn(M, 4096, generator=g, device=dev)
    before = (qmm.gemv_launches, qmm.group_launches, qmm.tf32_gemv_launches, qmm.f32_launches)
    got = qmm.quant_matmul_group(x, mats)
    torch.cuda.synchronize()
    assert (qmm.gemv_launches - before[0], qmm.group_launches - before[1],
            qmm.tf32_gemv_launches - before[2], qmm.f32_launches - before[3]) == (1, 1, 1, 1)
    for i, (out, (wq, scale)) in enumerate(zip(got, mats)):
        assert out.dtype == torch.float32 and out.shape == (M, wq.shape[1])
        want = qmm.quant_matmul_reference(x, wq, scale)
        torch.testing.assert_close(out, want, **QMM_TOL[torch.float32],
                                   msg=lambda m, _i=i: f"weight {_i}: {m}")


@pytest.mark.parametrize("M,K,N", [(16, 14336, 4096), (4, 4096, 1024), (704, 4096, 1024),
                                   (1536, 4096, 14336)],
                         ids=["gemv_down", "gemv_k_v", "gemm_split_k_v", "gemm_gate"])
def test_tf32_route_repeats_bit_for_bit(dev, tf32_weights, M, K, N):
    """The GEMV's split-K reduce and the GEMM's (k/v at M = 704 splits K
    across blocks) sum in a fixed order, and the GEMM's two warpgroups share a
    ring of x_lo tiles: 20 calls on one input, each beside memory traffic
    on a second stream, must agree bit for bit."""
    wq, scale = tf32_weights[(K, N)]
    if M > qmm.GEMV_MAX_M and K == 4096 and N == 1024:
        assert qmm.tf32_gemm_plan(K, N)[0] > 1
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(M, K, generator=g, device=dev)
    first = qmm.quant_matmul(x, wq, scale)
    noise = torch.zeros(64 << 20, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for i in range(20):
        with torch.cuda.stream(side):
            noise.add_(1.0)
        got = qmm.quant_matmul(x, wq, scale)
        assert torch.equal(got, first), f"call {i} differs from the first"
    torch.cuda.synchronize()


@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 4096)], ids=["k_v", "down"])
def test_tf32_rows_do_not_depend_on_the_batch(dev, tf32_weights, K, N):
    """A row's float32 product is the same bit for bit whatever rows share
    its call, in either regime (the K split plan takes no M, and the GEMV's
    8-row tiles at M <= 8 sum as its 16- to 64-row ones): the served paths'
    replays rely on it."""
    wq, scale = tf32_weights[(K, N)]
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(3584, K, generator=g, device=dev)
    big = qmm.quant_matmul(x, wq, scale)
    for M in (704, 65):
        assert torch.equal(qmm.quant_matmul(x[:M].contiguous(), wq, scale), big[:M]), M
    small = qmm.quant_matmul(x[:64].contiguous(), wq, scale)
    for M in (1, 4, 8, 9, 16, 45):
        assert torch.equal(qmm.quant_matmul(x[:M].contiguous(), wq, scale), small[:M]), M


def test_tf32_route_counters_return_to_zero(dev, qmm_groups, tf32_weights):
    """float32 calls that split (the GEMV's column tiles, the GEMM's k/v at
    M = 704) on the default stream and a second one, each against its plain
    version; then every workspace's arrival counters read back as 0."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    g = torch.Generator(device=dev).manual_seed(11)
    xs = {M: torch.randn(M, 4096, generator=g, device=dev) for M in (16, 704)}
    calls = []
    for stream in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(stream):
            for M, mats in ((16, qmm_groups["qkv"]), (16, qmm_groups["gate_up"]),
                            (704, [tf32_weights[(4096, 1024)]]),
                            (704, [tf32_weights[(4096, 4096)]])):
                calls.append((xs[M], qmm.quant_matmul_group(xs[M], mats), mats))
    torch.cuda.synchronize()
    for x, outs, mats in calls:
        for out, (wq, scale) in zip(outs, mats):
            torch.testing.assert_close(out, qmm.quant_matmul_reference(x, wq, scale),
                                       **QMM_TOL[torch.float32])
    keys = [k for k in qmm._counters if k[0] == xs[16].device]
    assert len(keys) >= 2
    for key in keys:
        assert int(qmm._counters[key].abs().sum()) == 0, key


def test_tf32_gemm_refuses_a_bad_plan(dev, tf32_weights, monkeypatch):
    """A split plan the kernel cannot take (an empty last split) raises;
    nothing falls back and nothing is counted."""
    wq, scale = tf32_weights[(4096, 1024)]
    x = torch.ones(704, 4096, device=dev)
    monkeypatch.setattr(qmm, "tf32_gemm_plan", lambda K, N: (3, 4096))
    before = (qmm.gemm_launches, qmm.f32_launches)
    with pytest.raises(RuntimeError, match="quant_matmul_gemm"):
        qmm.quant_matmul(x, wq, scale)
    assert (qmm.gemm_launches, qmm.f32_launches) == before


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8_cache"])
def test_paged_gather_scatter_round_trip_on_the_card(dev, quant):
    """The paged arena's gather into the view buffer and scatter back
    through write tables, on the card at llama3-8b's head shape: a view
    written and scattered reads back exactly; sink entries leave shared
    blocks alone; K2 over the gathered view equals K2 over the same keys
    laid out contiguously."""
    import dataclasses

    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.models.transformer import init_cache
    from fairness_llm_tpu_torch.serving import paged

    cfg = dataclasses.replace(get_model_config("llama3-8b"), num_layers=2,
                              kv_cache_quant=quant)
    N, bs, nb, B = 40, 16, 6, 4
    arena = paged.init_arena(cfg, N, bs, B, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for t in arena.tensors():
        src = torch.randn(t.shape, generator=g, device=dev) * 40
        t.copy_(src.to(t.dtype) if t.is_floating_point() else src.round().to(t.dtype))
    if quant:
        for lc in arena.layers:
            lc.k_scale.abs_().add_(1e-3)
            lc.v_scale.abs_().add_(1e-3)
    arena.key_valid.fill_(True)
    before = [t.clone() for t in arena.tensors()]
    tables = torch.arange(B * nb, device=dev).view(B, nb) + 1
    tables[:, 0] = 0  # block 0 shared by every row
    wtables = tables.clone()
    wtables[:, 0] = N  # the shared block is read-only: its entries go to the sink
    view = init_cache(cfg, B, nb * bs, device=dev)
    v = paged.gather_view(arena, tables, arena.lengths, view)
    torch.cuda.synchronize()
    for lc, big in zip(v.layers, arena.layers):
        assert torch.equal(lc.k.view(B * nb, bs, *lc.k.shape[2:]), big.k[tables.reshape(-1)])
    q = torch.randn(B, cfg.num_heads, cfg.head_dim, generator=g, device=dev)
    q = q.to(torch.bfloat16)
    layer = v.layers[0]
    kw = dict(k_scale=layer.k_scale, v_scale=layer.v_scale) if quant else {}
    out = dec_mod.decode_attention(q, layer.k, layer.v, v.key_valid, **kw)
    contig = [x.clone() for x in (layer.k, layer.v)]
    want = dec_mod.decode_attention(q, contig[0], contig[1], v.key_valid.clone(), **kw)
    assert torch.equal(out, want)
    for lc in v.layers:
        for t in (lc.k, lc.v) + ((lc.k_scale, lc.v_scale) if quant else ()):
            t.add_(1)
    paged.scatter_view(arena, v, wtables)
    torch.cuda.synchronize()
    # Every block a write table names, the sink apart, holds its view block
    # plus one; every other block of the arena is as it was (block 0, shared
    # and read-only, and the blocks no row's table names). Each tensor of
    # every layer: k, v and, over an int8 cache, the scales.
    written = torch.zeros(N, dtype=torch.bool, device=dev)
    named = wtables.reshape(-1)
    written[named[named < N]] = True
    assert not written[0] and int(written.sum()) == B * (nb - 1)
    for i, lc in enumerate(arena.layers):
        now = [lc.k, lc.v] + ([lc.k_scale, lc.v_scale] if quant else [])
        per = len(now)
        for j, t in enumerate(now):
            old = before[i * per + j]
            assert torch.equal(t[:N][written], old[:N][written] + 1), (i, j)
            assert torch.equal(t[:N][~written], old[:N][~written]), (i, j)
    fresh = init_cache(cfg, B, nb * bs, device=dev)
    v2 = paged.gather_view(arena, tables, arena.lengths, fresh)
    for lc, lv in zip(v2.layers, v.layers):
        assert torch.equal(lc.k[:, bs:], lv.k[:, bs:])
        assert torch.equal(lc.v[:, bs:], lv.v[:, bs:])


# ---------------------------------------------------------------------------
# The reference's other model families at their own shapes: gemma-7b (head
# width 256, 16 q heads over 16 kv heads), mistral-7b (a window of 4,096)
# and qwen2-7b (7 q heads a kv head, d_model 3,584, d_ff 18,944, vocab
# 152,064), as chip_smoke.py's phase 33 runs them.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,window", [
    (2, 16, 16, 640, 256, None),    # gemma: head width 256, one q head a kv head
    (1, 32, 8, 4608, 128, 4096),    # mistral: one row past its window
], ids=["gemma", "mistral_window"])
def test_flash_kernels_at_family_shapes(dev, dtype, B, H, Hkv, S, D, window):
    """K1 (flash_fwd_tc in bf16, flash_fwd in float32) at gemma's head
    width and over mistral's window with S > window (full rows, so the last
    S - window query rows lose keys to the window), against the plain
    version. The window must change the rows past it, and the kernel with
    each row's first valid key masked out must fail the tolerance on the
    rows valid under both masks."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=g, device=dev, dtype=dtype).transpose(1, 2)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev, dtype=dtype)
    lengths = torch.full((B,), S, device=dev, dtype=torch.int32)
    if B > 1:
        lengths[1] = S // 3
    before, tc = flash_mod.launches, flash_mod.tc_launches
    got = flash_mod.flash_attention(q, k, v, lengths, causal=True, window=window)
    torch.cuda.synchronize()
    assert (flash_mod.launches, flash_mod.tc_launches) == (before + 1,
                                                           tc + (dtype == torch.bfloat16))
    want = flash_mod.flash_attention_reference(q, k, v, lengths, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if window is not None:
        wide = flash_mod.flash_attention_reference(q, k, v, lengths, causal=True)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(wide[:, :, window:].float(), want[:, :, window:].float(),
                                       **TOL[dtype])
        del wide
    short_len = lengths - 1
    short = flash_mod.flash_attention(q, k, v, short_len, causal=True, window=window)
    rows = torch.arange(S, device=dev)[None, :] >= (S - short_len.long())[:, None]
    sel = rows[:, None, :, None].expand_as(want)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(short[sel].float(), want[sel].float(), **TOL[dtype])


def test_flash_tc_kernel_at_large_values(dev):
    """C8: v of scale 4 (mistral-7b's first layer holds |v| up to 7), where
    outputs of the early rows, each an average of a few values, can nearly
    cancel. The kernel must hold the bf16 allowance there; with P in one
    bf16 term it did not (tests/test_torch_ops.py emulates both)."""
    B, H, Hkv, S, D = 2, 32, 8, 256, 128
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16().transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16().transpose(1, 2)
    v = (torch.randn(B, S, Hkv, D, generator=g, device=dev) * 4).bfloat16().transpose(1, 2)
    lengths = torch.tensor([S, S - 37], device=dev, dtype=torch.int32)
    got = flash_mod.flash_attention(q, k, v, lengths)
    want = flash_mod.flash_attention_reference(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("P", [0, 704])
@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("rep,Hkv,D", [(7, 4, 128), (1, 16, 256)], ids=["qwen2", "gemma"])
def test_decode_tc_kernel_at_family_shapes(dev, rep, Hkv, D, B, P, int8):
    """decode_split_tc at qwen2's 7 q heads a kv head (4 kv heads of 128)
    and gemma's one (16 kv heads of 256), L = 900 (a full phase-1 row
    cache), against the plain version."""
    L = 900
    q, k, v, valid, shared, scales = _decode_inputs(dev, rep + D + B + P, B, rep, Hkv, L, D, P,
                                                    int8)
    before = dec_mod.decode_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, **scales)
    torch.cuda.synchronize()
    assert dec_mod.decode_tc_launches == before + 1
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("rep,Hkv,D", [(7, 4, 128), (1, 16, 256)], ids=["qwen2", "gemma"])
def test_verify_tc_kernel_at_family_shapes(dev, rep, Hkv, D, int8):
    """decode_verify_tc at a verify window of 9 rows a row: qwen2's 63
    query rows a kv head and gemma's 9 at head width 256, the sweep's
    prefix of 704, against the plain version; lowering every q_offset by
    one (each query loses its own slot) must fail the tolerance."""
    B, Q, L, P = 16, 9, 168, 704
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, rep + D, B, Q, rep, Hkv, L, D, P,
                                                          int8)
    before = dec_mod.multi_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert dec_mod.multi_tc_launches == before + 1
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    blind = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs - 1, **scales)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(blind.float(), want.float(), **TOL[torch.bfloat16])


# The families' K4 weights (K, N): qwen2-7b's gate/up, down and lm_head,
# gemma-7b's gate/up and down.
FAMILY_KN = [(3584, 18944), (18944, 3584), (3584, 152064), (3072, 24576), (24576, 3072)]
# Grouped as the decode step groups them: q|k|v and gate|up of each.
FAMILY_GROUPS = {"qwen2_qkv": [(3584, 3584), (3584, 512), (3584, 512)],
                 "qwen2_gate_up": [(3584, 18944), (3584, 18944)],
                 "gemma_qkv": [(3072, 4096)] * 3,
                 "gemma_gate_up": [(3072, 24576), (3072, 24576)]}


@pytest.fixture(scope="module")
def family_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    out = {kn: _qmm_weight(dev, *kn, seed=300 + i) for i, kn in enumerate(FAMILY_KN)}
    for name, kns in FAMILY_GROUPS.items():
        out[name] = [_qmm_weight(dev, *kn, seed=400 + 10 * len(name) + i)
                     for i, kn in enumerate(kns)]
    return out


@pytest.mark.parametrize("M", [1, 16, 48, 704, 2560])
@pytest.mark.parametrize("K,N", FAMILY_KN)
def test_quant_matmul_at_family_shapes(dev, family_weights, M, K, N):
    """K4 alone at the families' widths, both regimes (decode M = 1 and 16,
    the study batch's 48, the prefix's and 16 suffixes' prefill M), bf16 x;
    the lm_head with a float32 output, as the model calls it. x with its
    last 32 columns zeroed must fail the tolerance."""
    wq, scale = family_weights[(K, N)]
    out_dtype = torch.float32 if N == 152064 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    gemv, gemm = qmm.gemv_launches, qmm.gemm_launches
    got = qmm.quant_matmul(x, wq, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    small = M <= qmm.GEMV_MAX_M
    assert (qmm.gemv_launches - gemv, qmm.gemm_launches - gemm) == ((1, 0) if small else (0, 1))
    assert got.dtype == out_dtype and got.shape == (M, N)
    want = qmm.quant_matmul_reference(x, wq, scale, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
    cut = x.clone()
    cut[:, -32:] = 0
    with pytest.raises(AssertionError):
        torch.testing.assert_close(qmm.quant_matmul(cut, wq, scale, out_dtype=out_dtype).float(),
                                   want.float(), **QMM_TOL[out_dtype])


@pytest.mark.parametrize("M", [1, 16, 48, 64])
@pytest.mark.parametrize("group", list(FAMILY_GROUPS))
def test_quant_matmul_group_at_family_shapes(dev, family_weights, group, M):
    """One GEMV launch for each family's q|k|v and gate|up, each output
    against its own weight's plain product."""
    mats = family_weights[group]
    K = mats[0][0].shape[0]
    g = torch.Generator(device=dev).manual_seed(M + K + 3)
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    before = (qmm.gemv_launches, qmm.group_launches, qmm.gemm_launches)
    got = qmm.quant_matmul_group(x, mats, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (qmm.gemv_launches - before[0], qmm.group_launches - before[1],
            qmm.gemm_launches - before[2]) == (1, 1, 0)
    for i, (out, (wq, scale)) in enumerate(zip(got, mats)):
        assert out.shape == (M, wq.shape[1])
        want = qmm.quant_matmul_reference(x, wq, scale, torch.bfloat16)
        torch.testing.assert_close(out.float(), want.float(), **QMM_TOL[torch.bfloat16],
                                   msg=lambda m, _i=i: f"weight {_i}: {m}")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_verify_tc_kernel_at_72_rows_a_kv_head(dev, int8):
    """decode_verify_tc at llama3-70b's verify window: 9 rows a row times 8
    q heads a kv head, 72 query rows a kv head, so two row blocks a kv
    head (the second of 8 rows), at the phase-1 sweep's prefix of 640 and a
    row cache of 224, against the plain version; lowering every q_offset by
    one (each query loses its own slot) must fail the tolerance."""
    B, Q, rep, Hkv, L, D, P = 16, 9, 8, 8, 224, 128, 640
    q, k, v, valid, shared, offs, scales = _verify_inputs(dev, 72, B, Q, rep, Hkv, L, D, P,
                                                          int8)
    before = dec_mod.multi_tc_launches
    got = dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.cuda.synchronize()
    assert dec_mod.multi_tc_launches == before + 1
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs, **scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    _outside_tolerance(dec_mod.decode_attention(q, k, v, valid, shared, q_offsets=offs - 1,
                                                **scales), want, torch.bfloat16)


# (B, Q, H, Hkv) of the main path's decode (Q = 1) and verify (Q = 9) calls
# at llama3-8b's and llama3-70b's heads, head width 128.
LARGE_VALUE_SHAPES = {"llama3-8b_decode": (16, 1, 32, 8), "llama3-8b_verify": (16, 9, 32, 8),
                      "llama3-70b_decode": (16, 1, 64, 8), "llama3-70b_verify": (16, 9, 64, 8)}


@pytest.mark.parametrize("rows", ["sweep", "short"])
@pytest.mark.parametrize("shape", list(LARGE_VALUE_SHAPES))
def test_decode_tc_kernels_at_large_values(dev, shape, rows):
    """C9: decode_split_tc (Q = 1) and decode_verify_tc (Q = 9) with v of
    scale 4, rows as the phase-1 sweep gives them (the 640-key prefix and
    100-224 own slots) and rows of 12 keys with no prefix, where an output
    averages few values that can nearly cancel. Each must hold the bf16
    allowance; with P in one bf16 term rows of few keys did not
    (tests/test_torch_ops.py emulates both)."""
    B, Q, H, Hkv = LARGE_VALUE_SHAPES[shape]
    D, L = 128, 224
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, Q, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, L, Hkv, D, generator=g, device=dev).bfloat16()
    v = (torch.randn(B, L, Hkv, D, generator=g, device=dev) * 4).bfloat16()
    if rows == "sweep":
        P, keys = 640, torch.randint(100, L + 1, (B,), generator=g, device=dev)
    else:
        P, keys = 0, torch.full((B,), 12, device=dev)
    shared = None
    if P:
        shared = (torch.randn(P, Hkv, D, generator=g, device=dev).bfloat16(),
                  (torch.randn(P, Hkv, D, generator=g, device=dev) * 4).bfloat16())
    valid = torch.arange(L, device=dev)[None, :] < keys[:, None]
    kw = {} if Q == 1 else {"q_offsets": (keys - Q).to(torch.int32)}
    q = q[:, 0] if Q == 1 else q
    got = dec_mod.decode_attention(q, k, v, valid, shared, **kw)
    want = dec_mod.decode_attention_reference(q, k, v, valid, shared, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
