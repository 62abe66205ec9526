"""The port's int8 weight-only path against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
kernel runs in interpret mode on the CPU, as its own tests run it; the
port's wrapper takes its plain version for CPU tensors. Tolerances:

- quantization: int8 values equal, scales within 1 float32 ulp;
- the plain matmul against the Pallas kernel: 2e-5 (float32; sums of a few
  hundred products in another order), and one bf16 ulp for a bf16 output
  (both round one float32 result); the float32 route's two-pass TF32
  product (``quant_matmul_two_pass_reference``) the same 2e-5: it drops at
  most 2^-22 |x| of each x value;
- the TF32 split: x_hi + x_lo equal to x bit for bit;
- model logits: 1e-4 (float32, as the float model's parity tests);
- greedy tokens: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.ops import quant_matmul as jqm  # noqa: E402
from fairness_llm_tpu.runtime import weights as jweights  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import (  # noqa: E402
    build_model,
    dequantize_params,
    init_params,
    params_from_jax,
    quantize_params,
)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8(cfg):
    return dataclasses.replace(cfg, weight_quant="int8")


# ---------------------------------------------------------------------------
# Quantization and the plain matmul
# ---------------------------------------------------------------------------


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(256, 384)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0  # the 1e-12 floor
    w[:5, 9] = [0.5, -1.5, 2.5, 127.0, 0.0]  # halves: round half to even
    jq, js = jqm.quantize_weight(jnp.asarray(w))
    tq, ts = qmm.quantize_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    back = qmm.dequantize_weight(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jqm.dequantize_weight(jq, js, jnp.float32)))


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    wq, scale = jqm.quantize_weight(jnp.asarray(w))
    return x, np.asarray(wq), np.asarray(scale)


@pytest.mark.parametrize("m,k,n", [(48, 768, 3072), (16, 256, 128), (1, 128, 256),
                                   (45, 384, 640)])
def test_plain_matmul_matches_pallas_f32(m, k, n):
    x, wq, scale = _operands(m, k, n, seed=m * k + n)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                                       interpret=True))
    got = qmm.quant_matmul_reference(_t(x), _t(wq), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_matmul_matches_pallas_bf16_within_one_ulp():
    x, wq, scale = _operands(16, 256, 256, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jqm.quant_matmul(xb, jnp.asarray(wq), jnp.asarray(scale), interpret=True),
                      np.float32)
    got = qmm.quant_matmul_reference(_t(np.asarray(xb, np.float32)).bfloat16(), _t(wq),
                                     _t(scale))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_plain_matmul_matches_xla_branch_at_untileable_shape():
    x, wq, scale = _operands(8, 100, 96, seed=2)
    assert not jqm.quant_tileable(100, 96)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                                       interpret=True, out_dtype=jnp.float32))
    got = qmm.quant_matmul(_t(x), _t(wq), _t(scale), out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_takes_the_plain_version_and_checks_inputs():
    x, wq, scale = _operands(4, 64, 32, seed=3)
    before = (qmm.gemv_launches, qmm.gemm_launches)
    out = qmm.quant_matmul(_t(x), _t(wq), _t(scale))
    assert torch.equal(out, qmm.quant_matmul_reference(_t(x), _t(wq), _t(scale)))
    assert (qmm.gemv_launches, qmm.gemm_launches) == before  # no kernel for a CPU tensor
    with pytest.raises(ValueError, match="int8"):
        qmm.quant_matmul(_t(x), _t(wq).float(), _t(scale))
    with pytest.raises(ValueError, match="dtypes"):
        qmm.quant_matmul(_t(x), _t(wq), _t(scale), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="disagree"):
        qmm.quant_matmul(_t(x)[:, :-1], _t(wq), _t(scale))


# tf32_gemm_kernel's weights: llama3-8b's as phase 18's prefill GEMMs give
# them (gate/up, down, q/o, k/v, lm_head), tp=2's shards, and ragged ones.
TF32_GEMM_WEIGHTS = [(4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024), (4096, 128256),
                     (4096, 2048), (4096, 512), (2048, 4096), (4096, 7168), (7168, 4096),
                     (100, 96), (72, 96), (4144, 4096)]


@pytest.mark.parametrize("K,N", TF32_GEMM_WEIGHTS)
def test_tf32_gemm_plan_covers_k_and_splits_deep_weights(K, N):
    """Every k tile in exactly one split, none empty, each at least
    TF32_MIN_SPLIT_TILES k tiles; the split count the largest power of two
    at most K / N and TF32_MAX_SPLITS that allows. The plan takes no M, so
    a row's sums do not depend on the rows that share its call."""
    splits, per = qmm.tf32_gemm_plan(K, N)
    k_tiles = -(-K // qmm.TF32_BK)
    assert per % qmm.TF32_BK == 0 and splits * per >= K > (splits - 1) * per
    assert 1 <= splits <= qmm.TF32_MAX_SPLITS and splits & (splits - 1) == 0
    assert splits <= max(1, K // N)
    if splits > 1:
        assert per // qmm.TF32_BK >= qmm.TF32_MIN_SPLIT_TILES
    if 2 * splits <= min(K // N, qmm.TF32_MAX_SPLITS):
        assert k_tiles < 2 * splits * qmm.TF32_MIN_SPLIT_TILES
    expect = {(14336, 4096): 2, (4096, 1024): 4, (4096, 512): 4, (4096, 14336): 1,
              (4096, 4096): 1, (7168, 4096): 1}
    if (K, N) in expect:
        assert splits == expect[(K, N)]


def _tf32_inputs(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=4096).astype(np.float32)
    scale = {"random": 1.0, "tiny": 1e-30, "huge": 1e30, "subnormal": 1e-40}[kind]
    x = (x * np.float32(scale)).astype(np.float32)
    if kind == "random":  # ties of the TF32 rounding, and signed zeros
        x[:4] = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 0.0, -0.0], np.float32)
    return x


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "subnormal"])
def test_tf32_split_is_exact_and_keeps_ten_mantissa_bits(kind):
    """x_hi + x_lo == x bit for bit; x_hi has at most 10 mantissa bits (its
    low 13 are 0) and is x rounded to nearest, ties away from zero: x_lo
    is at most half a TF32 ulp of x."""
    x = _tf32_inputs(kind, seed=len(kind))
    hi, lo = qmm.tf32_split(_t(x))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal((hi + lo).numpy().view(np.int32), x.view(np.int32))
    assert not (hi.numpy().view(np.int32) & 0x1FFF).any()
    # half a TF32 ulp: 2^(e - 11) for x in [2^e, 2^(e+1)); subnormals share 2^-126's
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    assert np.all(np.abs(lo.numpy().astype(np.float64)) <= 2.0 ** (e - 11))
    ties = hi.numpy()[:2] if kind == "random" else None
    if ties is not None:
        np.testing.assert_array_equal(ties, np.array([1 + 2 ** -10, -(1 + 2 ** -10)], np.float32))


@pytest.mark.parametrize("m,k,n", [(48, 768, 3072), (16, 256, 128), (1, 128, 256),
                                   (45, 384, 640), (96, 512, 256)])
def test_two_pass_plain_product_matches_pallas_f32(m, k, n):
    """The float32 route's product in plain PyTorch (x_hi @ wq + tf32(x_lo)
    @ wq, times the scale) against the JAX kernel in interpret mode."""
    x, wq, scale = _operands(m, k, n, seed=m + k + n)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                                       interpret=True))
    got = qmm.quant_matmul_two_pass_reference(_t(x), _t(wq), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _mma_m16n8k8(a_frags, b_frags):
    """One warp's m16n8k8 product from its lanes' fragments, as PTX lays
    them out (g = lane // 4, q = lane % 4): A a0 (g, q), a1 (g+8, q), a2
    (g, q+4), a3 (g+8, q+4); B b0 (q, g), b1 (q+4, g); returns each lane's
    C: c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, q = divmod(lane, 4)
        A[g, q], A[g + 8, q], A[g, q + 4], A[g + 8, q + 4] = a_frags[lane]
        B[q, g], B[q + 4, g] = b_frags[lane]
    D = A @ B
    return [(D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q], D[g + 8, 2 * q + 1])
            for g, q in (divmod(lane, 4) for lane in range(32))]


@pytest.mark.parametrize("M", [1, 4, 8, 16])
def test_tf32_gemv_swapped_fragments_cover_the_product(M):
    """gemv_stream_tf32's fragment map, mirrored from the kernel on one
    warp's 32 columns and one k8 step: the weight is mma's A (bytes 2p and
    2p + 1 of the words of k rows 2q and 2q + 1; odd bytes as 256 q), x's n8
    tile j its B (floats 2q and 2q + 1 of row 8j + g), the k order (0, 2, 4,
    6, 1, 3, 5, 7); gs_unswap's shuffles and gs_row's columns (odd ones
    scaled by 2^-8) then give x @ w."""
    rng = np.random.default_rng(M)
    w = rng.integers(-127, 128, size=(8, 32)).astype(np.float64)  # k rows, columns
    x = np.zeros((16, 8))
    x[:M] = rng.normal(size=(M, 8))
    nt = max(1, -(-M // 8))
    # word j of k row r holds columns 4j .. 4j + 3 (byte c: column 4j + c)
    byte = lambda r, j, c: w[r, 4 * j + c] * (256.0 if c % 2 else 1.0)
    sw = [[None, None] for _ in range(nt)]
    for j in range(nt):
        b = [(x[8 * j + g, 2 * q], x[8 * j + g, 2 * q + 1])
             for g, q in (divmod(lane, 4) for lane in range(32))]
        for p in range(2):
            a = [(byte(2 * q, g, 2 * p), byte(2 * q, g, 2 * p + 1),
                  byte(2 * q + 1, g, 2 * p), byte(2 * q + 1, g, 2 * p + 1))
                 for g, q in (divmod(lane, 4) for lane in range(32))]
            sw[j][p] = _mma_m16n8k8(a, b)
    out = np.full((16, 32), np.nan)
    for lane in range(32):
        g, q = divmod(lane, 4)
        src = 8 * q + g // 2
        for h in range(2):
            j = h  # m = 0: rows 8h + g
            for c in range(4):
                for s in range(2):
                    v = sw[j][c // 2][src + 4 * s][2 * (c % 2) + g % 2] if j < nt else 0.0
                    out[8 * h + g, 8 * q + 4 * s + c] = v / (256.0 if c % 2 else 1.0)
    np.testing.assert_allclose(out[:M], x[:M] @ w, rtol=1e-12, atol=1e-12)
    if nt == 1:
        assert not out[8:].any()


# llama3-8b's projections as the decode step multiplies them: (K, widths of
# the weights one launch takes). The main path groups q/k/v and gate/up and
# calls o, down and lm_head alone; the other rows are the weights alone.
LLAMA3_8B_GEMV = {
    "qkv": (4096, (4096, 1024, 1024)), "o": (4096, (4096,)),
    "gate_up": (4096, (14336, 14336)), "down": (14336, (4096,)),
    "lm_head": (4096, (128256,)), "q": (4096, (4096,)), "k": (4096, (1024,)),
    "gate": (4096, (14336,)),
}
MAIN_PATH_GEMV = ("qkv", "o", "gate_up", "down", "lm_head")
H100_SMS = 132


@pytest.mark.parametrize("M", [1, 16, 48])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B_GEMV))
def test_gemv_plan_covers_every_k_tile_once_and_fills_one_wave(name, M):
    """gemv_stream_tc's plan: every (column tile, k tile) of every weight is
    one block's exactly once; a column tile's units are its splits in order
    (their k ranges ascending and adjacent); the runs differ by at most one
    tile step, in at most one wave; the main path's calls take the shortest
    run one wave allows; weights whose runs of 256-column tiles would be short
    (o_proj) take tiles of 128;
    the workspace slots the split units write are distinct, within the 2 *
    blocks * M * width floats the wrapper holds, and the ones the last block
    reads (gs_epilogue's rule)."""
    K, Ns = LLAMA3_8B_GEMV[name]
    blocks, tiles, work, bn = qmm.gemv_plan(K, Ns, H100_SMS)
    kt = -(-K // qmm.STREAM_BK)
    wide_run = max(-(-sum(-(-n // 256) for n in Ns) * kt // H100_SMS),
                   -(-kt // qmm.STREAM_MAX_SPLITS))
    assert bn == (128 if wide_run <= qmm.STREAM_SHORT_RUN else 256)
    assert bn == (128 if name in ("o", "q", "k") else 256)
    assert tiles == sum(-(-n // bn) for n in Ns) and work == tiles * kt
    assert 1 <= blocks <= H100_SMS
    units = qmm.gemv_units(blocks, kt, work)
    runs = [sum(u[2] - u[1] for u in us) for us in units]
    assert sum(runs) == work and max(runs) - min(runs) <= 1
    best = -(-work // H100_SMS)
    assert max(runs) == max(best, -(-kt // qmm.STREAM_MAX_SPLITS))
    if name in MAIN_PATH_GEMV:
        assert max(runs) == best
    by_tile = {}
    for b, us in enumerate(units):
        for t, k0, k1, split, splits, slot in us:
            by_tile.setdefault(t, []).append((split, k0, k1, splits, slot, b))
    assert sorted(by_tile) == list(range(tiles))
    slots = set()
    for t, pieces in by_tile.items():
        pieces.sort()
        n = len(pieces)
        assert [p[0] for p in pieces] == list(range(n))
        assert all(p[3] == n for p in pieces)
        assert pieces[0][1] == 0 and pieces[-1][2] == kt
        assert all(a[2] == b[1] for a, b in zip(pieces, pieces[1:]))
        assert n <= qmm.STREAM_MAX_SPLITS + 2
        first = pieces[0][5]
        for split, k0, k1, _, slot, b in pieces:
            assert b == first + split
            if n == 1:
                assert slot is None
                continue
            later = split == 0 and b * work // blocks != t * kt
            assert slot == 2 * b + later and slot not in slots
            slots.add(slot)
    assert all(s < 2 * blocks for s in slots)
    floats = 2 * blocks * M * bn
    assert (max(slots, default=-1) + 1) * M * bn <= floats


def _group_operands(k, ns, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for n in ns:
        w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
        wq, scale = jqm.quantize_weight(jnp.asarray(w))
        mats.append((np.asarray(wq), np.asarray(scale)))
    return mats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,ns", [(16, 256, (256, 128, 128)), (1, 128, (384, 384)),
                                    (45, 384, (128,))])
def test_quant_matmul_group_plain_matches_reference_and_pallas(m, k, ns, dtype):
    """The group's plain path (a CPU tensor) is the plain product a weight,
    exactly, and matches the JAX package's quant_matmul (Pallas kernel in
    interpret mode) a weight: 2e-5 in float32, one bf16 ulp in bfloat16."""
    mats = _group_operands(k, ns, seed=m + k)
    x = np.random.default_rng(k).normal(size=(m, k)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    xt = _t(np.asarray(xj, np.float32)).to(getattr(torch, dtype))
    tm = [(_t(wq), _t(scale)) for wq, scale in mats]
    before = (qmm.gemv_launches, qmm.group_launches, qmm.gemm_launches)
    got = qmm.quant_matmul_group(xt, tm)
    assert (qmm.gemv_launches, qmm.group_launches, qmm.gemm_launches) == before
    assert len(got) == len(ns)
    for out, (wq, scale), (jwq, jscale) in zip(got, tm, mats):
        assert out.dtype == xt.dtype and out.shape == (m, wq.shape[1])
        assert torch.equal(out, qmm.quant_matmul_reference(xt, wq, scale))
        want = np.asarray(qmm_jax(xj, jwq, jscale), np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert np.all(np.abs(out.float().numpy() - want) <= ulp)


def qmm_jax(x, wq, scale):
    return jqm.quant_matmul(x, jnp.asarray(wq), jnp.asarray(scale), interpret=True)


def test_quant_matmul_group_checks_inputs():
    mats = [(_t(wq), _t(s)) for wq, s in _group_operands(64, (32, 32, 32, 32), seed=4)]
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="1 to 3"):
        qmm.quant_matmul_group(x, mats)
    with pytest.raises(ValueError, match="1 to 3"):
        qmm.quant_matmul_group(x, [])
    with pytest.raises(ValueError, match="disagree"):
        qmm.quant_matmul_group(x, [mats[0], (mats[1][0][:-1], mats[1][1])])
    with pytest.raises(ValueError, match="dtypes"):
        qmm.quant_matmul_group(x, mats[:2], out_dtype=torch.bfloat16)


def test_int8_model_groups_qkv_and_gate_up(monkeypatch):
    """A forward of the int8 model makes one grouped call for q/k/v and one
    for gate/up a layer, and a single call for o, down and lm_head."""
    tcfg = _int8(tconfigs.get_model_config("tiny-test"))
    model = build_model(tcfg, init_params(tcfg, seed=0, device=torch.device("cpu")),
                        torch.device("cpu"), torch.float32)
    groups, singles = [], []
    inner_group, inner_single = qmm.quant_matmul_group, qmm.quant_matmul

    def group(x, mats, out_dtype=None):
        groups.append(tuple(tuple(wq.shape) for wq, _ in mats))
        return inner_group(x, mats, out_dtype)

    def single(x, wq, scale, out_dtype=None):
        singles.append(tuple(wq.shape))
        return inner_single(x, wq, scale, out_dtype)

    monkeypatch.setattr(qmm, "quant_matmul_group", group)
    monkeypatch.setattr(qmm, "quant_matmul", single)
    model(torch.arange(3, 11)[None], torch.arange(8)[None])
    d, q, kv, ff = tcfg.d_model, tcfg.q_dim, tcfg.kv_dim, tcfg.d_ff
    assert groups == [((d, q), (d, kv), (d, kv)), ((d, ff), (d, ff))] * tcfg.num_layers
    assert singles == [(q, d), (ff, d)] * tcfg.num_layers + [(d, tcfg.vocab_size)]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(float flax tree, int8 flax tree) for ``name`` from the reference."""
    params = jax.device_get(jtr.init_params(get_model_config(name), jax.random.key(0)))
    return params, jax.device_get(jweights.quantize_params(params))


def _japply(jcfg, params, *args, left_padded=False):
    fn = jax.jit(functools.partial(jtr.Transformer(jcfg).apply, left_padded=left_padded))
    return fn({"params": params}, *args)


def test_int8_logits_match_flax_without_cache_and_through_decode():
    jcfg = _int8(get_model_config("tiny-test"))
    tcfg = _int8(tconfigs.get_model_config("tiny-test"))
    _, qparams = _trees("tiny-test")
    tmodel = build_model(tcfg, params_from_jax(qparams, tcfg), torch.device("cpu"),
                         torch.float32)
    assert tmodel.layer_0.attn.q_proj.kernel_q.dtype == torch.int8
    assert isinstance(tmodel.lm_head, ttr.QuantDense)
    rng = np.random.default_rng(0)
    B, S, extra = 3, 20, 3
    tokens = rng.integers(3, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, :4] = valid[2, :11] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)

    jl, _ = _japply(jcfg, qparams, jnp.asarray(tokens), jnp.asarray(positions),
                    jnp.asarray(valid))
    tl, _ = tmodel(_t(tokens).long(), _t(positions), _t(valid))
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL, rtol=0)

    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, qparams, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tcfg, B, S + extra)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL, rtol=0)
    for _ in range(extra):
        tok = rng.integers(3, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
        live = np.ones((B, 1), bool)
        jl, jcache = _japply(jcfg, qparams, jnp.asarray(tok), jcache.lengths[:, None],
                             jnp.asarray(live), jcache)
        tl, tcache = tmodel(_t(tok).long(), tcache.lengths[:, None], _t(live), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny-test", "tiny-gpt2"])
def test_quantize_params_matches_reference_and_round_trips(name):
    """The port's quantize_params over its float state dict equals the
    reference's over the flax tree, leaf for leaf; dequantize_params brings
    back the float layout (biases and, for an untied model, a bare lm_head)."""
    cfg = tconfigs.get_model_config(name)
    params, qparams = _trees(name)
    sd = params_from_jax(params, cfg)
    q = quantize_params(sd)
    want = params_from_jax(qparams, _int8(cfg))
    assert set(q) == set(want)
    for key, t in want.items():
        assert q[key].dtype == t.dtype, key
        if key.endswith("kernel_scale"):
            np.testing.assert_array_max_ulp(q[key].numpy(), t.numpy(), maxulp=1)
        else:
            np.testing.assert_array_equal(q[key].numpy(), t.numpy(), err_msg=key)
    back = dequantize_params(q)
    assert set(back) == set(sd)
    for key, t in sd.items():
        bound = 0 if key.endswith(("bias", "scale", "embedding")) else 1e-6
        if key.endswith("kernel") or key == "lm_head":
            bound = float(t.abs().amax()) / 254 + 1e-7  # half a quantization step
        assert float((back[key] - t).abs().max()) <= bound, key


def test_int8_init_matches_lowmem_tree_and_gives_finite_logits():
    jcfg = _int8(get_model_config("tiny-test"))
    tcfg = _int8(tconfigs.get_model_config("tiny-test"))
    want = params_from_jax(jax.device_get(jtr.init_params_lowmem(jcfg, jax.random.key(0))),
                           tcfg)
    got = init_params(tcfg, seed=0, device=torch.device("cpu"))
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].shape == t.shape and got[key].dtype == t.dtype, key
    q = got["layer_0.mlp.up_proj.kernel_q"].float()
    assert q.abs().max() <= 127 and abs(float(q.std()) - 42.0) < 2.0
    assert torch.all(got["lm_head.kernel_scale"] == 0.02 / 42.0)
    assert torch.all(got["layer_1.attn_norm.scale"] == 1)
    model = build_model(tcfg, got, torch.device("cpu"), torch.float32)
    logits, _ = model(torch.arange(3, 19)[None], torch.arange(16)[None])
    assert logits.shape == (1, 16, tcfg.vocab_size) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

COMMON = "The shared instructions every counterfactual prompt starts with, " * 2
PROMPTS = [COMMON + "Gender: F", COMMON + "Gender: M, Age: 25-34", COMMON + "Age: 56+"]
GREEDY = dict(temperature=0.0, max_tokens=6)


@functools.lru_cache(maxsize=None)
def _engines():
    """(JAX int8 engine, the port's int8 engine, the port's float engine over
    the dequantized tree), all from one int8 flax tree."""
    _, qparams = _trees("tiny-test")
    jeng = JEngine(_int8(get_model_config("tiny-test")), params=qparams, seed=0)
    cfg = tconfigs.get_model_config("tiny-test")
    sd = params_from_jax(qparams, _int8(cfg))
    teng = DecodeEngine(_int8(cfg), params=sd, device="cpu")
    feng = DecodeEngine(cfg, params=dequantize_params(sd), device="cpu")
    return jeng, teng, feng


@pytest.mark.parametrize("share_prefix", [False, True])
def test_int8_engine_greedy_tokens_equal_jax_and_dequantized_engine(share_prefix):
    jeng, teng, feng = _engines()
    want = jeng.generate(PROMPTS, JSettings(**GREEDY), share_prefix=share_prefix)
    got = teng.generate(PROMPTS, ModelSettings(**GREEDY), share_prefix=share_prefix)
    assert got.stats["prefix_len"] == want.stats["prefix_len"]
    assert (got.stats["prefix_len"] > 0) == share_prefix
    assert np.array_equal(got.tokens, want.tokens), (
        f"port {got.tokens.tolist()}\njax  {want.tokens.tolist()}")
    assert got.texts == want.texts and got.stats["logits_finite"]
    flo = feng.generate(PROMPTS, ModelSettings(**GREEDY), share_prefix=share_prefix)
    assert np.array_equal(flo.tokens, got.tokens)
    assert all(p.dtype == torch.int8 for n, p in teng.model.named_parameters()
               if n.endswith("kernel_q"))
