"""The port's greedy prompt-lookup speculation against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
verify-window kernel runs in interpret mode on the CPU, as its own tests run
it; the port's wrapper takes its plain version for CPU tensors. Tolerances:

- drafting and acceptance: equal integers;
- the plain verify-window attention against the Pallas kernel: 1e-5
  (float32; sums of a few hundred unit-scale products in another order);
- model logits through a verify window: 1e-4 (float32, as the other model
  parity tests);
- tokens: equal. Speculative greedy equals plain greedy by construction, in
  the port and in the reference, and the port's equals the reference's.
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
from fairness_llm_tpu.config import SpeculationConfig as JSpec  # noqa: E402
from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from fairness_llm_tpu.ops.decode_attention import decode_attention as jax_decode  # noqa: E402
from fairness_llm_tpu.runtime import sampling as jsampling  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu.runtime.speculative import ngram_draft as jax_draft  # noqa: E402
from fairness_llm_tpu.utils.profiling import SpeculationStats as JStats  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings, SpeculationConfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from fairness_llm_tpu_torch.ops import _build  # noqa: E402
from fairness_llm_tpu_torch.ops import decode_attention as dec_mod  # noqa: E402
from fairness_llm_tpu_torch.ops import flash_attention as flash_mod  # noqa: E402
from fairness_llm_tpu_torch.pipeline.backends import EngineBackend  # noqa: E402
from fairness_llm_tpu_torch.runtime import sampling as tsampling  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.speculative import ngram_draft  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import build_model, params_from_jax  # noqa: E402
from fairness_llm_tpu_torch.utils.profiling import SpeculationStats  # noqa: E402

NAME = "tiny-test"
SPEC = SpeculationConfig(enabled=True, ngram_max=3, draft_len=4)
JSPEC = JSpec(enabled=True, ngram_max=3, draft_len=4)
COMMON = "The shared instructions every counterfactual prompt starts with, " * 2
PROMPTS = [COMMON + "Gender: F", COMMON + "Gender: M, Age: 25-34",
           COMMON + "Age: 56+ list list list list"]
GREEDY = dict(temperature=0.0, max_tokens=16)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Drafting and acceptance
# ---------------------------------------------------------------------------


def _both_drafts(ctx, valid, hist_end, k, n, pad):
    want = np.asarray(jax_draft(jnp.asarray(ctx, jnp.int32), jnp.asarray(valid, bool),
                                jnp.asarray(hist_end, jnp.int32), k, n, pad))
    got = ngram_draft(_t(ctx).long(), _t(valid), _t(hist_end), k, n, pad).numpy()
    return got, want


@pytest.mark.parametrize("ngram_max", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_matches_jax_on_random_contexts(seed, ngram_max):
    """A small vocabulary makes matches common; pad gaps sit anywhere, and
    history ends at a random point of each row."""
    rng = np.random.default_rng(seed)
    B, C, k = 8, 48, 5
    ctx = rng.integers(3, 8, size=(B, C))
    valid = rng.random((B, C)) < 0.85
    ctx[~valid] = 0
    hist_end = rng.integers(0, C + 1, size=B)
    got, want = _both_drafts(ctx, valid, hist_end, k, ngram_max, 0)
    np.testing.assert_array_equal(got, want)
    assert np.any(got != 0)  # some rows found a match


# The n-gram cases of tests/test_speculative.py: (ctx, valid, hist_end, expected).
_CASES = {
    "repetitive_history": ([[5, 6, 7, 5, 6, 7, 5, 6, 0, 0, 0, 0]], None, [8], [[7, 5, 6, 0]]),
    "prefers_longest_ngram": ([[9, 2, 3, 4, 3, 8, 9, 2, 3, 0, 0, 0]], None, [9], [[4, 3, 8, 9]]),
    "no_match_gives_pads": ([[1, 2, 3, 4, 5, 6, 7, 8]], "all", [8], [[0, 0, 0, 0]]),
    "window_valid_and_pads_at_gaps": ([[5, 6, 7, 9, 9, 5, 6, 7, 8, 5, 6, 7]], "gap0", [12],
                                      [[8, 5, 6, 7]]),
    "truncates_at_history_end": ([[1, 2, 3, 1, 2, 3, 0, 0, 0, 0]], None, [6], [[1, 2, 3, 0]]),
    "per_row_independent": ([[5, 6, 7, 5, 6, 7, 5, 6, 0, 0, 0, 0],
                             [1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 0, 0]], None, [8, 8],
                            [[7, 5, 6, 0], [0, 0, 0, 0]]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ngram_draft_reference_cases(case):
    ctx, vmode, hist_end, expected = _CASES[case]
    ctx = np.array(ctx)
    if vmode is None:
        valid = ctx != 0
    else:
        valid = np.ones_like(ctx, bool)
        if vmode == "gap0":
            valid[0, 0] = False
    got, want = _both_drafts(ctx, valid, hist_end, 4, 3, 0)
    np.testing.assert_array_equal(want, expected)
    np.testing.assert_array_equal(got, want)


def test_ngram_draft_refuses_empty_windows():
    ctx, valid, end = torch.ones(1, 4, dtype=torch.long), torch.ones(1, 4, dtype=torch.bool), \
        torch.tensor([4])
    with pytest.raises(ValueError, match="draft_len"):
        ngram_draft(ctx, valid, end, 0, 3, 0)
    with pytest.raises(ValueError, match="ngram_max"):
        ngram_draft(ctx, valid, end, 4, 0, 0)


def test_greedy_accept_length_matches_jax():
    rng = np.random.default_rng(3)
    drafts = rng.integers(0, 3, size=(64, 6))
    greedy = np.where(rng.random((64, 6)) < 0.7, drafts, rng.integers(0, 3, size=(64, 6)))
    fixed_d = np.array([[4, 5, 6], [4, 9, 6], [9, 5, 6], [4, 5, 6]])
    fixed_g = np.array([[4, 5, 6], [4, 5, 6], [4, 5, 6], [4, 5, 9]])
    for d, g in ((drafts, greedy), (fixed_d, fixed_g)):
        want = np.asarray(jsampling.greedy_accept_length(jnp.asarray(d), jnp.asarray(g)))
        got = tsampling.greedy_accept_length(_t(d), _t(g)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsampling.greedy_accept_length(_t(fixed_d), _t(fixed_g)).numpy(), [3, 1, 0, 2])


def test_speculation_stats_equal_reference():
    a = dict(drafted=40, accepted=13, verify_steps=9, emitted=30, draft_len=4, ngram_max=3)
    b = dict(drafted=12, accepted=2, verify_steps=3, emitted=9, draft_len=4, ngram_max=3)
    got = SpeculationStats(**a).merge(SpeculationStats(**b))
    want = JStats(**a).merge(JStats(**b))
    assert got.as_dict() == want.as_dict()
    assert SpeculationStats.from_dict(got.as_dict()) == got
    assert SpeculationStats().as_dict() == JStats().as_dict()


# ---------------------------------------------------------------------------
# The verify-window attention (K3) and the model's verify forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared_p", [None, 96])
@pytest.mark.parametrize("hkv", [1, 2])
def test_multi_query_reference_matches_pallas(hkv, shared_p):
    """As tests/test_decode_attention.py builds its inputs: slots up to each
    row's window valid, with holes below it."""
    rng = np.random.default_rng(3)
    B, Q, H, D, L = 8, 4, 4, 64, 256
    q = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    offs = rng.integers(1, L - Q, size=B).astype(np.int32)
    valid = np.arange(L)[None, :] <= (offs[:, None] + Q - 1)
    valid &= rng.random((B, L)) < 0.9
    valid[:, 0] = True
    shared = None
    if shared_p:
        shared = (rng.normal(size=(shared_p, hkv, D)).astype(np.float32),
                  rng.normal(size=(shared_p, hkv, D)).astype(np.float32))
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        None if shared is None else tuple(jnp.asarray(a) for a in shared),
        q_offsets=jnp.asarray(offs), interpret=True))
    got = dec_mod.decode_attention_reference(
        _t(q), _t(k), _t(v), _t(valid), None if shared is None else tuple(map(_t, shared)),
        q_offsets=_t(offs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# The card's verify-window kernel takes rep * Q query rows per kv head as its
# M side, 16 to a warp: 9, 16, 36 (llama3-8b), 63 and 64 rows, one to four
# warps. The plain version it is held to must match the Pallas kernel there,
# with every window at slot 0 and every window at the cache's end.
EDGE_ROWS = [(1, 9), (8, 2), (4, 9), (7, 9), (4, 16)]
EDGE_IDS = ["rows9", "rows16", "rows36", "rows63", "rows64"]


@pytest.mark.parametrize("at", ["offset0", "offset_end"])
@pytest.mark.parametrize("rep,Q", EDGE_ROWS, ids=EDGE_IDS)
def test_multi_query_reference_matches_pallas_at_row_and_offset_edges(rep, Q, at):
    rng = np.random.default_rng(13)
    B, hkv, D, L, P = 8, 1, 64, 128, 96
    q = rng.normal(size=(B, Q, rep * hkv, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    offs = np.full(B, 0 if at == "offset0" else L - Q, np.int32)
    valid = (np.arange(L)[None, :] <= (offs[:, None] + Q - 1)) & (rng.random((B, L)) < 0.9)
    valid[:, offs[0]] = True
    shared = (rng.normal(size=(P, hkv, D)).astype(np.float32),
              rng.normal(size=(P, hkv, D)).astype(np.float32))
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in shared), q_offsets=jnp.asarray(offs), interpret=True))
    got = dec_mod.decode_attention_reference(
        _t(q), _t(k), _t(v), _t(valid), tuple(map(_t, shared)), q_offsets=_t(offs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_verify_split_plan():
    """The card kernel's key-split plan: runs of whole tiles of one kind,
    within the kernel's bounds, as many splits as one wave of resident
    blocks holds, and one split of each kind where none fits."""
    sms = 132
    wave = dec_mod.SPLIT_BLOCKS_PER_SM * sms
    for B, Hkv, rows, P, L in [(16, 8, 36, 704, 168), (16, 8, 36, 0, 960), (1, 8, 36, 704, 0),
                               (64, 8, 36, 704, 168), (2, 2, 512, 96, 60), (3, 1, 9, 40, 100),
                               (1, 1, 9, 0, 10)]:
        ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
        sp, sc = dec_mod.verify_splits(B, Hkv, rows, P, L, sms)
        assert (ntp > 0) <= sp <= ntp and (ntc > 0) <= sc <= ntc
        per_split = B * Hkv * -(-rows // 64)
        assert (sp + sc) * per_split <= wave or (sp, sc) == (int(ntp > 0), int(ntc > 0))
        # No plan of whole runs with more splits fits the wave.
        for run in range(1, max(ntp, ntc) + 1):
            more = -(-ntp // run) + -(-ntc // run)
            assert more <= sp + sc or more * per_split > wave
    # llama3-8b's verify window at batch 16: 128 blocks a split, 528 a wave.
    assert dec_mod.verify_splits(16, 8, 36, 704, 168, sms) == (3, 1)
    # A grid that overflows the card alone takes one split of each kind.
    assert dec_mod.verify_splits(64, 8, 36, 704, 168, sms) == (1, 1)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_decode_split_plan(D):
    """The one-query kernel's plan: a prefix split costs Hkv * ceil(B * rep
    / 64) blocks, shared by the batch; a cache split B * Hkv. Runs of whole
    tiles, within the kernel's bounds, as many splits as one wave holds."""
    sms = 132
    wave = dec_mod.DECODE_BLOCKS_PER_SM[D] * sms
    for B, Hkv, rep, P, L in [(16, 8, 4, 704, 160), (16, 8, 4, 0, 960), (48, 8, 4, 704, 160),
                              (48, 8, 4, 0, 960), (1, 8, 4, 704, 0), (3, 2, 32, 96, 150),
                              (64, 8, 4, 704, 960), (1, 1, 1, 0, 10)]:
        ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
        sp, sc = dec_mod.decode_splits(B, Hkv, rep, P, L, D, sms)
        assert (ntp > 0) <= sp <= ntp and (ntc > 0) <= sc <= ntc
        pre, cache = Hkv * -(-B * rep // 64), B * Hkv
        fits = sp * pre + sc * cache <= wave
        assert fits or (sp, sc) == (int(ntp > 0), int(ntc > 0))
        for run in range(1, max(ntp, ntc) + 1):
            more = (-(-ntp // run), -(-ntc // run))
            assert sum(more) <= sp + sc or more[0] * pre + more[1] * cache > wave
    if D == 128:
        # llama3-8b at batch 16: 8 blocks a prefix split (64 query rows a kv
        # head), 128 a cache split, 528 a wave; each prefix tile is read by 8
        # blocks, not 128.
        assert dec_mod.decode_splits(16, 8, 4, 704, 160, D, sms) == (11, 3)  # 472 blocks
        assert dec_mod.decode_splits(16, 8, 4, 0, 960, D, sms) == (0, 4)  # 512
        # The study's batch of 48: 24 blocks a prefix split, 384 a cache split.
        assert dec_mod.decode_splits(48, 8, 4, 704, 160, D, sms) == (5, 1)  # 504
        assert dec_mod.decode_splits(48, 8, 4, 0, 960, D, sms) == (0, 1)  # 384


def _runs(n: int, splits: int) -> list:
    """The runs of whole tiles [t0, t1) the split kernels give ``splits``
    splits over n tiles (per = ceil(n / splits); split i from i * per)."""
    per = -(-n // splits) if splits else 0
    return [(i * per, min(i * per + per, n)) for i in range(splits)]


def _covered_once(n: int, splits: int) -> bool:
    tiles = [t for t0, t1 in _runs(n, splits) for t in range(t0, t1)]
    return sorted(tiles) == list(range(n))


@pytest.mark.parametrize("D", dec_mod.F32_WIDTHS)
def test_decode_split_f32_plan(D):
    """decode_split_f32's plan (float32, one query per row, a warp a
    block): every tile covered exactly once by runs of whole tiles of one
    kind, no split left without a tile, within the kernel's bounds, as many
    splits as one wave holds, and one split of each kind where none fits."""
    sms = 132
    rows = dec_mod.F32_PREFIX_ROWS
    per_sm = min(dec_mod.F32_DECODE_BLOCKS_PER_SM,
                 _build.SMEM_PER_SM // (dec_mod.f32_decode_smem(D) + 1024))
    wave = per_sm * sms
    for B, Hkv, rep, P, L in [(16, 2, 2, 128, 160), (16, 4, 1, 128, 160), (8, 2, 2, 0, 768),
                              (8, 4, 1, 0, 768), (16, 8, 4, 704, 160), (16, 8, 4, 0, 960),
                              (1, 8, 4, 704, 0), (3, 2, 32, 96, 150), (64, 8, 4, 704, 960),
                              (512, 8, 4, 4096, 4096), (1, 1, 1, 0, 10)]:
        ntp, ntc = -(-P // dec_mod.TILE_KEYS), -(-L // dec_mod.TILE_KEYS)
        sp, sc = dec_mod.decode_splits_f32(B, Hkv, rep, P, L, D, sms)
        dec_mod.check_splits(sp, sc, P, L)  # the wrapper's own check passes its plan
        assert _covered_once(ntp, sp) and _covered_once(ntc, sc)
        assert all(t1 > t0 for t0, t1 in _runs(ntp, sp) + _runs(ntc, sc))
        pre, cache = Hkv * -(-B * rep // rows), B * Hkv * -(-rep // rows)
        fits = sp * pre + sc * cache <= wave
        assert fits or (sp, sc) == (int(ntp > 0), int(ntc > 0))
        for run in range(1, max(ntp, ntc) + 1):
            more = (-(-ntp // run), -(-ntc // run))
            assert sum(more) <= sp + sc or more[0] * pre + more[1] * cache > wave
    if D == 32:
        # The study checkpoints (head width 32, f32): 8 one-warp blocks an
        # SM, 1,056 a wave. The phase-1 sweep's step, q [16, 4, 32] over a
        # 128-slot prefix and a 160-slot cache: every tile its own split
        # (4 prefix splits of 8 blocks, 8 rows of a kv head each; 5 cache
        # splits of 32 or 64 blocks): 192 and 352 blocks.
        assert wave == 1056
        assert dec_mod.decode_splits_f32(16, 2, 2, 128, 160, D, sms) == (4, 5)  # tiny-llama
        assert dec_mod.decode_splits_f32(16, 4, 1, 128, 160, D, sms) == (4, 5)  # tiny-gpt2
        # The served study pool, q [8, 4, 32] over 768 slots, no prefix: 24
        # cache splits of 16 or 32 blocks (384 and 768).
        assert dec_mod.decode_splits_f32(8, 2, 2, 0, 768, D, sms) == (0, 24)
        assert dec_mod.decode_splits_f32(8, 4, 1, 0, 768, D, sms) == (0, 24)
    if D == 128:
        # llama3-8b's float32 gates at batch 16: three blocks an SM (72 KB
        # each), 396 a wave; 64 blocks a prefix split, 128 a cache split.
        assert wave == 396
        assert dec_mod.decode_splits_f32(16, 8, 4, 704, 160, D, sms) == (4, 1)  # 384
        assert dec_mod.decode_splits_f32(16, 8, 4, 0, 960, D, sms) == (0, 3)  # 384


@pytest.mark.parametrize("sp,sc,P,L", [(4, 1, 96, 150), (0, 5, 96, 150), (1, 0, 96, 150),
                                       (1, 6, 96, 150), (1, 1, 0, 150), (0, 0, 0, 150),
                                       (-1, 5, 0, 150)])
def test_split_plan_refused(sp, sc, P, L):
    """No fallback: the wrapper refuses a plan the split kernels cannot
    take (more splits than tiles, a missing or extra kind, none at all)."""
    with pytest.raises(RuntimeError, match="decode_attention: the plan"):
        dec_mod.check_splits(sp, sc, P, L)


@pytest.mark.parametrize("D", flash_mod.F32_WIDTHS)
def test_flash_f32_rows_plan(D):
    """flash_fwd's plan: query tiles of 16, 32 or 64 rows cover every row
    exactly once, the 64 / rows key groups of a block walk every key tile
    of its causal band exactly once, a block's shared memory fits, and the
    plan has the fewest waves times (steps + a block's own cost), a tie
    going to more rows."""
    sms = 132
    for B, H, S in [(1, 4, 128), (184, 4, 128), (24, 4, 128), (8, 4, 640), (32, 4, 128),
                    (8, 4, 256), (1, 4, 320), (16, 32, 896), (3, 8, 77), (1, 1, 1)]:
        rows = flash_mod.flash_f32_rows(B, H, S, D, sms)
        flash_mod.check_rows(rows, D)  # the wrapper's own check passes its plan
        qtiles = [(q0, min(q0 + rows, S)) for q0 in range(0, S, rows)]
        assert sorted(i for a, b in qtiles for i in range(a, b)) == list(range(S))
        kg = 64 // rows
        for q0, q1 in qtiles:
            ntiles = -(-q1 // 32)  # causal, no padding: tiles 0 .. (q1 - 1) // 32
            walked = [s * kg + g for s in range(-(-ntiles // kg)) for g in range(kg)
                      if s * kg + g < ntiles]
            assert walked == list(range(ntiles))
        costs = {}
        for r in flash_mod.F32_ROWS:
            smem = flash_mod.flash_f32_smem(r, D)
            if smem <= _build.SMEM_PER_BLOCK:
                wave = sms * min(flash_mod.F32_BLOCKS_PER_SM,
                                 _build.SMEM_PER_SM // (smem + 1024))
                steps = -(-(-(-S // 32)) // (64 // r)) + flash_mod.F32_BLOCK_STEPS
                costs[r] = -(-B * H * -(-S // r) // wave) * steps
        assert rows in costs and costs[rows] == min(costs.values())
        assert all(costs[r] > costs[rows] for r in costs if r > rows)
    if D == 32:
        # The study checkpoints' float32 prefills, 2 blocks an SM (264 a
        # wave): the sweep's prefix, one row of 128 over 4 heads, in 32
        # blocks of 16 rows (64-row tiles made 8) whose 4 key groups share
        # its 4 tiles; phase 2's listwise query [8, 4, 640] in blocks of 16
        # rows too, whose key groups walk its 20 tiles in 5 steps; phase
        # 3's scoring [184, 4, 128] in 1,472 blocks of 64 rows; the served
        # prefill [8, 4, 256] in 32-row blocks.
        assert flash_mod.flash_f32_rows(1, 4, 128, D, sms) == 16
        assert flash_mod.flash_f32_rows(8, 4, 640, D, sms) == 16
        assert flash_mod.flash_f32_rows(184, 4, 128, D, sms) == 64
        assert flash_mod.flash_f32_rows(8, 4, 256, D, sms) == 32
    if D == 256:
        # At D = 256 only 64-row blocks (133 KB) fit: 16 rows take 532 KB,
        # 32 rows 266 KB.
        assert flash_mod.flash_f32_rows(1, 4, 128, D, sms) == 64


@pytest.mark.parametrize("rows,D", [(8, 32), (48, 32), (128, 32), (16, 256), (0, 64)])
def test_flash_f32_rows_refused(rows, D):
    """No fallback: a row count the float32 kernel does not take, or whose
    block does not fit in shared memory, is refused."""
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_mod.check_rows(rows, D)


# The float32 verify window's plan (verify_split_f32): the gate's and the
# study's shapes, then edges: no prefix, a cache shorter than one tile, no
# cache, and rep * Q of 9, 18 and 36 rows a (batch row, kv head).
VERIFY_F32_SHAPES = [(16, 8, 36, 704, 168), (16, 2, 18, 128, 168), (16, 4, 9, 128, 168),
                     (16, 2, 18, 160, 200), (16, 8, 36, 0, 960), (4, 2, 9, 96, 20),
                     (4, 8, 36, 704, 0), (1, 1, 18, 0, 10), (48, 8, 36, 704, 168),
                     (2, 2, 36, 40, 100)]


def _verify_f32_cost(B, Hkv, rows, P, L, D, sms, rb, sp, sc):
    """verify_splits_f32's documented cost of one plan, written out again."""
    ntp, ntc = -(-P // 32), -(-L // 32)
    run = max(-(-ntp // sp) if sp else 0, -(-ntc // sc) if sc else 0)
    pre, cache = Hkv * -(-B * rows // rb), B * Hkv * -(-rows // rb)
    k = min(dec_mod.VERIFY_F32_BLOCKS_PER_SM[rb],
            _build.SMEM_PER_SM // (dec_mod.verify_f32_smem(rb, D) + 1024))
    work = pre * ntp + cache * ntc
    cost = (-(-work // sms) * (64 * rb * D // dec_mod.VERIFY_F32_FMAS_PER_CLOCK)
            + max(-(-work // (k * sms)), run) * dec_mod.VERIFY_F32_TILE_CLOCKS)
    if sp + sc > 1:
        split = 2 * (B * Hkv * rows * (D + 2) * 8) // dec_mod.HBM_BYTES_PER_CLOCK
        cost += (sp + sc) * split + dec_mod.VERIFY_F32_COMBINE_CLOCKS
    return cost


@pytest.mark.parametrize("D", dec_mod.F32_WIDTHS)
def test_verify_split_f32_plan(D):
    """verify_split_f32's plan: a row count the kernel takes at D, every
    tile covered exactly once by runs of whole tiles of one kind, no split
    left without a tile, within the kernel's bounds, and the cheapest plan
    of whole runs under the cost formula; at the study's shapes it fits one
    wave of resident blocks."""
    sms = 132
    for B, Hkv, rows, P, L in VERIFY_F32_SHAPES:
        rb, sp, sc = dec_mod.verify_splits_f32(B, Hkv, rows, P, L, D, sms)
        dec_mod.check_verify_rows(rb, D)  # the wrapper's own checks pass its plan
        dec_mod.check_splits(sp, sc, P, L)
        ntp, ntc = -(-P // 32), -(-L // 32)
        assert _covered_once(ntp, sp) and _covered_once(ntc, sc)
        assert all(t1 > t0 for t0, t1 in _runs(ntp, sp) + _runs(ntc, sc))
        cost = _verify_f32_cost(B, Hkv, rows, P, L, D, sms, rb, sp, sc)
        for other in dec_mod.VERIFY_F32_ROWS:
            if other * D > 8192:
                continue
            for run in range(1, max(ntp, ntc) + 1):
                plan = (other, -(-ntp // run), -(-ntc // run))
                assert cost <= _verify_f32_cost(B, Hkv, rows, P, L, D, sms, *plan), plan
    if D == 128:
        # llama3-8b's verify window at batch 16 (phase 13's float32 gates):
        # 64 rows a block, 144 prefix blocks of 11 tiles and 128 cache
        # blocks, two waves of two 112 KB blocks an SM; the card ran it in
        # 0.109 ms against 0.159 for the one-wave plan (64, 1, 1).
        assert dec_mod.verify_splits_f32(16, 8, 36, 704, 168, D, sms) == (64, 2, 1)
    if D == 32:
        # The study's speculative sweep (tiny-llama-study, tiny-gpt2-study):
        # every tile a split of its own, blocks of 16 rows, one wave.
        assert dec_mod.verify_splits_f32(16, 2, 18, 128, 168, D, sms) == (16, 4, 6)
        assert dec_mod.verify_splits_f32(16, 4, 9, 128, 168, D, sms) == (16, 4, 6)
        for B, Hkv, rows, P, L in VERIFY_F32_SHAPES[1:4]:
            rb, sp, sc = dec_mod.verify_splits_f32(B, Hkv, rows, P, L, D, sms)
            per_sm = min(4, _build.SMEM_PER_SM // (dec_mod.verify_f32_smem(rb, D) + 1024))
            blocks = sp * Hkv * -(-B * rows // rb) + sc * B * Hkv * -(-rows // rb)
            assert blocks <= per_sm * sms, (B, Hkv, rows, P, L)


@pytest.mark.parametrize("rows,D", [(48, 32), (0, 128), (8, 64), (128, 32), (64, 256)])
def test_verify_f32_rows_refused(rows, D):
    """No fallback: a row count verify_split_f32 does not take at D (at D =
    256 a block of 64 rows would hold 128 accumulators a thread) is refused."""
    with pytest.raises(RuntimeError, match="decode_attention: a verify block"):
        dec_mod.check_verify_rows(rows, D)


@pytest.mark.parametrize("shared_p", [None, 96])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("rep", [1, 2, 4], ids=["rows9", "rows18", "rows36"])
def test_multi_query_reference_matches_pallas_at_the_split_kernels_edges(rep, int8, shared_p):
    """The plain verify window the card's verify_split_f32 is held to,
    against the Pallas kernel (``_kernel_multi``, interpret mode) at the
    cases the split kernel treats apart: row 0's window at slot 0 with slot
    0 not valid (its first query's limit sees no cache key), row 1's at
    L - Q, row 2 with a whole 32-key tile of no valid slot and row 3 with
    no valid slot at all, over a float and an int8 cache, with and without
    a prefix."""
    rng = np.random.default_rng(40 + rep)
    B, Q, hkv, D, L = 8, 9, 2, 64, 128
    q = rng.normal(size=(B, Q, rep * hkv, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    offs = rng.integers(1, L - Q, size=B).astype(np.int32)
    offs[0], offs[1] = 0, L - Q
    valid = (np.arange(L)[None, :] <= (offs[:, None] + Q - 1)) & (rng.random((B, L)) < 0.9)
    valid[0, 0] = False
    valid[1, L - Q] = True
    valid[2, 32:64] = False
    offs[2] = max(offs[2], 70)
    valid[3] = False
    shared = None
    if shared_p:
        shared = (rng.normal(size=(shared_p, hkv, D)).astype(np.float32),
                  rng.normal(size=(shared_p, hkv, D)).astype(np.float32))
    scales = {}
    if int8:
        (kq, ks), (vq, vs) = ttr._quantize_kv(_t(k)), ttr._quantize_kv(_t(v))
        k, v = kq.numpy(), vq.numpy()
        scales = {"k_scale": ks.numpy(), "v_scale": vs.numpy()}
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        None if shared is None else tuple(jnp.asarray(a) for a in shared),
        q_offsets=jnp.asarray(offs), interpret=True,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    got = dec_mod.decode_attention_reference(
        _t(q), _t(k), _t(v), _t(valid), None if shared is None else tuple(map(_t, shared)),
        q_offsets=_t(offs), **{n: _t(a) for n, a in scales.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if shared is None:
        assert not got[3].any() and not got[0, 0].any()  # no key at all: exactly 0


@functools.lru_cache(maxsize=None)
def _flax_params():
    return jax.device_get(jtr.init_params(get_model_config(NAME), jax.random.key(0)))


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_verify_window_logits_match_flax(decode_kernel):
    """A left-padded prefill, then two verify windows at per-row
    ``write_offsets`` (rows advanced by different counts), with the rejected
    slots of the first window marked invalid between them, as the
    speculative loop does."""
    jcfg = get_model_config(NAME)
    tcfg = dataclasses.replace(tconfigs.get_model_config(NAME),
                               use_decode_attention_kernel=decode_kernel)
    params = _flax_params()
    tmodel = build_model(tcfg, params_from_jax(params, tcfg), torch.device("cpu"),
                         torch.float32)
    japply = jax.jit(jtr.Transformer(jcfg).apply, static_argnames=("left_padded",))
    rng = np.random.default_rng(5)
    B, S, W, cache_len = 3, 12, 4, 24
    tokens = rng.integers(3, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, :3] = valid[2, :7] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    jcache = jtr.init_cache(jcfg, B, cache_len)
    _, jcache = japply({"params": params}, jnp.asarray(tokens), jnp.asarray(positions),
                       jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tcfg, B, cache_len)
    tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True)

    out_len = np.zeros(B, np.int64)
    for emitted in ([1, 3, 2], [2, 1, 4]):
        win = rng.integers(3, tcfg.vocab_size, size=(B, W)).astype(np.int32)
        off = (S + out_len).astype(np.int32)
        pos = (np.asarray(jcache.lengths)[:, None] + np.arange(W)[None, :]).astype(np.int32)
        live = np.ones((B, W), bool)
        jl, jcache = japply({"params": params}, jnp.asarray(win), jnp.asarray(pos),
                            jnp.asarray(live), jcache, write_offsets=jnp.asarray(off))
        tl, tcache = tmodel(_t(win).long(), _t(pos).long(), _t(live), tcache,
                            write_offsets=_t(off))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        e = np.asarray(emitted)
        slot = np.arange(cache_len)[None, :] - off[:, None]
        reject = (slot >= 0) & (slot < W) & (slot >= e[:, None])
        jcache = jcache.replace(key_valid=jcache.key_valid & ~jnp.asarray(reject),
                                lengths=jcache.lengths - W + jnp.asarray(e, jnp.int32))
        tcache.key_valid &= ~_t(reject)
        tcache.lengths = tcache.lengths - W + _t(e)
        out_len += e
    np.testing.assert_array_equal(tcache.key_valid.numpy(), np.asarray(jcache.key_valid))


def test_write_offsets_past_the_cache_raise():
    """Per-row offsets are checked on the host by the loops that hold them
    (``check_write_offsets``), not read back by the forward: the check
    refuses a window past the cache, and the speculative loop, handed a
    cache too short for its first verify window, raises before any write."""
    from fairness_llm_tpu_torch.runtime.stepbuilder import build_spec_decode

    tcfg = tconfigs.get_model_config(NAME)
    model = build_model(tcfg, params_from_jax(_flax_params(), tcfg), torch.device("cpu"),
                        torch.float32)
    with pytest.raises(ValueError, match="max_len"):
        ttr.check_write_offsets(np.array([2, 7]), 4, 10)
    with pytest.raises(ValueError, match="max_len"):
        ttr.check_write_offsets(np.array([-1, 2]), 4, 10)
    ttr.check_write_offsets(np.array([2, 6]), 4, 10)  # fits
    cache = ttr.init_cache(tcfg, 2, 10)
    tok = torch.ones(2, 4, dtype=torch.long)
    pos = torch.arange(4)[None].expand(2, -1)
    model(tok, pos, cache=cache, write_offsets=torch.tensor([2, 6]))  # fits

    entry, loop = build_spec_decode(tcfg, model, 0, 1, batch=2, prompt_len=4, max_new=4,
                                    prefix_len=0, ngram_max=2, draft_len=2)
    valid = torch.ones(2, 4, dtype=torch.bool)
    last, _ = entry(tok, valid, None)
    short = ttr.init_cache(tcfg, 2, 6)  # the first window needs slots 4..6
    with pytest.raises(ValueError, match="max_len 6"):
        loop(short, last, tok, valid, np.ones(2, bool), None, torch.zeros(0, dtype=torch.long))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines():
    jeng = JEngine(get_model_config(NAME), params=_flax_params(), seed=0)
    cfg = dataclasses.replace(tconfigs.get_model_config(NAME), use_decode_attention_kernel=True)
    teng = DecodeEngine(cfg, params=params_from_jax(_flax_params(), cfg), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("mode", ["off", "detected", "explicit"])
def test_spec_greedy_equals_plain_and_jax(mode):
    jeng, teng = _engines()
    kw = {"off": dict(share_prefix=False), "detected": dict(share_prefix=True),
          "explicit": dict(prefix_ids=teng.tokenizer.encode(COMMON)[:64])}[mode]
    want = jeng.generate(PROMPTS, JSettings(**GREEDY), speculation=JSPEC, **kw)
    plain = teng.generate(PROMPTS, ModelSettings(**GREEDY), **kw)
    got = teng.generate(PROMPTS, ModelSettings(**GREEDY), speculation=SPEC, **kw)
    assert (got.stats["prefix_len"] > 0) == (mode != "off")
    assert got.stats["prefix_len"] == want.stats["prefix_len"]
    np.testing.assert_array_equal(plain.tokens, got.tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.texts == want.texts and got.stats["logits_finite"]
    assert got.stats["speculation"] == want.stats["speculation"]
    assert got.stats["cache_slots"] == want.stats["cache_slots"] == plain.stats[
        "cache_slots"] + SPEC.draft_len
    assert got.stats["decode_steps"] == got.stats["speculation"]["verify_steps"]
    assert "speculation" not in plain.stats


@pytest.mark.parametrize("n", [1, 3, 8])
def test_spec_greedy_equals_plain_across_batch_sizes(n):
    _, teng = _engines()
    prompts = ["the quick brown fox", "hi", "abc abc abc abc abc abc",
               "a much longer prompt that shifts padding around quite a bit",
               "movies", "fairness", "one two three one two three", "zz"][:n]
    plain = teng.generate(prompts, ModelSettings(**GREEDY))
    spec = teng.generate(prompts, ModelSettings(**GREEDY), speculation=SPEC)
    np.testing.assert_array_equal(plain.tokens, spec.tokens)
    st = spec.stats["speculation"]
    assert st["emitted"] == int(np.sum(spec.tokens != teng.tokenizer.pad_id))
    assert st["verify_steps"] <= GREEDY["max_tokens"]


def test_spec_stops_at_early_eos_as_plain_and_jax():
    """A random model rarely samples EOS, so the EOS id is taken from the
    plain greedy stream: one row then stops mid-window."""
    jeng, teng = _engines()
    prompts = ["the quick brown fox", "hi there", "abc"]
    eos = int(teng.generate(prompts, ModelSettings(**GREEDY)).tokens[0][5])
    jtok, ttok = JByteTokenizer(512), ByteTokenizer(512)
    jtok.eos_id = ttok.eos_id = eos
    jeng2 = JEngine(get_model_config(NAME), params=jeng.params, tokenizer=jtok)
    teng2 = DecodeEngine(teng.config, params=teng.model.state_dict(), tokenizer=ttok,
                         device="cpu")
    plain = teng2.generate(prompts, ModelSettings(**GREEDY))
    spec = teng2.generate(prompts, ModelSettings(**GREEDY), speculation=SPEC)
    want = jeng2.generate(prompts, JSettings(**GREEDY), speculation=JSPEC)
    np.testing.assert_array_equal(plain.tokens, spec.tokens)
    np.testing.assert_array_equal(spec.tokens, want.tokens)
    row = list(spec.tokens[0])
    assert eos in row and row.index(eos) < len(row) - 1
    assert all(t == ttok.pad_id for t in row[row.index(eos) + 1:])


def test_spec_temperature_takes_the_plain_path():
    _, teng = _engines()
    s = ModelSettings(temperature=0.7, max_tokens=8)
    a = teng.generate(["hello there"], s, row_seeds=[123])
    b = teng.generate(["hello there"], s, row_seeds=[123], speculation=SPEC)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert "speculation" not in b.stats
    assert b.stats["cache_slots"] == a.stats["cache_slots"]
    one = teng.generate(["hello there"], ModelSettings(temperature=0.0, max_tokens=1),
                        speculation=SPEC)
    assert "speculation" not in one.stats  # max_new == 1: nothing to draft
    off = teng.generate(["hello"], ModelSettings(**GREEDY),
                        speculation=dataclasses.replace(SPEC, enabled=False))
    assert "speculation" not in off.stats


def test_spec_long_generate_on_a_small_cache():
    """Each verify step advances the cache's uniform index by the window's
    width while rows advance by what they accept, so after a few steps the
    index passes the cache's end; the per-row write offsets still fit and
    must be what the forward checks. 40 tokens over a cache of 64 + 40 + 8
    slots take more steps of 9 than that index leaves room for."""
    _, teng = _engines()
    s = ModelSettings(temperature=0.0, max_tokens=40)
    spec_cfg = SpeculationConfig(enabled=True, draft_len=8)
    plain = teng.generate(["the quick brown fox"], s)
    spec = teng.generate(["the quick brown fox"], s, speculation=spec_cfg)
    np.testing.assert_array_equal(plain.tokens, spec.tokens)
    steps = spec.stats["speculation"]["verify_steps"]
    assert spec.stats["cache_slots"] == 64 + 40 + 8
    assert spec.stats["prompt_len"] + steps * (spec_cfg.draft_len + 1) > spec.stats["cache_slots"]


def test_engine_default_speculation_and_backend_totals():
    jeng, teng = _engines()
    eng = DecodeEngine(teng.config, params=teng.model.state_dict(), device="cpu",
                       speculation=SPEC)
    assert "speculation" in eng.generate(["abc abc abc"], ModelSettings(**GREEDY)).stats
    be = EngineBackend(teng, speculation=SPEC)
    be.generate(["abc abc abc abc"], ModelSettings(**GREEDY), keys=["a"])
    first = be.spec_totals.as_dict()
    be.generate(["def def def def"], ModelSettings(**GREEDY), keys=["b"])
    assert be.spec_totals.verify_steps > first["verify_steps"]
    assert be.spec_totals.drafted == first["drafted"] + be.last_stats["speculation"]["drafted"]
    before = be.spec_totals.as_dict()
    be.generate(["xyz"], ModelSettings(temperature=0.8, max_tokens=6), keys=["c"])
    assert be.spec_totals.as_dict() == before  # the sampled call added nothing
    assert EngineBackend(teng).spec_totals is None
