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

from fairness_llm_tpu.ops.decode_attention import decode_attention as jax_decode  # noqa: E402
from fairness_llm_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
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
