"""The port's int8 weight-only path against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
kernel runs in interpret mode on the CPU, as its own tests run it; the
port's wrapper takes its plain version for CPU tensors. Tolerances:

- quantization: int8 values equal, scales within 1 float32 ulp;
- the plain matmul against the Pallas kernel: 2e-5 (float32; sums of a few
  hundred products in another order), and one bf16 ulp for a bf16 output
  (both round one float32 result);
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


def test_gemv_splits_cover_k_and_fill_the_card():
    for M, K, N in [(16, 4096, 1024), (16, 4096, 14336), (16, 14336, 4096),
                    (16, 4096, 128256), (1, 100, 96)]:
        splits, per = qmm.gemv_splits(M, K, N)
        n_tiles = -(-N // 128)
        assert per % 64 == 0 and splits * per >= K > (splits - 1) * per
        # Every k tile its own split, or within one split's worth of blocks
        # of the target (two per SM).
        assert splits == -(-K // 64) or n_tiles * (splits + 1) >= 264


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
