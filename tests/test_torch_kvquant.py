"""The port's int8 KV cache against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
kernel's int8 modes run in interpret mode on the CPU, as its own tests run
them; the port's wrapper takes its plain versions for CPU tensors.
Tolerances:

- quantization: int8 values and scales bit-equal;
- the plain int8-cache attention (one query, and the verify window) against
  the Pallas kernel: 1e-5 (float32; scale folding is the same arithmetic,
  sums of a few hundred unit-scale products in another order);
- model logits: 1e-4 (float32, as the other model parity tests);
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
from fairness_llm_tpu.config import SpeculationConfig as JSpec  # noqa: E402
from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.ops.decode_attention import decode_attention as jax_decode  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings, SpeculationConfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.ops import decode_attention as dec_mod  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import build_model, params_from_jax  # noqa: E402

NAME = "tiny-test"
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant(cfg):
    return dataclasses.replace(cfg, kv_cache_quant=True)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def test_quantize_kv_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32) * 3
    # Values at exactly .5 of a step round half to even: amax 127 gives a
    # scale of 1, so the others are their own quantized values.
    x[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5, 0, 0, 0, 0, 0, 0, 0]
    x[0, 1, 1] = 0.0  # the 1e-8 floor
    x[1, 2, 0, :4] = [1e-12, -1e-12, 0, 0]
    jq, js = jtr._quantize_kv(jnp.asarray(x))
    tq, ts = ttr._quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 7, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(tq.numpy()[0, 0, 0, :9], [127, 0, 2, 2, 0, -2, -2, 126, 4])
    back = ttr._dequantize_kv(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jtr._dequantize_kv(jq, js, jnp.float32)))
    bf = ttr._dequantize_kv(tq, ts, torch.bfloat16)
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The int8-cache attention (K2q, and K3 over an int8 cache)
# ---------------------------------------------------------------------------


def _int8_inputs(rng, B, L, hkv, D):
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    qk, ks = jtr._quantize_kv(jnp.asarray(k))
    qv, vs = jtr._quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (qk, qv, ks, vs)]


def _shared(rng, shared_p, hkv, D):
    if not shared_p:
        return None
    return (rng.normal(size=(shared_p, hkv, D)).astype(np.float32),
            rng.normal(size=(shared_p, hkv, D)).astype(np.float32))


def _jx(shared):
    return None if shared is None else tuple(jnp.asarray(a) for a in shared)


def _tx(shared):
    return None if shared is None else tuple(_t(a) for a in shared)


@pytest.mark.parametrize("shared_p", [None, 96])
@pytest.mark.parametrize("hkv", [1, 2])
def test_int8_decode_reference_matches_pallas(hkv, shared_p):
    rng = np.random.default_rng(2)
    B, H, D, L = 8, 4, 64, 256
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    qk, qv, ks, vs = _int8_inputs(rng, B, L, hkv, D)
    valid = rng.random((B, L)) < 0.5
    valid[:, 0] = True
    shared = _shared(rng, shared_p, hkv, D)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(qk), jnp.asarray(qv),
                                 jnp.asarray(valid), _jx(shared), k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), interpret=True))
    got = dec_mod.decode_attention_reference(_t(q), _t(qk), _t(qv), _t(valid), _tx(shared),
                                             k_scale=_t(ks), v_scale=_t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shared_p", [None, 96])
@pytest.mark.parametrize("hkv", [1, 2])
def test_int8_multi_query_reference_matches_pallas(hkv, shared_p):
    rng = np.random.default_rng(4)
    B, Q, H, D, L = 8, 3, 4, 64, 256
    q = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    qk, qv, ks, vs = _int8_inputs(rng, B, L, hkv, D)
    offs = rng.integers(0, L - Q, size=B).astype(np.int32)
    valid = rng.random((B, L)) < 0.8
    valid[:, 0] = True
    shared = _shared(rng, shared_p, hkv, D)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(qk), jnp.asarray(qv),
                                 jnp.asarray(valid), _jx(shared), k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), q_offsets=jnp.asarray(offs),
                                 interpret=True))
    got = dec_mod.decode_attention_reference(_t(q), _t(qk), _t(qv), _t(valid), _tx(shared),
                                             k_scale=_t(ks), v_scale=_t(vs),
                                             q_offsets=_t(offs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("at", ["offset0", "offset_end"])
@pytest.mark.parametrize("rep,Q", [(1, 9), (8, 2), (4, 9), (7, 9), (4, 16)],
                         ids=["rows9", "rows16", "rows36", "rows63", "rows64"])
def test_int8_multi_query_reference_matches_pallas_at_row_and_offset_edges(rep, Q, at):
    """The int8-cache verify window at the card kernel's row counts per kv
    head (9 to 64: one to four 16-row warps), every window at slot 0 or at
    the cache's end."""
    rng = np.random.default_rng(14)
    B, hkv, D, L = 8, 1, 64, 128
    q = rng.normal(size=(B, Q, rep * hkv, D)).astype(np.float32)
    qk, qv, ks, vs = _int8_inputs(rng, B, L, hkv, D)
    offs = np.full(B, 0 if at == "offset0" else L - Q, np.int32)
    valid = rng.random((B, L)) < 0.8
    valid[:, offs[0]] = True
    shared = _shared(rng, 96, hkv, D)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(qk), jnp.asarray(qv),
                                 jnp.asarray(valid), _jx(shared), k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), q_offsets=jnp.asarray(offs),
                                 interpret=True))
    got = dec_mod.decode_attention_reference(_t(q), _t(qk), _t(qv), _t(valid), _tx(shared),
                                             k_scale=_t(ks), v_scale=_t(vs),
                                             q_offsets=_t(offs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cpu_wrapper_takes_the_plain_versions_of_the_new_modes():
    rng = np.random.default_rng(6)
    B, Q, H, hkv, D, L = 3, 4, 4, 2, 16, 24
    q3 = _t(rng.normal(size=(B, H, D)).astype(np.float32))
    q4 = _t(rng.normal(size=(B, Q, H, D)).astype(np.float32))
    kf = _t(rng.normal(size=(B, L, hkv, D)).astype(np.float32))
    qk, qv, ks, vs = (_t(a) for a in _int8_inputs(rng, B, L, hkv, D))
    valid = _t(rng.random((B, L)) < 0.7)
    offs = torch.tensor([3, 10, 19], dtype=torch.int32)
    counts = lambda: (dec_mod.launches, dec_mod.quant_launches,  # noqa: E731
                      dec_mod.multi_launches, dec_mod.multi_quant_launches,
                      dec_mod.multi_tc_launches, dec_mod.decode_tc_launches,
                      dec_mod.decode_f32_launches)
    before = counts()
    for args, kw in [((q3, qk, qv, valid), dict(k_scale=ks, v_scale=vs)),
                     ((q4, kf, kf, valid), dict(q_offsets=offs)),
                     ((q4, qk, qv, valid), dict(k_scale=ks, v_scale=vs, q_offsets=offs))]:
        out = dec_mod.decode_attention(*args, **kw)
        assert torch.equal(out, dec_mod.decode_attention_reference(*args, **kw))
        assert out.shape == args[0].shape
    assert counts() == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        dec_mod.decode_attention(q3.to("meta"), qk, qv, valid, k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax_params():
    return jax.device_get(jtr.init_params(get_model_config(NAME), jax.random.key(0)))


def _models(decode_kernel):
    jcfg = _quant(get_model_config(NAME))
    tcfg = dataclasses.replace(_quant(tconfigs.get_model_config(NAME)),
                               use_decode_attention_kernel=decode_kernel)
    params = _flax_params()
    tmodel = build_model(tcfg, params_from_jax(params, tcfg), torch.device("cpu"),
                         torch.float32)
    return jcfg, params, tcfg, tmodel


def _japply(jcfg, params, *args, left_padded=False, last_only=False, shared_layers=None):
    fn = jax.jit(functools.partial(jtr.Transformer(jcfg).apply,
                                   left_padded=left_padded, last_only=last_only))
    return fn({"params": params}, *args, shared_layers=shared_layers)


def _batch(rng, B, S, vocab, pads):
    tokens = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    for b, p in enumerate(pads):
        valid[b, :p] = False
        tokens[b, :p] = 0
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return tokens, valid, positions


def _decode_steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, n, prefix_len=0,
                  jshared=None, tshared=None):
    B = tcache.lengths.shape[0]
    for _ in range(n):
        tok = rng.integers(3, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
        live = np.ones((B, 1), bool)
        jl, jcache = _japply(jcfg, params, jnp.asarray(tok), prefix_len + jcache.lengths[:, None],
                             jnp.asarray(live), jcache, shared_layers=jshared)
        tl, tcache = tmodel(_t(tok).long(), prefix_len + tcache.lengths[:, None], _t(live),
                            tcache, shared_layers=tshared)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    return jcache, tcache


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_int8_cache_prefill_and_steps_match_flax(decode_kernel):
    """A left-padded prefill (the flash path attends to the round trip of
    the new keys) and 4 decode steps over the int8 cache."""
    jcfg, params, tcfg, tmodel = _models(decode_kernel)
    rng = np.random.default_rng(0)
    B, S, extra = 3, 24, 4
    tokens, valid, positions = _batch(rng, B, S, tcfg.vocab_size, pads=[0, 5, 17])
    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tcfg, B, S + extra)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL, rtol=0)
    jcache, tcache = _decode_steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, extra)
    # At the valid slots the cached int8 values and scales agree up to the
    # rounding of the float k/v the two frameworks' matmuls hand to the
    # quantizer (left-pad slots hold what pad rows computed, never read).
    kv = tcache.key_valid.numpy()
    np.testing.assert_array_equal(kv, np.asarray(jcache.key_valid))
    for jl_, tl_ in zip(jcache.layers, tcache.layers):
        assert tl_.k.dtype == tl_.v.dtype == torch.int8
        for got, want in ((tl_.k, jl_.k), (tl_.v, jl_.v)):
            diff = got.numpy().astype(int) - np.asarray(want).astype(int)
            assert np.abs(diff[kv]).max() <= 1
        for got, want in ((tl_.k_scale, jl_.k_scale), (tl_.v_scale, jl_.v_scale)):
            np.testing.assert_allclose(got.numpy()[kv], np.asarray(want)[kv], rtol=1e-5, atol=0)


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_int8_cache_shared_prefix_steps_match_flax(decode_kernel):
    """The prefix KV is the dequantized round trip of the int8 prefix cache
    and stays float; steps attend to it and to the int8 own cache."""
    jcfg, params, tcfg, tmodel = _models(decode_kernel)
    rng = np.random.default_rng(1)
    P, B, S, extra = 20, 3, 12, 3
    prefix = rng.integers(3, tcfg.vocab_size, size=(1, P)).astype(np.int32)
    ppos = np.arange(P, dtype=np.int32)[None]
    _, jpc = _japply(jcfg, params, jnp.asarray(prefix), jnp.asarray(ppos),
                     jnp.asarray(np.ones((1, P), bool)), jtr.init_cache(jcfg, 1, P),
                     left_padded=True, last_only=True)
    jshared = tuple((jtr._dequantize_kv(layer.k, layer.k_scale, jnp.float32)[0],
                     jtr._dequantize_kv(layer.v, layer.v_scale, jnp.float32)[0])
                    for layer in jpc.layers)
    from fairness_llm_tpu_torch.runtime.stepbuilder import build_prefix

    tshared = build_prefix(tcfg, tmodel, prefix_len=P)(_t(prefix).long())
    for (jk, jv), (tk, tv) in zip(jshared, tshared):
        assert tk.dtype == torch.float32 and tk.shape == (P, tcfg.num_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)

    tokens, valid, positions = _batch(rng, B, S, tcfg.vocab_size, pads=[0, 4, 9])
    positions = positions + P
    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True, shared_layers=jshared)
    tcache = ttr.init_cache(tcfg, B, S + extra)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True,
                        shared_layers=tshared)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL, rtol=0)
    _decode_steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, extra, prefix_len=P,
                  jshared=jshared, tshared=tshared)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

COMMON = "The shared instructions every counterfactual prompt starts with, " * 2
PROMPTS = [COMMON + "Gender: F", COMMON + "Gender: M, Age: 25-34",
           COMMON + "Age: 56+ list list list list"]
GREEDY = dict(temperature=0.0, max_tokens=12)


@functools.lru_cache(maxsize=None)
def _engines():
    jeng = JEngine(_quant(get_model_config(NAME)), params=_flax_params(), seed=0)
    cfg = dataclasses.replace(_quant(tconfigs.get_model_config(NAME)),
                              use_decode_attention_kernel=True)
    teng = DecodeEngine(cfg, params=params_from_jax(_flax_params(), cfg), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("share_prefix", [False, True])
def test_int8_cache_engine_tokens_equal_jax(share_prefix, spec):
    jeng, teng = _engines()
    kw = dict(speculation=SpeculationConfig(enabled=True, draft_len=4)) if spec else {}
    jkw = dict(speculation=JSpec(enabled=True, draft_len=4)) if spec else {}
    want = jeng.generate(PROMPTS, JSettings(**GREEDY), share_prefix=share_prefix, **jkw)
    got = teng.generate(PROMPTS, ModelSettings(**GREEDY), share_prefix=share_prefix, **kw)
    assert (got.stats["prefix_len"] > 0) == share_prefix
    assert got.stats["prefix_len"] == want.stats["prefix_len"]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.texts == want.texts and got.stats["logits_finite"]
    assert ("speculation" in got.stats) == spec
    if spec:
        assert got.stats["speculation"] == want.stats["speculation"]
        plain = teng.generate(PROMPTS, ModelSettings(**GREEDY), share_prefix=share_prefix)
        np.testing.assert_array_equal(plain.tokens, got.tokens)


def test_second_engine_shares_the_first_engines_tensors():
    """An int8-cache engine built from a float-cache engine's state dict
    uses the same parameter tensors: nothing is copied."""
    _, teng = _engines()
    plain_cfg = dataclasses.replace(teng.config, kv_cache_quant=False)
    first = DecodeEngine(plain_cfg, params=params_from_jax(_flax_params(), plain_cfg),
                         device="cpu")
    second = DecodeEngine(_quant(plain_cfg), params=first.model.state_dict(), device="cpu")
    a, b = dict(first.model.named_parameters()), dict(second.model.named_parameters())
    assert set(a) == set(b)
    assert all(a[n].data_ptr() == b[n].data_ptr() for n in a)
    assert second.config.kv_cache_quant and not first.config.kv_cache_quant
