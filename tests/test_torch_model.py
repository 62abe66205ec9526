"""The port's transformer against the flax forward, on the same weights.

Weights come from the reference's flax init and go through
``params_from_jax``; token inputs are made with numpy from a seed. Both run
in float32 on the CPU. Logits must agree within 1e-4 at every valid
position in three cases: a left-padded prefill, cached single-token steps,
and steps over a shared prompt prefix. The flax side never takes a Pallas
kernel off the TPU; the port takes its kernels' plain versions on the CPU
(flash on the prefill, decode attention on the steps when the flag is on).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import (  # noqa: E402
    build_model,
    init_params,
    params_from_jax,
)

ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _flax_params(name):
    return jax.device_get(jtr.init_params(get_model_config(name), jax.random.key(0)))


def _models(name, decode_kernel):
    jcfg = dataclasses.replace(get_model_config(name),
                               use_decode_attention_kernel=decode_kernel)
    tcfg = dataclasses.replace(tconfigs.get_model_config(name),
                               use_decode_attention_kernel=decode_kernel)
    params = _flax_params(name)
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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, n_steps, prefix_len=0,
           jshared=None, tshared=None):
    """n_steps cached single-token steps on both sides, compared each step."""
    B = tcache.lengths.shape[0]
    for _ in range(n_steps):
        tok = rng.integers(3, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
        live = np.ones((B, 1), bool)
        jpos = prefix_len + jcache.lengths[:, None]
        jl, jcache = _japply(jcfg, params, jnp.asarray(tok), jpos, jnp.asarray(live),
                             jcache, shared_layers=jshared)
        tl, tcache = tmodel(_t(tok).long(), prefix_len + tcache.lengths[:, None],
                            _t(live), tcache, shared_layers=tshared)
        _close(tl.numpy(), jl)
    return jcache, tcache


MODELS = ["tiny-test", "tiny-gpt2"]


@pytest.mark.parametrize("decode_kernel", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_cached_steps_match_flax(name, decode_kernel):
    jcfg, params, tcfg, tmodel = _models(name, decode_kernel)
    rng = np.random.default_rng(0)
    B, S, extra = 3, 24, 4
    tokens, valid, positions = _batch(rng, B, S, tcfg.vocab_size, pads=[0, 5, 17])
    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tcfg, B, S + extra)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache,
                        left_padded=True)
    assert tl.dtype == torch.float32 and tl.shape == (B, S, tcfg.vocab_size)
    _close(tl.numpy(), jl, mask=valid)
    _steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, n_steps=extra)


@pytest.mark.parametrize("decode_kernel", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_shared_prefix_steps_match_flax(name, decode_kernel):
    jcfg, params, tcfg, tmodel = _models(name, decode_kernel)
    rng = np.random.default_rng(1)
    P, B, S, extra = 20, 3, 12, 3
    prefix = rng.integers(3, tcfg.vocab_size, size=(1, P)).astype(np.int32)
    ppos = np.arange(P, dtype=np.int32)[None]
    pvalid = np.ones((1, P), bool)
    _, jpc = _japply(jcfg, params, jnp.asarray(prefix), jnp.asarray(ppos),
                     jnp.asarray(pvalid), jtr.init_cache(jcfg, 1, P),
                     left_padded=True, last_only=True)
    jshared = tuple((layer.k[0], layer.v[0]) for layer in jpc.layers)
    tpc = ttr.init_cache(tcfg, 1, P)
    tmodel(_t(prefix).long(), _t(ppos), _t(pvalid), tpc, left_padded=True, last_only=True)
    tshared = [(layer.k[0], layer.v[0]) for layer in tpc.layers]
    for (jk, jv), (tk, tv) in zip(jshared, tshared):
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)

    tokens, valid, positions = _batch(rng, B, S, tcfg.vocab_size, pads=[0, 4, 9])
    positions = positions + P
    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True,
                         shared_layers=jshared)
    tcache = ttr.init_cache(tcfg, B, S + extra)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache,
                        left_padded=True, shared_layers=tshared)
    _close(tl.numpy(), jl, mask=valid)
    _steps(rng, jcfg, params, tcfg, tmodel, jcache, tcache, n_steps=extra,
           prefix_len=P, jshared=jshared, tshared=tshared)


@pytest.mark.parametrize("name", MODELS)
def test_params_from_jax_maps_every_leaf(name):
    tcfg = tconfigs.get_model_config(name)
    params = _flax_params(name)
    sd = params_from_jax(params, tcfg)
    np.testing.assert_array_equal(sd["layer_1.attn.q_proj.kernel"].numpy(),
                                  params["layer_1"]["attn"]["q_proj"]["kernel"])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    broken = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(broken, tcfg)


def test_rope_matches_flax_rope():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    want = np.asarray(jtr.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    got = ttr.rope(_t(x), _t(pos), 500000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_init_params_families_and_seed():
    tcfg = tconfigs.get_model_config("tiny-gpt2")
    a = init_params(tcfg, seed=7, device=torch.device("cpu"))
    b = init_params(tcfg, seed=7, device=torch.device("cpu"))
    c = init_params(tcfg, seed=8, device=torch.device("cpu"))
    assert torch.equal(a["embedding"], b["embedding"])
    assert not torch.equal(a["embedding"], c["embedding"])
    assert torch.all(a["layer_0.attn_norm.scale"] == 1)
    assert torch.all(a["layer_0.mlp.up_proj.bias"] == 0)
    assert abs(float(a["embedding"].std()) - 0.02) < 2e-3
    bf = init_params(tconfigs.get_model_config("tiny-test"), seed=0,
                     device=torch.device("cpu"), dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf.values())


def test_unported_cache_and_weights_refuse():
    """int8 weights (test_torch_quant.py) and the int8 KV cache
    (test_torch_kvquant.py) are ported; any other weight format is refused.
    The int8 cache holds int8 k/v and float32 per-(slot, head) scales."""
    cfg = tconfigs.get_model_config("tiny-test")
    cache = ttr.init_cache(dataclasses.replace(cfg, kv_cache_quant=True), 3, 8,
                           dtype=torch.bfloat16)
    kv = (3, 8, cfg.num_kv_heads, cfg.head_dim)
    assert len(cache.layers) == cfg.num_layers and cache.max_len == 8
    for layer in cache.layers:
        assert layer.k.dtype == layer.v.dtype == torch.int8
        assert layer.k.shape == layer.v.shape == kv
        assert layer.k_scale.dtype == layer.v_scale.dtype == torch.float32
        assert layer.k_scale.shape == layer.v_scale.shape == kv[:3]
    plain = ttr.init_cache(cfg, 3, 8)
    assert plain.layers[0].k.dtype == torch.float32 and plain.layers[0].k_scale is None
    with pytest.raises(NotImplementedError):
        ttr.Transformer(dataclasses.replace(cfg, weight_quant="int4"))
    assert isinstance(ttr.Transformer(dataclasses.replace(cfg, weight_quant="int8")).lm_head,
                      ttr.QuantDense)


def test_cache_write_past_the_end_raises():
    tcfg = tconfigs.get_model_config("tiny-test")
    model = build_model(tcfg, init_params(tcfg, 0, torch.device("cpu")),
                        torch.device("cpu"), torch.float32)
    cache = ttr.init_cache(tcfg, 1, 4)
    tok = torch.ones(1, 5, dtype=torch.long)
    with pytest.raises(ValueError, match="max_len"):
        model(tok, torch.arange(5)[None], cache=cache)
