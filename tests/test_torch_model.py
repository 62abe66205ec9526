"""The port's transformer against the flax forward, on the same weights.

Weights come from the reference's flax init and go through
``params_from_jax``; token inputs are made with numpy from a seed. Both run
in float32 on the CPU. Logits must agree within 1e-4 at every valid
position in three cases: a left-padded prefill, cached single-token steps,
and steps over a shared prompt prefix. The flax side never takes a Pallas
kernel off the TPU; the port takes its kernels' plain versions on the CPU
(flash on the prefill, decode attention on the steps when the flag is on).

In bfloat16 the logits product sums bf16 operands into float32 on both
sides: the head function alone agrees with the reference's einsum to a few
float32 ulps, and a bf16 ``tiny-test`` forward agrees within the bf16
tolerance stated at ``BF16_ATOL``.
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

from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import (  # noqa: E402
    build_model,
    init_params,
    param_shapes,
    params_from_jax,
)

ATOL = 1e-4
# bf16 tiny-test logits (scale < 1): the two frameworks round the bf16
# residual stream at different places, one bf16 ulp (2^-8 below 1) at a
# time; 8e-3 is two such ulps. Measured: 4.1e-3 at logits of scale 0.77.
BF16_ATOL = 8e-3


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


def _init_params_in_model_order(cfg, seed, dtype):
    """init_params as it drew before it drew the largest tensors first:
    parameter i from its own generator seeded from (seed, i), in the
    model's order."""
    out = {}
    for i, (name, shape) in enumerate(param_shapes(cfg).items()):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        if name.endswith("kernel_q"):
            t = torch.randn(shape, generator=gen, dtype=torch.float32)
            out[name] = t.mul_(42.0).round_().clamp_(-127, 127).to(torch.int8)
        elif name.endswith("kernel_scale"):
            out[name] = torch.full(shape, 0.02 / 42.0, dtype=torch.float32)
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, dtype=dtype)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, dtype=dtype)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dtype).mul_(0.02)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["tiny-test", "tiny-gpt2"])
def test_init_params_largest_first_draws_the_same_tensors(name, dtype):
    """Drawing the largest tensors first (an int8 lm_head's float32 draw
    before the rest of a 70B model is on the card) gives every parameter
    bit for bit as the model-order draw did, for int8 and float weights,
    biases and a tied head included; the dict keeps the model's order."""
    for quant in ("none", "int8"):
        cfg = dataclasses.replace(tconfigs.get_model_config(name), weight_quant=quant)
        got = init_params(cfg, seed=3, device=torch.device("cpu"), dtype=dtype)
        want = _init_params_in_model_order(cfg, 3, dtype)
        assert list(got) == list(want) == list(param_shapes(cfg))
        for key, w in want.items():
            assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
        if quant == "int8":
            assert got["layer_0.mlp.down_proj.kernel_q"].dtype == torch.int8


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


def test_logits_product_sums_bf16_operands_in_f32():
    """The head product of bf16 x and a bf16 head, against the reference's
    ``einsum(..., preferred_element_type=float32)`` on the same operands:
    within 1e-4 absolute, float32 summation order over 512 products of
    outputs up to ~80 (a few ulps). A product rounded to bf16 before the
    cast misses by up to 2^-9 of each value (0.25 at 80)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 3, 512)).astype(np.float32)
    head = rng.normal(size=(512, 300)).astype(np.float32)
    xb, hb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)
    want = np.asarray(jnp.einsum("bsd,dv->bsv", xb, hb, preferred_element_type=jnp.float32))
    got = ttr._logits(_t(x).bfloat16(), _t(head).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 300)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # The tied head is the embedding's transpose, a strided view.
    tied = ttr._logits(_t(x).bfloat16(), _t(head.T.copy()).bfloat16().t())
    np.testing.assert_allclose(tied.numpy(), want, atol=1e-4, rtol=0)


def _greedy_run(jcfg, params, tmodel, tokens, valid, positions, steps):
    """Prefill then ``steps`` greedy steps on each side, each side feeding
    its own argmax; the prefill's logits must agree within BF16_ATOL at
    every valid position. Returns per side the [steps + 1, B, V] logits that
    chose each token (the prefill's last position, then each step's)."""
    B, S = tokens.shape
    jcache = jtr.init_cache(jcfg, B, S + steps)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tmodel.config, B, S + steps)
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl, np.float32)[valid],
                               atol=BF16_ATOL, rtol=0)
    jout, tout = [np.asarray(jl[:, -1], np.float32)], [tl[:, -1].numpy()]
    live = np.ones((B, 1), bool)
    pos = positions[:, -1:] + 1
    for _ in range(steps):
        jtok = jout[-1].argmax(-1)[:, None].astype(np.int32)
        ttok = tout[-1].argmax(-1)[:, None]
        jl, jcache = _japply(jcfg, params, jnp.asarray(jtok), jnp.asarray(pos),
                             jnp.asarray(live), jcache)
        tl, tcache = tmodel(torch.from_numpy(ttok).long(), _t(pos), _t(live), tcache)
        jout.append(np.asarray(jl[:, -1], np.float32))
        tout.append(tl[:, -1].numpy())
        pos = pos + 1
    return np.stack(jout), np.stack(tout)


def test_bf16_forward_and_greedy_tokens_match_flax():
    """A bf16 tiny-test model, flax and port on the same params_from_jax
    weights: logits within BF16_ATOL at every valid prefill position and at
    every step while a row's tokens agree; greedy tokens equal up to each
    row's first divergence, which must be a near-tie: the reference's
    logits of the two chosen tokens within BF16_ATOL of each other (the
    rule of __graft_entry__.py's near-tie check)."""
    name = "tiny-test"
    jcfg = dataclasses.replace(get_model_config(name), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_model_config(name), dtype="bfloat16")
    tmodel = build_model(tcfg, params_from_jax(_flax_params(name), tcfg), torch.device("cpu"),
                         torch.bfloat16)
    rng = np.random.default_rng(22)
    tokens, valid, positions = _batch(rng, 16, 24, tcfg.vocab_size,
                                      pads=[0, 3, 7, 11] * 4)
    jl, tl = _greedy_run(jcfg, _flax_params(name), tmodel, tokens, valid, positions, steps=16)
    jtok, ttok = jl.argmax(-1), tl.argmax(-1)  # [steps + 1, B]
    rows_diverged = 0
    for b in range(tokens.shape[0]):
        differ = np.nonzero(jtok[:, b] != ttok[:, b])[0]
        t = int(differ[0]) if differ.size else jtok.shape[0]
        # Inputs agree up to and including step t: so must the logits.
        np.testing.assert_allclose(tl[:t + 1, b], jl[:t + 1, b], atol=BF16_ATOL, rtol=0)
        if differ.size:
            rows_diverged += 1
            gap = abs(jl[t, b, jtok[t, b]] - jl[t, b, ttok[t, b]])
            assert gap <= BF16_ATOL, (b, t, gap)
    assert rows_diverged < tokens.shape[0]
