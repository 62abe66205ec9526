"""The reference's other model families through the port, against the JAX
package on the CPU.

Tiny configurations of four families, built in both packages from the same
fields: mistral (a sliding window of 8 under rows longer than it), gemma
(one q head a kv head, ``gelu_tanh``, ``embed_scale``, a tied head), qwen2
(q/k/v biases, two q heads a kv head, a tied head), llama with a tied
head, and two at the head ratios of the largest and smallest configurations
the port runs: llama with 16 q heads over 2 kv heads (llama3-70b's rep 8)
and tied qwen2 with 14 over 2 (qwen2-0.5b's rep 7). Weights come from the
reference's flax init and go through ``params_from_jax``; inputs are made
with numpy from a seed.

- The forward: a left-padded prefill, cached single-token steps, and steps
  over a shared prompt prefix (the phase-1 sweep's layout), with the decode
  kernel off and on, in float32 and bfloat16, with float and int8 weights
  (K4's plain version on the CPU). Logits within 1e-4 in float32 and 8e-3
  in bfloat16 (``tests/test_torch_model.py``'s allowances).
- Greedy decode through ``DecodeEngine.generate``: tokens equal the
  reference engine's.
- Checkpoint loading for all six families of ``tests/test_hf_parity.py``
  (tiny checkpoints written by ``transformers`` in the test): the port's
  ``load_checkpoint`` equals the reference's followed by
  ``params_from_jax``, key for key and bit for bit, with float and int8
  weights.
- Phase 2 over three families with injected engine backends: the record
  equals the reference's ``run_phase2``'s, metrics within 1e-6 (the corpus
  perplexity, ~500 for random weights, within 1e-6 of its value: both
  sides take it as the exponential of a float32 mean).
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

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.models import configs as jconfigs  # noqa: E402
from fairness_llm_tpu.models import transformer as jtr  # noqa: E402
from fairness_llm_tpu.pipeline import backends as jbackends  # noqa: E402
from fairness_llm_tpu.pipeline import phase2 as jphase2  # noqa: E402
from fairness_llm_tpu.runtime import weights as jweights  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.pipeline import backends as tbackends  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase2 as tphase2  # noqa: E402
from fairness_llm_tpu_torch.runtime import weights as tweights  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402

from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

ATOL = {"float32": 1e-4, "bfloat16": 8e-3}

# The fields every tiny family shares: vocab 512 hosts the byte tokenizer.
BASE = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=64, d_ff=128, head_dim=16,
            max_seq_len=256, rope_theta=10000.0, eos_token_id=1, pad_token_id=0,
            dtype="float32")
FAMILIES = {
    "mistral": dict(num_kv_heads=2, norm_eps=1e-5, sliding_window=8),
    "gemma": dict(num_kv_heads=4, norm_eps=1e-6, activation="gelu_tanh", embed_scale=True,
                  tie_embeddings=True),
    "qwen2": dict(num_kv_heads=2, norm_eps=1e-6, qkv_bias=True, tie_embeddings=True),
    "llama-tied": dict(num_kv_heads=2, tie_embeddings=True),
    # llama3-70b's eight q heads a kv head, and qwen2-0.5b's seven with its
    # tied head and q/k/v biases.
    "llama-rep8": dict(num_heads=16, num_kv_heads=2),
    "qwen2-tied-rep7": dict(num_heads=14, num_kv_heads=2, norm_eps=1e-6, qkv_bias=True,
                            tie_embeddings=True),
}


def _configs(family, **over):
    """(reference config, port config) of a tiny family, from one field set."""
    fields = dict(BASE, name=f"tiny-{family}-family", **FAMILIES[family], **over)
    return jconfigs.ModelConfig(**fields), tconfigs.ModelConfig(**fields)


@functools.lru_cache(maxsize=None)
def _flax_params(family, weights):
    jcfg, _ = _configs(family)
    params = jax.device_get(jtr.init_params(jcfg, jax.random.key(0)))
    return jax.device_get(jweights.quantize_params(params)) if weights == "int8" else params


def _models(family, dtype, decode_kernel, weights):
    """The flax side off the TPU takes XLA attention whatever the decode
    kernel's flag, so its config leaves the flag out and both of the port's
    cases reuse one compiled forward; the port's config carries it."""
    jcfg, _ = _configs(family, dtype=dtype, weight_quant=weights)
    _, tcfg = _configs(family, dtype=dtype, weight_quant=weights,
                       use_decode_attention_kernel=decode_kernel)
    params = _flax_params(family, weights)
    tmodel = tweights.build_model(tcfg, tweights.params_from_jax(params, tcfg),
                                  torch.device("cpu"), getattr(torch, dtype))
    return jcfg, params, tcfg, tmodel


@functools.lru_cache(maxsize=None)
def _jitted(jcfg, left_padded, last_only):
    """One jitted flax forward a (config, mode): the cached steps reuse it."""
    return jax.jit(functools.partial(jtr.Transformer(jcfg).apply, left_padded=left_padded,
                                     last_only=last_only))


def _japply(jcfg, params, *args, left_padded=False, last_only=False, shared_layers=None):
    fn = _jitted(jcfg, left_padded, last_only)
    return fn({"params": params}, *args, shared_layers=shared_layers)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol, mask=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _batch(rng, B, S, vocab, pads):
    tokens = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    for b, p in enumerate(pads):
        valid[b, :p] = False
        tokens[b, :p] = 0
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return tokens, valid, positions


def _steps(rng, jcfg, params, tmodel, jcache, tcache, n_steps, atol, prefix_len=0,
           jshared=None, tshared=None):
    """``n_steps`` cached single-token steps on both sides, compared each step."""
    B = tcache.lengths.shape[0]
    for _ in range(n_steps):
        tok = rng.integers(3, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        live = np.ones((B, 1), bool)
        jl, jcache = _japply(jcfg, params, jnp.asarray(tok),
                             prefix_len + jcache.lengths[:, None], jnp.asarray(live), jcache,
                             shared_layers=jshared)
        tl, tcache = tmodel(_t(tok).long(), prefix_len + tcache.lengths[:, None], _t(live),
                            tcache, shared_layers=tshared)
        _close(tl.float().numpy(), jl, atol)


@pytest.mark.parametrize("weights", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_kernel", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_matches_jax(family, decode_kernel, dtype, weights):
    """Prefill of rows longer than mistral's window, five cached steps, then
    a shared prefix of 12 with rows of 14 and four steps over it."""
    jcfg, params, tcfg, tmodel = _models(family, dtype, decode_kernel, weights)
    atol = ATOL[dtype]
    rng = np.random.default_rng(0)
    B, S, extra = 3, 24, 5
    tokens, valid, positions = _batch(rng, B, S, tcfg.vocab_size, pads=[0, 5, 17])
    jcache = jtr.init_cache(jcfg, B, S + extra)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True)
    tcache = ttr.init_cache(tcfg, B, S + extra, dtype=getattr(torch, dtype))
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True)
    assert tl.dtype == torch.float32 and tl.shape == (B, S, tcfg.vocab_size)
    _close(tl.numpy(), jl, atol, mask=valid)
    _steps(rng, jcfg, params, tmodel, jcache, tcache, extra, atol)

    P, S2, extra2 = 12, 14, 4
    prefix = rng.integers(3, tcfg.vocab_size, size=(1, P)).astype(np.int32)
    ppos, pvalid = np.arange(P, dtype=np.int32)[None], np.ones((1, P), bool)
    _, jpc = _japply(jcfg, params, jnp.asarray(prefix), jnp.asarray(ppos),
                     jnp.asarray(pvalid), jtr.init_cache(jcfg, 1, P), left_padded=True,
                     last_only=True)
    jshared = tuple((layer.k[0], layer.v[0]) for layer in jpc.layers)
    tpc = ttr.init_cache(tcfg, 1, P, dtype=getattr(torch, dtype))
    tmodel(_t(prefix).long(), _t(ppos), _t(pvalid), tpc, left_padded=True, last_only=True)
    tshared = [(layer.k[0], layer.v[0]) for layer in tpc.layers]
    for (jk, jv), (tk, tv) in zip(jshared, tshared):
        _close(tk.float().numpy(), jk, atol)
        _close(tv.float().numpy(), jv, atol)
    tokens, valid, positions = _batch(rng, B, S2, tcfg.vocab_size, pads=[0, 4, 9])
    positions = positions + P
    jcache = jtr.init_cache(jcfg, B, S2 + extra2)
    jl, jcache = _japply(jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
                         jnp.asarray(valid), jcache, left_padded=True, shared_layers=jshared)
    tcache = ttr.init_cache(tcfg, B, S2 + extra2, dtype=getattr(torch, dtype))
    tl, tcache = tmodel(_t(tokens).long(), _t(positions), _t(valid), tcache, left_padded=True,
                        shared_layers=tshared)
    _close(tl.numpy(), jl, atol, mask=valid)
    _steps(rng, jcfg, params, tmodel, jcache, tcache, extra2, atol, prefix_len=P,
           jshared=jshared, tshared=tshared)


def test_mistral_window_cuts_keys_in_the_forward():
    """The window is live in the parity cases: at S = 24 the last query of
    a full row sees 8 keys, so the same model without a window gives other
    logits there."""
    _, params, tcfg, tmodel = _models("mistral", "float32", False, "none")
    wide = tweights.build_model(dataclasses.replace(tcfg, sliding_window=None),
                                tweights.params_from_jax(params, tcfg), torch.device("cpu"),
                                torch.float32)
    tokens, valid, positions = _batch(np.random.default_rng(0), 1, 24, tcfg.vocab_size, [0])
    args = (_t(tokens).long(), _t(positions), _t(valid))
    a, _ = tmodel(*args)
    b, _ = wide(*args)
    assert torch.equal(a[:, :8], b[:, :8])
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# Greedy decode through the engine
# ---------------------------------------------------------------------------

COMMON = "The shared instructions every counterfactual prompt of the sweep starts with. "
PROMPTS = [COMMON + "Gender: F", COMMON + "Gender: M, Age: 25-34", COMMON + "Age: 56+"]


@pytest.mark.parametrize("share_prefix", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_greedy_tokens_equal_the_reference_engine(family, share_prefix):
    from fairness_llm_tpu.config import ModelSettings as JSettings
    from fairness_llm_tpu_torch.config import ModelSettings

    jcfg, tcfg = _configs(family)
    params = _flax_params(family, "none")
    jeng = JEngine(jcfg, params=params, seed=0)
    teng = DecodeEngine(tcfg, params=tweights.params_from_jax(params, tcfg), device="cpu")
    greedy = dict(temperature=0.0, max_tokens=8)
    want = jeng.generate(PROMPTS, JSettings(**greedy), share_prefix=share_prefix)
    got = teng.generate(PROMPTS, ModelSettings(**greedy), share_prefix=share_prefix)
    assert got.stats["prefix_len"] == want.stats["prefix_len"]
    assert (got.stats["prefix_len"] > 0) == share_prefix
    assert np.array_equal(got.tokens, want.tokens), (
        f"port {got.tokens.tolist()}\njax  {want.tokens.tolist()}")
    assert got.texts == want.texts and got.stats["logits_finite"]


# ---------------------------------------------------------------------------
# Checkpoint loading: the six families of tests/test_hf_parity.py
# ---------------------------------------------------------------------------

HF_TINY = dict(d=64, ff=128, layers=2, heads=4, vocab=256, seq=256)
HF_FAMILIES = ["llama", "llama-tied", "gemma", "gpt2", "mistral", "qwen2", "llama-rep8",
               "qwen2-tied-rep7"]
# Q heads of the families with more than the tiny default's four (of head
# width 16, so q is wider than d_model): llama3-70b's rep 8, qwen2-0.5b's 7.
HF_HEADS = {"llama-rep8": 16, "qwen2-tied-rep7": 14}


def _hf_build(family):
    """A tiny transformers model of ``family`` and the fields of the
    matching config of both packages."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    t = HF_TINY
    fields = dict(name=f"tiny-{family}-ckpt", vocab_size=t["vocab"], num_layers=t["layers"],
                  num_heads=t["heads"], d_model=t["d"], d_ff=t["ff"], head_dim=16,
                  max_seq_len=t["seq"], rope_theta=10000.0, dtype="float32",
                  use_flash_attention=False)
    common = dict(vocab_size=t["vocab"], hidden_size=t["d"], intermediate_size=t["ff"],
                  num_hidden_layers=t["layers"], num_attention_heads=t["heads"], head_dim=16,
                  max_position_embeddings=t["seq"], rope_theta=10000.0)
    heads = HF_HEADS.get(family, t["heads"])
    common.update(num_attention_heads=heads)
    fields.update(num_heads=heads)
    if family in ("llama", "llama-tied", "llama-rep8"):
        tied = family == "llama-tied"
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **common, num_key_value_heads=2, rms_norm_eps=1e-5, tie_word_embeddings=tied,
            attention_bias=False, mlp_bias=False))
        fields.update(num_kv_heads=2, norm_eps=1e-5, tie_embeddings=tied)
    elif family == "gemma":
        hf = transformers.GemmaForCausalLM(transformers.GemmaConfig(
            **common, num_key_value_heads=t["heads"], rms_norm_eps=1e-6,
            hidden_activation="gelu_pytorch_tanh", attention_bias=False))
        fields.update(num_kv_heads=t["heads"], norm_eps=1e-6, activation="gelu_tanh",
                      embed_scale=True, tie_embeddings=True)
    elif family == "gpt2":
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=t["vocab"], n_positions=t["seq"], n_embd=t["d"], n_layer=t["layers"],
            n_head=t["heads"], activation_function="gelu_new", layer_norm_epsilon=1e-5))
        fields.update(d_ff=4 * t["d"], num_kv_heads=t["heads"], pos_emb="learned",
                      norm="layernorm", mlp="mlp", use_bias=True, activation="gelu_tanh",
                      tie_embeddings=True, norm_eps=1e-5)
    elif family == "mistral":
        hf = transformers.MistralForCausalLM(transformers.MistralConfig(
            **common, num_key_value_heads=2, rms_norm_eps=1e-5, sliding_window=8))
        fields.update(num_kv_heads=2, norm_eps=1e-5, sliding_window=8)
    elif family in ("qwen2", "qwen2-tied-rep7"):
        hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **common, num_key_value_heads=2, rms_norm_eps=1e-6, tie_word_embeddings=True))
        fields.update(num_kv_heads=2, norm_eps=1e-6, qkv_bias=True, tie_embeddings=True)
    else:
        raise KeyError(family)
    return hf.eval(), fields


@pytest.fixture(scope="module")
def hf_checkpoints(tmp_path_factory):
    """family -> (checkpoint directory, config fields), written once."""
    out = {}
    for family in HF_FAMILIES:
        hf, fields = _hf_build(family)
        path = tmp_path_factory.mktemp(f"ckpt-{family}")
        hf.save_pretrained(str(path), safe_serialization=True)
        out[family] = (str(path), fields)
    return out


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("family", HF_FAMILIES)
def test_family_checkpoint_loads_equal_the_reference(family, quant, hf_checkpoints):
    path, fields = hf_checkpoints[family]
    jcfg = jconfigs.ModelConfig(**fields, weight_quant=quant)
    tcfg = tconfigs.ModelConfig(**fields, weight_quant=quant)
    want = tweights.params_from_jax(jax.device_get(jweights.load_checkpoint(jcfg, path)), tcfg)
    got = tweights.load_checkpoint(tcfg, path, device="cpu")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert torch.equal(got[key], w), key
    if quant == "int8":
        assert got["layer_0.attn.q_proj.kernel_q"].dtype == torch.int8
        assert ("lm_head.kernel_q" in got) == (not tcfg.tie_embeddings)
    # The loaded tensors build the port's model at the config's shapes.
    tweights.build_model(tcfg, got, torch.device("cpu"), torch.float32)


# ---------------------------------------------------------------------------
# Phase 2 over three families
# ---------------------------------------------------------------------------

P2_FAMILIES = ("mistral", "gemma", "qwen2")


def _p2_config(mod, tmp, names):
    base = mod.Config()
    table = base.model_settings + tuple(
        (n, mod.ModelSettings(temperature=0.0, max_tokens=12)) for n in names)
    return mod.Config(results_dir=str(tmp), model_settings=table)


def test_phase2_over_three_families_equals_the_reference(tmp_path):
    """Greedy ``run_phase2`` over mistral, gemma and qwen2 (6 synthetic
    items, one listwise query, 4 comparisons, 12 new tokens), each family an
    injected engine backend over the same weights in both packages: the
    records equal, floats within 1e-6 and each corpus perplexity within 1e-6
    of its value; three models evaluated."""
    jback, tback = {}, {}
    for family in P2_FAMILIES:
        jcfg, tcfg = _configs(family)
        params = _flax_params(family, "none")
        jback[jcfg.name] = jbackends.EngineBackend(JEngine(jcfg, params=params, seed=0))
        tback[tcfg.name] = tbackends.EngineBackend(DecodeEngine(
            tcfg, params=tweights.params_from_jax(params, tcfg), device="cpu"))
    names = list(tback)
    kw = dict(models=names, num_items=6, num_comparisons=4, num_queries=1)
    want = jphase2.run_phase2(_p2_config(jconfig, tmp_path / "j", names), backends=jback,
                              save=False, **kw)
    got = tphase2.run_phase2(_p2_config(tconfig, tmp_path / "t", names), backends=tback,
                             save=False, **kw)
    got, want = _drop_times(got), _drop_times(want)
    assert sorted(got["model_results"]) == sorted(names)
    for name in names:
        g = got["model_results"][name].pop("corpus_perplexity")
        w = want["model_results"][name].pop("corpus_perplexity")
        assert g == pytest.approx(w, rel=1e-6, abs=0), name
    assert_same_record(got, want)
