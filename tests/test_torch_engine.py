"""The port's decode engine and sampler against the JAX package's.

Greedy ``generate`` must give the same tokens as the JAX ``DecodeEngine`` on
``tiny-test`` with the same weights, with the shared prefix off, detected,
and given explicitly. Sampling cannot share a random stream across the two
frameworks, so both sides get the same injected noise.
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
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.runtime import sampling as jsampling  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings  # noqa: E402
from fairness_llm_tpu_torch.data.profiles import Profile  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.pipeline.backends import (  # noqa: E402
    EngineBackend,
    shared_prefix_ids,
)
from fairness_llm_tpu_torch.pipeline.parsing import parse_numbered_list  # noqa: E402
from fairness_llm_tpu_torch.pipeline.prompts import recommendation_prompt  # noqa: E402
from fairness_llm_tpu_torch.runtime import sampling as tsampling  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import params_from_jax  # noqa: E402

NAME = "tiny-test"
COMMON = "The shared instructions every counterfactual prompt starts with, " * 2
PROMPTS = [COMMON + "Gender: F", COMMON + "Gender: M, Age: 25-34", COMMON + "Age: 56+"]
GREEDY = dict(temperature=0.0, max_tokens=6)


@functools.lru_cache(maxsize=None)
def _engines():
    jeng = JEngine(get_model_config(NAME), seed=0)
    cfg = tconfigs.get_model_config(NAME)
    teng = DecodeEngine(cfg, params=params_from_jax(jax.device_get(jeng.params), cfg),
                        device="cpu")
    return jeng, teng


def _logit_gap_report(teng, prompts, got, want):
    """For each mismatching row: the first divergent step and the port's
    logits of the two candidate tokens there (a plain forward over the prompt
    and the JAX tokens before that step), so a near-tie flip reads apart
    from a real fault."""
    lines = []
    for r in np.flatnonzero(np.any(got != want, axis=1)):
        t = int(np.flatnonzero(got[r] != want[r])[0])
        ids = teng.tokenizer.encode(prompts[r]) + [int(x) for x in want[r, :t]]
        logits, _ = teng.model(torch.tensor([ids]), torch.arange(len(ids))[None])
        last = logits[0, -1]
        a, b = int(got[r, t]), int(want[r, t])
        lines.append(f"row {r} step {t}: port chose {a} (logit {float(last[a]):.6f}), "
                     f"jax chose {b} (logit {float(last[b]):.6f}), "
                     f"|gap| {abs(float(last[a] - last[b])):.2e}")
    return "\n".join(lines)


@pytest.mark.parametrize("mode", ["off", "detected", "explicit"])
def test_greedy_tokens_equal_jax_engine(mode):
    jeng, teng = _engines()
    kw = {"off": dict(share_prefix=False), "detected": dict(share_prefix=True),
          "explicit": dict(prefix_ids=teng.tokenizer.encode(COMMON)[:64])}[mode]
    want = jeng.generate(PROMPTS, JSettings(**GREEDY), **kw)
    got = teng.generate(PROMPTS, ModelSettings(**GREEDY), **kw)
    assert got.stats["prefix_len"] == want.stats["prefix_len"]
    assert got.stats["prompt_len"] == want.stats["prompt_len"]
    assert got.stats["batch"] == want.stats["batch"] == 8
    if mode != "off":
        assert got.stats["prefix_len"] > 0
    assert np.array_equal(got.tokens, want.tokens), (
        f"port {got.tokens.tolist()}\njax  {want.tokens.tolist()}\n"
        + _logit_gap_report(teng, PROMPTS, got.tokens, want.tokens))
    assert got.texts == want.texts
    assert got.stats["logits_finite"]


def test_greedy_tokens_equal_with_decode_kernel_flag():
    """With ``use_decode_attention_kernel`` the port's steps take the decode
    op (its plain version on the CPU); the JAX engine stays on XLA off-TPU."""
    jeng, teng = _engines()
    cfg = dataclasses.replace(teng.config, use_decode_attention_kernel=True)
    keng = DecodeEngine(cfg, params=params_from_jax(jax.device_get(jeng.params), cfg),
                        device="cpu")
    want = jeng.generate(PROMPTS, JSettings(**GREEDY), share_prefix=True)
    got = keng.generate(PROMPTS, ModelSettings(**GREEDY), share_prefix=True)
    assert got.stats["decode_kernel"]
    assert np.array_equal(got.tokens, want.tokens)


SETTINGS = [
    tsampling.SamplerSettings(temperature=0.7),
    tsampling.SamplerSettings(temperature=1.3, top_k=5),
    tsampling.SamplerSettings(temperature=0.9, top_p=0.8),
    tsampling.SamplerSettings(temperature=0.5, top_k=7, top_p=0.6),
]


def _tied_logits():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    x[0, :6] = 3.0  # ties at the top-k boundary
    x[1, 10:14] = 2.5  # ties at the top-p boundary
    return x


@pytest.mark.parametrize("s", SETTINGS, ids=lambda s: f"T{s.temperature}-k{s.top_k}-p{s.top_p}")
def test_filtered_logits_equal_jax(s):
    x = _tied_logits()
    js = jsampling.SamplerSettings(temperature=s.temperature, top_k=s.top_k, top_p=s.top_p)
    want = np.asarray(jsampling.filtered_logits(js, jnp.asarray(x)))
    got = tsampling.filtered_logits(s, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], rtol=1e-6)


@pytest.mark.parametrize("s", SETTINGS, ids=lambda s: f"T{s.temperature}-k{s.top_k}-p{s.top_p}")
def test_same_noise_same_sampled_token(s):
    x = _tied_logits()
    u = np.random.default_rng(1).random(x.shape).astype(np.float32)
    js = jsampling.SamplerSettings(temperature=s.temperature, top_k=s.top_k, top_p=s.top_p)
    g = -jnp.log(-jnp.log(jnp.maximum(jnp.asarray(u), jnp.finfo(jnp.float32).tiny)))
    want = np.asarray(jnp.argmax(jsampling.filtered_logits(js, jnp.asarray(x)) + g, axis=-1))
    got = tsampling.make_sampler(s)(torch.from_numpy(x),
                                    tsampling.gumbel_from_uniform(torch.from_numpy(u)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_noise_depends_only_on_row_seed_and_step():
    a = tsampling.row_gumbel([5, 9], [3, 0], 32, torch.device("cpu"))
    b = tsampling.row_gumbel([9, 5, 1], [0, 3, 3], 32, torch.device("cpu"))
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0])
    c = tsampling.row_gumbel([5], [4], 32, torch.device("cpu"))
    assert not torch.equal(a[0], c[0])


def test_sampled_row_independent_of_batch_composition():
    _, teng = _engines()
    s = ModelSettings(temperature=0.7, max_tokens=6)
    full = teng.generate(PROMPTS, s, row_seeds=[11, 22, 33], share_prefix=False)
    alone = teng.generate(PROMPTS[1:2], s, row_seeds=[22], share_prefix=False)
    assert np.array_equal(full.tokens[1], alone.tokens[0])
    other = teng.generate(PROMPTS[1:2], s, row_seeds=[23], share_prefix=False)
    assert not np.array_equal(other.tokens[0], alone.tokens[0])


def test_engine_backend_sweep_path():
    """The phase-1 path: counterfactual prompts, a sweep-wide prefix, keyed
    per-row streams; parsing runs on whatever comes out."""
    _, teng = _engines()
    profiles = [Profile(id=f"user_{i}", gender=g, age=a, occupation="writer",
                        watched_movies=["Heat (1995)", "Fargo (1996)"],
                        favorite_genres=["Drama"])
                for i, (g, a) in enumerate([("F", "18-24"), ("M", "25-34"), ("F", "56+")])]
    prompts = [recommendation_prompt(p) for p in profiles]
    backend = EngineBackend(teng)
    prefix = shared_prefix_ids(backend, prompts)
    assert prefix is not None and len(prefix) % 64 == 0
    s = ModelSettings(temperature=0.7, max_tokens=4)
    texts = backend.generate(prompts, s, keys=[p.id for p in profiles], prefix_ids=prefix)
    # the engine caps the prefix to leave 64 remainder slots in max_seq_len
    assert len(texts) == 3 and 0 < backend.last_stats["prefix_len"] <= len(prefix)
    again = backend.generate(prompts, s, keys=[p.id for p in profiles], prefix_ids=prefix)
    assert texts == again
    assert all(isinstance(parse_numbered_list(t), list) for t in texts)
    with pytest.raises(ValueError, match="strict prefix"):
        backend.generate(["short"], s, prefix_ids=prefix)
