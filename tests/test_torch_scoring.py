"""The port's teacher-forced scoring (``runtime/scoring.py``) against the JAX
package's, on ``tiny-test`` (random weights from seed 0, carried across with
``params_from_jax``; the byte tokenizer) and on the ``tiny-llama-study``
checkpoint (its BPE tokenizer).

Token counts must be equal. Log-likelihoods are sums of float32 log
probabilities over up to 255 tokens, which both sides sum in their own
order: they are held to 1e-5 + 1e-5 * |value| (a row of one likely token
sums to near 0); mean log-probabilities to 1e-5 absolute. On the CPU the port's forward runs K1's plain version, as it does
wherever the tensors lie on the CPU.
"""

import functools
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.pipeline.backends import backend_for as jbackend_for  # noqa: E402
from fairness_llm_tpu.runtime import scoring as jscoring  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.ops import flash_attention as fm  # noqa: E402
from fairness_llm_tpu_torch.pipeline.backends import backend_for  # noqa: E402
from fairness_llm_tpu_torch.runtime import scoring as tscoring  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LL_RTOL = 1e-5
LL_ATOL = 1e-5
MEAN_ATOL = 1e-5
STUDY = "tiny-llama-study"


@functools.lru_cache(maxsize=None)
def _engines(name: str):
    """(JAX engine, port engine on the CPU) with the same weights."""
    if name == STUDY:
        jb = jbackend_for(name, jconfig.Config(weights_dir=str(ROOT / "checkpoints")))
        tb = backend_for(name, tconfig.Config(weights_dir=str(ROOT / "checkpoints")),
                         device="cpu")
        return jb.engine, tb.engine
    jeng = JEngine(get_model_config(name), seed=0)
    cfg = tconfigs.get_model_config(name)
    return jeng, DecodeEngine(cfg, params=params_from_jax(jax.device_get(jeng.params), cfg),
                              device="cpu")


def _texts(seed: int, n: int, longest: int = 90):
    rng = np.random.default_rng(seed)
    return ["".join(chr(c) for c in rng.integers(32, 123, size=rng.integers(1, longest)))
            for _ in range(n)]


def assert_scores_equal(got, want):
    np.testing.assert_array_equal(got.token_counts, want.token_counts)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods, rtol=LL_RTOL,
                               atol=LL_ATOL)
    np.testing.assert_allclose(got.mean_logprobs, want.mean_logprobs, rtol=0, atol=MEAN_ATOL)


TITLES = ["Toy Story (1995)", "Heat (1995)", "American Beauty (1999)", "Fargo (1996)",
          "Star Wars: Episode IV - A New Hope (1977)", "Casablanca (1942)", "Z"]


@pytest.mark.parametrize("name", ["tiny-test", STUDY])
@pytest.mark.parametrize("fn", ["score_texts", "score_continuations",
                                "score_prompted_continuations"])
def test_scoring_matches_the_reference(name, fn):
    jeng, teng = _engines(name)
    texts = _texts(1, 11) + TITLES
    if fn == "score_texts":
        args = (texts,)
    elif fn == "score_continuations":
        args = ("Query: the best films\nA highly relevant result: ", texts)
    else:
        ctx = [f"A user who enjoyed {TITLES[i % 3]}, {TITLES[3]} would also enjoy: "
               for i in range(len(texts))]
        args = (ctx, texts)
    got = getattr(tscoring, fn)(teng, *args)
    want = getattr(jscoring, fn)(jeng, *args)
    assert len(got.token_counts) == len(texts)
    assert_scores_equal(got, want)


@pytest.mark.parametrize("name", ["tiny-test", STUDY])
def test_left_truncation_past_max_seq_len_matches_the_reference(name, caplog):
    jeng, teng = _engines(name)
    max_len = teng.config.max_seq_len
    prompt = "Q" * 40 + ": "
    conts = ["ok", "x" * (max_len + 50), "y " * (max_len // 2 + 30)]
    got = tscoring.score_continuations(teng, prompt, conts)
    assert "left-truncating" in caplog.text
    assert_scores_equal(got, jscoring.score_continuations(jeng, prompt, conts))
    # the truncated rows lose the prompt first: every kept token past the
    # first is scored
    tok = teng.tokenizer
    for i in (1, 2):
        assert got.token_counts[i] == min(len(tok.encode(prompt + conts[i])), max_len) - 1


def test_chain_rule_decomposition():
    """As the reference's test: with the byte tokenizer, log p(prompt + c) =
    log p(prompt) + log p(c | prompt) per row, up to float32 re-accumulation
    across two forwards (the reference's 5e-3), and the continuation's token
    count is the full text's less the prompt's."""
    _, engine = _engines("tiny-test")
    prompt = "Query: best films\nA highly relevant result: "
    conts = ["Alpha Movie (1990)", "A Much Longer Movie Title (2001)", "Z"]
    full = tscoring.score_texts(engine, [prompt + c for c in conts])
    prefix = tscoring.score_texts(engine, [prompt])
    cond = tscoring.score_continuations(engine, prompt, conts)
    np.testing.assert_allclose(cond.log_likelihoods + prefix.log_likelihoods[0],
                               full.log_likelihoods, atol=5e-3)
    assert (cond.token_counts == full.token_counts - prefix.token_counts[0]).all()


@pytest.mark.parametrize("budget,forwards", [(1.0, 4), (1.2e7, 2)])
def test_chunked_scoring_equals_unchunked(budget, forwards, monkeypatch):
    """A small ``LOGITS_BUDGET_BYTES`` halves the 31 rows (one truncated)
    into several forwards: at 1.0 down to chunks of at most 8 rows (4
    forwards), at 1.2e7 once (the whole batch's logits, 32 x 256 x 512 x 4
    bytes, pass it; each half's do not). The values are the unchunked ones,
    and the reference's under the same budget."""
    jeng, teng = _engines("tiny-test")
    prompt = "P" * 30 + ": "
    conts = [f"doc {i} " + "y" * (7 * i) for i in range(30)]
    conts.append("z" * (teng.config.max_seq_len + 40))
    whole = tscoring.score_continuations(teng, prompt, conts)
    calls = []
    forward = tscoring._forward
    monkeypatch.setattr(tscoring, "_forward", lambda e, t, *a: calls.append(t.shape)
                        or forward(e, t, *a))
    monkeypatch.setattr(tscoring, "LOGITS_BUDGET_BYTES", budget)
    monkeypatch.setattr(jscoring, "LOGITS_BUDGET_BYTES", budget)
    chunked = tscoring.score_continuations(teng, prompt, conts)
    assert len(calls) == forwards, calls
    np.testing.assert_array_equal(chunked.token_counts, whole.token_counts)
    np.testing.assert_allclose(chunked.log_likelihoods, whole.log_likelihoods,
                               rtol=LL_RTOL, atol=LL_ATOL)
    assert_scores_equal(chunked, jscoring.score_continuations(jeng, prompt, conts))


def test_bucket_rows_with_no_valid_token_change_nothing():
    """Three rows bucket to a batch of 8: five rows hold no valid token, so
    K1 gets lengths 0 for them. The forward stays finite, those rows score
    nothing, and each real row scores as it does alone."""
    _, teng = _engines("tiny-test")
    texts = ["Toy Story (1995)", "Heat", "American Beauty (1999) and more"]
    tb = teng.tokenizer.encode_batch(texts)
    s = 64
    tokens = torch.zeros(8, s, dtype=torch.long)
    valid = torch.zeros(8, s, dtype=torch.bool)
    tokens[:3, s - tb.tokens.shape[1]:] = torch.from_numpy(tb.tokens)
    valid[:3, s - tb.tokens.shape[1]:] = torch.from_numpy(tb.valid)
    lengths = []

    inner = fm.flash_attention

    def spy(q, k, v, lens, *a, **kw):
        lengths.append(lens.tolist())
        return inner(q, k, v, lens, *a, **kw)

    fm.flash_attention = spy
    try:
        ll, counts = tscoring._forward(teng, tokens, valid, torch.zeros(8, dtype=torch.long))
    finally:
        fm.flash_attention = inner
    assert lengths and all(row[3:] == [0] * 5 for row in lengths)
    assert torch.isfinite(ll).all()
    assert ll[3:].tolist() == [0.0] * 5 and counts[3:].tolist() == [0] * 5
    batch = tscoring.score_texts(teng, texts)
    for i, text in enumerate(texts):
        alone = tscoring.score_texts(teng, [text])
        assert alone.token_counts[0] == batch.token_counts[i] == counts[i]
        np.testing.assert_allclose(alone.log_likelihoods[0], batch.log_likelihoods[i],
                                   rtol=LL_RTOL, atol=LL_ATOL)
        np.testing.assert_allclose(float(ll[i]), batch.log_likelihoods[i], rtol=LL_RTOL,
                                   atol=LL_ATOL)


def test_perplexity_by_model_matches_the_reference():
    jeng, teng = _engines(STUDY)
    texts = TITLES + _texts(2, 5)
    got = tscoring.perplexity_by_model({"m": teng}, texts)["m"]
    want = jscoring.perplexity_by_model({"m": jeng}, texts)["m"]
    assert got == pytest.approx(want, rel=LL_RTOL)


def test_scoring_inputs_are_checked():
    _, teng = _engines("tiny-test")
    with pytest.raises(ValueError, match="align"):
        tscoring.score_prompted_continuations(teng, ["a", "b"], ["c"])
