"""The port's phase 2 (cross-model ranking fairness) against the JAX
package's, module by module and as a whole: the ranking corpora, the
ranking metrics, the listwise and pairwise prompts and parsers, the
simulated backend's ranking and comparison answers, ``run_phase2`` on the
simulated backends and, greedy, on the ``tiny-llama-study`` checkpoint, and
the committed phase-2 golden records.

Metrics are held to 1e-6 (both sides compute them in float32 and sum in
their own order); the golden records to the 1e-4 that
``tests/test_golden_run.py`` holds the reference to."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.data import movielens as jml  # noqa: E402
from fairness_llm_tpu.data import ranking as jranking  # noqa: E402
from fairness_llm_tpu.metrics import ranking as jmetrics  # noqa: E402
from fairness_llm_tpu.pipeline import backends as jbackends  # noqa: E402
from fairness_llm_tpu.pipeline import parsing as jparsing  # noqa: E402
from fairness_llm_tpu.pipeline import phase2 as jphase2  # noqa: E402
from fairness_llm_tpu.pipeline import prompts as jprompts  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.data import movielens as tml  # noqa: E402
from fairness_llm_tpu_torch.data import ranking as tranking  # noqa: E402
from fairness_llm_tpu_torch.metrics import ranking as tmetrics  # noqa: E402
from fairness_llm_tpu_torch.pipeline import backends as tbackends  # noqa: E402
from fairness_llm_tpu_torch.pipeline import parsing as tparsing  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase2 as tphase2  # noqa: E402
from fairness_llm_tpu_torch.pipeline import prompts as tprompts  # noqa: E402
from fairness_llm_tpu_torch.pipeline import results as tresults  # noqa: E402
from fairness_llm_tpu_torch.runtime import scoring as tscoring  # noqa: E402

from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "ml-1m")
GOLDEN = ROOT / "results" / "phase2"
TOL = 1e-6
GOLDEN_ATOL = 1e-4
STUDY = "tiny-llama-study"
SIMULATED = ["simulated", "simulated-fair", "simulated-biased"]


# ---------------------------------------------------------------------------
# Corpora, metrics, prompts, parsers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [42, 7])
def test_ranking_corpora_match_the_reference(seed):
    for n in (0, 1, 20, 37):
        got = tranking.create_synthetic_ranking_data(n, seed=seed)
        want = jranking.create_synthetic_ranking_data(n, seed=seed)
        assert [vars(i) for i in got] == [vars(i) for i in want]
    data, jdata = tml.load_movielens(DATA, seed=seed), jml.load_movielens(DATA, seed=seed)
    for n, min_ratings in ((50, 20), (200, 20), (30, 0)):
        got = tranking.movielens_ranking_corpus(data, n, seed=seed, min_ratings=min_ratings)
        want = jranking.movielens_ranking_corpus(jdata, n, seed=seed, min_ratings=min_ratings)
        assert [vars(i) for i in got] == [vars(i) for i in want]
        assert len({i.protected_attribute for i in got}) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ndcg_kernel_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 5, 17):
        rels = rng.random(n).astype(np.float32) * (rng.random(n) < 0.7)
        ideal = np.sort(rels)[::-1].copy()
        for a, b in ((rels, ideal), (rels, np.zeros_like(ideal))):
            got = tmetrics.ndcg_kernel(torch.from_numpy(a), torch.from_numpy(b))
            want = jmetrics.ndcg_kernel(jnp.asarray(a), jnp.asarray(b))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), abs=TOL)


def test_ranking_metric_wrappers_match_the_reference():
    rng = np.random.default_rng(3)
    items = [f"i{k}" for k in range(30)]
    truth = {i: float(r) for i, r in zip(items, rng.random(30)) if r > 0.3}
    for _ in range(5):
        ranking = list(rng.permutation(items)[: rng.integers(0, 30)])
        for k in (1, 5, 10, 40):
            assert tmetrics.ndcg(ranking, truth, k) == pytest.approx(
                jmetrics.ndcg(ranking, truth, k), abs=TOL)
            p = tmetrics.precision_at_k(ranking, set(truth), k)
            r = tmetrics.recall_at_k(ranking, set(truth), k)
            assert p == jmetrics.precision_at_k(ranking, set(truth), k)
            assert r == jmetrics.recall_at_k(ranking, set(truth), k)
            assert tmetrics.f1_score(p, r) == jmetrics.f1_score(p, r)
    assert tmetrics.ndcg([], {}) == jmetrics.ndcg([], {})
    lists = [items[:5], items[3:9], []]
    for size in (0, 12, 30):
        assert tmetrics.catalog_coverage(lists, size) == jmetrics.catalog_coverage(lists, size)


def test_ranking_prompts_match_the_reference():
    items = tranking.create_synthetic_ranking_data(7)
    jitems = jranking.create_synthetic_ranking_data(7)
    for q in (None, "the best drama movies"):
        assert tprompts.listwise_prompt(items, q) == jprompts.listwise_prompt(jitems, q)
        assert tprompts.pairwise_prompt(items[1], items[4], q) == \
            jprompts.pairwise_prompt(jitems[1], jitems[4], q)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(list("0123456789,; \n\tAB ab²①x-.")), max_size=60),
       st.integers(0, 12))
def test_ranking_parsers_match_the_reference(text, n):
    assert tparsing.parse_ranking_indices_with_count(text, n) == \
        jparsing.parse_ranking_indices_with_count(text, n)
    assert tparsing.parse_ranking_indices(text, n) == jparsing.parse_ranking_indices(text, n)
    assert tparsing.parse_pairwise_answer_full(text) == jparsing.parse_pairwise_answer_full(text)
    assert tparsing.parse_pairwise_answer(text) == jparsing.parse_pairwise_answer(text)
    assert tparsing.parse_comma_list(text, max(n, 1)) == jparsing.parse_comma_list(text, max(n, 1))


@pytest.mark.parametrize("corpus", ["synthetic", "movielens"])
def test_make_queries_match_the_reference(corpus):
    items = tphase2.build_corpus(tconfig.Config(data_dir=DATA), corpus, 40)
    jitems = jphase2.build_corpus(jconfig.Config(data_dir=DATA), corpus, 40)
    for n in (1, 3, 8, 60):
        assert tphase2.make_queries(items, n) == jphase2.make_queries(jitems, n)
    for q in (None, "x"):
        assert tphase2.scored_ranking_prompt(q) == jphase2.scored_ranking_prompt(q)


# ---------------------------------------------------------------------------
# The simulated backend's ranking and comparison answers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouped", [False, True])
def test_simulated_rankings_and_comparisons_match_the_reference(grouped):
    items = tranking.create_synthetic_ranking_data(12, seed=5)
    jitems = jranking.create_synthetic_ranking_data(12, seed=5)
    catalog = [it.text for it in items]
    groups = [it.protected_attribute for it in items] if grouped else None
    prompts = [tprompts.listwise_prompt(items), tprompts.listwise_prompt(items[:5], "x"),
               tprompts.pairwise_prompt(items[0], items[3]),
               tprompts.pairwise_prompt(items[2], items[7], "most useful"),
               tprompts.recommendation_prompt(_profile()), "no shape at all"]
    for name, bias in tbackends.SIMULATED_VARIANTS.items():
        got = tbackends.SimulatedRecommender(catalog, seed=3, bias=bias, name=name,
                                             catalog_groups=groups)
        want = jbackends.SimulatedRecommender([it.text for it in jitems], seed=3, bias=bias,
                                              name=name, catalog_groups=groups)
        for seed in (0, 9):
            assert got.generate(prompts, seed=seed) == want.generate(prompts, seed=seed)
            keys = [f"k{i}" for i in range(len(prompts))]
            assert got.generate(prompts, seed=seed, keys=keys) == \
                want.generate(prompts, seed=seed, keys=keys)


def _profile():
    from fairness_llm_tpu_torch.data.profiles import Profile

    return Profile(id="u", gender="female", age="25-34", occupation="professional",
                   watched_movies=["A (1990)", "B (1991)"], favorite_genres=["Drama"])


def test_simulated_duplicate_titles_warn_and_groups_must_align(caplog):
    with pytest.raises(ValueError, match="align"):
        tbackends.SimulatedRecommender(["a", "b"], catalog_groups=["x"])
    tbackends.SimulatedRecommender(["a", "a ", "b"], catalog_groups=["x", "y", "x"])
    assert "duplicate catalog title 'a'" in caplog.text
    sim = tbackends.backend_for("simulated-biased", tconfig.Config(), catalog=["a", "b"],
                                catalog_groups=["x", "y"])
    assert sim._preferred == "x" and sim.bias == 0.9


# ---------------------------------------------------------------------------
# run_phase2 as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_queries", [1, 3])
@pytest.mark.parametrize("corpus", ["synthetic", "movielens"])
def test_run_phase2_simulated_record_equals_the_reference(corpus, num_queries, tmp_path):
    kw = dict(models=SIMULATED, corpus=corpus, num_queries=num_queries)
    got = tphase2.run_phase2(tconfig.Config(results_dir=str(tmp_path / "t"), data_dir=DATA),
                             **kw)
    want = jphase2.run_phase2(jconfig.Config(results_dir=str(tmp_path / "j"), data_dir=DATA),
                              save=False, **kw)
    assert got["metadata"]["models"] == SIMULATED
    assert_same_record(_drop_times(got), _drop_times(want))
    saved = tresults.load_results(str(tmp_path / "t" / "phase2" / "phase2_results.json"))
    assert_same_record(_drop_times(saved), _drop_times(want))


def _golden(name: str):
    path = GOLDEN / name
    if not path.exists():
        pytest.skip("no committed golden record")
    golden = json.loads(path.read_text())
    prov = golden["metadata"].get("corpus_provenance")
    if golden["metadata"]["corpus"] == "movielens":
        # compared only while the loader reproduces the record's corpus, as
        # tests/test_golden_run.py does
        have = tml.load_movielens(DATA, seed=42).provenance()
        if prov != have:
            pytest.skip(f"corpus provenance changed (record {prov} vs current {have})")
    return golden


@pytest.mark.parametrize("name", ["phase2_results.json", "phase2_movielens_results.json"])
def test_run_phase2_reproduces_the_committed_record(name, tmp_path):
    golden = _golden(name)
    md = golden["metadata"]
    fresh = tphase2.run_phase2(
        tconfig.Config(results_dir=str(tmp_path), data_dir=DATA), models=md["models"],
        corpus=md["corpus"], num_items=md["num_items"], num_queries=md["num_queries"],
        num_comparisons=md["num_comparisons"], save=False)
    g, f = golden["comparison"]["model_fairness"], fresh["comparison"]["model_fairness"]
    for model in g:
        for key in ("listwise_fairness", "pairwise_fairness", "average_fairness"):
            assert f[model][key] == pytest.approx(g[model][key], abs=GOLDEN_ATOL), (model, key)
    for model in g:
        assert fresh["model_results"][model]["listwise"]["ranking"] == \
            golden["model_results"][model]["listwise"]["ranking"]
    if len(g) == 3:
        lw = {m: f[m]["listwise_fairness"] for m in f}
        assert lw["simulated-fair"] > lw["simulated"] > lw["simulated-biased"]


class _Recording:
    """A backend that records every generate call's texts."""

    def __init__(self, backend):
        self.inner, self.name, self.engine = backend, backend.name, backend.engine
        self.texts = []

    def generate(self, prompts, settings=None, seed=0, keys=None, prefix_ids=None):
        out = self.inner.generate(prompts, settings, seed=seed, keys=keys, prefix_ids=prefix_ids)
        self.texts.append(out)
        return out


def _greedy_config(mod, tmp, tokens=32):
    base = mod.Config()
    table = tuple((n, mod.ModelSettings(temperature=0.0, max_tokens=tokens) if n == STUDY else s)
                  for n, s in base.model_settings)
    return mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(tmp),
                      model_settings=table)


@pytest.fixture(scope="module")
def study_runs(tmp_path_factory):
    """Greedy run_phase2 on tiny-llama-study (10 synthetic items, 2 listwise
    queries, 6 comparisons, 32 new tokens): the reference once, the port on
    the CPU, each through a recording backend."""
    d = tmp_path_factory.mktemp("p2")
    jcfg, tcfg = _greedy_config(jconfig, d / "j"), _greedy_config(tconfig, d / "t")
    jb = _Recording(jbackends.backend_for(STUDY, jcfg))
    tb = _Recording(tbackends.backend_for(STUDY, tcfg, device="cpu"))
    kw = dict(models=[STUDY], num_items=10, num_comparisons=6, num_queries=2)
    want = jphase2.run_phase2(jcfg, backends={STUDY: jb}, save=False, **kw)
    got = tphase2.run_phase2(tcfg, backends={STUDY: tb}, **kw)
    return got, want, tb, jb, tcfg


def test_study_listwise_and_pairwise_texts_equal_the_reference(study_runs):
    got, want, tb, jb, _ = study_runs
    assert len(tb.texts) == 2 and [len(t) for t in tb.texts] == [2, 6]
    assert tb.texts == jb.texts
    g, w = got["model_results"][STUDY], want["model_results"][STUDY]
    for key in ("listwise", "pairwise", "parse_failures"):
        assert_same_record(g[key], w[key])


def test_study_perplexity_and_scored_ranking_equal_the_reference(study_runs):
    got, want, tb, _, tcfg = study_runs
    g, w = got["model_results"][STUDY], want["model_results"][STUDY]
    assert g["corpus_perplexity"] == pytest.approx(w["corpus_perplexity"], rel=1e-5)
    items = tphase2.build_corpus(tcfg, "synthetic", 10)
    queries = tphase2.make_queries(items, 2)
    for q, gq, wq in zip(queries, g["scored"]["per_query"], w["scored"]["per_query"]):
        sc = tscoring.score_continuations(tb.engine, tphase2.scored_ranking_prompt(q),
                                          [it.text for it in items])
        score_of = dict(zip((it.id for it in items), sc.mean_logprobs))
        assert_same_order_up_to_near_ties(gq["ranking"], wq["ranking"], score_of)
    if g["scored"]["ranking"] == w["scored"]["ranking"]:
        assert_same_record(g["scored"], w["scored"])
    assert "scored_fairness" in got["comparison"]["model_fairness"][STUDY]


NEAR_TIE = 1e-5


def assert_same_order_up_to_near_ties(got, want, score_of):
    """Two rankings by score: equal where every gap between neighbouring
    scores exceeds NEAR_TIE; otherwise the k-th score of each within NEAR_TIE
    of the other's, so they differ only by swaps inside near ties."""
    assert sorted(got) == sorted(want)
    scores = [score_of[i] for i in want]
    if all(abs(a - b) > NEAR_TIE for a, b in zip(scores, scores[1:])):
        assert got == want
    for a, b in zip(got, want):
        assert abs(score_of[a] - score_of[b]) <= NEAR_TIE, (a, b)


def test_failed_decode_raises_out_of_run_phase2(tmp_path):
    class Broken:
        name = "broken"

        def generate(self, *a, **k):
            raise RuntimeError("kernel fault")

    with pytest.raises(RuntimeError, match="kernel fault"):
        tphase2.run_phase2(tconfig.Config(results_dir=str(tmp_path)), models=["broken"],
                           backends={"broken": Broken()}, save=False)
    with pytest.raises(ValueError, match="unknown corpus"):
        tphase2.build_corpus(tconfig.Config(), "other")
