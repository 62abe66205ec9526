"""The port's phase 3 (FACTER mitigation) against the JAX package's: the
calibration helpers, the three FACTER functions (conformal thresholds, the
conformal filter, the balanced re-rank) on seeded and generated inputs,
``run_phase3`` for all three variants on the simulated backend and, greedy,
with the model and model-conditional calibrations on the
``tiny-llama-study`` checkpoint, the committed phase-3 golden records, and
the CLI's ``--all``.

The FACTER functions must equal the reference's exactly. Fractions in the
records are held to 1e-6; ``bias_reduction_rate`` is a percentage that
divides a difference of two parities (each within 1e-6) by a bias of about
0.25, so it is held to 1e-3."""

import json
import math
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
from fairness_llm_tpu.cli import main as jcli  # noqa: E402
from fairness_llm_tpu.pipeline import backends as jbackends  # noqa: E402
from fairness_llm_tpu.pipeline import facter as jfacter  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu.pipeline import phase3 as jphase3  # noqa: E402
from fairness_llm_tpu.pipeline import prompts as jprompts  # noqa: E402
from fairness_llm_tpu.reports import figures as jfigures  # noqa: E402
from fairness_llm_tpu.runtime import scoring as jscoring  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.data import profiles as tprof  # noqa: E402
from fairness_llm_tpu_torch.pipeline import backends as tbackends  # noqa: E402
from fairness_llm_tpu_torch.pipeline import facter as tfacter  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase3 as tphase3  # noqa: E402
from fairness_llm_tpu_torch.pipeline import prompts as tprompts  # noqa: E402
from fairness_llm_tpu_torch.reports import report as treport  # noqa: E402
from fairness_llm_tpu_torch.runtime import scoring as tscoring  # noqa: E402

from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "ml-1m")
GOLDEN = ROOT / "results" / "phase3"
RATE_TOL = 1e-3
GOLDEN_ATOL = 1e-4
STUDY = "tiny-llama-study"
NEAR_TIE = 1e-5


def assert_same_phase3_record(got, want):
    got, want = _drop_times(got), _drop_times(want)
    rate_g = got["bias_reduction"].pop("bias_reduction_rate")
    rate_w = want["bias_reduction"].pop("bias_reduction_rate")
    assert rate_g == pytest.approx(rate_w, abs=RATE_TOL)
    assert_same_record(got, want)


# ---------------------------------------------------------------------------
# Prompts and calibration helpers
# ---------------------------------------------------------------------------


def _profile(mod):
    return mod.Profile(id="u1", gender="female", age="25-34", occupation="professional",
                       watched_movies=[f"Movie {i} ({1980 + i})" for i in range(8)],
                       favorite_genres=["Drama", "Comedy"])


def test_phase3_prompts_match_the_reference():
    from fairness_llm_tpu.data import profiles as jprof

    p, jp = _profile(tprof), _profile(jprof)
    for anonymize in (False, True):
        base = tprompts.recommendation_prompt(p, anonymize=anonymize)
        assert base == jprompts.recommendation_prompt(jp, anonymize=anonymize)
        for strategy in ("demographic_parity", "equal_opportunity", "individual_fairness",
                         "unknown"):
            for aggressive in (False, True):
                assert tprompts.fairness_aware_prompt(base, strategy, aggressive) == \
                    jprompts.fairness_aware_prompt(base, strategy, aggressive)
    for n in (0, 3, 5, 20):
        assert tprompts.calibration_context(p, n) == jprompts.calibration_context(jp, n)


@pytest.mark.parametrize("seed", [0, 5])
def test_calibration_helpers_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 11, size=9)
    for a, b in zip(tfacter.simulate_calibration(lengths, seed),
                    jfacter.simulate_calibration(lengths, seed)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    lp = np.round(rng.normal(-4, 1, size=40), 1)  # rounded: ties
    for mapping in ("percentile", "probability"):
        for temp in (0.5, 1.0, 3.0):
            np.testing.assert_array_equal(tfacter.model_confidences(lp, mapping, temp),
                                          jfacter.model_confidences(lp, mapping, temp))
    for edge in (np.zeros(0), np.full(4, -2.0), np.array([-1.0])):
        for mapping in ("percentile", "probability"):
            np.testing.assert_array_equal(tfacter.model_confidences(edge, mapping),
                                          jfacter.model_confidences(edge, mapping))
    with pytest.raises(ValueError):
        tfacter.model_confidences(lp, "probability", 0.0)
    with pytest.raises(ValueError):
        tfacter.model_confidences(lp, "rank")
    thresholds = rng.random(9).astype(np.float32)
    thresholds[:3] = [0.8, 0.85, 1.0]  # boundaries of (1 - t) / 0.05
    np.testing.assert_array_equal(tfacter.conformal_keep_counts(lengths, thresholds),
                                  jfacter.conformal_keep_counts(lengths, thresholds))


# ---------------------------------------------------------------------------
# The three FACTER functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.2])
def test_conformal_thresholds_equal_the_reference_for_every_group_size(alpha):
    """Group g holds g + 1 records (n = 1..200 in one call) and group 200
    none: every float32 quantile index ceil((n + 1)(1 - alpha)) - 1 for n up
    to 200, and the empty group's 0.5."""
    rng = np.random.default_rng(int(alpha * 100))
    groups = np.concatenate([np.full(g + 1, g, np.int32) for g in range(200)])
    perm = rng.permutation(len(groups))
    groups = groups[perm]
    scores = rng.random(len(groups)).astype(np.float32)
    scores[::7] = scores[1]  # ties
    got = tfacter.conformal_thresholds_kernel(torch.from_numpy(scores),
                                              torch.from_numpy(groups), 201, alpha=alpha)
    want = jfacter.conformal_thresholds_kernel(jnp.asarray(scores), jnp.asarray(groups), 201,
                                               alpha=alpha)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[200]) == 0.5


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 30), st.integers(1, 4), st.sampled_from([0.05, 0.1, 0.2, 0.35]),
       st.integers(0, 2**31 - 1))
def test_conformal_thresholds_equal_the_reference(n, num_groups, alpha, seed):
    rng = np.random.default_rng(seed)
    scores = rng.choice(np.array([0.0, 0.05, 0.1, 0.3], np.float32), size=n)
    groups = rng.integers(0, num_groups, size=n).astype(np.int32)
    got = tfacter.conformal_thresholds_kernel(torch.from_numpy(scores),
                                              torch.from_numpy(groups), num_groups, alpha)
    want = jfacter.conformal_thresholds_kernel(jnp.asarray(scores), jnp.asarray(groups),
                                               num_groups, alpha=alpha)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 8), st.integers(1, 12), st.integers(0, 2**31 - 1), st.integers(1, 4))
def test_conformal_filter_mask_equals_the_reference(n, k, seed, floor):
    """NaN padding (rows of every length, an empty one), confidences drawn
    from a few values (ties), thresholds on and between them."""
    rng = np.random.default_rng(seed)
    conf = rng.choice(np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32), size=(n, k))
    lengths = rng.integers(0, k + 1, size=n)
    for i, length in enumerate(lengths):
        conf[i, length:] = np.nan
    thresholds = rng.choice(np.array([0.0, 0.25, 0.4, 0.75, 1.1], np.float32), size=n)
    got = tfacter.conformal_filter_mask(torch.from_numpy(conf), torch.from_numpy(thresholds),
                                        floor)
    want = jfacter.conformal_filter_mask(jnp.asarray(conf), jnp.asarray(thresholds), floor)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_AGGRESSIVE = dict(threshold=0.3, relaxed_threshold=0.3, relax_below=0, backfill_first=True)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 8), st.integers(1, 25), st.integers(0, 2**31 - 1),
       st.sampled_from([3, 10]), st.booleans(), st.sampled_from([0, 3, 20]))
def test_balanced_rerank_equals_the_reference(n, k, v, seed, top_k, aggressive, relax_below):
    """Both orders (smart, and aggressive's backfill first), PAD slots, items
    of one group only, equal count ratios on the thresholds."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, v, size=(n, k)).astype(np.int32)
    c1 = rng.choice(np.array([0, 1, 2, 3, 4], np.float32), size=v)
    c2 = rng.choice(np.array([0, 1, 2, 5, 10], np.float32), size=v)
    kw = dict(_AGGRESSIVE) if aggressive else dict(relax_below=relax_below)
    got = tfacter.balanced_rerank_kernel(torch.from_numpy(rows), torch.from_numpy(c1),
                                         torch.from_numpy(c2), top_k=top_k, **kw)
    want = jfacter.balanced_rerank_kernel(jnp.asarray(rows), jnp.asarray(c1), jnp.asarray(c2),
                                          top_k=top_k, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _rec_groups(seed, n_groups=3, empty_group=False):
    rng = np.random.default_rng(seed)
    titles = [f"T{i}" for i in range(25)]
    out = {}
    for g in range(n_groups):
        lists = [list(rng.choice(titles, size=rng.integers(0, 12))) for _ in range(5)]
        out[f"g{g}"] = [] if (empty_group and g == 1) else lists
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smart_balance_and_blended_fairness_match_the_reference(seed):
    for groups in (_rec_groups(seed), _rec_groups(seed, 1), _rec_groups(seed, 2, True)):
        for aggressive in (False, True):
            assert tfacter.smart_balance(groups, aggressive=aggressive) == \
                jfacter.smart_balance(groups, aggressive=aggressive)
        assert tfacter.blended_group_fairness(groups) == pytest.approx(
            jfacter.blended_group_fairness(groups), abs=1e-12)


# ---------------------------------------------------------------------------
# run_phase3 as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def simulated_phase1():
    return jphase1.run_phase1(jconfig.Config(data_dir=DATA), "simulated", save=False)


@pytest.mark.parametrize("variant", ["conformal", "smart", "aggressive"])
def test_run_phase3_simulated_record_equals_the_reference(variant, simulated_phase1, tmp_path):
    kw = dict(phase1_results=simulated_phase1, model_name="simulated", variant=variant)
    got = tphase3.run_phase3(tconfig.Config(results_dir=str(tmp_path / "t"), data_dir=DATA),
                             **kw)
    want = jphase3.run_phase3(jconfig.Config(results_dir=str(tmp_path / "j"), data_dir=DATA),
                              save=False, **kw)
    assert got["metadata"]["num_profiles"] == 45
    assert_same_phase3_record(got, want)
    suffix = "" if variant == "conformal" else f"_{variant}"
    saved = json.loads((tmp_path / "t" / "phase3" / f"phase3{suffix}_results.json").read_text())
    assert_same_phase3_record(saved, want)


@pytest.mark.parametrize("variant", ["conformal", "smart", "aggressive"])
def test_run_phase3_reproduces_the_committed_record(variant, tmp_path):
    """As ``tests/test_golden_run.py`` holds the reference to its record:
    the default simulated study, phase 1 then phase 3, while the loader
    reproduces the record's corpus."""
    suffix = "" if variant == "conformal" else f"_{variant}"
    path = GOLDEN / f"phase3{suffix}_results.json"
    p1_path = ROOT / "results" / "phase1" / "phase1_results.json"
    if not (path.exists() and p1_path.exists()):
        pytest.skip("no committed golden run")
    from fairness_llm_tpu_torch.data.movielens import load_movielens
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    want_corpus = json.loads(p1_path.read_text())["metadata"].get("corpus")
    if want_corpus != load_movielens(DATA, seed=42).provenance():
        pytest.skip("corpus provenance changed; the records must be regenerated")
    golden = json.loads(path.read_text())
    config = tconfig.Config(results_dir=str(tmp_path), data_dir=DATA)
    p1 = run_phase1(config, "simulated", save=False)
    fresh = tphase3.run_phase3(config, phase1_results=p1, model_name="simulated",
                               variant=variant, save=False)
    gb, fb = golden["bias_reduction"], fresh["bias_reduction"]
    assert fb["original_fairness"] == pytest.approx(gb["original_fairness"], abs=GOLDEN_ATOL)
    assert fb["mitigated_fairness"] == pytest.approx(gb["mitigated_fairness"], abs=GOLDEN_ATOL)
    assert fb["bias_reduction_rate"] == pytest.approx(gb["bias_reduction_rate"], abs=1e-2)
    assert fresh["mitigated_recommendations"] == golden["mitigated_recommendations"]


def test_run_phase3_refuses_what_the_reference_refuses(simulated_phase1, tmp_path):
    cfg = tconfig.Config(results_dir=str(tmp_path))
    with pytest.raises(ValueError, match="variant"):
        tphase3.run_phase3(cfg, simulated_phase1, variant="other", save=False)
    with pytest.raises(ValueError, match="unknown calibration"):
        tphase3.run_phase3(cfg, simulated_phase1, calibration="other", save=False)
    with pytest.raises(ValueError, match="only to variant='conformal'"):
        tphase3.run_phase3(cfg, simulated_phase1, variant="smart", calibration="model",
                           save=False)
    for calibration in ("model", "model-conditional"):
        with pytest.raises(ValueError, match="needs an EngineBackend"):
            tphase3.run_phase3(cfg, simulated_phase1, calibration=calibration, save=False)


def test_run_phase3_without_a_record_runs_phase_1(tmp_path):
    cfg = tconfig.Config(results_dir=str(tmp_path), data_dir=DATA, profiles_per_combo=1)
    got = tphase3.run_phase3(cfg, model_name="simulated", num_profiles=1)
    assert got["metadata"]["num_profiles"] == 15
    assert (tmp_path / "phase1" / "phase1_results.json").exists()
    again = tphase3.run_phase3(cfg, model_name="simulated", save=False)  # reads it back
    assert again["mitigated_recommendations"] == got["mitigated_recommendations"]


def _greedy_config(mod, tmp, tokens=64):
    base = mod.Config()
    table = tuple((n, mod.ModelSettings(temperature=0.0, max_tokens=tokens) if n == STUDY else s)
                  for n, s in base.model_settings)
    return mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(tmp),
                      data_dir=DATA, profiles_per_combo=1, model_settings=table)


@pytest.fixture(scope="module")
def study_backends(tmp_path_factory):
    """The greedy --quick phase-1 record of tiny-llama-study (15 profiles,
    64 new tokens) from the reference, and both packages' backends."""
    d = tmp_path_factory.mktemp("p3")
    jcfg, tcfg = _greedy_config(jconfig, d / "j"), _greedy_config(tconfig, d / "t")
    jb = jbackends.backend_for(STUDY, jcfg)
    tb = tbackends.backend_for(STUDY, tcfg, device="cpu")
    p1 = jphase1.run_phase1(jcfg, STUDY, backend=jb, save=False)
    return p1, jcfg, tcfg, jb, tb


def _scoring_calls(monkeypatch, module, replay=None):
    """Wraps ``module``'s ``score_texts`` and ``score_prompted_continuations``:
    the list returned gains each call's output. With ``replay`` (outputs,
    one a call), each call returns the next of them, of as many rows,
    instead of scoring."""
    outs = []
    for fname in ("score_texts", "score_prompted_continuations"):
        def wrapped(engine, *rows, _inner=getattr(module, fname)):
            out = _inner(engine, *rows) if replay is None else replay[len(outs)]
            assert len(out.token_counts) == len(rows[-1])
            outs.append(out)
            return out

        monkeypatch.setattr(module, fname, wrapped)
    return outs


def _far_inversions(got, want):
    """The pairs of rows that ``got``'s scores rank otherwise than
    ``want``'s (stable ranks, as the percentile confidence takes them)
    though ``want``'s two scores lie more than NEAR_TIE apart."""
    def ranks(v):
        return np.argsort(np.argsort(np.asarray(v, np.float64), kind="stable"), kind="stable")

    rg, rw, w = ranks(got), ranks(want), np.asarray(want, np.float64)
    flipped = (rg[:, None] < rg[None, :]) != (rw[:, None] < rw[None, :])
    return int(np.sum(flipped & (np.abs(w[:, None] - w[None, :]) > NEAR_TIE))) // 2


def test_far_inversions_counts_only_pairs_outside_a_near_tie():
    want = np.array([0.0, 1.0, 1.0 + NEAR_TIE / 10, 3.0])
    assert _far_inversions(want, want) == 0
    assert _far_inversions(want[[0, 2, 1, 3]], want) == 0  # the near tie swapped
    assert _far_inversions(np.array([3.0, 0.0, 1.0, 2.0]), want) == 3
    assert _far_inversions(want[::-1], want) == 5  # all but the near-tied pair


@pytest.mark.parametrize("calibration", ["model", "model-conditional"])
def test_study_model_calibration_equals_the_reference(calibration, study_backends, monkeypatch):
    """Greedy conformal phase 3 on tiny-llama-study: the same fair lists and
    the same kept titles, or other kept titles only as a reordering of
    near-tied scores explains; with equal lists, the measures within the
    record tolerances."""
    p1, jcfg, tcfg, jb, tb = study_backends
    kw = dict(phase1_results=p1, model_name=STUDY, calibration=calibration, save=False)
    with monkeypatch.context() as m:
        got_scores = _scoring_calls(m, tscoring)
        got = tphase3.run_phase3(tcfg, backend=tb, **kw)
    with monkeypatch.context() as m:
        want_scores = _scoring_calls(m, jscoring)
        want = jphase3.run_phase3(jcfg, backend=jb, **kw)
    mitigated = got["mitigated_recommendations"]
    assert sum(len(v) for v in mitigated.values()) > 0
    assert len(got_scores) == len(want_scores) == 1
    if mitigated != want["mitigated_recommendations"]:
        # The port ranks no two calibration rows otherwise than the
        # reference unless the reference's scores of the two lie within
        # NEAR_TIE, and the reference given the port's scores keeps the
        # port's lists.
        assert _far_inversions(got_scores[0].mean_logprobs, want_scores[0].mean_logprobs) == 0
        with monkeypatch.context() as m:
            _scoring_calls(m, jscoring, replay=got_scores)
            again = jphase3.run_phase3(jcfg, backend=jb, **kw)
        assert again["mitigated_recommendations"] == mitigated
        return
    assert_same_phase3_record(got, want)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_all_quick_writes_the_reference_records(tmp_path, capsys):
    args = ["--all", "--quick", "--model", "simulated"]
    assert tcli.main(args + ["--device", "cpu", "--results-dir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    for title in ("PHASE 1 SUMMARY", "PHASE 2 SUMMARY", "PHASE 3 SUMMARY", "RUN COMPLETE"):
        assert title in out
    assert jcli.main(args + ["--results-dir", str(tmp_path / "j")]) == 0
    for path in ("phase1/phase1_results.json", "phase2/phase2_results.json",
                 "phase3/phase3_results.json"):
        got = json.loads((tmp_path / "t" / path).read_text())
        want = json.loads((tmp_path / "j" / path).read_text())
        if path.startswith("phase3"):
            assert_same_phase3_record(got, want)
        else:
            assert_same_record(_drop_times(got), _drop_times(want))
    report = "phase1/phase1_summary_report.txt"
    assert (tmp_path / "t" / report).read_text() == (tmp_path / "j" / report).read_text()
    # The figures (reports/figures.py): the reference's files.
    assert sorted(p.name for p in (tmp_path / "t" / "visualizations").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / "visualizations").iterdir())


@pytest.mark.parametrize("phase,flags", [
    (2, ["--models", "simulated-fair", "simulated-biased", "--corpus", "movielens",
         "--num-queries", "2"]),
    (3, ["--variant", "smart"])])
def test_cli_single_phase_matches_the_reference(phase, flags, tmp_path):
    common = ["--quick", "--seed", "3", "--data-dir", DATA]
    if phase == 3:  # phase 3 reads phase 1's saved record
        tcli.main(["--phase", "1", "--device", "cpu", "--results-dir", str(tmp_path / "t")]
                  + common)
        jcli.main(["--phase", "1", "--results-dir", str(tmp_path / "j")] + common)
    argv = ["--phase", str(phase)] + flags + common
    assert tcli.main(argv + ["--device", "cpu", "--results-dir", str(tmp_path / "t")]) == 0
    assert jcli.main(argv + ["--results-dir", str(tmp_path / "j")]) == 0
    path = "phase2/phase2_results.json" if phase == 2 else "phase3/phase3_smart_results.json"
    got = json.loads((tmp_path / "t" / path).read_text())
    want = json.loads((tmp_path / "j" / path).read_text())
    if phase == 3:
        assert_same_phase3_record(got, want)
    else:
        assert_same_record(_drop_times(got), _drop_times(want))


def test_cli_phase_flags_match_the_reference():
    for argv in ([], ["--all", "--phase", "1"], ["--phase", "4"], ["--calibration", "x"]):
        with pytest.raises(SystemExit):
            tcli.build_parser().parse_args(argv)
        with pytest.raises(SystemExit):
            jcli.build_parser().parse_args(argv)
    argv = ["--all", "--models", "a", "b", "--num-items", "7", "--corpus", "movielens",
            "--num-queries", "3", "--num-comparisons", "9", "--variant", "aggressive",
            "--strategy", "equal_opportunity", "--calibration", "model-conditional",
            "--confidence-mapping", "probability", "--confidence-temperature", "0.5"]
    got, want = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    for name in ("all", "phase", "models", "num_items", "corpus", "num_queries",
                 "num_comparisons", "variant", "strategy", "calibration",
                 "confidence_mapping", "confidence_temperature"):
        assert getattr(got, name) == getattr(want, name), name
    defaults = tcli.build_parser().parse_args(["--phase", "2"])
    jdefaults = jcli.build_parser().parse_args(["--phase", "2"])
    for name in ("num_items", "corpus", "num_queries", "num_comparisons", "variant",
                 "strategy", "calibration", "confidence_mapping", "confidence_temperature"):
        assert getattr(defaults, name) == getattr(jdefaults, name), name


def test_summary_report_matches_the_reference(simulated_phase1, tmp_path):
    got = treport.generate_summary_report(simulated_phase1, str(tmp_path / "r.txt"))
    assert got == jfigures.generate_summary_report(simulated_phase1)
    assert (tmp_path / "r.txt").read_text() == got
    assert not math.isnan(simulated_phase1["metrics"]["individual_fairness"]["score"])
