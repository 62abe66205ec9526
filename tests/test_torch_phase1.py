"""The port's phase-1 sweep against the JAX package's, module by module and
as a whole: MovieLens loading and the profile grid, the five fairness
kernels and their wrappers, the results writer, ``run_phase1`` on the
simulated backend and on the ``tiny-llama-study`` checkpoint, and the CLI.

Floats are held to 1e-6: both sides compute the metrics in float32 and sum
in their own order."""

import dataclasses
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

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.cli import main as jcli  # noqa: E402
from fairness_llm_tpu.data import movielens as jml  # noqa: E402
from fairness_llm_tpu.data import profiles as jprof  # noqa: E402
from fairness_llm_tpu.metrics import divergence as jdiv  # noqa: E402
from fairness_llm_tpu.metrics import fairness as jfair  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu.pipeline import prompts as jprompts  # noqa: E402
from fairness_llm_tpu.pipeline import results as jresults  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.data import movielens as tml  # noqa: E402
from fairness_llm_tpu_torch.data import profiles as tprof  # noqa: E402
from fairness_llm_tpu_torch.metrics import divergence as tdiv  # noqa: E402
from fairness_llm_tpu_torch.metrics import fairness as tfair  # noqa: E402
from fairness_llm_tpu_torch.pipeline import backends as tbackends  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase1 as tphase1  # noqa: E402
from fairness_llm_tpu_torch.pipeline import prompts as tprompts  # noqa: E402
from fairness_llm_tpu_torch.pipeline import results as tresults  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "ml-1m")
TOL = 1e-6


def assert_same_record(got, want, path="", tol=TOL):
    """Equal structure and values, floats within ``tol`` (NaN equals NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, got, want)
        for k in want:
            assert_same_record(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_record(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (float, int)), (path, got, want)
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _drop_times(record):
    record = json.loads(json.dumps(record))
    record["metadata"].pop("timestamp")
    record["metadata"].pop("elapsed_seconds")
    return record


# ---------------------------------------------------------------------------
# Data and profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["real-catalog", "synthetic"])
def test_load_movielens_matches_the_reference(mode, tmp_path):
    data_dir = DATA if mode == "real-catalog" else str(tmp_path)
    got, want = tml.load_movielens(data_dir, seed=7), jml.load_movielens(data_dir, seed=7)
    assert got.source == want.source and got.synthetic == want.synthetic
    assert got.provenance() == want.provenance()
    assert got.titles == want.titles and got.genres == want.genres
    for field in ("movie_ids", "rating_user_ids", "rating_movie_ids", "rating_values"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if mode == "real-catalog":
        assert got.source == "real-catalog+synthetic-ratings" and got.num_movies == 3883


def test_ratings_parse_matches_the_reference(tmp_path):
    (tmp_path / "movies.dat").write_text("1::Toy Story (1995)::Animation|Comedy\n"
                                         "2::Zoë (2001)::Drama\n", encoding="latin-1")
    (tmp_path / "ratings.dat").write_text("1::1::5::978300760\n2::2::3::978302109\n"
                                          "2::1::4::978301968\n", encoding="latin-1")
    got, want = tml.load_movielens(str(tmp_path)), jml.load_movielens(str(tmp_path))
    assert got.source == want.source == "real" and got.titles == want.titles
    for field in ("rating_user_ids", "rating_movie_ids", "rating_values"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("seed", [42, 3])
def test_profile_grid_and_pairs_match_the_reference(seed):
    data = tml.load_movielens(DATA, seed=seed)
    jdata = jml.load_movielens(DATA, seed=seed)
    base = tprof.create_base_preferences(data, seed=seed)
    assert base == jprof.create_base_preferences(jdata, seed=seed)
    for per_combo in (None, 1):
        got = tprof.create_profile_grid(base, tconfig.Config(), per_combo)
        want = jprof.create_profile_grid(base, jconfig.Config(), per_combo)
        assert [p.to_dict() for p in got] == [p.to_dict() for p in want]
        assert tprof.profile_pairs(got) == jprof.profile_pairs(want)
        assert tprof.profile_pairs(got, "age") == jprof.profile_pairs(want, "age")
    assert len(tprof.create_profile_grid(base, tconfig.Config())) == 45


def test_config_matches_the_reference(monkeypatch):
    monkeypatch.setenv("FAIRNESS_TPU_SEED", "9")
    monkeypatch.setenv("FAIRNESS_TPU_RESULTS_DIR", "/tmp/r")
    got, want = tconfig.default_config(), jconfig.default_config()
    for field in ("random_seed", "results_dir", "data_dir", "genders", "age_groups",
                  "occupation", "profiles_per_combo", "default_model_phase1",
                  "decode_batch_size", "max_prompt_len", "max_new_tokens", "weights_dir",
                  "weight_quant", "checkpoint_every"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.integrity.verify_manifests == want.integrity.verify_manifests
    for name, _ in want.model_settings:
        for cap in (512, 32):
            a = dataclasses.replace(got, max_new_tokens=cap).settings_for(name)
            b = dataclasses.replace(want, max_new_tokens=cap).settings_for(name)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(KeyError):
        got.settings_for("llama3-8b-int8")


def test_prompt_divergence_matches_the_reference():
    data = tml.load_movielens(DATA)
    profiles = tprof.create_profile_grid(tprof.create_base_preferences(data), tconfig.Config())
    pairs = [(tprompts.recommendation_prompt(profiles[a]), tprompts.recommendation_prompt(profiles[b]))
             for a, b in ((0, 1), (0, 3), (2, 40))]
    assert tprompts.check_late_divergence(pairs) == jprompts.check_late_divergence(pairs)
    assert tprompts.divergence_stats([]) == jprompts.divergence_stats([])
    for a, b in (("abc", "abd"), ("", "x"), ("same", "same")):
        assert tprompts.lcp_len(a, b) == jprompts.lcp_len(a, b)


# ---------------------------------------------------------------------------
# Metric kernels and wrappers
# ---------------------------------------------------------------------------


def _kernel_inputs(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind in ("dp", "eo"):
        counts = rng.integers(0, 4, size=(5, 60)).astype(np.float32)
        counts[rng.integers(0, 5)] = 0  # an empty group
        if kind == "dp":
            return (counts,)
        return counts, rng.random(60) < 0.3
    if kind == "jaccard":
        mem = rng.random((12, 40)) < 0.25
        mem[3] = False
        return mem, rng.integers(0, 12, size=(30, 2)).astype(np.int32)
    if kind == "exposure":
        return rng.integers(-1, 4, size=37).astype(np.int32), 5
    mem = rng.random((4, 50)) < 0.3
    return mem[0], mem[1:]


_KERNELS = {
    "dp": (jfair.demographic_parity_kernel, tfair.demographic_parity_kernel),
    "jaccard": (jfair.jaccard_pairs_kernel, tfair.jaccard_pairs_kernel),
    "eo": (jfair.equal_opportunity_kernel, tfair.equal_opportunity_kernel),
    "exposure": (jfair.exposure_ratio_kernel, tfair.exposure_ratio_kernel),
    "snsr": (jfair.snsr_snsv_kernel, tfair.snsr_snsv_kernel),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(_KERNELS))
def test_metric_kernel_matches_the_reference(kind, seed):
    jfn, tfn = _KERNELS[kind]
    args = _kernel_inputs(kind, seed)
    want = jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = tfn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_divergence_functions_match_the_reference():
    rng = np.random.default_rng(5)
    p = rng.integers(0, 5, size=30).astype(np.float32)
    q = rng.integers(0, 5, size=30).astype(np.float32)
    np.testing.assert_allclose(tdiv.js_distance(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
                               np.asarray(jdiv.js_distance(jnp.asarray(p), jnp.asarray(q))),
                               atol=TOL)
    pp, qq = p + 0.5, q + 0.5
    np.testing.assert_allclose(
        tdiv.kl_divergence(torch.from_numpy(pp), torch.from_numpy(qq)).numpy(),
        np.asarray(jdiv.kl_divergence(jnp.asarray(pp), jnp.asarray(qq))), atol=TOL)
    g = np.stack([p, q, p + q])
    np.testing.assert_allclose(tdiv.pairwise_js_matrix(torch.from_numpy(g)).numpy(),
                               np.asarray(jdiv.pairwise_js_matrix(jnp.asarray(g))), atol=TOL)


def _rec_groups(seed: int, groups=("male", "female", "non-binary"), empty=True):
    rng = np.random.default_rng(seed)
    titles = [f"Movie {i} ({1950 + i})" for i in range(40)]
    out = {}
    for gi, g in enumerate(groups):
        out[g] = [list(rng.choice(titles, size=rng.integers(0 if empty else 1, 8)))
                  for _ in range(4)]
    return out, titles


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_wrappers_match_the_reference(seed):
    groups, titles = _rec_groups(seed)
    assert_same_record(list(tfair.demographic_parity(groups)), list(jfair.demographic_parity(groups)))
    relevant = set(titles[::3])
    assert_same_record(list(tfair.equal_opportunity(groups, relevant)),
                       list(jfair.equal_opportunity(groups, relevant)))
    recs = {f"u{i}": r for i, r in enumerate(r for lists in groups.values() for r in lists)}
    pairs = [(f"u{i}", f"u{j}") for i in range(12) for j in range(i + 1, 12) if (i + j) % 3 == 0]
    assert_same_record(list(tfair.individual_fairness(pairs, recs)),
                       list(jfair.individual_fairness(pairs, recs)))
    ranked = [g for g in np.random.default_rng(seed).choice(["a", "b", "c", "zz"], size=20)]
    assert_same_record(list(tfair.exposure_ratio(ranked, ["a", "b", "c"])),
                       list(jfair.exposure_ratio(ranked, ["a", "b", "c"])))
    flat = {g: [t for lst in lists for t in lst] for g, lists in groups.items()}
    assert_same_record(list(tfair.snsr_snsv(titles[:10], flat)),
                       list(jfair.snsr_snsv(titles[:10], flat)))
    # the degenerate inputs
    assert_same_record(list(tfair.demographic_parity({})), list(jfair.demographic_parity({})))
    assert_same_record(list(tfair.equal_opportunity({}, relevant)),
                       list(jfair.equal_opportunity({}, relevant)))
    assert_same_record(list(tfair.snsr_snsv([], {})), list(jfair.snsr_snsv([], {})))
    assert_same_record(list(tfair.exposure_ratio([])), list(jfair.exposure_ratio([])))


def test_metric_golden_replay_matches_the_reference(reference_phase1_results):
    """The replay ``tests/test_metrics_golden.py`` makes of the original
    study's saved recommendations, through both packages."""
    res = reference_phase1_results
    recs = res["recommendations"]
    for attr in ("gender", "age"):
        grouped = {}
        for prof in res["profiles"]:
            r = recs.get(prof["id"], {}).get("recommendations", [])
            if r:
                grouped.setdefault(prof[attr], []).append(r)
        assert_same_record(list(tfair.demographic_parity(grouped)),
                           list(jfair.demographic_parity(grouped)))
        qualified = {"The Shawshank Redemption", "The Godfather", "The Matrix"}
        assert_same_record(list(tfair.equal_opportunity(grouped, qualified)),
                           list(jfair.equal_opportunity(grouped, qualified)))
    profiles = [tprof.Profile(id=p["id"], gender=p["gender"], age=p["age"],
                              occupation=p["occupation"],
                              watched_movies=p["preferences"]["watched_movies"],
                              favorite_genres=p["preferences"]["favorite_genres"])
                for p in res["profiles"]]
    flat = {pid: r["recommendations"] for pid, r in recs.items() if "recommendations" in r}
    pairs = tprof.profile_pairs(profiles)
    assert_same_record(list(tfair.individual_fairness(pairs, flat)),
                       list(jfair.individual_fairness(pairs, flat)))


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


def test_results_writer_matches_the_reference(tmp_path):
    record = {"metadata": {"phase": 1}, "metrics": {"x": float("nan"), "y": [1.5, float("inf")]},
              "recommendations": {"u": {"recommendations": ["A"], "raw_response": "1. A"}}}
    tresults.save_results(record, str(tmp_path / "t" / "r.json"))
    jresults.save_results(record, str(tmp_path / "j" / "r.json"))
    got = tresults.load_results(str(tmp_path / "t" / "r.json"))
    assert got == jresults.load_results(str(tmp_path / "j" / "r.json"))
    assert got["metadata"]["sanitized_non_finite"] == ["metrics.x", "metrics.y[1]"]
    assert math.isnan(record["metrics"]["x"])  # the caller's dict is untouched
    for d in ("t", "j"):
        manifest = json.loads((tmp_path / d / "manifest.json").read_text())
        assert list(manifest["files"]) == ["r.json"]
    assert tresults.load_results(str(tmp_path / "none.json")) is None


def test_resume_skips_a_corrupt_checkpoint(tmp_path):
    d = str(tmp_path)
    tresults.save_checkpoint({"u1": {"recommendations": ["A"], "raw_response": "1. A"}}, d,
                             "phase1", 1)
    tresults.save_checkpoint({"u1": {"recommendations": ["A"], "raw_response": "1. A"},
                              "u2": {"recommendations": [], "raw_response": ""}}, d, "phase1", 2)
    assert tresults.checkpoint_path(d, "phase1", 2) == jresults.checkpoint_path(d, "phase1", 2)
    assert sorted(tresults.load_latest_checkpoint(d, "phase1")) == ["u1", "u2"]
    newest = pathlib.Path(tresults.checkpoint_path(d, "phase1", 2))
    newest.write_text(newest.read_text().replace('"1. A"', '"1. B"'))  # valid JSON, wrong bytes
    assert sorted(tresults.load_latest_checkpoint(d, "phase1")) == ["u1"]
    assert sorted(jresults.load_latest_checkpoint(d, "phase1")) == ["u1"]


# ---------------------------------------------------------------------------
# The sweep as a whole
# ---------------------------------------------------------------------------


def test_run_phase1_simulated_record_equals_the_reference(tmp_path):
    got = tphase1.run_phase1(tconfig.Config(results_dir=str(tmp_path / "t")), "simulated")
    want = jphase1.run_phase1(jconfig.Config(results_dir=str(tmp_path / "j")), "simulated")
    assert got["metadata"]["num_profiles"] == 45
    assert_same_record(_drop_times(got), _drop_times(want))
    saved = tresults.load_results(str(tmp_path / "t" / "phase1" / "phase1_results.json"))
    assert_same_record(_drop_times(saved), _drop_times(want))


def test_run_phase1_resume_reuses_the_checkpoints(tmp_path):
    cfg = tconfig.Config(results_dir=str(tmp_path), checkpoint_every=4, decode_batch_size=4)
    first = tphase1.run_phase1(cfg, "simulated", num_profiles=1)

    class Refuse:
        name = "simulated"

        def generate(self, *a, **k):
            raise AssertionError("a resumed sweep with every profile done decodes nothing")

    again = tphase1.run_phase1(cfg, "simulated", num_profiles=1, backend=Refuse(), resume=True,
                               save=False)
    assert again["recommendations"] == first["recommendations"]
    assert again["metrics"] == first["metrics"]


def _greedy_settings(base, settings_cls, name, tokens):
    return tuple((n, settings_cls(temperature=0.0, max_tokens=tokens) if n == name else s)
                 for n, s in base.model_settings)


STUDY_MODEL = "tiny-llama-study"


@pytest.fixture(scope="module")
def llama_sweeps(tmp_path_factory):
    """The greedy --quick sweep (15 profiles and 1 neutral prompt, 32 new
    tokens) on the study checkpoint: the reference once, and the port on the
    CPU."""
    d = tmp_path_factory.mktemp("sweeps")

    def cfg(mod):
        return mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(d / mod.__name__),
                          profiles_per_combo=1,
                          model_settings=_greedy_settings(mod.Config(), mod.ModelSettings,
                                                          STUDY_MODEL, 32))

    want = jphase1.run_phase1(cfg(jconfig), STUDY_MODEL)
    backend = tbackends.backend_for(STUDY_MODEL, cfg(tconfig), device="cpu")
    got = tphase1.run_phase1(cfg(tconfig), STUDY_MODEL, backend=backend)
    return got, want, backend


def test_study_sweep_raw_responses_equal_the_reference(llama_sweeps):
    got, want, backend = llama_sweeps
    assert type(backend.engine.tokenizer).__name__ == "HFTokenizer"
    assert got["metadata"]["num_profiles"] == 15
    raw = {k: v["raw_response"] for k, v in got["recommendations"].items()}
    assert raw == {k: v["raw_response"] for k, v in want["recommendations"].items()}
    assert len(raw) == 15 and sum(bool(v["recommendations"])
                                  for v in got["recommendations"].values()) > 0
    assert got["neutral_recommendations"] == want["neutral_recommendations"]


def test_study_sweep_metrics_equal_the_reference(llama_sweeps):
    got, want, _ = llama_sweeps
    assert_same_record(got["metrics"], want["metrics"])
    assert_same_record(_drop_times(got)["metadata"], _drop_times(want)["metadata"])


def test_cli_record_equals_the_reference_cli(tmp_path, capsys):
    args = ["--phase", "1", "--quick", "--model", "simulated"]
    assert tcli.main(args + ["--device", "cpu", "--results-dir", str(tmp_path / "t")]) == 0
    assert jcli.main(args + ["--results-dir", str(tmp_path / "j")]) == 0
    path = pathlib.Path("phase1") / "phase1_results.json"
    got = json.loads((tmp_path / "t" / path).read_text())
    want = json.loads((tmp_path / "j" / path).read_text())
    assert got["metadata"]["num_profiles"] == 15
    assert_same_record(_drop_times(got), _drop_times(want))
    assert "PHASE 1 SUMMARY" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--continuous", "--tp", "2"], ["--mesh", "tp=2"]])
def test_cli_refuses_what_is_not_ported(flags):
    """``--tp`` and tp meshes are ported; one process is refused them, as a
    world smaller than the mesh is, naming the ranks to launch."""
    with pytest.raises((SystemExit, ValueError), match="torchrun --nproc-per-node 2"):
        tcli.main(["--phase", "1", "--quick", "--no-save", "--device", "cpu", "--model",
                   "tiny-llama-study", "--weights-dir", str(ROOT / "checkpoints")] + flags)


def test_cli_checks_match_the_reference():
    for argv in (["--max-new-tokens", "0"], ["--draft-len", "4"], ["--speculate", "--draft-len", "0"]):
        with pytest.raises(SystemExit):
            tcli.config_from_args(tcli.build_parser().parse_args(["--phase", "1"] + argv))
        with pytest.raises(SystemExit):
            jcli.config_from_args(jcli.build_parser().parse_args(["--phase", "1"] + argv))
    args = ["--phase", "1", "--quick", "--weight-quant", "int8", "--speculate", "--draft-len", "4",
            "--no-verify-manifests", "--seed", "3", "--max-new-tokens", "16"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args))
    want = jcli.config_from_args(jcli.build_parser().parse_args(args))
    for field in ("profiles_per_combo", "weight_quant", "random_seed", "max_new_tokens"):
        assert getattr(got, field) == getattr(want, field)
    assert dataclasses.asdict(got.speculation) == dataclasses.asdict(want.speculation)
    assert got.integrity.verify_manifests is want.integrity.verify_manifests is False


def test_backend_for_needs_weights_or_allow_random(tmp_path):
    cfg = tconfig.Config(weights_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="tiny-test"):
        tbackends.backend_for("tiny-test", cfg, device="cpu")
    b = tbackends.backend_for("tiny-test", dataclasses.replace(cfg, weight_quant="int8"),
                              allow_random=True, device="cpu")
    assert b.engine.config.weight_quant == "int8"
    assert type(b.engine.tokenizer).__name__ == "ByteTokenizer"
    assert b.engine.config.use_decode_attention_kernel and b.engine.config.use_flash_attention
    sim = tbackends.backend_for("simulated-fair", cfg, catalog=["A", "B"])
    assert isinstance(sim, tbackends.SimulatedRecommender) and sim.bias == 0.15
