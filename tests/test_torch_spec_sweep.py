"""The study checkpoint's speculative greedy phase-1 sweep (``--speculate``)
through the port, on the CPU, against a live speculative run of the JAX
package and against the port's own greedy run without speculation.

With greedy settings every decode step of the sweep is a float32 verify
window (on the card, ``verify_split_f32``; here its plain version). The
sweep is the --quick one (15 profiles and 1 neutral prompt) at 16 new
tokens, draft 8, n-gram 3. Tolerances: tokens, responses and the
speculation counters equal; metrics within 1e-6 (float32 metrics differ
from JAX's by ~1e-7, as tests/test_torch_phase1.py holds them).
"""

import json
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch.pipeline import backends as tbackends  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase1 as tphase1  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUDY_MODEL = "tiny-llama-study"
TOKENS = 16
TOL = 1e-6


def _cfg(mod, results_dir, speculate: bool):
    settings = tuple((n, mod.ModelSettings(temperature=0.0, max_tokens=TOKENS)
                      if n == STUDY_MODEL else s) for n, s in mod.Config().model_settings)
    return mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(results_dir),
                      profiles_per_combo=1, model_settings=settings,
                      speculation=mod.SpeculationConfig(enabled=speculate, draft_len=8,
                                                        ngram_max=3))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The reference's speculative sweep, then the port's on the CPU with
    speculation and without."""
    d = tmp_path_factory.mktemp("spec_sweeps")
    want = jphase1.run_phase1(_cfg(jconfig, d / "jax", True), STUDY_MODEL)
    out = {}
    for speculate in (True, False):
        cfg = _cfg(tconfig, d / f"port_{speculate}", speculate)
        backend = tbackends.backend_for(STUDY_MODEL, cfg, device="cpu")
        out[speculate] = (tphase1.run_phase1(cfg, STUDY_MODEL, backend=backend), backend)
    return want, out


def _same(got, want, path=""):
    """Equal structure and values, floats within ``TOL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _raw(record):
    return {k: v["raw_response"] for k, v in record["recommendations"].items()}


def test_speculative_sweep_took_the_verify_path(sweeps):
    """Every decode step was a verify window: speculation counters present,
    each verify step emitting at least one token a row."""
    _, out = sweeps
    record, backend = out[True]
    spec = backend.spec_totals
    assert spec is not None and spec.verify_steps > 0 and spec.drafted > 0
    assert spec.emitted >= spec.verify_steps and spec.draft_len == 8 and spec.ngram_max == 3
    assert out[False][1].spec_totals is None
    assert record["metadata"]["num_profiles"] == 15


def test_speculative_sweep_responses_equal_the_reference(sweeps):
    want, out = sweeps
    got = out[True][0]
    assert _raw(got) == _raw(want) and len(_raw(got)) == 15
    assert got["neutral_recommendations"] == want["neutral_recommendations"]
    assert {k: v["recommendations"] for k, v in got["recommendations"].items()} == \
        {k: v["recommendations"] for k, v in want["recommendations"].items()}


def test_speculative_sweep_metrics_and_counters_equal_the_reference(sweeps):
    want, out = sweeps
    got = json.loads(json.dumps(out[True][0]))
    want = json.loads(json.dumps(want))
    _same(got["metrics"], want["metrics"])
    for record in (got, want):
        record["metadata"].pop("timestamp")
        record["metadata"].pop("elapsed_seconds")
    _same(got["metadata"], want["metadata"])


def test_speculative_sweep_equals_the_plain_greedy_sweep(sweeps):
    """Speculative greedy decoding changes how many forwards a row takes,
    never its tokens: the port's sweep with speculation equals its own sweep
    without, response for response and metric for metric."""
    _, out = sweeps
    spec, plain = out[True][0], out[False][0]
    assert _raw(spec) == _raw(plain)
    assert spec["neutral_recommendations"] == plain["neutral_recommendations"]
    _same(spec["metrics"], plain["metrics"])
