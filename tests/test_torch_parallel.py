"""The port's mesh, sharding rules, multihost helpers, sharded metrics and
data-parallel engine, scoring and study against the JAX package's.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's dp=2 side runs in two gloo ranks on 127.0.0.1, spawned once for
the module (``torch_dp_worker.py``, with the environment ``torchrun``
gives a rank). The sharding functions and the single-process multihost
cases run in this process while the ranks work.
"""

import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers.
torch.set_num_threads(1)

import torch_dp_worker as W  # noqa: E402
from fairness_llm_tpu.config import Config as JConfig  # noqa: E402
from fairness_llm_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.metrics import fairness as jfair  # noqa: E402
from fairness_llm_tpu.metrics.sharded import mesh_group_counts_fn as jcounts_fn  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as jget_config  # noqa: E402
from fairness_llm_tpu.parallel import sharding as jshd  # noqa: E402
from fairness_llm_tpu.pipeline.backends import EngineBackend as JBackend  # noqa: E402
from fairness_llm_tpu.pipeline.phase1 import run_phase1 as jrun_phase1  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu.runtime.scoring import score_prompted_continuations as jscore_cont  # noqa: E402,E501
from fairness_llm_tpu.runtime.scoring import score_texts as jscore_texts  # noqa: E402
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings  # noqa: E402
from fairness_llm_tpu_torch.metrics import fairness as tfair  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.parallel import multihost  # noqa: E402
from fairness_llm_tpu_torch.parallel import sharding as shd  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine, _bucket_batch  # noqa: E402
from fairness_llm_tpu_torch.runtime.scoring import (  # noqa: E402
    score_prompted_continuations,
    score_texts,
)
from fairness_llm_tpu_torch.runtime.weights import params_from_jax  # noqa: E402
from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

CONFIGS = ["tiny-test", "llama3-8b", "llama3-8b-int8", "llama3-70b-int8"]
MESHES = [dict(dp=2), dict(tp=2), dict(dp=2, tp=4), dict(tp=8)]
MESH_IDS = ["dp2", "tp2", "dp2tp4", "tp8"]
# tests/test_torch_scoring.py's allowance against the reference.
LL_RTOL = LL_ATOL = 1e-5
METRIC_TOL = 1e-6


def _jmesh(axes):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jshd.make_mesh(JMeshConfig(**axes))


# ---------------------------------------------------------------------------
# Sharding functions (a MeshConfig stands for the mesh: no world is needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_axis_rules_and_byte_counts_equal_the_reference(name, axes):
    jmesh, mc = _jmesh(axes), MeshConfig(**axes)
    jcfg, tcfg = jget_config(name), get_model_config(name)
    assert shd.make_axis_rules(tcfg, mc) == tuple(jshd.make_axis_rules(jcfg, jmesh))
    for itemsize in (None, 2, 4):
        assert shd.per_device_param_bytes(tcfg, mc, itemsize=itemsize) == \
            jshd.per_device_param_bytes(jcfg, jmesh, itemsize=itemsize)
    for batch, max_len in ((1, 64), (12, 960), (45, 2048)):
        assert shd.per_device_kv_cache_bytes(tcfg, mc, batch, max_len) == \
            jshd.per_device_kv_cache_bytes(jcfg, jmesh, batch, max_len)


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", CONFIGS + ["tiny-gpt2", "qwen2-0.5b"])
def test_param_shardings_equal_the_reference(name, axes):
    """Every parameter's spec, by the port's name (``params_from_jax``'s flax
    path joined by dots; the port keeps the reference's [in, out] layout, so
    no spec is transposed)."""
    jmesh, mc = _jmesh(axes), MeshConfig(**axes)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            jshd.param_shardings(jget_config(name), jmesh))[0]:
        want[".".join(str(getattr(k, "key", k)) for k in path)] = tuple(sharding.spec)
    assert shd.param_shardings(get_model_config(name), mc) == want


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_kv_and_logits_shardings_equal_the_reference(name, axes):
    jmesh, mc = _jmesh(axes), MeshConfig(**axes)
    jcfg, tcfg = jget_config(name), get_model_config(name)
    assert shd.kv_heads_sharded(tcfg, mc) == jshd.kv_heads_sharded(jcfg, jmesh)
    assert shd.logits_sharding(tcfg, mc) == tuple(jshd.logits_sharding(jcfg, jmesh).spec)
    n_kv, d = tcfg.num_kv_heads, tcfg.head_dim
    shapes = {"k": (2, 16, n_kv, d), "k_scale": (2, 16, n_kv), "key_valid": (2, 16),
              "lengths": (2,), "blocks": [(5, 4, n_kv, d)]}

    def build(make):
        return {k: ([make(s) for s in v] if isinstance(v, list) else make(v))
                for k, v in shapes.items()}

    got = shd.kv_tree_shardings(tcfg, mc, build(lambda s: torch.zeros(s)))
    want = jax.tree.map(lambda ns: tuple(ns.spec), jshd.kv_tree_shardings(
        jcfg, jmesh, build(lambda s: jax.ShapeDtypeStruct(s, np.float32))))
    assert got == want


def test_shard_params_replicates_at_dp_and_refuses_tp():
    """dp replicates (the tensor itself is placed); a tp-sharded spec
    needs the rank's mesh to cut its block (tests/test_torch_tp.py runs
    it over tp ranks) and is refused without one."""
    cfg = get_model_config("tiny-test")
    params = {"w": torch.ones(2)}
    placed = shd.shard_params(params, {"w": (None,)}, "cpu")
    assert placed["w"] is params["w"]
    with pytest.raises(ValueError, match="pass the mesh"):
        shd.shard_params({"embedding": torch.ones(512, 64)},
                         shd.param_shardings(cfg, MeshConfig(tp=2)), "cpu")
    assert shd.batch_sharding(None, 8) == slice(0, 8)
    assert _bucket_batch(45) == 48 and _bucket_batch(3, MeshConfig(dp=2)) == 8
    assert _bucket_batch(9, MeshConfig(dp=3)) == 18


# ---------------------------------------------------------------------------
# Multihost, in this process (the reference's tests/test_multihost.py)
# ---------------------------------------------------------------------------


def test_initialize_distributed_is_a_noop_without_an_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.is_primary() and multihost.world_size() == 1


def test_initialize_distributed_needs_an_address_for_a_world(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize_distributed()


def test_a_mesh_bigger_than_the_world_raises():
    with pytest.raises(ValueError, match="torchrun"):
        multihost.make_multihost_mesh(MeshConfig(dp=64, tp=8))
    with pytest.raises(ValueError, match="torchrun"):
        shd.make_mesh(MeshConfig(dp=2))


# ---------------------------------------------------------------------------
# The dp=2 ranks
# ---------------------------------------------------------------------------


class Ranks:
    """The spawned ranks; the first read waits for them."""

    def __init__(self, out, procs):
        self.out, self.procs, self._res = out, procs, None

    def __getitem__(self, rank):
        if self._res is None:
            codes = [p.wait(timeout=600) for p in self.procs]
            logs = "\n".join((self.out / f"rank{r}.log").read_text()[-3000:]
                             for r in range(len(self.procs)))
            assert codes == [0, 0], logs
            self._res = [pickle.loads((self.out / f"rank{r}.pkl").read_bytes())
                         for r in range(len(self.procs))]
        return self._res[rank]


@pytest.fixture(scope="module")
def engines():
    """The reference's engine (random tiny-test weights, seed 0), its dp=2
    twin, and the port's dp=1 engine on the same weights."""
    cfg = get_model_config(W.MODEL)
    jeng = JEngine(jget_config(W.MODEL), seed=0)
    params = params_from_jax(jax.device_get(jeng.params), cfg)
    jmesh = _jmesh(dict(dp=2))
    jeng2 = JEngine(jget_config(W.MODEL), params=jeng.params, mesh=jmesh)
    return jeng, jeng2, DecodeEngine(cfg, params=params, device="cpu"), params


@pytest.fixture(scope="module")
def ranks(engines, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp2")
    torch.save(engines[3], out / "params.pt")
    procs = W.spawn(out, world=2)
    yield Ranks(out, procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_the_scheduler_refuses_a_dp_mesh_as_the_references_does(engines):
    """Serving takes no dp mesh in either package (the slot scatter is not
    dp-aware); the check reads the mesh's shape, for which a MeshConfig
    stands in here."""
    from fairness_llm_tpu.serving import ContinuousScheduler as JScheduler
    from fairness_llm_tpu_torch.serving import ContinuousScheduler

    _, jeng2, teng, _ = engines
    dp_engine = DecodeEngine(teng.config, params=teng.model.state_dict(), device="cpu")
    dp_engine.mesh = MeshConfig(dp=2)
    with pytest.raises(ValueError, match="dp/sp-aware"):
        ContinuousScheduler(dp_engine)
    with pytest.raises(ValueError, match="dp/sp-aware"):
        JScheduler(jeng2)


def test_the_ranks_form_a_dp_outer_mesh(ranks):
    for r in (0, 1):
        assert ranks[r]["initialized"] and ranks[r]["backend"] == "gloo"
        # dp outermost over the ranks in rank order: a tp line is consecutive ranks
        assert ranks[r]["mesh"] == [[[0]], [[1]]]
        assert ranks[r]["mesh_tp"] == [[[0], [1]]]


@pytest.mark.parametrize("case", range(W.NUM_COUNT_CASES))
def test_sharded_group_counts_equal_the_reference(ranks, case):
    counts, owners, groups = W.count_case(case)
    want = np.asarray(jcounts_fn(_jmesh(dict(dp=2)))(counts, owners, groups))
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["counts"][case], want)


def test_metrics_on_the_mesh_equal_the_host_path(ranks):
    groups, relevant = W.rec_groups()
    want_dp = tfair.demographic_parity(groups)
    want_eo = tfair.equal_opportunity(groups, relevant)
    assert jfair.demographic_parity(groups)[0] == pytest.approx(want_dp[0], abs=METRIC_TOL)
    for r in (0, 1):
        assert_same_record(ranks[r]["dp_on_mesh"], want_dp, tol=METRIC_TOL)
        assert_same_record(ranks[r]["eo_on_mesh"], want_eo, tol=METRIC_TOL)


@pytest.mark.parametrize("case", W.gen_cases(), ids=[c[0] for c in W.gen_cases()])
def test_dp2_engine_equals_dp1_and_the_reference(ranks, engines, case):
    """Every rank returns the whole batch; its tokens equal the port's dp=1
    engine's (sampled rows too: each row keeps its global seed) and, when
    greedy, the reference engine's on its dp=2 mesh."""
    name, prompts, temp, kw = case
    _, jeng2, teng, _ = engines
    one = teng.generate(prompts, ModelSettings(temperature=temp, max_tokens=W.GEN_TOKENS), **kw)
    for r in (0, 1):
        got = ranks[r]["gen"][name]
        np.testing.assert_array_equal(got["tokens"], one.tokens)
        assert got["texts"] == one.texts
        assert got["stats"]["batch"] == _bucket_batch(len(prompts), MeshConfig(dp=2))
        assert got["stats"]["decode_steps"] <= W.GEN_TOKENS
    if temp == 0.0:
        want = jeng2.generate(prompts, JSettings(temperature=0.0, max_tokens=W.GEN_TOKENS),
                              **kw)
        np.testing.assert_array_equal(ranks[0]["gen"][name]["tokens"],
                                      np.asarray(want.tokens))


def test_dp2_scoring_equals_dp1_and_the_reference(ranks, engines):
    jeng, jeng2, teng, _ = engines
    one = (score_texts(teng, W.SCORE_TEXTS),
           score_prompted_continuations(teng, W.SCORE_PROMPTS, W.SCORE_CONTS))
    ref = (jscore_texts(jeng2, W.SCORE_TEXTS),
           jscore_cont(jeng2, W.SCORE_PROMPTS, W.SCORE_CONTS))
    for r in (0, 1):
        for got, d1, want in zip((ranks[r]["score_texts"], ranks[r]["score_cont"]), one, ref):
            np.testing.assert_allclose(got.log_likelihoods, d1.log_likelihoods, rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(got.token_counts, d1.token_counts)
            np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                                       rtol=LL_RTOL, atol=LL_ATOL)
            np.testing.assert_array_equal(got.token_counts, want.token_counts)


def test_dp2_study_equals_the_reference_dp2_study(ranks, engines, tmp_path):
    """Phase 1 at dp=2 on tiny-test, greedy: the raw responses equal a live
    reference run on its dp=2 mesh, both reduce their metric counts over
    dp, the metrics agree to 1e-6, and rank 0 alone wrote files."""
    _, jeng2, _, _ = engines
    want = jrun_phase1(W.study_config(str(tmp_path), JConfig, JSettings), W.MODEL,
                       backend=JBackend(jeng2, name=W.MODEL), save=False)
    assert want["metadata"]["metric_reduction"] == "dp-psum"
    for r in (0, 1):
        got = ranks[r]["phase1"]
        assert got["metadata"]["metric_reduction"] == "dp-psum"
        assert sorted(got["recommendations"]) == sorted(want["recommendations"])
        for pid, rec in want["recommendations"].items():
            assert got["recommendations"][pid]["raw_response"] == rec["raw_response"], pid
        assert_same_record(got["metrics"], want["metrics"], tol=METRIC_TOL)
    assert "phase1/phase1_results.json" in ranks[0]["study_files"]
    assert ranks[1]["study_files"] == []


def test_cli_study_at_dp2_equals_one_process(ranks, tmp_path):
    """``--mesh dp=2`` through the CLI on the tiny-llama-study checkpoint at
    t=0.7 writes the record a single process writes, but for the reduction
    path; rank 1 writes no file."""
    import json

    assert ranks[0]["cli_rc"] == 0 and ranks[1]["cli_rc"] == 0
    assert ranks[1]["cli_files"] == []
    assert "phase1/phase1_results.json" in ranks[0]["cli_files"]
    assert tcli.main(W.cli_args(str(tmp_path), mesh=False)) == 0
    path = "phase1/phase1_results.json"
    got = _drop_times(json.loads((ranks.out / "cli0" / path).read_text()))
    want = _drop_times(json.loads((tmp_path / path).read_text()))
    assert (got["metadata"].pop("metric_reduction"), want["metadata"].pop("metric_reduction")) \
        == ("dp-psum", "host")
    assert_same_record(got, want, tol=METRIC_TOL)
