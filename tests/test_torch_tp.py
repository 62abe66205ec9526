"""The port's tensor-parallel serving and engine (``--tp``, ``--mesh tp=N``)
against the JAX package's and the port's single-process runs.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's tp ranks run as gloo processes on 127.0.0.1, two worlds spawned
once for the module (``torch_tp_worker.py``, mode ``tp``): two ranks (tp=2:
the engine, the serving grid, int8 weights, scoring, the cost ledger and
the CLI) and eight (tp=8, where attention replicates, and dp=2 x tp=4,
where kv heads replicate, with one training step there against the plain
step). Greedy f32 tokens must be equal; scores agree to 1e-5.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers.
torch.set_num_threads(1)

import torch_tp_worker as W  # noqa: E402
from fairness_llm_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.models.configs import MODEL_CONFIGS as JCONFIGS  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as jget_config  # noqa: E402
from fairness_llm_tpu.parallel import sharding as jshd  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu.runtime.stepbuilder import compile_key as jcompile_key  # noqa: E402
from fairness_llm_tpu.runtime.stepbuilder import program_label as jprogram_label  # noqa: E402
from fairness_llm_tpu.serving import ContinuousScheduler as JScheduler  # noqa: E402
from fairness_llm_tpu.serving import Request as JRequest  # noqa: E402
from fairness_llm_tpu.telemetry.costmodel import (  # noqa: E402
    tp_collective_costs as jtp_collective_costs,
)
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings, ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.models.configs import MODEL_CONFIGS, get_model_config  # noqa: E402
from fairness_llm_tpu_torch.parallel import sharding as shd  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.scoring import score_texts  # noqa: E402
from fairness_llm_tpu_torch.runtime.stepbuilder import program_label, tp_key  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import params_from_jax, quantize_params  # noqa: E402
from fairness_llm_tpu_torch.telemetry.costmodel import (  # noqa: E402
    check_costmodel,
    tp_collective_costs,
)
from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import validate_telemetry as V  # noqa: E402

# tests/test_torch_scoring.py's allowance against the reference.
LL_RTOL = LL_ATOL = 1e-5
# tests/test_ring_training.py's allowance for a parallel step against the
# plain one (plain SGD): loss relative, parameters and gradients absolute.
PLAIN_RTOL = PLAIN_ATOL = 2e-5
GREEDY = ModelSettings(temperature=0.0, max_tokens=W.M)


def _jmesh(axes):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jshd.make_mesh(JMeshConfig(**axes))


@pytest.fixture(scope="module")
def engines():
    """The reference's engine (random tiny-test weights, seed 0), the
    port's single-process engine on the same weights, and the weights."""
    cfg = get_model_config(W.MODEL)
    jeng = JEngine(jget_config(W.MODEL), seed=0)
    params = params_from_jax(jax.device_get(jeng.params), cfg)
    return jeng, DecodeEngine(cfg, params=params, device="cpu"), params


@pytest.fixture(scope="module")
def baseline(engines):
    """Each prompt's single-request greedy tokens from the port's tp=1
    engine: what every served cell must reproduce."""
    teng = engines[1]
    return {p: teng.generate([p], GREEDY).tokens[0] for p in W.PROMPTS}


@pytest.fixture(scope="module")
def worlds(engines, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    torch.save(engines[2], out / "params.pt")
    ranks = {w: W.Ranks(out, W.spawn(out, w, "tp"), "tp") for w in (2, 8)}
    yield ranks
    for r in ranks.values():
        r.kill()


def _assert_served(baseline, prompts, tokens):
    for p, got in zip(prompts, tokens):
        ref = baseline[p]
        assert len(got) > 0 and np.array_equal(got, ref[:len(got)]), (p, got, ref)


# ---------------------------------------------------------------------------
# In this process: layouts, labels, keys, collective costs, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,want", [
    (2, [((0, 2), (0,)), ((2, 4), (1,))]),
    (4, [((0, 1), (0,)), ((1, 2), (0,)), ((2, 3), (1,)), ((3, 4), (1,))]),
    (8, [((0, 4), (0, 1))] * 8),
])
def test_tp_layouts_of_tiny_test(tp, want):
    """tp=2 shards q and kv heads; tp=4 shards q but replicates kv, each
    rank keeping the kv head its q head reads (so K2's H % Hkv holds);
    tp=8 replicates attention whole. ff and vocab shard at every tp."""
    cfg = get_model_config("tiny-test")
    for rank, (q, kv) in enumerate(want):
        lay = shd.tp_layout(cfg, MeshConfig(tp=tp), rank)
        assert ((lay.q_lo, lay.q_hi), lay.kv_heads) == (q, kv)
        assert lay.ff_sharded and lay.vocab_sharded
        assert (lay.ff_lo, lay.ff_hi) == (rank * 128 // tp, (rank + 1) * 128 // tp)
        local = lay.local_config(cfg)
        assert local.num_heads % local.num_kv_heads == 0
    assert shd.tp_layout(cfg, MeshConfig(tp=4), 0).attn_sharded
    assert not shd.tp_layout(cfg, MeshConfig(tp=8), 0).attn_sharded


@pytest.mark.parametrize("name", ["llama3-8b", "llama3-8b-int8"])
def test_llama3_8b_tp2_local_shapes(name):
    """The shard shapes the card's tp=2 run gives the kernels: q/k/v
    [4096, 2048+512+512], o [2048, 4096], gate/up [4096, 2 x 7168], down
    [7168, 4096], lm_head [4096, 64128]; 16 q and 4 kv heads a rank."""
    cfg = get_model_config(name)
    lay = shd.tp_layout(cfg, MeshConfig(tp=2), 1)
    local = lay.local_config(cfg)
    assert (local.num_heads, local.num_kv_heads, local.d_ff, local.vocab_size) == \
        (16, 4, 7168, 64128)
    assert (local.q_dim, local.kv_dim) == (2048, 512)


def test_labels_and_keys_carry_tp_and_are_unchanged_at_tp1(engines):
    for base in ("serve_step", "paged_step", "serve_prefill", "paged_prefill"):
        for fuse in (1, 4):
            for tp in (1, 2, 8):
                assert program_label(base, fuse, tp=tp) == jprogram_label(base, fuse, tp=tp)
    assert program_label("serve_step", 1, tp=1) == "serve_step"
    key = ("serve_prefill", 2, 64, False)
    assert tp_key(key, 1) is key
    assert tp_key(key, 2) == jcompile_key("serve_prefill", nb=2, P=64, guard=False, tp=2)
    # a tp=1 scheduler's labels and keys are the pre-mesh ones
    _, sched = W.serve(engines[1], 1, prompts=W.PROMPTS[:2])
    assert sched._program == "serve_step"
    assert all("tp" not in repr(k) and "@" not in k[0] for k in sched._programs)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(JCONFIGS))
def test_tp_collective_costs_equal_the_references(name, tp):
    assert sorted(MODEL_CONFIGS) == sorted(JCONFIGS)
    tcfg, jcfg = get_model_config(name), jget_config(name)
    for rows, tokens, scope in ((1, 1, "step"), (16, 1, "step"), (8, 192, "call")):
        assert tp_collective_costs(tcfg, tp, rows, tokens=tokens, scope=scope) == \
            jtp_collective_costs(jcfg, tp, rows, tokens=tokens, scope=scope)


def test_serving_config_tp_must_match_the_mesh(engines):
    """As the reference's: a ServingConfig.tp the engine's mesh does not
    have raises; the field itself parses as the reference's."""
    assert dataclasses.asdict(ServingConfig(tp=2)) == dataclasses.asdict(JServingConfig(tp=2))
    with pytest.raises(ValueError, match="ServingConfig.tp=2"):
        W.serve(engines[1], 2)
    with pytest.raises(ValueError, match="ServingConfig.tp=2"):
        JScheduler(engines[0], JServingConfig(enabled=True, tp=2))


def test_a_tp_mesh_bigger_than_the_world_raises():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        shd.make_mesh(MeshConfig(tp=2))
    with pytest.raises(ValueError, match="torchrun"):
        DecodeEngine(get_model_config("tiny-test"), device="cpu",
                     mesh_config=MeshConfig(tp=2))


def test_shard_params_needs_the_mesh_for_a_sharded_spec():
    cfg = get_model_config("tiny-test")
    params = {"w": torch.ones(2)}
    assert shd.shard_params(params, {"w": (None,)}, "cpu")["w"] is params["w"]
    with pytest.raises(ValueError, match="pass the mesh"):
        shd.shard_params({"embedding": torch.ones(512, 64)},
                         shd.param_shardings(cfg, MeshConfig(tp=2)), "cpu")


def test_rank_params_refuses_a_tp_dimension_that_does_not_divide():
    """The tp cut (the engine's and the train state's) checks that a sharded
    dimension divides tp, as ``shard_params`` does."""
    cfg = get_model_config("tiny-test")
    layout = shd.tp_layout(cfg, MeshConfig(tp=2), 1)
    part = shd.rank_params(cfg, {"embedding": torch.ones(cfg.vocab_size, 64)}, layout, "cpu")
    assert part["embedding"].shape == (cfg.vocab_size // 2, 64)
    with pytest.raises(ValueError, match="does not divide tp=2"):
        shd.rank_params(cfg, {"embedding": torch.ones(cfg.vocab_size + 1, 64)}, layout, "cpu")


# ---------------------------------------------------------------------------
# The tp=2 ranks
# ---------------------------------------------------------------------------


def test_tp2_holds_its_shard(worlds):
    for r in (0, 1):
        assert worlds[2][r]["local"] == (2, 1, 64, 256)


def test_tp2_engine_equals_tp1_and_the_reference(worlds, engines, baseline):
    """Greedy f32 tokens of the batch and of each prompt alone equal the
    port's tp=1 engine's and the reference's; sampled rows equal tp=1's
    (each row keeps its seed, and both ranks see the same logits)."""
    jeng, teng, _ = engines
    one = teng.generate(W.PROMPTS, GREEDY).tokens
    want = np.asarray(jeng.generate(W.PROMPTS, JSettings(temperature=0.0,
                                                          max_tokens=W.M)).tokens)
    sampled = teng.generate(W.PROMPTS, ModelSettings(temperature=0.7, max_tokens=W.M),
                            seed=3).tokens
    for r in (0, 1):
        got = worlds[2][r]
        np.testing.assert_array_equal(got["batch"], one)
        np.testing.assert_array_equal(got["batch"], want)
        np.testing.assert_array_equal(got["sampled"], sampled)
        for p in W.PROMPTS:
            np.testing.assert_array_equal(got["single"][p], baseline[p])


@pytest.fixture(scope="module")
def reference_grid(engines):
    """The reference's tp=2 serving grid (its own
    ``test_tp2_serving_grid_parity``): tokens by cell."""
    jeng2 = JEngine(jget_config(W.MODEL), params=engines[0].params, mesh=_jmesh(dict(tp=2)))
    greedy = JSettings(temperature=0.0, max_tokens=W.M)
    out = {}
    for paged, fuse in W.GRID:
        sched = JScheduler(jeng2, JServingConfig(**dataclasses.asdict(
            W.serving_config(2, paged, fuse))), settings=greedy)
        res = sched.serve([JRequest(id=f"g{i}", prompt=p, settings=greedy)
                           for i, p in enumerate(W.PROMPTS)])
        assert all(r.ok for r in res)
        out[(paged, fuse)] = [np.asarray(r.tokens) for r in res]
    return out


@pytest.mark.parametrize("paged,fuse", W.GRID, ids=[f"{'paged' if p else 'contiguous'}-fuse{f}"
                                                    for p, f in W.GRID])
def test_tp2_serving_grid_equals_the_reference(worlds, reference_grid, baseline, paged, fuse):
    """{contiguous, paged} x {fuse 1, 4} at tp=2: 6 requests over 2 slots
    decode the tokens of the single-request engine and of the reference's
    tp=2 grid; the program is labelled ``@tp2`` and every key carries
    ``("tp", 2)``."""
    base = "paged_step" if paged else "serve_step"
    for r in (0, 1):
        cell = worlds[2][r]["grid"][(paged, fuse)]
        _assert_served(baseline, W.PROMPTS, cell["tokens"])
        for got, want in zip(cell["tokens"], reference_grid[(paged, fuse)]):
            np.testing.assert_array_equal(got, want)
        assert cell["label"] == program_label(base, fuse, tp=2) == \
            jprogram_label(base, fuse, tp=2)
        assert all(k.endswith("('tp', 2))") for k in cell["keys"])


def test_tp2_program_owns_its_telemetry(worlds, baseline):
    """The port's side of the reference's (red here) label test: the fused
    tp=2 program publishes compile stats, a cost ledger with a nonzero
    ``collectives`` component and roofline gauges under its own
    ``serve_step_fused@tp2`` label, nothing under ``serve_step_fused``, and
    the cost-model gate (with its ``@tp`` clause) passes."""
    label = "serve_step_fused@tp2"
    for r in (0, 1):
        tel = worlds[2][r]["telemetry"]
        _assert_served(baseline, W.PROMPTS[:4], tel["tokens"])
        snap = tel["snapshot"]

        def rows(kind, name, **extra):
            return [m for m in snap.get(kind, []) if m.get("name") == name
                    and m.get("labels", {}).get("program") == label
                    and all(m["labels"].get(k) == v for k, v in extra.items())]

        assert any(m["value"] >= 1 for m in rows("counters", "compiles_total"))
        coll = rows("gauges", "cost_ledger_bytes", component="collectives")
        assert coll and sum(m["value"] for m in coll) > 0
        assert rows("gauges", "achieved_over_achievable")
        assert not [m for m in snap.get("gauges", []) if m.get("name") == "cost_ledger_bytes"
                    and m.get("labels", {}).get("program") == "serve_step_fused"]
        assert tel["problems"] == []
        # the @tp clause finds what the reference validator's finds, with the
        # program's collectives and without them
        bare = dict(snap, gauges=[g for g in snap["gauges"] if not (
            g.get("name") == "cost_ledger_bytes"
            and g.get("labels", {}).get("component") == "collectives")])
        for s in (snap, bare):
            assert check_costmodel(s) == V._check_costmodel(s)
        assert any("@tp2" in p and "collectives" in p for p in check_costmodel(bare))


def test_tp2_int8_weights_equal_tp1(worlds, engines):
    """int8 weights at tp=2: the o and down shards' products summed in f32
    (K4's plain version here), the scales with their columns."""
    cfg = dataclasses.replace(get_model_config(W.MODEL), weight_quant="int8")
    one = DecodeEngine(cfg, params=quantize_params(engines[2]), device="cpu")
    want = one.generate(W.PROMPTS, GREEDY).tokens
    for r in (0, 1):
        np.testing.assert_array_equal(worlds[2][r]["int8"], want)


def test_tp2_scoring_equals_tp1_and_the_reference(worlds, engines):
    from fairness_llm_tpu.runtime.scoring import score_texts as jscore_texts

    jeng, teng, _ = engines
    one, ref = score_texts(teng, W.SCORE_TEXTS), jscore_texts(jeng, W.SCORE_TEXTS)
    for r in (0, 1):
        got = worlds[2][r]["scores"]
        np.testing.assert_allclose(got.log_likelihoods, one.log_likelihoods, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods, rtol=LL_RTOL,
                                   atol=LL_ATOL)
        np.testing.assert_array_equal(got.token_counts, one.token_counts)


@pytest.mark.parametrize("name,flags", [("cli_tp", ["--continuous"]), ("cli_mesh", [])])
def test_cli_at_tp2_equals_one_process(worlds, tmp_path, name, flags):
    """``--continuous --tp 2`` and ``--mesh tp=2`` through the CLI on the
    tiny-llama-study checkpoint at t=0.7 write the record one process
    writes; rank 1 writes no file."""
    ranks = worlds[2]
    assert ranks[0][name]["rc"] == 0 and ranks[1][name]["rc"] == 0
    assert ranks[1][name]["files"] == []
    path = "phase1/phase1_results.json"
    assert path in ranks[0][name]["files"]
    assert tcli.main(W.cli_args(str(tmp_path), flags)) == 0
    got = _drop_times(json.loads((ranks.out / f"{name}0" / path).read_text()))
    want = _drop_times(json.loads((tmp_path / path).read_text()))
    assert_same_record(got, want, tol=1e-6)


# ---------------------------------------------------------------------------
# The eight ranks: the mixed layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,local", [("tp8", (4, 2, 16, 64)), ("dp2tp4", (1, 1, 32, 128))])
def test_mixed_layouts_equal_tp1(worlds, engines, baseline, name, local):
    """tp=8 (attention replicated whole, only ff and vocab shard: no
    all-reduce after o) and dp=2 x tp=4 (q heads shard, kv heads
    replicate: each rank keeps the kv head its q head reads) decode the
    tp=1 engine's greedy tokens; tp=8 serves them too (the reference's
    ``test_tp8_heads_replicate_parity``)."""
    one = engines[1].generate(W.PROMPTS, GREEDY).tokens
    for r in range(8):
        got = worlds[8][r][name]
        assert got["local"] == local
        np.testing.assert_array_equal(got["batch"], one)
        if name == "tp8":
            _assert_served(baseline, W.PROMPTS[:3], got["served"])


def test_dp2tp4_train_step_equals_the_plain_step(worlds, engines):
    """One plain-SGD training step on the reference's own test mesh (dp=2 x
    tp=4, ``tests/conftest.py``'s ``eight_device_mesh``), kv heads held by
    two ranks each: every rank's loss equals one process's step, and its
    gradients and updated parameters its part of that step's."""
    from fairness_llm_tpu_torch.train.step import make_train_step

    cfg = get_model_config(W.MODEL)
    init, step = make_train_step(cfg, optimizer=lambda ps: torch.optim.SGD(list(ps),
                                                                             lr=W.TRAIN_LR),
                                 device="cpu")
    state, loss = step(init(params=engines[2]), *W.train_batch())
    want = {k: (v.detach(), v.grad) for k, v in state.params.items()}
    for r in range(8):
        got = worlds[8][r]["train_dp2tp4"]
        assert got["loss"] == pytest.approx(float(loss), rel=PLAIN_RTOL)
        assert got["tp_rank"] == (4, r % 4)
        layout = shd.tp_layout(cfg, MeshConfig(tp=4), r % 4)
        part_p = shd.rank_params(cfg, {k: p for k, (p, _) in want.items()}, layout, "cpu")
        part_g = shd.rank_params(cfg, {k: g for k, (_, g) in want.items()}, layout, "cpu")
        for k in part_p:
            np.testing.assert_allclose(got["grads"][k], part_g[k].numpy(), rtol=0,
                                       atol=PLAIN_ATOL, err_msg=k)
            np.testing.assert_allclose(got["params"][k], part_p[k].numpy(), rtol=0,
                                       atol=PLAIN_ATOL, err_msg=k)
