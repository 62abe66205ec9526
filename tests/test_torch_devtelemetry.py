"""The port's device-facing telemetry (``telemetry/compilestats.py``,
``roofline.py``, ``memory.py``, ``costmodel.py``) against the JAX
package's, on the CPU.

The same inputs go through both packages: the byte model integer-equal over
a grid of configs; the same compile, lookup and roofline calls into fresh
registries give the same rows; the same ledger operations under one
injected limit give the same gauges, headroom and forecasts; one snapshot
renders the same cost and memory reports and decomposes alike. A served
study run compiles the same programs and accounts the same pools in both
(with the differences the port's layout makes, stated where they are
checked), and the autoscaler's and the overload ladder's headroom signals
fire at the same tick. The port's own cost walk is held to arithmetic from
the config: a decode step's parameter matmuls are ``2·B·Σ d_in·d_out``
FLOPs, whether the products run as plain matmuls or through the int8
kernel's self-report. The reference's jaxpr walk is not called (it fails to
import under this jax; ROADMAP C).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as jget  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu.pipeline.backends import backend_for as jbackend_for  # noqa: E402
from fairness_llm_tpu.serving import autoscaler as jautoscaler  # noqa: E402
from fairness_llm_tpu.serving import overload as joverload  # noqa: E402
from fairness_llm_tpu.telemetry import compilestats as jcs  # noqa: E402
from fairness_llm_tpu.telemetry import costmodel as jcost  # noqa: E402
from fairness_llm_tpu.telemetry import memory as jmem  # noqa: E402
from fairness_llm_tpu.telemetry import roofline as jroof  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config as tget  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase1 as tphase1  # noqa: E402
from fairness_llm_tpu_torch.pipeline.backends import backend_for as tbackend_for  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.serving import autoscaler as tautoscaler  # noqa: E402
from fairness_llm_tpu_torch.serving import overload as toverload  # noqa: E402
from fairness_llm_tpu_torch.telemetry import compilestats as tcs  # noqa: E402
from fairness_llm_tpu_torch.telemetry import costmodel as tcost  # noqa: E402
from fairness_llm_tpu_torch.telemetry import memory as tmem  # noqa: E402
from fairness_llm_tpu_torch.telemetry import roofline as troof  # noqa: E402
from test_torch_serving import ROOT, SERVING, STUDY_MODEL, _engines, greedy  # noqa: E402

PKGS = {"t": (T, tcs, troof, tmem, tcost), "j": (J, jcs, jroof, jmem, jcost)}


def _strip(snap):
    return {k: v for k, v in snap.items() if k != "created_at_unix"}


# ---------------------------------------------------------------------------
# The byte model
# ---------------------------------------------------------------------------

CONFIGS = ["tiny-test", "tiny-llama-study", "tiny-gpt2-study", "llama3-8b", "llama3-8b-int8",
           "llama32-1b"]
VARIANTS = {"as_is": {}, "f32": {"dtype": "float32"}, "bf16": {"dtype": "bfloat16"},
            "int8_weights": {"weight_quant": "int8"}, "int8_kv": {"kv_cache_quant": True}}
STATS = [
    {"batch": 16, "cache_slots": 960, "prefix_len": 0},
    {"batch": 48, "cache_slots": 224, "prefix_len": 704},
    {"batch": 16, "cache_slots": 1152, "prefix_len": 0, "paged_kv": True, "chunk_steps": 8},
    {"batch": 8, "cache_slots": 768, "prefix_len": 0, "paged_kv": True, "chunk_steps": 3},
    {"batch": 1, "cache_slots": 33, "prefix_len": 0, "paged_kv": True, "chunk_steps": 0},
]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_bytes_equals_the_reference(name, variant):
    """Integer-equal for every stats shape: bf16, f32, int8 weights (the
    float embedding), int8 KV (values and f32 scales), a shared prefix, and
    the paged view's 4x amortized over the chunk's steps."""
    change = VARIANTS[variant]
    tcfg = dataclasses.replace(tget(name), **change)
    jcfg = dataclasses.replace(jget(name), **change)
    for stats in STATS:
        got = troof.decode_step_bytes(tcfg, stats)
        assert isinstance(got, int)
        assert got == jroof.decode_step_bytes(jcfg, stats), (name, variant, stats)


# ---------------------------------------------------------------------------
# Compile stats and the roofline: the same calls, the same rows
# ---------------------------------------------------------------------------


def _compile_and_roofline_calls(pkg):
    tel, cs, roof, _, _ = PKGS[pkg]
    cfg = (tget if pkg == "t" else jget)("tiny-llama-study")
    out = []
    with tel.use_registry() as reg, tel.use_timeline(), tel.use_flight_recorder():
        cs.note_lookup("decode", hit=False)
        cs.note_lookup("decode", hit=True)
        cs.note_lookup("serve_step", hit=False, labels={"replica": "r1"})
        cs.record_compile("decode", "shape", 1.25, key=("decode", 8, 64), t0=10.0)
        cs.record_compile("serve_step", "decode_chunk", 0.5, track="r1", key=("serve_step", 4),
                          labels={"replica": "r1"}, t0=20.0)
        stats = {"batch": 8, "cache_slots": 768, "prefix_len": 0}
        out.append(roof.observe_decode(cfg, stats, 8, 0.25, program="serve_step",
                                       labels={"replica": "r1"}))
        out.append(roof.observe_decode(cfg, dict(stats, paged_kv=True, chunk_steps=8), 8, 0.5,
                                       program="paged_step"))
        out.append(roof.observe_decode(cfg, stats, 0, 0.25, program="serve_step"))
        roof.set_achievable_gbps(3350.0)
        try:
            out.append(roof.observe_decode(cfg, stats, 3, 0.125, program="decode"))
        finally:
            roof.set_achievable_gbps(None)
        ring = list(tel.get_flight_recorder().rings["roofline"])
        spans = [(e["name"], e["cat"], e["track"], e["t0"], e["dur_s"], e["args"])
                 for e in tel.get_timeline().events()]
        return _strip(tel.snapshot(reg)), out, [{k: v for k, v in e.items() if k != "t"}
                                                 for e in ring], spans


def test_compile_stats_and_roofline_rows_equal_the_reference():
    got, want = _compile_and_roofline_calls("t"), _compile_and_roofline_calls("j")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[1][2] is None and got[1][3]["achievable_gbps"] == 3350.0
    assert got[1][0]["achievable_gbps"] == troof.CPU_NOMINAL_GBPS == 16.0


def test_reference_rates_state_no_tpu_figure(monkeypatch):
    """No CUDA card: the reference's CPU nominals. A card in the table gets
    its data-sheet figures; a card missing from it raises for the bandwidth
    (asking for --achievable-gbps) and gets no compute wall, no dispatch
    figure."""
    for attr in ("V5E_HBM_GBPS", "TPU_DISPATCH_S", "V5E_BF16_GFLOPS"):
        assert not hasattr(troof, attr) and not hasattr(tcost, attr)
    assert troof.reference_achievable_gbps() == 16.0
    assert tcost.reference_achievable_gflops() == 100.0
    assert tcost.reference_dispatch_s() == 2e-4
    monkeypatch.setattr(troof, "card_name", lambda: "NVIDIA H100 80GB HBM3")
    assert troof.reference_achievable_gbps() == 3350.0
    assert tcost.reference_achievable_gflops() == 989_000.0
    assert tcost.reference_dispatch_s() == 0.0
    monkeypatch.setattr(troof, "card_name", lambda: "Some Other Card")
    with pytest.raises(RuntimeError, match="--achievable-gbps"):
        troof.reference_achievable_gbps()
    assert tcost.reference_achievable_gflops() == 0.0
    troof.set_achievable_gbps(1234.5)
    tcost.set_dispatch_s(3e-6)
    try:
        assert troof.reference_achievable_gbps() == 1234.5
        assert tcost.reference_dispatch_s() == 3e-6
    finally:
        troof.set_achievable_gbps(None)
        tcost.set_dispatch_s(None)


# ---------------------------------------------------------------------------
# The memory ledger
# ---------------------------------------------------------------------------


def _tree(pkg, shapes, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if pkg == "t":
        return {f"w{i}": torch.from_numpy(a) for i, a in enumerate(arrays)}
    return {f"w{i}": jax.numpy.asarray(a) for i, a in enumerate(arrays)}


def _ledger_session(pkg):
    """Register, release, forecast and read headroom under an injected
    analytic limit; returns what each call gave and the final snapshot."""
    tel, _, _, mem, _ = PKGS[pkg]
    out = []
    with tel.use_registry() as reg, tel.use_flight_recorder():
        with mem.use_memory_ledger() as led:
            out.append(led.headroom_frac())
            out.append(led.forecast(100))
            led.set_analytic_limit(4_000_000)
            out.append(led.register("params", "engine0", _tree(pkg, [(128, 512), (512,)], 0)))
            out.append(led.register("kv_contiguous", "sched0:cache",
                                    _tree(pkg, [(8, 64, 2, 32)] * 4, 1), replica="r0"))
            out.append(led.register("logits_carry", "sched0:logits", _tree(pkg, [(8, 512)], 2),
                                    replica="r0"))
            out.append(led.register("kv_paged", "sched1:arena", _tree(pkg, [(33, 16, 2, 32)], 3),
                                    replica="r1"))
            out.append(led.register("prefix_cache", "engine0:prefix:a", _tree(pkg, [(64, 2, 32)], 4)))
            out.append((led.headroom_bytes(), led.headroom_frac()))
            out.append(led.forecast(300_000))
            out.append(led.forecast(10_000_000))
            led.note_pressure("r1", True)
            led.note_pressure("r1", True)
            out.append(led.release("prefix_cache", "engine0:prefix:a"))
            out.append(led.release("prefix_cache", "engine0:prefix:a"))
            out.append(led.release_matching("sched0:"))
            led.note_pressure("r1", False)
            out.append(led.register("kv_paged", "sched1:arena", _tree(pkg, [(9, 16, 2, 32)], 5),
                                    replica="r1"))
            out.append((led.pool_bytes("kv_paged"), led.total_bytes(), led.headroom_frac()))
            out.append(led.reconcile())
            with pytest.raises(ValueError, match="unknown memory pool"):
                led.register("nope", "x", _tree(pkg, [(2,)], 6))
        snap = _strip(tel.snapshot(reg))
    return out, snap


def test_memory_ledger_gauges_equal_the_reference():
    got, gsnap = _ledger_session("t")
    want, wsnap = _ledger_session("j")
    assert got == want
    assert gsnap == wsnap
    assert got[0] is None and got[1]["fits"] is None
    assert tmem.RECONCILE_TOL_FRAC == jmem.RECONCILE_TOL_FRAC
    assert tmem.POOLS == jmem.POOLS


def test_tree_device_bytes_counts_each_storage_once():
    arena = torch.zeros(9, 16, 2, 32)
    view = arena[:4]
    assert tmem.tree_device_bytes([arena, view, arena.view(-1)]) == arena.nbytes
    assert tmem.tree_device_bytes({"a": arena, "b": [torch.zeros(3, dtype=torch.int8)]}) == \
        arena.nbytes + 3
    assert tmem.tree_device_bytes(view) == arena.nbytes  # a view keeps its storage alive
    assert tmem.device_memory_stats() == {}


# ---------------------------------------------------------------------------
# One snapshot, both renderers
# ---------------------------------------------------------------------------


def _cost_snapshot(pkg):
    """A run's worth of cost and memory accounting fed through one
    package's publishing functions."""
    tel, cs, roof, mem, cost = PKGS[pkg]
    cfg = (tget if pkg == "t" else jget)("tiny-llama-study")
    with tel.use_registry() as reg, tel.use_timeline() as tl, tel.use_flight_recorder():
        for prog, scale in (("serve_step", 1), ("serve_prefill", 3), ("paged_step_fused", 2)):
            led = cost.CostLedger(program=prog)
            for comp, b, f in (("matmuls", 5_000_000, 9_000_000), ("attention", 700_000, 80_000),
                               ("kv_rw", 90_000, 100), ("sampling", 4_000, 500)):
                led.record("step" if prog != "serve_prefill" else "call", comp, b * scale,
                           f * scale)
            led.record("call", "gather_scatter", 123_456, 7)
            cost.publish_ledger(led)
            cs.record_compile(prog, "shape", 0.75 * scale, t0=1.0)
            for i in range(3):
                cost.note_invocation(prog, 0.01 * scale + 0.001 * i, 8 if "step" in prog else 0,
                                     ledger=led, compiling=i == 0)
                tl.decode_chunk("serving", 10.0 * scale + i, 0.01, 8, program=prog)
        roof.observe_decode(cfg, {"batch": 8, "cache_slots": 768, "prefix_len": 0}, 8, 0.02,
                            program="serve_step")
        with mem.use_memory_ledger() as ml:
            ml.set_analytic_limit(60_000_000)
            ml.register("params", "engine0", _tree(pkg, [(256, 256)], 0))
            ml.register("kv_paged", "sched0:arena", _tree(pkg, [(17, 16, 2, 32)], 1),
                        replica="r0")
            ml.note_pressure("r0", True)
        mem.publish_program_memory("serve_step", 1000, 200, 3000)
        mem.publish_program_memory("paged_step", 4_000_000, 16_384, 0, peak=9_000_000)
        return _strip(tel.snapshot(reg))


def test_cost_and_memory_reports_render_the_reference_text():
    snap = _cost_snapshot("t")
    assert snap == _cost_snapshot("j")
    assert tcost.render_cost_report(snap) == jcost.render_cost_report(snap)
    assert tmem.render_memory_report(snap) == jmem.render_memory_report(snap)
    got, want = tcost.gap_decomposition(snap), jcost.gap_decomposition(snap)
    assert got == want
    for d in got.values():
        assert d["sum_check_s"] == pytest.approx(d["total_s"], rel=1e-12, abs=1e-12)
    empty = {"gauges": [], "counters": [], "histograms": []}
    assert tcost.render_cost_report(empty) == jcost.render_cost_report(empty)
    assert "no hbm_bytes gauges" in tmem.render_memory_report(empty)
    assert tcost.has_cost_data(snap) and tmem.has_memory_data(snap)
    assert not tcost.has_cost_data(empty) and not tmem.has_memory_data(empty)


# The reference's historical op names (tests/test_costmodel.py), whose
# first-match-wins labels are load-bearing.
HISTORICAL_OPS = [
    "multiply_reduce_fusion.3", "reduce_fusion", "softmax_exp", "exponential.12",
    "divide_fusion.2", "dynamic-update-slice.7", "dynamic-update-slice_fusion",
    "fused_dynamic_update_slice", "slice.42", "bitcast-convert.1", "copy.3",
    "dynamic-slice-start", "copy-start.2", "copy-done.2", "slice_fusion", "dot.17",
    "dot_general_fusion", "convolution.1", "rsqrt.4", "layer_norm_fusion", "add_fusion.9",
    "multiply_fusion", "subtract.2", "tanh.1", "gelu_fusion", "sort.1", "argmax.3",
    "rng-bit-generator", "random_fold_in", "iota.2", "cumsum_fusion", "select_n.5", "compare.8",
    "gather.11", "scatter.4", "while.1", "condition.2", "tuple.1", "parameter.0", "constant.5",
    "some-unknown-op", "all-reduce.1", "all-reduce-start", "all-gather.3",
    "reduce-scatter_fusion", "collective-permute.2", "all-to-all", "psum",
]


@pytest.mark.parametrize("name", HISTORICAL_OPS)
def test_classify_equals_the_reference(name):
    assert tcost.classify(name) == jcost.classify(name)


def test_validator_gates_find_what_the_reference_finds():
    """``check_costmodel`` and ``check_memory`` against the reference
    validator's gates on the same snapshot, clean and perturbed."""
    import sys

    sys.path.insert(0, str(ROOT / "tools"))
    import validate_telemetry as V

    snap = _cost_snapshot("t")
    snap["counters"].append({"name": "compiles_total", "labels": {
        "component": "compile", "program": "paged_step", "reason": "shape"}, "value": 1})
    for perturb in (None, "no_ledger", "no_memory", "no_compiles"):
        s = {k: [dict(r) for r in v] if isinstance(v, list) else v for k, v in snap.items()}
        if perturb == "no_ledger":
            s["gauges"] = [g for g in s["gauges"] if g["name"] != "cost_ledger_bytes"]
        elif perturb == "no_memory":
            s["gauges"] = [g for g in s["gauges"] if g["name"] != "program_memory_bytes"]
        elif perturb == "no_compiles":
            s["counters"] = [c for c in s["counters"] if c["name"] != "compiles_total"]
        assert T.check_costmodel(s) == V._check_costmodel(s), perturb
        assert T.check_memory(s) == V._check_memory(s), perturb
    assert T.check_costmodel(snap)  # paged_step compiled without a ledger
    assert T.check_memory(snap)  # serve_prefill compiled with no program memory


# ---------------------------------------------------------------------------
# A served study run through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_runs(tmp_path_factory):
    """The greedy --quick sweep (15 profiles, 1 neutral prompt, 4 tokens)
    on the study checkpoint through ``backend_for`` with serving on, in
    both packages, each with its own registry, timeline and memory ledger."""
    d = tmp_path_factory.mktemp("devtel")
    out = {}
    for pkg, mod in (("t", tconfig), ("j", jconfig)):
        tel, _, _, mem, _ = PKGS[pkg]
        settings = tuple((n, mod.ModelSettings(temperature=0.0, max_tokens=4)
                          if n == STUDY_MODEL else s) for n, s in mod.Config().model_settings)
        cfg = mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(d / pkg),
                         profiles_per_combo=1, model_settings=settings,
                         serving=mod.ServingConfig(enabled=True, num_slots=8))
        with tel.use_registry() as reg, tel.use_timeline(), tel.use_incident_manager(), \
                mem.use_memory_ledger():
            backend = (tbackend_for(STUDY_MODEL, cfg, device="cpu") if pkg == "t"
                       else jbackend_for(STUDY_MODEL, cfg))
            run = tphase1.run_phase1 if pkg == "t" else jphase1.run_phase1
            rec = run(cfg, STUDY_MODEL, backend=backend, save=False)
            out[pkg] = (rec, tel.snapshot(reg), backend)
    return out


def _rows(snap, name, *keys):
    return {tuple(r["labels"].get(k) for k in keys): r["value"]
            for section in ("counters", "gauges") for r in snap[section] if r["name"] == name}


def test_served_study_run_compiles_the_reference_programs(served_runs):
    """The same program labels (and first uses and lookups) as the
    reference scheduler's compiled-program cache."""
    gsnap, wsnap = served_runs["t"][1], served_runs["j"][1]
    got = _rows(gsnap, "compiles_total", "program", "reason")
    assert {p for p, _ in got} == {"serve_prefill", "serve_step"}
    assert got == _rows(wsnap, "compiles_total", "program", "reason")
    for name in ("compile_cache_hits_total", "compile_cache_misses_total"):
        assert _rows(gsnap, name, "program") == _rows(wsnap, name, "program")
    assert _rows(gsnap, "decode_step_bytes", "program") == \
        _rows(wsnap, "decode_step_bytes", "program")
    assert T.check_costmodel(gsnap) == []


def test_served_study_run_accounts_the_reference_pools(served_runs):
    """Bytes per pool equal the reference's: the parameters and the
    carried logits exactly. The slot cache differs by its integer planes
    alone: the port keeps ``key_positions`` and ``lengths`` in int64, the
    reference in int32, and the reference's tree also holds its int32
    ``index`` scalar."""
    gsnap, wsnap = served_runs["t"][1], served_runs["j"][1]
    got, want = _rows(gsnap, "hbm_bytes", "pool"), _rows(wsnap, "hbm_bytes", "pool")
    assert set(got) == set(want) == {("params",), ("kv_contiguous",), ("logits_carry",)}
    assert got[("params",)] == want[("params",)] > 0
    assert got[("logits_carry",)] == want[("logits_carry",)] == 8 * 4 * \
        tget(STUDY_MODEL).vocab_size
    backend = served_runs["t"][2]
    sched = next(iter(backend._schedulers.values()))
    slots, L = sched.num_slots, sched.cache_len
    assert got[("kv_contiguous",)] - want[("kv_contiguous",)] == slots * L * 4 + slots * 4 - 4
    assert set(_rows(gsnap, "hbm_bytes_total", "reconciliation")) == \
        set(_rows(wsnap, "hbm_bytes_total", "reconciliation")) == {("indicative",)}


def test_paged_pools_differ_by_the_sink_block_and_the_view():
    """Paged, in schedulers of one shape: the port's arena holds one more
    block than the reference's (the sink, ROADMAP A5.1) and keeps its
    positions and slot lengths in int64 (the reference's int32); its view
    and table buffers, which the reference keeps inside its compiled step,
    are the ``other`` pool. The carried logits are equal."""
    jeng, teng = _engines()
    cfg = dict(SERVING, paged_kv=True, kv_block_size=16)
    with T.use_registry() as treg, T.use_memory_ledger():
        tsched = tserving.ContinuousScheduler(teng, ServingConfig(**cfg), settings=greedy(8))
        got = _rows(T.snapshot(treg), "hbm_bytes", "pool")
    from fairness_llm_tpu import serving as jserving

    with J.use_registry() as jreg, jmem.use_memory_ledger():
        jserving.ContinuousScheduler(jeng, jconfig.ServingConfig(**cfg), settings=greedy(8))
        want = _rows(J.snapshot(jreg), "hbm_bytes", "pool")
    c = teng.config
    N, bs, slots = tsched.pool.paged.num_blocks, 16, tsched.num_slots
    block = c.num_layers * 2 * bs * c.num_kv_heads * c.head_dim * 4 + bs * (1 + 8)
    assert got[("kv_paged",)] - want[("kv_paged",)] == block + N * bs * 4 + slots * 4
    assert got[("logits_carry",)] == want[("logits_carry",)]
    assert ("other",) not in want
    view = tmem.tree_device_bytes([tsched._view, tsched._tables, tsched._wtables])
    assert got[("other",)] == view > 0
    tsched.release_memory()


# ---------------------------------------------------------------------------
# The port's cost walk against arithmetic from the config
# ---------------------------------------------------------------------------


def _param_products(cfg) -> int:
    """Σ d_in·d_out over a decode step's parameter products: q, k, v, o and
    the MLP's projections in every layer, and the head."""
    mlp = 3 if cfg.mlp == "glu" else 2
    per_layer = (2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + mlp * cfg.d_model * cfg.d_ff)
    return cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size


def _step_ledger(snap, program):
    """{component: (bytes, flops)} of ``program``'s step scope."""
    nbytes = _rows(snap, "cost_ledger_bytes", "program", "component", "scope")
    flops = _rows(snap, "cost_ledger_flops", "program", "component", "scope")
    return {c: (b, flops[(p, c, scope)]) for (p, c, scope), b in nbytes.items()
            if p == program and scope == "step"}


ENGINE_CASES = {
    "f32": {},
    "int8_weights": {"weight_quant": "int8"},
    "kernels": {"use_decode_attention_kernel": True, "use_flash_attention": True},
    "int8_kernels": {"weight_quant": "int8", "use_decode_attention_kernel": True,
                     "kv_cache_quant": True},
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_step_ledger_matmuls_are_the_config_arithmetic(case):
    """The decode step's ``matmuls`` FLOPs are ``2·B·Σ d_in·d_out`` from the
    config, exactly: as plain products, and through the int8 kernel's own
    report (its plain version on the CPU). With the attention kernels on,
    their self-reported bytes and operations are the step's attention."""
    cfg = dataclasses.replace(tget("tiny-test"), **ENGINE_CASES[case])
    with T.use_registry() as reg, T.use_memory_ledger():
        eng = DecodeEngine(cfg, device="cpu")
        out = eng.generate(["the quick brown fox", "hello there", "abc abc abc"],
                           greedy(4), max_new_tokens=4)
        snap = T.snapshot(reg)
    B = out.stats["batch"]
    step = _step_ledger(snap, "decode")
    assert step["matmuls"][1] == 2 * B * _param_products(cfg)
    assert step["attention"][0] > 0 and step["attention"][1] > 0
    if cfg.use_decode_attention_kernel and not cfg.kv_cache_quant:
        # K2's count alone: 4·D operations per visible (query, key) pair
        # per head (an int8 cache adds its rank-4 quantize ops).
        visible = step["attention"][1] / (4 * cfg.head_dim * cfg.num_heads)
        assert visible == int(visible) and visible >= B
    if cfg.weight_quant == "int8":
        # The int8 weights the step streams are in its matmuls' bytes.
        embed = cfg.vocab_size * cfg.d_model
        assert step["matmuls"][0] >= cfg.approx_param_count - embed
    assert _rows(snap, "compiles_total", "program", "reason") == {("decode", "shape"): 1}
    assert T.check_costmodel(snap) == []


@pytest.mark.parametrize("paged", [False, True], ids=["serve_step", "paged_step"])
def test_served_step_ledger_matmuls_are_the_config_arithmetic(paged):
    """The serve step over a pool of B slots: ``2·B·Σ d_in·d_out``; the
    paged step charges its view's gather and scatter to the call, never to
    the step; the per-program memory is captured once armed."""
    _, teng = _engines()
    cfg = dict(SERVING, paged_kv=paged, kv_block_size=16)
    prev = tmem.set_program_memory_capture(True)
    try:
        with T.use_registry() as reg, T.use_memory_ledger():
            sched = tserving.ContinuousScheduler(teng, ServingConfig(**cfg), settings=greedy(6))
            res = sched.serve([tserving.Request(prompt=p, settings=greedy(6))
                               for p in ("the quick brown fox", "hi", "zz")])
            snap = T.snapshot(reg)
    finally:
        tmem.set_program_memory_capture(prev)
    assert all(r.ok for r in res)
    prog = "paged_step" if paged else "serve_step"
    step = _step_ledger(snap, prog)
    c, B = teng.config, sched.num_slots
    assert step["matmuls"][1] == 2 * B * _param_products(c)
    # The step's one gather is its embedding lookup (the whole f32 table, B
    # token ids, B rows out): the paged view's copies are the call's.
    assert step["gather_scatter"][0] == c.vocab_size * c.d_model * 4 + B * 8 + B * c.d_model * 4
    calls = _rows(snap, "cost_ledger_bytes", "program", "component", "scope")
    if paged:
        assert calls[(prog, "gather_scatter", "call")] > 2 * tmem.tree_device_bytes(sched._view)
    kinds = _rows(snap, "program_memory_bytes", "program", "kind")
    assert {k for p, k in kinds} == {"argument", "output", "temp"}
    assert {p for p, k in kinds} == {p for p, _ in _rows(snap, "compiles_total", "program",
                                                         "reason")}
    assert kinds[(prog, "temp")] == 0
    assert kinds[(prog, "argument")] > 0


def test_a_failed_walk_never_fails_the_call(monkeypatch, caplog):
    """Counting that raises is logged once and the call's result stands; an
    exception of the real call propagates untouched, and the next call
    walks again."""
    prog = tcost.InstrumentedProgram("decode")
    monkeypatch.setattr(tcost, "classify_op", lambda *a: 1 / 0)
    x = torch.ones(4, 4)
    assert torch.equal(prog.run(lambda a: a @ a, x), x @ x * 1)
    assert prog.ledger is None and prog._ledger_failed
    assert "cost ledger for decode unavailable" in caplog.text
    monkeypatch.undo()
    good = tcost.InstrumentedProgram("decode")
    with pytest.raises(KeyError, match="boom"):
        good.run(lambda: {}["boom"])
    assert good.ledger is None and not good._ledger_failed
    good.run(lambda a: a @ a, x)
    assert good.ledger.per_call["matmuls"].flops == 2 * 4 * 4 * 4
    assert not tcost.walk_active()


# ---------------------------------------------------------------------------
# The headroom signals
# ---------------------------------------------------------------------------


def _fake_fleet():
    return types.SimpleNamespace(replicas=[], queue=[], _pending=[], _fleet_labels={},
                                 serving=types.SimpleNamespace(queue_capacity=4),
                                 _max_replica_burn=lambda: 0.0, shed_controller=None)


def _headroom_ticks(pkg):
    """Fill one ledger under an injected limit, a tenth a tick: the
    autoscaler's hot reason and the overload controller's batch cap at
    each tick."""
    tel, _, _, mem, _ = PKGS[pkg]
    mod = tconfig if pkg == "t" else jconfig
    scaler_mod = tautoscaler if pkg == "t" else jautoscaler
    over_mod = toverload if pkg == "t" else joverload
    out = []
    with tel.use_registry(), tel.use_flight_recorder(), mem.use_memory_ledger() as led:
        scaler = scaler_mod.Autoscaler(_fake_fleet(), mod.AutoscaleConfig(
            enabled=True, up_headroom_frac=0.35), clock=lambda: 0.0)
        ctl = over_mod.ShedController(mod.OverloadConfig(enabled=True, headroom_cap_frac=0.25,
                                                         batch_token_cap=7),
                                      clock=lambda: 0.0)
        out.append((scaler._hot_reason(scaler.signals()), ctl.batch_cap(64, "batch")))
        led.set_analytic_limit(10 * 4096)
        for i in range(10):
            led.register("kv_paged", f"sched{i}:arena", _tree(pkg, [(1024,)], i))
            sig = scaler.signals()
            out.append((sig["headroom_frac"], scaler._hot_reason(sig),
                        ctl.batch_cap(64, "batch"), ctl.batch_cap(64, "interactive")))
    return out


def test_headroom_signals_fire_at_the_reference_tick():
    got = _headroom_ticks("t")
    assert got == _headroom_ticks("j")
    assert got[0] == (None, 64)  # no limit: no opinion, no clamp
    hot = [i for i, row in enumerate(got[1:]) if row[1]]
    capped = [i for i, row in enumerate(got[1:]) if row[2] == 7]
    assert hot[0] == 6 and got[7][1] == "hbm_headroom 0.30"
    assert capped[0] == 7 and all(row[3] == 64 for row in got[1:])


def test_report_subcommands_render_and_gate(tmp_path, capsys):
    """``perf-report`` and ``memory-report`` print the renderers' text and
    exit 0 on a snapshot with a ledger, 1 under ``--require-ledger``
    without one; ``telemetry-report --require-costmodel --require-memory``
    fails on the programs that published no memory."""
    import json

    from fairness_llm_tpu_torch.cli import main as tcli

    snap = _cost_snapshot("t")
    path = tmp_path / "telemetry_snapshot.json"
    path.write_text(json.dumps(snap))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"gauges": [], "counters": [], "histograms": []}))
    assert tcli.main(["perf-report", str(path), "--require-ledger"]) == 0
    assert capsys.readouterr().out.strip() == tcost.render_cost_report(snap)
    assert tcli.main(["memory-report", str(path), "--require-ledger"]) == 0
    assert capsys.readouterr().out.strip() == tmem.render_memory_report(snap)
    assert tcli.main(["perf-report", str(empty), "--require-ledger"]) == 1
    assert tcli.main(["memory-report", str(empty), "--require-ledger"]) == 1
    capsys.readouterr()
    rc = tcli.main(["telemetry-report", str(path), "--require-costmodel", "--require-memory"])
    out = capsys.readouterr().out
    assert rc == 1 and "SNAPSHOT INVALID" in out
    assert "'serve_prefill' missing program_memory_bytes" in out
