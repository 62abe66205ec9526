"""The port's telemetry core (``fairness_llm_tpu_torch/telemetry``) against
the JAX package's: the same operations into both packages' registries,
timelines, tracers, SLO evaluators, heartbeats and flight recorders give
the same snapshots, Prometheus text, reports, traces and summaries; and a
serve through the port's scheduler publishes the reference's instruments
under the reference's names and labels.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.telemetry import flightrecorder as jfr  # noqa: E402
from fairness_llm_tpu.utils import profiling as jprof  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.telemetry import flightrecorder as tfr  # noqa: E402
from fairness_llm_tpu_torch.utils import profiling as tprof  # noqa: E402
from test_torch_serving import ROOT, STUDY_MODEL, _engines, greedy  # noqa: E402


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _same_snapshot(a, b):
    """Snapshots equal but for their creation stamps (the incident engine's
    decision counters included)."""
    def strip(snap):
        return {k: v for k, v in snap.items() if k != "created_at_unix"}

    assert strip(a) == strip(b)


def _report(snap):
    """The rendered report without its time-stamped title line."""
    return "\n".join(line for line in J.render_report(snap).splitlines()
                     if not line.startswith("TELEMETRY REPORT"))


def _random_ops(rng, n=120):
    names = ["a_total", "b_total", "lat_s", "depth", "ratio"]
    comps = ["serving", "engine", "paged_kv"]
    ops = []
    for _ in range(n):
        kind = rng.choice(["counter", "gauge_set", "gauge_add", "gauge_max", "hist",
                           "count_hist"])
        name = str(rng.choice(names))
        labels = {"component": str(rng.choice(comps))}
        if rng.random() < 0.3:
            labels["replica"] = str(rng.choice(["r0", "r1"]))
        value = float(rng.choice([0.0, 1e-4, 0.003, 0.2, 1.0, 7.0, 45.0, 2e3]))
        ops.append((kind, name, labels, value))
    return ops


def _apply(reg, ops):
    for kind, name, labels, value in ops:
        name = f"{kind}_{name}"  # one instrument kind per name
        if kind == "counter":
            reg.counter(name, **labels).inc(int(value))
        elif kind == "gauge_set":
            reg.gauge(name, **labels).set(value)
        elif kind == "gauge_add":
            reg.gauge(name, **labels).add(value)
        elif kind == "gauge_max":
            reg.gauge(name, **labels).set_max(value)
        elif kind == "hist":
            reg.histogram(name, **labels).observe(value)
        else:
            reg.histogram(name, J.DEFAULT_COUNT_BOUNDS, **labels).observe(value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_prometheus_and_report_match_the_reference(seed):
    ops = _random_ops(np.random.default_rng(seed))
    got, want = T.MetricsRegistry(), J.MetricsRegistry()
    _apply(got, ops)
    _apply(want, ops)
    gs, ws = T.snapshot(got), J.snapshot(want)
    _same_snapshot(gs, ws)
    assert T.validate_snapshot(gs) == J.validate_snapshot(ws) == []
    assert T.to_prometheus(got) == J.to_prometheus(want)
    assert T.render_report(gs).splitlines()[1:] == J.render_report(ws).splitlines()[1:]
    for q in (50, 95, 99):
        for g, w in zip(got.instruments(), want.instruments()):
            if isinstance(w, J.Histogram):
                assert g.percentile(q) == w.percentile(q)
    assert T.DEFAULT_LATENCY_BOUNDS == J.DEFAULT_LATENCY_BOUNDS


def test_validate_snapshot_flags_the_same_problems():
    reg = T.MetricsRegistry()
    reg.histogram("h", component="x").observe(0.1)
    bad = T.snapshot(reg)
    bad["histograms"][0]["count"] = 3
    bad["histograms"][0]["p95"] = 1e9
    bad["counters"] = [{"name": 1, "labels": {}, "value": "x"}]
    assert T.validate_snapshot(bad) == J.validate_snapshot(bad) != []
    assert T.validate_snapshot([]) == J.validate_snapshot([])


def test_registry_scoping_and_peek_match_the_reference():
    for mod in (T, J):
        with mod.use_registry() as reg:
            mod.get_registry().counter("c", component="x").inc(3)
            assert reg.peek("c", component="x").value == 3
            assert reg.peek("c", component="y") is None
            assert reg.read_value("c", component="x") == 3
        assert mod.get_registry() is not reg


def _timeline_ops(tl):
    tl.record_span("prefill[2x64]", "prefill", "serving", 10.0, 0.25, rows=2)
    tl.note_busy("serving", 10.0, 0.25)
    gaps = []
    for i in range(4):
        gaps.append(tl.decode_chunk("serving", 10.3 + i * 0.5, 0.4, 4, rows=2,
                                    program="paged_step"))
    tl.record_instant("fence", "serving", t=11.0, reason="test")
    tl.record_request("req_1", "serving", 9.9, 12.0, "completed", tokens=8)
    tl.record_span("phase1", "phase", "host", 9.0, 4.0)
    tl.clear_track_cursor("serving")
    gaps.append(tl.decode_chunk("serving", 20.0, 0.1, 1))
    return gaps


def test_timeline_trace_matches_and_validates_under_both():
    with T.use_registry() as treg, T.use_timeline() as ttl:
        tg = _timeline_ops(ttl)
    with J.use_registry() as jreg, J.use_timeline() as jtl:
        jg = _timeline_ops(jtl)
    assert tg == jg
    got, want = ttl.to_chrome_trace(), jtl.to_chrome_trace()
    assert T.validate_chrome_trace(got) == J.validate_chrome_trace(got) == []
    assert J.validate_chrome_trace(want) == []
    for trace in (got, want):  # the producer names its package
        trace["traceEvents"][0]["args"].pop("name")
        trace["otherData"].pop("producer")
    assert got == want
    assert T.summarize_chrome_trace(got) == J.summarize_chrome_trace(want)
    _same_snapshot(T.snapshot(treg), J.snapshot(jreg))
    broken = {"traceEvents": [{"ph": "b", "name": "r", "pid": 1, "ts": 1.0, "id": "r",
                               "cat": "request"}, {"ph": "Q", "name": "x", "pid": 1,
                                                   "ts": -1}]}
    assert T.validate_chrome_trace(broken) == J.validate_chrome_trace(broken) != []


def test_timeline_export_and_the_attribution_switch(tmp_path):
    tl = T.Timeline(capacity=3)
    for i in range(5):
        tl.record_span(f"s{i}", "decode", "serving", float(i), 0.5)
    assert tl.dropped == 2 and len(tl.events()) == 3
    path = tl.export(str(tmp_path / "t" / T.TRACE_FILENAME))
    trace = json.loads(open(path).read())
    assert J.validate_chrome_trace(trace) == [] and trace["otherData"]["dropped_events"] == 2
    with T.use_timeline():
        prev = T.set_attribution(False)
        try:
            assert not T.attribution_on()
            T.get_timeline().record_span("x", "decode", "serving", 0.0, 1.0)
            assert T.get_timeline().events() == []
        finally:
            T.set_attribution(prev)


def _tracer_ops(mod, clock):
    """A lifecycle of four requests on the injected clock."""
    tracer = mod.RequestTracer(component="serving")
    tracer.slo._clock = clock
    rows = []
    plan = [("a", "completed", 5), ("b", "failed", 0), ("c", "expired", 2),
            ("d", "completed", 1)]
    for rid, outcome, toks in plan:
        for event, dt in (("submitted", 0.0), ("admitted", 0.02), ("prefill_start", 0.01),
                          ("first_token", 0.3)):
            if outcome == "failed" and event == "first_token":
                continue
            clock.t += dt
            tracer.record(rid, event)
        clock.t += 0.4
        row = tracer.finalize(rid, outcome, tokens=toks)
        rows.append((row.queue_wait_s, row.ttft_s, row.e2e_s, row.per_output_token_s))
        tracer.sample_step_gauges(occupancy=len(rows), queue_depth=4 - len(rows),
                                  decode_steps=3)
    order = []
    for row, evs in tracer.finished:
        mod.assert_span_order(evs)
        order.append([e.event for e in evs])
    return rows, order, tracer.slo.evaluate(now=clock.t)


def test_request_tracer_spans_and_slo_match_the_reference(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    with T.use_registry() as treg, T.use_timeline() as ttl:
        got = _tracer_ops(T, clock)
    clock.t = 100.0
    with J.use_registry() as jreg, J.use_timeline() as jtl:
        want = _tracer_ops(J, clock)
    assert got == want
    _same_snapshot(T.snapshot(treg), J.snapshot(jreg))
    gs = T.snapshot(treg)
    assert T.render_slo_report(gs) == J.render_slo_report(gs)
    assert any(g["name"] == "slo_burn_rate" for g in gs["gauges"])
    got_trace = ttl.to_chrome_trace()
    assert J.validate_chrome_trace(got_trace) == []
    assert len(got_trace["traceEvents"]) == len(jtl.to_chrome_trace()["traceEvents"])
    with pytest.raises(ValueError):
        T.RequestTracer().finalize("x", "done", tokens=0)
    with pytest.raises(AssertionError):
        T.assert_span_order([T.SpanEvent("x", "admitted", 1.0)])


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_evaluator_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    clocks = FakeClock(), FakeClock()
    targets = dict(ttft_p95_s=0.5, e2e_p99_s=2.0, error_rate=0.1, fast_window_s=10.0,
                   slow_window_s=60.0)
    with T.use_registry() as treg, J.use_registry() as jreg:
        got = T.SLOEvaluator(T.SLOTargets(**targets), clock=clocks[0])
        want = J.SLOEvaluator(J.SLOTargets(**targets), clock=clocks[1])
        for _ in range(80):
            dt = float(rng.choice([0.0, 0.5, 3.0, 20.0]))
            for c in clocks:
                c.t += dt
            outcome = str(rng.choice(["completed", "completed", "failed", "expired",
                                      "preempted", "shed"]))
            ttft = float(rng.choice([0.1, 0.9]))
            e2e = float(rng.choice([0.5, 3.0]))
            got.observe(outcome, ttft_s=ttft, e2e_s=e2e)
            want.observe(outcome, ttft_s=ttft, e2e_s=e2e)
            if rng.random() < 0.3:
                assert got.evaluate() == want.evaluate()
            got.maybe_evaluate()
            want.maybe_evaluate()
    _same_snapshot(T.snapshot(treg), J.snapshot(jreg))
    assert T.render_slo_report(T.snapshot(treg)) == J.render_slo_report(J.snapshot(jreg))


def test_heartbeat_matches_the_reference():
    clocks = FakeClock(), FakeClock()
    beats = ([], [])
    with T.use_registry() as treg, J.use_registry() as jreg:
        hbs = (T.Heartbeat(interval_s=10.0, name="serving", clock=clocks[0]),
               J.Heartbeat(interval_s=10.0, name="serving", clock=clocks[1]))
        for dt in (0.0, 5.0, 6.0, 12.0, 100.0, 1.0, 10.0):
            for c, hb, out in zip(clocks, hbs, beats):
                c.t += dt
                out.append(hb.poke(completed=3))
    assert beats[0] == beats[1]
    assert (hbs[0].beats, hbs[0].max_gap_s) == (hbs[1].beats, hbs[1].max_gap_s)
    _same_snapshot(T.snapshot(treg), J.snapshot(jreg))


def test_flight_recorder_matches_the_reference():
    snaps = []
    for mod in (tfr, jfr):
        with mod.use_flight_recorder(mod.FlightRecorder(capacity=3)) as rec:
            for i in range(5):
                rec.record("chunks", program="paged_step", steps=i, t=float(i))
            assert rec.transition("breaker", "decode", 1, t=9.0)
            assert not rec.transition("breaker", "decode", 1, t=9.5)
            assert not rec.record("nope", x=1)  # unknown ring: refused, never raised
            snaps.append(rec.snapshot())
    assert snaps[0] == snaps[1]
    assert tfr.RING_CATEGORIES == jfr.RING_CATEGORIES


def test_event_sink_rotation_and_configure(tmp_path):
    for mod, sub in ((T, "t"), (J, "j")):
        sink = mod.JsonlSink(str(tmp_path / sub / "events.jsonl"), max_bytes=200, keep=2)
        for i in range(12):
            sink.emit("span", request_id=f"r{i}", event="submitted")
        sink.close()
    got = [{k: v for k, v in e.items() if k != "ts_unix"}
           for e in T.read_events(str(tmp_path / "t" / "events.jsonl"))]
    want = [{k: v for k, v in e.items() if k != "ts_unix"}
            for e in J.read_events(str(tmp_path / "j" / "events.jsonl"))]
    assert got == want and got
    sink = T.configure(str(tmp_path / "tel"))
    try:
        T.emit_event("heartbeat", name="x")
        assert T.event_sink() is sink
    finally:
        T.install_event_sink(None)
        sink.close()
    assert [e["kind"] for e in T.read_events(str(tmp_path / "tel" / "events.jsonl"))] == \
        ["heartbeat"]


def test_stats_publish_and_phase_timer_match_the_reference():
    serving = dict(num_slots=8, admitted=3, completed=2, expired=1, decode_steps=10,
                   decoded_tokens=25, occupancy_sum=20, queue_depth_max=4,
                   loop_iterations=5, prefill_batches=2, prefill_tokens=300)
    spec = dict(drafted=40, accepted=11, verify_steps=9, emitted=30, draft_len=8,
                ngram_max=3)
    regs = T.MetricsRegistry(), J.MetricsRegistry()
    for reg, prof in zip(regs, (tprof, jprof)):
        prof.ServingStats(**serving).publish(reg, labels={"replica": "r0"})
        prof.ServingStats(**serving).publish(reg)
        prof.SpeculationStats(**spec).publish(reg)
    _same_snapshot(T.snapshot(regs[0]), J.snapshot(regs[1]))
    sink = {}
    with tprof.phase_timer("phase 1", sink):
        pass
    assert set(sink) == {"phase 1"} and sink["phase 1"] >= 0.0


# The cost walk's per-component rows: the port walks aten ops where the
# reference walks jaxpr equations (whose walk fails to import under jax
# 0.9.0); tests/test_torch_devtelemetry.py holds the port's walk to the
# config's arithmetic instead.
WALKED = ("cost_ledger_bytes", "cost_ledger_flops", "cost_component_min_s_total")
# Compared by presence: the roofline's achieved rates read the host's clock,
# and the ledger's pool bytes differ by the port's int64 cache planes
# (test_torch_devtelemetry.py states the difference).
PRESENCE = ("achieved_hbm_gbps", "achieved_over_achievable", "hbm_bytes", "hbm_bytes_total")


def _instruments(snap):
    """(section, name, labels) -> value, or the count for histograms. The
    instruments that read the host's clock (``*_s`` gauges, and the SLO
    burn rates and alerts, which judge latencies against targets) map to
    None: two frameworks on one CPU take different times; so do the
    ``PRESENCE`` rows. The ``WALKED`` rows are left out."""
    out = {}
    for section in ("counters", "gauges", "histograms"):
        for row in snap[section]:
            key = (section, row["name"], tuple(sorted(row["labels"].items())))
            if row["name"] in WALKED or (row["name"] == "hbm_bytes"
                                         and row["labels"].get("pool") == "other"):
                # (the "other" pool holds the paged view and table buffers,
                # which the reference keeps inside its compiled step)
                continue
            if row["name"].startswith("slo_") or row["name"] in PRESENCE or (
                    section != "histograms" and row["name"].endswith(("_s", "_s_total"))):
                out[key] = None
            else:
                out[key] = row["count"] if section == "histograms" else row["value"]
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_serve_publishes_the_reference_instruments(paged):
    """The same serve through both schedulers: every instrument the port
    publishes is one the reference publishes, with the same value (or
    observation count); wall-clock instruments and the memory ledger's
    bytes compare by presence, the cost walk's rows are held elsewhere."""
    from fairness_llm_tpu import serving as jserving
    from fairness_llm_tpu.config import ModelSettings as JSettings
    from fairness_llm_tpu.config import ServingConfig as JServingConfig
    from fairness_llm_tpu.telemetry import memory as jmem
    from fairness_llm_tpu_torch import serving as tserving
    from fairness_llm_tpu_torch.config import ServingConfig
    from fairness_llm_tpu_torch.telemetry import memory as tmem

    from test_torch_paged import FAMILY

    kw = dict(enabled=True, num_slots=2, max_prompt_len=192, max_new_tokens=32,
              decode_chunk=4, paged_kv=paged)
    prompts = FAMILY[:3] + ["hi", "zz"]
    budgets = [8, 6, 4, 8, 2]
    jeng, teng = _engines()
    # Neither package captures per-program memory here, whatever an earlier
    # test in the process armed (the two captures measure differently), and
    # each accounts into a fresh memory ledger (the process-wide one holds
    # earlier tests' pools, which every refresh publishes).
    tprev, jprev = tmem.set_program_memory_capture(False), jmem.set_aot_memory_capture(False)
    try:
        with T.use_registry() as treg, T.use_timeline() as ttl, tmem.use_memory_ledger():
            sched = tserving.ContinuousScheduler(teng, ServingConfig(**kw), settings=greedy(8))
            sched.serve([tserving.Request(prompt=p, settings=greedy(m), id=f"q{i}")
                         for i, (p, m) in enumerate(zip(prompts, budgets))])
        with J.use_registry() as jreg, J.use_timeline() as jtl, jmem.use_memory_ledger():
            js = JSettings(temperature=0.0, max_tokens=8)
            jsched = jserving.ContinuousScheduler(jeng, JServingConfig(**kw), settings=js)
            jsched.serve([jserving.Request(prompt=p, settings=JSettings(temperature=0.0,
                                                                         max_tokens=m),
                                           id=f"q{i}")
                          for i, (p, m) in enumerate(zip(prompts, budgets))])
    finally:
        tmem.set_program_memory_capture(tprev)
        jmem.set_aot_memory_capture(jprev)
    got, want = _instruments(T.snapshot(treg)), _instruments(J.snapshot(jreg))
    missing = {k for k, v in got.items() if k not in want and not k[1].startswith("slo_")}
    assert not missing
    assert {k: v for k, v in got.items() if v is not None} == \
        {k: want[k] for k, v in got.items() if v is not None}
    names = {k[1] for k in got}
    for name in ("serving_completed_total", "ttft_s", "e2e_latency_s", "step_gap_s",
                 "prefill_wall_s", "queue_depth_hwm", "slot_occupancy_dist",
                 "slo_burn_rate", "cost_host_gap_s_total"):
        assert name in names, name
    if paged:
        for name in ("prefix_cache_hit_ratio", "kv_blocks_free", "matched_prefix_len"):
            assert name in names, name
    assert T.validate_snapshot(T.snapshot(treg)) == []
    trace = ttl.to_chrome_trace()
    assert T.validate_chrome_trace(trace) == J.validate_chrome_trace(trace) == []
    spans = sorted(e["name"] for e in trace["traceEvents"] if e["ph"] == "X")
    want_spans = sorted(e["name"] for e in jtl.to_chrome_trace()["traceEvents"]
                        if e["ph"] == "X" and e.get("cat") in ("prefill", "decode", "compile"))
    assert spans == want_spans
    chunks = tfr.get_flight_recorder().snapshot()["rings"]["chunks"]
    assert chunks and chunks[-1]["program"] == ("paged_step" if paged else "serve_step")
    for row, evs in sched.tracer.finished:
        T.assert_span_order(evs)


def test_cli_paged_run_writes_a_valid_telemetry_dir(tmp_path):
    """``--continuous --paged-kv --telemetry-dir`` on the study checkpoint:
    the snapshot passes both validators and holds the paged gauges, and
    ``trace.json`` passes both trace validators."""
    from fairness_llm_tpu_torch.cli import main as tcli

    tel = tmp_path / "tel"
    args = ["--phase", "1", "--quick", "--model", STUDY_MODEL, "--weights-dir",
            str(ROOT / "checkpoints"), "--device", "cpu", "--continuous", "--paged-kv",
            "--max-new-tokens", "8", "--results-dir", str(tmp_path / "r"),
            "--telemetry-dir", str(tel)]
    with T.use_registry(), T.use_timeline():
        assert tcli.main(args) == 0
    assert T.event_sink() is None
    snap = T.load_snapshot(str(tel))
    assert T.validate_snapshot(snap) == J.validate_snapshot(snap) == []
    gauges = {g["name"]: g["value"] for g in snap["gauges"]
              if g["labels"].get("component") == "paged_kv"}
    assert gauges["prefix_cache_hit_ratio"] > 0.5 and "kv_blocks_free" in gauges
    trace = json.loads((tel / T.TRACE_FILENAME).read_text())
    assert T.validate_chrome_trace(trace) == J.validate_chrome_trace(trace) == []
    assert "TIMELINE SUMMARY" in T.summarize_chrome_trace(trace)
    assert (tel / "metrics.prom").read_text().startswith("# TYPE")
    kinds = {e["kind"] for e in T.read_events(str(tel / "events.jsonl"))}
    assert "span" in kinds
    rec = json.loads((tmp_path / "r" / "phase1" / "phase1_results.json").read_text())
    assert rec["metadata"]["serving"]["completed"] == 16
