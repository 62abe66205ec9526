"""The port's incident engine (``telemetry/incidents.py``), its callers (the
SLO alert, the heartbeat gap, the manifest mismatch, the containment
branches) and the canary (``integrity/canary.py``) against the JAX
package's.

The contract: the same decisions and triggers give the same ring contents,
counters, bundles and renderings in both packages; the reference's
``validate_incidents`` accepts a bundle the port dumped (its manifest's
``config`` fingerprint names torch, where the reference's names jax, and
the reference reads no key of it); the canary trips the same breaker and
ladder; a canary armed on a healthy server never mismatches, and the
backend's output is the same with it on or off.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import integrity as jinteg  # noqa: E402
from fairness_llm_tpu import resilience as jres  # noqa: E402
from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.config import IntegrityConfig as JIntegrity  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ResilienceConfig as JResilience  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.telemetry import incidents as jinc  # noqa: E402
from fairness_llm_tpu_torch import integrity as tinteg  # noqa: E402
from fairness_llm_tpu_torch import resilience as tres  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import IntegrityConfig, ModelSettings  # noqa: E402
from fairness_llm_tpu_torch.config import ResilienceConfig, ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.telemetry import incidents as tinc  # noqa: E402
from fairness_llm_tpu_torch.utils import failures as tfail  # noqa: E402
from test_torch_resilience import guards  # noqa: E402
from test_torch_serving import SERVING, _engines, greedy  # noqa: E402

PKGS = {
    "port": dict(T=T, inc=tinc, res=tres, serving=tserving, integ=tinteg, S=ModelSettings,
                 Cfg=ServingConfig, R=ResilienceConfig, I=IntegrityConfig),
    "reference": dict(T=J, inc=jinc, res=jres, serving=jserving, integ=jinteg, S=JSettings,
                      Cfg=JServingConfig, R=JResilience, I=JIntegrity),
}


@contextlib.contextmanager
def scoped(tel, incidents_dir=None, clock=None):
    """A fresh registry, timeline, flight recorder and incident manager of
    one package (armed at ``incidents_dir`` when given)."""
    mgr = tel.IncidentManager(incidents_dir, clock=clock) if clock else \
        tel.IncidentManager(incidents_dir)
    with tel.use_registry() as reg, tel.use_timeline(), \
            tel.use_flight_recorder() as rec, tel.use_incident_manager(mgr):
        yield reg, rec, mgr


def _trail(rec):
    return [{k: v for k, v in d.items() if k != "t"} for d in rec.rings["decisions"]]


def _counters(reg, tel, names):
    return sorted((c["name"], sorted(c["labels"].items()), c["value"])
                  for c in tel.snapshot(reg)["counters"] if c["name"] in names)


INCIDENT_COUNTERS = ("decisions_total", "incident_triggers_total", "incident_bundles_total",
                     "incident_suppressed_total")


def test_decisions_triggers_and_dedup_match_the_reference(tmp_path):
    out = {}
    for name, p in PKGS.items():
        clock = [0.0]
        with scoped(p["T"], str(tmp_path / name), clock=lambda: clock[0]) as (reg, rec, mgr):
            p["T"].record_decision("fault", "decode:numerics",
                                   signals={"request_ids": ["a", "b"]}, request_id="a")
            p["T"].record_decision("breaker", "decode:closed->open",
                                   signals={"consecutive_failures": 3})
            with pytest.raises(ValueError):
                p["T"].record_decision("nonsense", "x")
            with pytest.raises(ValueError):
                mgr.trigger("nonsense", "x")
            first = mgr.trigger("numerics_fault", "nan chunk", scope="serving",
                                request_id="a")
            again = mgr.trigger("numerics_fault", "again", scope="serving")
            clock[0] = 61.0
            third = mgr.trigger("numerics_fault", "later", scope="serving")
            names = sorted(os.path.basename(b["path"]) for b in p["T"].list_bundles(
                str(tmp_path / name)))
            out[name] = (_trail(rec), _counters(reg, p["T"], INCIDENT_COUNTERS),
                         first is not None, again, third is not None, names,
                         p["inc"].causal_chain(
                             json.load(open(os.path.join(first, "incident.json"))),
                             [json.loads(x) for x in open(os.path.join(first,
                                                                       "decisions.jsonl"))],
                             []))
    assert out["port"] == out["reference"]
    assert out["port"][5] == ["numerics_fault-serving-001", "numerics_fault-serving-002"]


def test_port_bundle_validates_under_both_and_renders_alike(tmp_path):
    """A NaN drill through the port's scheduler with the incident engine
    armed: the bundles pass both packages' ``validate_incidents``, and both
    packages render them and derive the same causal chain."""
    _, teng = _engines()
    tel = tmp_path / "tel"
    with guards(teng), scoped(T, str(tel / T.incidents.INCIDENTS_DIRNAME)):
        sched = tserving.ContinuousScheduler(
            teng, ServingConfig(**SERVING), settings=greedy(8),
            fault_injector=tfail.ScriptedFaultInjector(corruptions={("n", "decode"): 1}),
            resilience=ResilienceConfig(enabled=True))
        results = sched.serve([tserving.Request(prompt=p, id=rid, settings=greedy(8))
                               for rid, p in (("n", "hello"), ("m", "zz"))])
    assert all(r.ok for r in results)
    assert T.validate_incidents(str(tel), require=True) == []
    assert J.validate_incidents(str(tel), require=True) == []
    assert J.validate_incidents(str(tel), forbid=True) != []
    (bundle,) = T.list_bundles(str(tel / "incidents"))
    assert bundle["class"] == "numerics_fault" and bundle["request_id"] == "n"
    # The fingerprint names torch where the reference's names jax/platform.
    assert {"torch", "cuda", "device"} <= set(bundle["config"])
    assert not {"jax", "platform"} & set(bundle["config"])
    assert T.render_incident_report(bundle["path"]) == \
        J.render_incident_report(bundle["path"])
    assert "numerics_fault" in T.render_incident_report(bundle["path"])


def test_heartbeat_gap_and_slo_alerts_match_the_reference(tmp_path):
    out = {}
    for name, p in PKGS.items():
        from importlib import import_module

        hb_mod = import_module(p["T"].__name__ + ".heartbeat")
        slo_mod = import_module(p["T"].__name__ + ".slo")
        inc = str(tmp_path / name)
        with scoped(p["T"], inc) as (reg, rec, mgr):
            clock = [0.0]
            hb = hb_mod.Heartbeat(interval_s=10.0, name="t", clock=lambda: clock[0])
            hb.poke()
            clock[0] = 12.0
            hb.poke()
            clock[0] = 100.0
            hb.poke()
            slo_mod.SLOEvaluator(targets=slo_mod.SLOTargets(ttft_p95_s=0.001)).observe(
                "completed", ttft_s=5.0, e2e_s=5.0)
            slo_mod.SLOEvaluator(targets=slo_mod.SLOTargets(error_rate=0.01)).observe(
                "failed", ttft_s=None, e2e_s=None)
            classes = [b["class"] for b in p["T"].list_bundles(inc)]
            out[name] = (_trail(rec), classes, _counters(reg, p["T"], INCIDENT_COUNTERS))
    assert out["port"] == out["reference"]
    assert out["port"][1] == ["heartbeat_gap", "slo_burn"]


def test_manifest_mismatch_triggers_like_the_reference(tmp_path):
    from fairness_llm_tpu.integrity import manifest as jman
    from fairness_llm_tpu_torch.integrity import manifest as tman

    (tmp_path / "w").mkdir()
    (tmp_path / "w" / "a.bin").write_bytes(b"\x00" * 64)
    jman.write_manifest(str(tmp_path / "w"))
    tfail.ScriptedFaultInjector.flip_bit(str(tmp_path / "w" / "a.bin"), 9)
    out = {}
    for name, mod, err in (("port", tman, tman.IntegrityError),
                           ("reference", jman, jman.IntegrityError)):
        p = PKGS[name]
        with scoped(p["T"], str(tmp_path / name)) as (reg, rec, mgr):
            with pytest.raises(err, match="a.bin"):
                mod.verify_manifest(str(tmp_path / "w"), kind="weights")
            assert mod.verify_manifest_entry(str(tmp_path / "w"), "a.bin") is False
            out[name] = (_counters(reg, p["T"], ("manifest_verifications_total",
                                                 "manifest_failures_total",
                                                 "incident_triggers_total")),
                         [b["class"] for b in p["T"].list_bundles(str(tmp_path / name))])
    assert out["port"] == out["reference"]
    assert out["port"][1] == ["integrity_fault", "integrity_fault"]  # weights, results


def test_fatal_device_error_dumps_a_bundle(tmp_path):
    with scoped(T, str(tmp_path)) as (reg, rec, mgr):
        err = torch.AcceleratorError("CUDA error: device-side assert triggered")
        tfail.note_fatal_device_error(err, "serving", "decode")
        tfail.note_fatal_device_error(err, "pipeline", "generate")  # counted once
        (bundle,) = T.list_bundles(str(tmp_path))
        assert bundle["class"] == "device_fatal" and "device-side assert" in bundle["cause"]
        assert reg.peek("faults_total", component="serving", kind="device_fatal",
                        stage="decode").value == 1
        assert reg.peek("faults_total", component="pipeline", kind="device_fatal",
                        stage="generate") is None
        assert [d["action"] for d in _trail(rec)] == ["decode:device_fatal", "device_fatal"]


def test_breaker_trip_dumps_a_bundle_naming_the_riders(tmp_path):
    """Two decode faults in a row open the decode breaker: in both packages
    the trip dumps a ``breaker_open`` bundle after the fault decisions that
    name the faulted requests, the ladder moves one rung and, the cooldown
    being 0, the half-open probe closes it again. (SLO latency decisions
    depend on the host's clock and stay out of the comparison.)"""
    jeng, teng = _engines()
    out = {}
    for name, eng in (("port", teng), ("reference", jeng)):
        p = PKGS[name]
        with scoped(p["T"], str(tmp_path / name)) as (reg, rec, mgr):
            F = tfail if name == "port" else __import__(
                "fairness_llm_tpu.utils.failures", fromlist=["x"])
            sched = p["serving"].ContinuousScheduler(
                eng, p["Cfg"](**SERVING), settings=p["S"](temperature=0.0, max_tokens=8),
                fault_injector=F.ScriptedFaultInjector(faults={
                    ("x", "decode"): 1, ("y", "decode"): 1}),
                resilience=p["R"](enabled=True, breaker_threshold=2, breaker_cooldown_s=0.0))
            res = sched.serve([p["serving"].Request(prompt="hi", id=i, settings=p["S"](
                temperature=0.0, max_tokens=4)) for i in "xyz"])
            bundles = p["T"].list_bundles(str(tmp_path / name))
            out[name] = ([(r.id, r.ok, r.finish_reason) for r in res],
                         [b["class"] for b in bundles], sched.breakers.ladder.level,
                         [(d["decision"], d["action"], d.get("request_id"))
                          for d in _trail(rec) if d["decision"] != "slo_alert"])
    assert out["port"] == out["reference"]
    assert out["port"][1] == ["breaker_open"]
    assert ("breaker", "decode:closed->open", None) in out["port"][3]


# ---------------------------------------------------------------------------
# The canary
# ---------------------------------------------------------------------------


def test_canary_match_then_mismatch_trips_the_ladder_like_the_reference():
    jeng, teng = _engines()
    out = {}
    for name, eng in (("port", teng), ("reference", jeng)):
        p = PKGS[name]
        with p["T"].use_registry() as reg, p["T"].use_incident_manager():
            board = p["res"].BreakerBoard(failure_threshold=3, cooldown_s=60.0)
            sched = p["serving"].ContinuousScheduler(
                eng, p["Cfg"](**SERVING), settings=p["S"](temperature=0.0, max_tokens=8),
                breakers=board)
            # The port records at the pool's shape, the reference with its
            # engine: in float32 on the CPU both give the same row.
            where = (p["Cfg"](**SERVING),) if name == "port" else ()
            probe = p["integ"].CanaryProbe.record(eng, *where, max_tokens=8, every_n=2,
                                                  board=board)
            ticks = [probe.tick(), probe.tick()]
            first = probe.probe(sched)
            probe.reference = probe.reference.copy()
            probe.reference[0] += 1
            second = probe.probe(sched)
            out[name] = (ticks, first, second, board.state("decode"), board.ladder.level,
                         [int(t) for t in probe.reference],
                         _counters(reg, p["T"], ("canary_runs_total",
                                                 "canary_mismatch_total")))
    assert out["port"] == out["reference"]
    assert out["port"][:5] == ([False, True], True, False, "open", 1)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_canary_recorded_at_the_pool_shape_never_trips_a_healthy_server(paged):
    """The backend's canary, recorded in a private pool of the live pool's
    shape, probes every call and never mismatches; the backend's output
    equals the canary-free backend's and the reference's."""
    jeng, teng = _engines()
    kw = dict(SERVING, paged_kv=paged, kv_block_size=16)
    prompts = ["hello there", "the quick brown fox", "zz"]
    keys = ["a", "b", "c"]
    want = jserving.ServingBackend(jeng, JServingConfig(**kw)).generate(
        prompts, JSettings(temperature=0.0, max_tokens=8), keys=keys)
    plain = tserving.ServingBackend(teng, ServingConfig(**kw)).generate(
        prompts, greedy(8), keys=keys)
    with guards(teng), T.use_registry() as reg, T.use_incident_manager():
        be = tserving.ServingBackend(teng, ServingConfig(**kw),
                                     resilience=ResilienceConfig(enabled=True),
                                     integrity=IntegrityConfig(numerics_guards=True,
                                                               canary_every_n=1,
                                                               canary_max_tokens=8))
        got = [be.generate(prompts, greedy(8), keys=keys) for _ in range(3)]
        assert reg.peek("canary_runs_total", component="serving").value == 3
        assert reg.peek("canary_mismatch_total", component="serving") is None
        assert be.board.ladder.level == 0
    assert got == [plain] * 3 and plain == want
    probe = be._canary
    assert len(probe.alternates) <= (1 if paged else 0)
    ref = jinteg.CanaryProbe.record(jeng, max_tokens=8)
    np.testing.assert_array_equal(probe.reference, ref.reference)


def test_static_fallback_rung_serves_through_the_engine():
    """Level 3 of the ladder with the breakers open and cooling down: the
    backend serves through the static engine, counted, with the same
    tokens; the reference does the same."""
    jeng, teng = _engines()
    prompts, keys = ["hello there", "zz"], ["a", "b"]
    out = {}
    for name, eng in (("port", teng), ("reference", jeng)):
        p = PKGS[name]
        with p["T"].use_registry() as reg, p["T"].use_incident_manager():
            be = p["serving"].ServingBackend(
                eng, p["Cfg"](**SERVING),
                resilience=p["R"](enabled=True, breaker_threshold=1,
                                  breaker_cooldown_s=3600.0))
            for stage in ("prefill", "decode", "speculate"):
                be.board.trip(stage)
            texts = be.generate(prompts, p["S"](temperature=0.0, max_tokens=8), keys=keys)
            out[name] = (texts, be.board.ladder.level, reg.peek(
                "static_fallback_calls_total", component="serving").value)
            eng.breakers = None
            eng.restore_speculation()
    assert out["port"] == out["reference"]
    assert out["port"][1:] == (3, 1)


# ---------------------------------------------------------------------------
# The CLI: flags, the incident report and resume-serving
# ---------------------------------------------------------------------------


def test_cli_guarded_journaled_run_then_reports_and_resume(tmp_path, capsys):
    from fairness_llm_tpu_torch.cli import main as tcli

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tel, jdir = tmp_path / "tel", tmp_path / "journal"
    args = ["--phase", "1", "--quick", "--model", "tiny-llama-study", "--weights-dir",
            os.path.join(root, "checkpoints"), "--data-dir", str(tmp_path / "no-data"),
            "--results-dir", str(tmp_path / "r"), "--device", "cpu", "--continuous",
            "--slots", "4", "--serving-journal", str(jdir), "--numerics-guards",
            "--canary-every", "1", "--max-step-seconds", "600", "--incidents",
            "--telemetry-dir", str(tel), "--no-save"]
    with T.use_registry(), T.use_timeline(), T.use_incident_manager():
        assert tcli.main(args) == 0
    assert tres.ServingJournal(str(jdir)).unfinished() == []
    snap = T.load_snapshot(str(tel))
    assert T.validate_snapshot(snap) == []
    names = {c["name"] for c in snap["counters"]}
    assert "canary_runs_total" in names and "canary_mismatch_total" not in names
    assert T.validate_incidents(str(tel), forbid=True) == []
    capsys.readouterr()
    assert tcli.main(["incident-report", str(tel)]) == 0
    assert "no incident bundles" in capsys.readouterr().out
    assert tcli.main(["resume-serving", str(jdir), "--model", "tiny-llama-study",
                      "--weights-dir", os.path.join(root, "checkpoints"),
                      "--device", "cpu"]) == 0
    assert "nothing to do" in capsys.readouterr().out
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(args))
    assert dataclasses.asdict(cfg.resilience)["journal_dir"] == str(jdir)
