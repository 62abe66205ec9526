"""The port's fairness observability (``telemetry/fairness.py``: the
streaming group accumulators, the pair watch, the serving-neutrality audit,
the report and the snapshot check) and the rest of the serving telemetry
(the engine's and the phases' registry calls, the report subcommands)
against the JAX package's.

The contract: the same study feed through both ``FairnessMonitor``s gives
snapshot gauges equal to 1e-6 and the same divergent-pair table; a biased
fault script through both schedulers gives the same alerts and
attributions; ``run_phase1`` with ``fairness_obs`` in both packages gives
records whose ``fairness`` block agrees to 1e-6; the report subcommands
render the same text from the same snapshot; ``check_fairness`` finds what
the reference validator's fairness gate finds.
"""

import importlib.util
import json
import pathlib
import random

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import config as jconfig  # noqa: E402
from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.cli import main as jcli  # noqa: E402
from fairness_llm_tpu.pipeline import phase1 as jphase1  # noqa: E402
from fairness_llm_tpu.pipeline.backends import backend_for as jbackend_for  # noqa: E402
from fairness_llm_tpu.utils import failures as jfail  # noqa: E402
from fairness_llm_tpu_torch import config as tconfig  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.cli import main as tcli  # noqa: E402
from fairness_llm_tpu_torch.pipeline import phase1 as tphase1  # noqa: E402
from fairness_llm_tpu_torch.pipeline.backends import backend_for as tbackend_for  # noqa: E402
from fairness_llm_tpu_torch.utils import failures as tfail  # noqa: E402
from test_torch_phase1 import _greedy_settings, assert_same_record  # noqa: E402
from test_torch_serving import SERVING, FakeClock, _engines  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
PKGS = {"t": (T, tserving, tconfig, tfail), "j": (J, jserving, jconfig, jfail)}
# Latency disparities are wall-clock ratios: compared by presence only.
TIMED_SIGNALS = ("ttft_mean_ratio", "queue_wait_mean_ratio")


def _fairness_view(snap) -> dict:
    """The fairness instruments of a snapshot: {(kind, name, labels):
    value}, histograms by count, wall-clock disparities as None."""
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        for row in snap.get(kind, []):
            labels = row.get("labels", {})
            if labels.get("component") != "fairness":
                continue
            key = (kind, row["name"], tuple(sorted(labels.items())))
            if kind == "histograms":
                out[key] = row["count"] if row["name"] != "fairness_pair_js" else \
                    (row["count"], round(row["sum"], 5))
            elif labels.get("signal") in TIMED_SIGNALS:
                out[key] = None
            else:
                out[key] = row["value"]
    return out


def assert_same_fairness(got_snap, want_snap):
    got, want = _fairness_view(got_snap), _fairness_view(want_snap)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], float):
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
        else:
            assert got[k] == want[k], (k, got[k], want[k])


# ---------------------------------------------------------------------------
# The monitor alone: the same feed
# ---------------------------------------------------------------------------

TITLES = [f"Film {c}" for c in "ABCDEFGHIJKLMNOP"]
OUTCOMES = ("completed", "completed", "completed", "failed", "expired", "shed", "preempted")


def _feed(pkg: str, seed: int):
    """A random study on a fake clock: two attributes, a pair grid, parsed
    outputs (some error rows), serving outcomes with latencies, requeue
    events and a direct-tagged pair; refreshes between feeds and after a
    window ages out. Returns the snapshot, the divergent table and the
    live values."""
    tel, serving = PKGS[pkg][0], PKGS[pkg][1]
    rng = random.Random(seed)
    clock = FakeClock()
    with tel.use_registry() as reg, tel.use_incident_manager():
        mon = tel.FairnessMonitor(window_s=50.0, min_group_n=2, clock=clock)
        mon.begin_study()
        keys = [f"p{i:02d}" for i in range(18)]
        for i, k in enumerate(keys):
            mon.register_request(k, {"gender": "mfx"[i % 3], "age": "ab"[i // 9]})
        for i in range(0, 18, 2):
            mon.register_pair(f"{keys[i]}|{keys[i + 1]}", keys[i], keys[i + 1],
                              "gender" if i % 4 else "age")
        for step, k in enumerate(rng.sample(keys, len(keys))):
            clock.t += rng.choice([1.0, 5.0, 30.0])
            if rng.random() < 0.3:
                mon.note_event(k, rng.choice(["requeued:device", "requeued:injected"]))
            outcome = rng.choice(OUTCOMES)
            req = serving.Request(prompt=f"prompt {k}" if rng.random() < 0.8 else "same",
                                  id=k, retries=int(rng.random() < 0.2))
            mon.observe_request(req, outcome, queue_wait_s=rng.uniform(0, 2),
                                ttft_s=(rng.uniform(0.1, 3) if outcome == "completed" else None),
                                text=" ".join(rng.sample(TITLES, 3)), rung=rng.randint(0, 2))
            mon.observe_output(k, rng.sample(TITLES, rng.randint(0, 6)),
                               error=rng.random() < 0.1)
            if step % 4 == 3:
                mon.maybe_refresh(min_interval_s=10.0)
        # A direct-tagged pair (auto-registers on the second member), one
        # member twice.
        for rid, text in (("d0", "alpha beta"), ("d0", "alpha beta"), ("d1", "alpha gamma")):
            mon.observe_request(serving.Request(prompt="same", id=rid, group=rid,
                                                attribute="probe", pair_id="dp"),
                                "completed", text=text)
        clock.t += 80.0  # the recent window ages out
        live = mon.live_values()
        table = list(mon.divergent)
        snap = tel.snapshot(reg)
    return snap, table, live


@pytest.mark.parametrize("seed", range(3))
def test_monitor_matches_the_reference(seed):
    got, want = _feed("t", seed), _feed("j", seed)
    assert_same_fairness(got[0], want[0])
    assert got[1] == want[1]
    assert_same_record(got[2], want[2], tol=TOL)
    assert got[1] and any(k[1] == "fairness_pair_divergence_total" for k in _fairness_view(got[0]))


# ---------------------------------------------------------------------------
# Both schedulers: a fault-free and a biased fault script
# ---------------------------------------------------------------------------

DRILL_PROMPTS = ["the quick brown fox", "hello there friend", "one two three",
                 "name five good books"]


def _tagged(serving, S):
    return [serving.Request(prompt=p, id=f"{g}{i}", settings=S(temperature=0.0, max_tokens=6),
                            group=g, attribute="drill", pair_id=f"pp{i}")
            for i, p in enumerate(DRILL_PROMPTS) for g in ("ga", "gb")]


@pytest.mark.parametrize("biased", [False, True], ids=["fault-free", "biased"])
def test_fault_script_through_both_schedulers_gives_the_same_audit(biased):
    """Group gb's first two requests fault twice (failed) in the biased
    script: the impaired-rate disparity alerts and the divergent pairs name
    the failed members and their requeues, alike in both packages; the
    fault-free run is silent."""
    jeng, teng = _engines()
    faults = {("gb0", "decode"): 2, ("gb1", "decode"): 2} if biased else {}
    out = {}
    for pkg, eng in (("t", teng), ("j", jeng)):
        tel, serving, cfg, fail = PKGS[pkg]
        with tel.use_registry() as reg, tel.use_incident_manager(), \
                tel.use_fairness_monitor() as mon:
            mon.min_group_n = 3
            sched = serving.ContinuousScheduler(
                eng, cfg.ServingConfig(**SERVING),
                settings=cfg.ModelSettings(temperature=0.0, max_tokens=8),
                fault_injector=fail.ScriptedFaultInjector(faults=faults))
            res = sched.serve(_tagged(serving, cfg.ModelSettings))
            out[pkg] = ([(r.id, r.ok, r.finish_reason, [int(t) for t in r.tokens]) for r in res],
                        list(mon.divergent), mon.pairs_joined, mon.pairs_divergent,
                        tel.snapshot(reg))
    assert out["t"][:4] == out["j"][:4]
    assert_same_fairness(out["t"][4], out["j"][4])
    alerts = {c["labels"]["signal"]: c["value"] for c in out["t"][4]["counters"]
              if c["name"] == "fairness_alerts_total"}
    if biased:
        assert alerts == {"impaired_rate": 1, "fault_rate": 1}
        assert out["t"][3] == 2
        for d in out["t"][1]:
            bad = d["members"][f"gb{d['pair_id'][-1]}"]
            assert bad["outcome"] == "failed" and any("requeued" in e for e in bad["events"])
    else:
        assert not alerts and out["t"][3] == 0 and out["t"][2] == len(DRILL_PROMPTS)


# ---------------------------------------------------------------------------
# run_phase1 with fairness_obs, served with overload armed, in both packages
# ---------------------------------------------------------------------------

STUDY_MODEL = "tiny-llama-study"


@pytest.fixture(scope="module")
def study_runs(tmp_path_factory):
    """The greedy --quick sweep (15 profiles and 1 neutral prompt, 8 new
    tokens) on the study checkpoint through ``backend_for`` with serving,
    overload control and the fairness monitor on, in both packages, each in
    its own registry; the port's snapshot and events are written to a
    telemetry dir."""
    d = tmp_path_factory.mktemp("fobs")
    out = {}
    for pkg in ("t", "j"):
        tel, _, mod, _ = PKGS[pkg]
        # SLO targets far above a loaded CPU's latencies: the burn gauges
        # (and slo-report --fail-on-burn) then read the same in both runs.
        prev = tel.set_slo_targets(tel.SLOTargets(ttft_p95_s=300.0, e2e_p99_s=600.0))
        cfg = mod.Config(weights_dir=str(ROOT / "checkpoints"),
                         results_dir=str(d / pkg), profiles_per_combo=1,
                         model_settings=_greedy_settings(mod.Config(), mod.ModelSettings,
                                                         STUDY_MODEL, 8),
                         serving=mod.ServingConfig(enabled=True, num_slots=8),
                         overload=mod.OverloadConfig(enabled=True),
                         telemetry=mod.TelemetryConfig(fairness_obs=True))
        tdir = d / f"{pkg}_tel"
        with tel.use_registry() as reg, tel.use_timeline(), tel.use_incident_manager(), \
                tel.use_fairness_monitor():
            sink = tel.configure(str(tdir))
            try:
                backend = (tbackend_for(STUDY_MODEL, cfg, device="cpu") if pkg == "t"
                           else jbackend_for(STUDY_MODEL, cfg))
                run = tphase1.run_phase1 if pkg == "t" else jphase1.run_phase1
                rec = run(cfg, STUDY_MODEL, backend=backend, save=False)
                tel.write_snapshot(reg, str(tdir))
            finally:
                tel.install_event_sink(None)
                sink.close()
                tel.set_slo_targets(prev)
            out[pkg] = (rec, tel.snapshot(reg), tdir, backend)
    return out


def test_run_phase1_fairness_block_matches_the_reference(study_runs):
    got, gsnap, _, backend = study_runs["t"]
    want, wsnap, _, _ = study_runs["j"]
    assert backend.overload is not None
    assert_same_record(got["metadata"]["fairness"], want["metadata"]["fairness"], tol=TOL)
    fb = got["metadata"]["fairness"]
    assert fb["live"]["pairs_joined"] > 0 and fb["live"]["alerts"] == 0
    assert_same_fairness(gsnap, wsnap)
    assert [r["raw_response"] for r in got["recommendations"].values()] == \
        [r["raw_response"] for r in want["recommendations"].values()]
    for name in ("phase_runs_total", "profiles_decoded_total", "decode_failures_total",
                 "overload_level", "shed_total"):
        rows = lambda s: sorted((r["name"], sorted(r["labels"].items()), r["value"])  # noqa: E731
                                for k in ("counters", "gauges") for r in s[k]
                                if r["name"] == name)
        assert rows(gsnap) == rows(wsnap), name
    assert T.check_fairness(gsnap) == []


# The reference's snapshot gate, loaded by path (tools/ is not a package).
def _validator():
    spec = importlib.util.spec_from_file_location("validate_telemetry",
                                                  ROOT / "tools" / "validate_telemetry.py")
    vt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vt)
    return vt


@pytest.mark.parametrize("perturb", ["none", "offline", "diverged", "alert", "empty"])
def test_check_fairness_finds_what_the_reference_gate_finds(study_runs, perturb):
    snap = json.loads(json.dumps(study_runs["t"][1]))
    if perturb == "offline":
        for g in snap["gauges"]:
            if g["name"] == "fairness_offline_dp":
                g["value"] += 0.01
    elif perturb in ("diverged", "alert"):
        name = ("fairness_pair_divergence_total" if perturb == "diverged"
                else "fairness_alerts_total")
        snap["counters"].append({"name": name, "value": 1,
                                 "labels": {"component": "fairness", "attribute": "gender"}})
    elif perturb == "empty":
        snap = {"counters": [], "gauges": []}
    got = T.check_fairness(snap)
    assert got == _validator()._check_fairness(snap)
    assert bool(got) == (perturb != "none")
    assert T.FAIRNESS_TOLERANCE == _validator().FAIRNESS_TOLERANCE


@pytest.mark.parametrize("argv", [
    ["telemetry-report", "--validate", "--timeline"], ["slo-report", "--fail-on-burn"],
    ["fairness-report", "--fail-on-alert"]], ids=lambda a: a[0])
def test_report_subcommands_render_the_reference_text(study_runs, argv, capsys):
    tdir = str(study_runs["t"][2])
    rcs = []
    texts = []
    for cli in (tcli, jcli):
        rcs.append(cli.main([argv[0], tdir] + argv[1:]))
        texts.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] == 0
    assert texts[0] == texts[1]
    assert "FAIRNESS SIGNALS" in texts[0] or argv[0] == "slo-report"


def test_fairness_report_validate_and_fail_on_alert(study_runs, tmp_path, capsys):
    tdir = study_runs["t"][2]
    assert tcli.main(["fairness-report", str(tdir), "--validate"]) == 0
    assert "fairness check: OK" in capsys.readouterr().out
    snap = json.loads((tdir / "telemetry_snapshot.json").read_text())
    snap["counters"].append({"name": "fairness_alerts_total", "value": 1,
                             "labels": {"component": "fairness", "attribute": "gender",
                                        "signal": "impaired_rate"}})
    bad = tmp_path / "telemetry_snapshot.json"
    bad.write_text(json.dumps(snap))
    for flags in (["--validate"], ["--fail-on-alert"]):
        assert tcli.main(["fairness-report", str(bad)] + flags) == 1
    assert jcli.main(["fairness-report", str(bad), "--fail-on-alert"]) == 1


# ---------------------------------------------------------------------------
# The engine's telemetry
# ---------------------------------------------------------------------------


def test_engine_publishes_the_reference_instruments():
    """The same generate calls (one with a shared prefix, one
    speculative) publish the same engine counters, histogram counts,
    prefix-LRU gauge and span names in both packages."""
    from fairness_llm_tpu.config import SpeculationConfig as JSpec
    from fairness_llm_tpu_torch.config import SpeculationConfig

    jeng, teng = _engines()
    prompts = ["a shared opening that both rows carry word for word " * 2 + s
               for s in ("then one", "then two")]
    views = []
    for tel, eng, mod, spec in ((T, teng, tconfig, SpeculationConfig),
                                (J, jeng, jconfig, JSpec)):
        s = mod.ModelSettings(temperature=0.0, max_tokens=6)
        with tel.use_registry() as reg, tel.use_timeline() as tl:
            eng.generate(prompts, s, share_prefix=True)
            eng.generate(prompts[:1], s, speculation=spec(enabled=True, draft_len=2))
            snap = tel.snapshot(reg)
            spans = sorted(e["name"] for e in tl.to_chrome_trace()["traceEvents"]
                           if e["ph"] == "X" and e.get("cat") in ("decode", "speculate"))
        rows = sorted((k, r["name"], sorted(r["labels"].items()),
                       r["count"] if k == "histograms" else r["value"])
                      for k in ("counters", "gauges", "histograms") for r in snap[k]
                      if r["labels"].get("component") == "engine"
                      and not r["name"].startswith("cost_"))
        views.append((rows, spans))
    assert views[0] == views[1]
    names = {r[1] for r in views[0][0]}
    assert {"generate_calls_total", "decode_paths_total", "generate_wall_s",
            "prefix_kv_entries", "spec_verify_steps_total"} <= names
