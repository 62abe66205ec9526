"""The port's replica fleet (``serving/router.py``, ``serving/fleet.py``, the
fleet mode of ``ServingBackend``, the CLI's ``--replicas``) against the JAX
package's.

The contract: both routers give the same health scores, loads and
placement weights (to 1e-6), the same picks and the same fence verdicts
for the same replica states; both fleets, driven by the same
``ScriptedFaultInjector`` scripts (a replica crash, a hang, a ladder fence
from request faults, every replica crashing), give the same greedy rows,
the same fence reasons and the same ``fleet_*`` counters, and every row
equals the port's engine; a migrated request reaches its new replica with
its id, settings and row seed; a fatal CUDA error inside a replica raises
out of the fleet, uncounted as a crash and unmigrated; ``check_fleet``
finds what the reference's ``--require-fleet`` gate finds. The CLI's
``--continuous --replicas 2`` run exits 0 with an empty journal, a whole
fleet and the rows of the single scheduler.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.config import FleetConfig as JFleet  # noqa: E402
from fairness_llm_tpu.config import IntegrityConfig as JIntegrity  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ResilienceConfig as JResilience  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServing  # noqa: E402
from fairness_llm_tpu.resilience import breaker as jbreaker  # noqa: E402
from fairness_llm_tpu.telemetry import slo as jslo  # noqa: E402
from fairness_llm_tpu.utils.failures import ScriptedFaultInjector as JInjector  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import (  # noqa: E402
    AutoscaleConfig,
    FleetConfig,
    IntegrityConfig,
    ModelSettings,
    ResilienceConfig,
    ServingConfig,
)
from fairness_llm_tpu_torch.resilience import breaker as tbreaker  # noqa: E402
from fairness_llm_tpu_torch.serving import router as trouter  # noqa: E402
from fairness_llm_tpu_torch.serving.fleet import check_fleet  # noqa: E402
from fairness_llm_tpu_torch.telemetry import slo as tslo  # noqa: E402
from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector  # noqa: E402
from test_torch_serving import SERVING, _engines  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {
    "t": dict(serving=tserving, tel=T, F=FleetConfig, S=ServingConfig, R=ResilienceConfig,
              I=IntegrityConfig, M=ModelSettings, Inj=ScriptedFaultInjector, B=tbreaker),
    "j": dict(serving=jserving, tel=J, F=JFleet, S=JServing, R=JResilience, I=JIntegrity,
              M=JSettings, Inj=JInjector, B=jbreaker),
}
# The reference's fleet drill knobs (tests/test_fleet.py): one fault trips a
# breaker, cooldowns of milliseconds, an 8-token canary through 2-slot pools.
RES = dict(enabled=True, breaker_threshold=1, breaker_cooldown_s=0.01)
FLEET2 = dict(replicas=2, fence_cooldown_s=0.02)
PROMPTS = ["the quick brown fox", "hello there friend", "abc abc abc abc",
           "one two three one two", "recommend ten films please", "name five good books",
           "zz zz zz", "a longer prompt that shifts padding and lands in a bucket"]
TOKENS = 8
# SLO targets far above what a loaded CPU takes, so that wall-clock burn
# never moves the router or the ladder.
SAFE_SLO = dict(ttft_p95_s=300.0, e2e_p99_s=600.0)


@pytest.fixture(autouse=True)
def safe_slo():
    prev = (tslo.set_slo_targets(tslo.SLOTargets(**SAFE_SLO)),
            jslo.set_slo_targets(jslo.SLOTargets(**SAFE_SLO)))
    yield
    tslo.set_slo_targets(prev[0])
    jslo.set_slo_targets(prev[1])


@pytest.fixture(scope="module")
def baseline():
    """The port engine's greedy row of each prompt, alone."""
    _, teng = _engines()
    return {f"q{i}": np.asarray(teng.generate([p], ModelSettings(temperature=0.0,
                                                                  max_tokens=TOKENS)).tokens[0])
            for i, p in enumerate(PROMPTS)}


def _counter(reg, name, **labels):
    m = reg.peek(name, **labels)
    return 0 if m is None else m.value


# ---------------------------------------------------------------------------
# The router: the same replica states
# ---------------------------------------------------------------------------


class _Queue:
    def __init__(self, depth, full, closed):
        self.depth, self.full, self.closed = depth, full, closed

    def __len__(self):
        return self.depth


class _Sched:
    def __init__(self, rng, B, stalled):
        self.pool = type("P", (), {"occupancy": rng.randint(0, 4)})()
        self.queue = _Queue(rng.randint(0, 6), rng.random() < 0.15, rng.random() < 0.1)
        self._pending = [None] * rng.randint(0, 2)
        self.num_slots = 4
        self.has_work = bool(self.pool.occupancy or self.queue.depth)
        self.breakers = None
        if rng.random() < 0.8:
            self.breakers = B.BreakerBoard(failure_threshold=1, cooldown_s=300.0,
                                           labels={"replica": "x"})
            for stage in ("prefill", "decode"):
                if rng.random() < 0.3:
                    self.breakers.trip(stage)
        self.watchdog = type("W", (), {"stalled": staticmethod(lambda: stalled)})()


class _Replica:
    def __init__(self, name, rng, B, stalled):
        self.name = name
        self.fenced = rng.random() < 0.15
        self.version = rng.choice(["v0", "v1"])
        self.sched = _Sched(rng, B, stalled)


def _router_walk(pkg: str, seed: int) -> list:
    """Random replica states (breakers tripped, queues, fences, canary and
    burn gauges, the queue high-water mark, a stall), then every router
    answer: scores, loads, weights, picks by class and version, the traffic
    split's picks and the fence verdicts."""
    p = PKGS[pkg]
    rng = random.Random(seed)
    out = []
    with p["tel"].use_registry() as reg, p["tel"].use_timeline():
        reps = [_Replica(f"r{i}", rng, p["B"], 12.0 if rng.random() < 0.2 else None)
                for i in range(rng.randint(2, 5))]
        for rep in reps:
            if rng.random() < 0.3:
                reg.gauge("canary_last_ok", component="serving",
                          replica=rep.name).set(rng.choice([0.0, 1.0]))
            for slo in ("error_rate", "ttft_p95"):
                if rng.random() < 0.3:
                    reg.gauge("slo_burn_rate", component="serving", replica=rep.name, slo=slo,
                              window="fast").set(rng.choice([0.5, 1.5, 4.0, 9.0]))
            if rng.random() < 0.5:
                reg.gauge("queue_depth_hwm", component="serving",
                          replica=rep.name).set(rng.randint(0, 9))
        router = p["serving"].HealthRouter(p["F"](fence_ladder_level=rng.choice([0, 1, 2]),
                                                  fence_open_breakers=rng.choice([0, 1, 2])))
        for rep in reps:
            out.append((rep.name, round(router.health_score(rep), 9), round(router.load(rep), 9),
                        round(router.placement_weight(rep), 9), router.should_fence(rep)))

        def name(r):
            return None if r is None else r.name

        for qos in (None, "interactive", "batch", "probe"):
            out.append(("pick", qos, name(router.pick(reps, qos=qos))))
        for version in ("v0", "v1"):
            out.append(("pinned", version, name(router.pick(reps, require_version=version))))
        router.set_version_traffic("v1", rng.choice([0.25, 0.5, 0.75]))
        out.append(("split", [name(router.pick(reps, qos="batch")) for _ in range(8)]))
        router.set_version_traffic(None)
        for counter in range(4):
            mod = trouter if pkg == "t" else importlib.import_module(
                "fairness_llm_tpu.serving.router")
            out.append(("rr", name(mod.round_robin_pick(reps, counter))))
        out.append(sorted((g["labels"]["replica"], round(g["value"], 9))
                          for g in p["tel"].snapshot(reg)["gauges"]
                          if g["name"] == "replica_health_score"))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_router_matches_the_reference(seed):
    assert _router_walk("t", seed) == _router_walk("j", seed)


def test_router_discounts_match_the_reference():
    from fairness_llm_tpu.serving import router as jrouter

    for name in ("OPEN_BREAKER_DISCOUNT", "HALF_OPEN_BREAKER_DISCOUNT",
                 "DEGRADATION_RUNG_DISCOUNT", "CANARY_MISMATCH_DISCOUNT",
                 "SLO_BURN_DISCOUNT_FLOOR"):
        assert getattr(trouter, name) == getattr(jrouter, name)


# ---------------------------------------------------------------------------
# Both fleets under the same fault scripts
# ---------------------------------------------------------------------------

# name -> (injector script, fleet knobs, request-fault script)
DRILLS = {
    "crash": (dict(replica_crashes={"r1": 3}), {}),
    "hang": (dict(replica_hangs={"r0": 2}), {}),
    "ladder": (dict(faults={("q2", "decode"): 1}), dict(fence_ladder_level=1)),
    "all_fenced": (dict(replica_crashes={"r0": 2, "r1": 4}), {}),
}
FLEET_COUNTERS = ("fleet_fenced_total", "fleet_migrated_requests_total",
                  "fleet_migrated_recovered_total", "fleet_rejoins_total",
                  "fleet_rejoin_denied_total", "faults_total")


def _drill(pkg: str, name: str) -> dict:
    p = PKGS[pkg]
    script, knobs = DRILLS[name]
    jeng, teng = _engines()
    settings = p["M"](temperature=0.0, max_tokens=TOKENS)
    submitted = []
    with p["tel"].use_registry() as reg, p["tel"].use_timeline(), \
            p["tel"].use_incident_manager():
        inj = p["Inj"](**script)
        fleet = p["serving"].ReplicaSet(
            teng if pkg == "t" else jeng, p["S"](**SERVING), settings=settings,
            fleet=p["F"](**FLEET2, **knobs), resilience=p["R"](**RES), fault_injector=inj,
            integrity=p["I"](canary_max_tokens=8))
        for rep in fleet.replicas:
            real = rep.sched.submit

            def spy(req, front=False, restamp=True, _real=real, _rep=rep.name):
                submitted.append((req.id, _rep, front, req.settings, req.row_seed))
                return _real(req, front=front, restamp=restamp)

            rep.sched.submit = spy
        reqs = [p["serving"].Request(prompt=pr, id=f"q{i}", settings=settings,
                                     row_seed=1000 + i) for i, pr in enumerate(PROMPTS)]
        results = fleet.serve(reqs)
        whole = fleet.await_recovery(timeout_s=30.0)
        snap = p["tel"].snapshot(reg)
    counters = sorted((c["name"], tuple(sorted(c["labels"].items())), c["value"])
                      for c in snap["counters"]
                      if c["name"] in FLEET_COUNTERS and c["labels"].get("component") == "fleet")
    return {
        "rows": {r.id: [int(t) for t in r.tokens] for r in results},
        "reasons": {r.id: r.finish_reason for r in results},
        "fired": sorted(inj.replica_faults_fired),
        "fences": [(r.name, r.fences, r.rejoins) for r in fleet.replicas],
        "counters": counters, "whole": whole, "healthy": fleet.healthy_count,
        "submitted": submitted,
    }


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_fleet_drill_matches_the_reference(name, baseline):
    """The crash, hang and ladder drills through both packages; every
    replica crashing (the longest reference drill) through the port's
    alone, against the engine and the script."""
    got = _drill("t", name)
    if name == "all_fenced":
        assert got["fired"] == [("r0", "replica_crash"), ("r1", "replica_crash")]
        assert [f[1] for f in got["fences"]] == [1, 1]
        assert all(r == "length" or r == "eos" for r in got["reasons"].values())
    else:
        want = _drill("j", name)
        for key in ("rows", "reasons", "fired", "fences", "counters", "whole", "healthy"):
            assert got[key] == want[key], key
    _, teng = _engines()
    pad = teng.tokenizer.pad_id
    for rid, row in got["rows"].items():
        ref = baseline[rid]
        assert row == [int(t) for t in ref[:len(row)]] and np.all(ref[len(row):] == pad), rid
    assert got["whole"] and got["healthy"] == 2
    # A migrated request reaches its new replica at the head of its queue
    # with its id, settings and row seed.
    first = {}
    migrated = 0
    for rid, rep, front, settings, seed in got["submitted"]:
        if rid not in first:
            first[rid] = (rep, settings, seed)
            assert not front
            continue
        migrated += 1
        assert front and (settings, seed) == first[rid][1:]
    moved = sum(c[2] for c in got["counters"] if c[0] == "fleet_migrated_requests_total")
    assert migrated >= moved > 0


def test_fleet_rows_equal_the_single_scheduler_sampled():
    """t=0.7: the noise is keyed on (row_seed, emitted), so routing over
    two replicas changes no row."""
    _, teng = _engines()
    s = ModelSettings(temperature=0.7, max_tokens=TOKENS)
    reqs = [tserving.Request(prompt=p, id=f"s{i}", settings=s, row_seed=77 + i)
            for i, p in enumerate(PROMPTS)]
    with T.use_registry(), T.use_timeline():
        fleet = tserving.ReplicaSet(teng, ServingConfig(**SERVING), settings=s,
                                    fleet=FleetConfig(**FLEET2))
        got = fleet.serve([dataclasses.replace(r) for r in reqs])
        alone = tserving.ContinuousScheduler(teng, ServingConfig(**SERVING), settings=s)
        want = alone.serve(reqs)
    assert [list(r.tokens) for r in got] == [list(r.tokens) for r in want]
    assert fleet.last_stats.completed == len(PROMPTS) == sum(
        1 for r in got if r.ok)


def test_fatal_device_error_raises_out_of_the_fleet():
    """A fatal CUDA error in a replica's decode call is recorded by the
    scheduler and raised out of the fleet: not a crash, not fenced, not
    migrated."""
    _, teng = _engines()
    settings = ModelSettings(temperature=0.0, max_tokens=TOKENS)
    with T.use_registry() as reg, T.use_timeline(), T.use_incident_manager():
        fleet = tserving.ReplicaSet(teng, ServingConfig(**SERVING), settings=settings,
                                    fleet=FleetConfig(**FLEET2),
                                    resilience=ResilienceConfig(**RES))
        sched = fleet.replicas[1].sched

        def fatal(*args, **kwargs):
            raise torch.AcceleratorError("CUDA error: device-side assert triggered")

        sched._step = fatal
        with pytest.raises(torch.AcceleratorError):
            fleet.serve([tserving.Request(prompt=p, id=f"q{i}", settings=settings)
                         for i, p in enumerate(PROMPTS)])
        assert _counter(reg, "faults_total", component="serving", kind="device_fatal",
                        stage="decode", replica="r1") == 1
        for name in ("fleet_fenced_total", "fleet_migrated_requests_total"):
            assert not any(c["name"] == name for c in T.snapshot(reg)["counters"])
        assert not any(rep.fenced for rep in fleet.replicas)
        assert _counter(reg, "faults_total", component="serving", kind="device",
                        stage="decode", replica="r1") == 0


# ---------------------------------------------------------------------------
# The backend's fleet mode
# ---------------------------------------------------------------------------


def test_backend_builds_named_fleets_and_periodic_canary():
    _, teng = _engines()
    with T.use_registry() as reg, T.use_timeline():
        backend = tserving.ServingBackend(
            teng, ServingConfig(**SERVING), fleet=FleetConfig(**FLEET2),
            resilience=ResilienceConfig(**RES), integrity=IntegrityConfig(
                canary_every_n=1, canary_max_tokens=8))
        assert backend.board is None and teng.breakers is None
        greedy = ModelSettings(temperature=0.0, max_tokens=TOKENS)
        texts = backend.generate(PROMPTS[:4], greedy, keys=[f"k{i}" for i in range(4)])
        assert all(t is not None for t in texts)
        backend.generate(PROMPTS[4:6], greedy)
        first = backend.scheduler_for(greedy)
        assert isinstance(first, tserving.ReplicaSet) and first.name is None
        assert [r.name for r in first.replicas] == ["r0", "r1"]
        # one probe a call, round robin over the replicas, all passing
        for rep in ("r0", "r1"):
            assert _counter(reg, "canary_runs_total", component="serving", replica=rep) == 1
            assert reg.read_value("canary_last_ok", component="serving", replica=rep) == 1
        second = backend.scheduler_for(ModelSettings(temperature=0.7, max_tokens=TOKENS))
        assert second.name == "s1" and [r.name for r in second.replicas] == ["s1.r0", "s1.r1"]
        assert backend.last_output.stats["batch"] == 2 * SERVING["num_slots"]
        assert backend.serve_totals.completed == 6
    one = tserving.ServingBackend(teng, ServingConfig(**SERVING), fleet=FleetConfig(replicas=1))
    assert isinstance(one.scheduler_for(greedy), tserving.ContinuousScheduler)
    with T.use_registry(), T.use_timeline():
        grows = tserving.ServingBackend(teng, ServingConfig(**SERVING),
                                        autoscale=AutoscaleConfig(enabled=True))
        assert isinstance(grows.scheduler_for(greedy), tserving.ReplicaSet)
        assert grows.scheduler_for(greedy).autoscaler is not None


# ---------------------------------------------------------------------------
# The fleet gate and the CLI
# ---------------------------------------------------------------------------


def _validator():
    spec = importlib.util.spec_from_file_location("validate_telemetry",
                                                  ROOT / "tools" / "validate_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_snapshot(perturb: str) -> dict:
    """A failover run's fleet instruments, one of them perturbed."""
    with T.use_registry() as reg:
        fleets = {None: (2, 2)}
        if perturb == "not_whole":
            fleets[None] = (2, 1)
        elif perturb == "second_fleet_not_whole":
            fleets["s1"] = (3, 2)
        elif perturb == "no_fleet":
            fleets = {}
        for name, (n, healthy) in fleets.items():
            labels = {"fleet": name} if name else {}
            reg.gauge("fleet_replicas", component="fleet", **labels).set(n)
            reg.gauge("fleet_healthy_replicas", component="fleet", **labels).set(healthy)
        if perturb != "no_fence":
            reg.counter("fleet_fenced_total", component="fleet", replica="r0",
                        reason="replica_crash").inc()
        if perturb != "no_migration":
            reg.counter("fleet_migrated_requests_total", component="fleet").inc(3)
            reg.counter("fleet_migrated_recovered_total", component="fleet").inc(
                2 if perturb == "lost" else 3)
        return T.snapshot(reg)


@pytest.mark.parametrize("perturb", ["clean", "no_fence", "lost", "no_migration", "not_whole",
                                     "second_fleet_not_whole", "no_fleet"])
def test_check_fleet_finds_what_the_reference_gate_finds(perturb, tmp_path):
    snap = _fleet_snapshot(perturb)
    path = tmp_path / "telemetry_snapshot.json"
    path.write_text(json.dumps(snap))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _validator().check(str(path), require_fleet=True)
    want = [line[4:] for line in out.getvalue().splitlines() if line.startswith("  - ")]
    assert J.validate_snapshot(snap) == []
    got = check_fleet(snap)
    assert got == want
    assert bool(got) == bool(rc) == (perturb != "clean")


def test_cli_fleet_flags_match_the_reference():
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    base = ["--phase", "1"]
    for argv in (["--replicas", "2"], ["--continuous", "--replicas", "0"],
                 ["--continuous", "--fence-level", "-1"], ["--fence-cooldown", "1"],
                 ["--continuous", "--fence-cooldown", "-1"], ["--min-replicas", "2"],
                 ["--autoscale"], ["--continuous", "--autoscale", "--min-replicas", "0"],
                 ["--continuous", "--autoscale", "--min-replicas", "3", "--max-replicas", "2"],
                 ["--continuous", "--autoscale", "--min-replicas", "9"]):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.config_from_args(cli.build_parser().parse_args(base + argv))
    args = base + ["--continuous", "--replicas", "3", "--fence-level", "1", "--fence-cooldown",
                   "0.5", "--autoscale", "--min-replicas", "2", "--max-replicas", "5"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args))
    want = jcli.config_from_args(jcli.build_parser().parse_args(args))
    for field in ("fleet", "autoscale", "rollout"):
        assert dataclasses.asdict(getattr(got, field)) == dataclasses.asdict(getattr(want, field))
    for cls in ("FleetConfig", "AutoscaleConfig", "RolloutConfig"):
        import fairness_llm_tpu.config as jc
        import fairness_llm_tpu_torch.config as tc

        assert dataclasses.asdict(getattr(tc, cls)()) == dataclasses.asdict(getattr(jc, cls)())
    # The headroom signal reads the memory ledger (A7(b)), ported: the
    # field is accepted as the reference accepts it.
    import fairness_llm_tpu.config as jc

    assert dataclasses.asdict(AutoscaleConfig(enabled=True, up_headroom_frac=0.2)) == \
        dataclasses.asdict(jc.AutoscaleConfig(enabled=True, up_headroom_frac=0.2))


def test_cli_fleet_run_on_the_cpu(tmp_path, capsys):
    """``--continuous --replicas 2 --serving-journal --telemetry-dir`` on a
    study checkpoint: exit 0, no unfinished request in the journal, a whole
    fleet of two, nothing for the failover gate but that no replica was
    fenced, the snapshot valid, and the rows of the single scheduler."""
    from fairness_llm_tpu_torch.cli import main as tcli
    from fairness_llm_tpu_torch.resilience import ServingJournal

    base = ["--phase", "1", "--quick", "--model", "tiny-gpt2-study", "--weights-dir",
            str(ROOT / "checkpoints"), "--device", "cpu", "--continuous", "--max-new-tokens",
            "12"]
    fleet_args = base + ["--replicas", "2", "--serving-journal", str(tmp_path / "j"),
                         "--telemetry-dir", str(tmp_path / "t"), "--results-dir",
                         str(tmp_path / "fleet")]
    with T.use_registry(), T.use_timeline(), T.use_incident_manager():
        assert tcli.main(fleet_args) == 0
    with T.use_registry(), T.use_timeline():
        assert tcli.main(base + ["--results-dir", str(tmp_path / "one")]) == 0
    assert ServingJournal(str(tmp_path / "j")).unfinished() == []
    snap = T.load_snapshot(str(tmp_path / "t"))
    assert T.validate_snapshot(snap) == []
    gauges = {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
              for g in snap["gauges"]}
    assert gauges[("fleet_healthy_replicas", (("component", "fleet"),))] == 2
    assert gauges[("fleet_replicas", (("component", "fleet"),))] == 2
    assert check_fleet(snap) == [
        "fleet_fenced_total is zero (no replica was ever fenced)",
        "fleet_migrated_requests_total is zero (failover never migrated anything)"]
    recs = [json.loads((tmp_path / d / "phase1" / "phase1_results.json").read_text())
            for d in ("fleet", "one")]
    assert recs[0]["metadata"]["serving"]["num_slots"] == 2 * ServingConfig().num_slots
    assert recs[0]["metadata"]["serving"]["completed"] == 16
    assert {k: e["raw_response"] for k, e in recs[0]["recommendations"].items()} == \
        {k: e["raw_response"] for k, e in recs[1]["recommendations"].items()}
    assert recs[0]["neutral_recommendations"] == recs[1]["neutral_recommendations"]
    # the report renders the fleet and passes the gate's own validation
    capsys.readouterr()
    assert tcli.main(["telemetry-report", str(tmp_path / "t"), "--validate"]) == 0
    assert tcli.main(["telemetry-report", str(tmp_path / "t"), "--require-fleet"]) == 1
    assert "fleet_fenced_total is zero" in capsys.readouterr().out
