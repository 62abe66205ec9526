"""The port's autoscaler (``serving/autoscaler.py``) and trace replay
(``serving/replay.py``) against the JAX package's.

The contract: ``generate_trace`` gives the reference's trace byte for byte
for a seed, and ``read_trace`` reads it back; both ``Autoscaler``s, fed the
same signals on the same injected clock, take the same decisions (``up``,
``down``, ``up_denied``) at the same times, with the same target gauge and
event counters; both ``ReplayDriver``s give the same report against the
same stub fleet; a replay burst against both real fleets, on injected
clocks, scales 1 -> 2 -> 1 at the same trace times with the same rows; a
retirement migrates in-flight work with greedy parity and frees the retired
replica's pool; ``check_autoscale`` finds what the reference's
``--require-autoscale`` gate finds.
"""

import dataclasses
import importlib.util
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
from fairness_llm_tpu.config import AutoscaleConfig as JAutoscale  # noqa: E402
from fairness_llm_tpu.config import FleetConfig as JFleet  # noqa: E402
from fairness_llm_tpu.config import IntegrityConfig as JIntegrity  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ResilienceConfig as JResilience  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServing  # noqa: E402
from fairness_llm_tpu.serving import replay as jreplay  # noqa: E402
from fairness_llm_tpu.telemetry import slo as jslo  # noqa: E402
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
from fairness_llm_tpu_torch.serving import replay as treplay  # noqa: E402
from fairness_llm_tpu_torch.serving.autoscaler import check_autoscale  # noqa: E402
from fairness_llm_tpu_torch.telemetry import slo as tslo  # noqa: E402
from test_torch_serving import SERVING, _engines  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {
    "t": dict(serving=tserving, replay=treplay, tel=T, A=AutoscaleConfig, F=FleetConfig,
              S=ServingConfig, R=ResilienceConfig, I=IntegrityConfig, M=ModelSettings),
    "j": dict(serving=jserving, replay=jreplay, tel=J, A=JAutoscale, F=JFleet, S=JServing,
              R=JResilience, I=JIntegrity, M=JSettings),
}
SAFE_SLO = dict(ttft_p95_s=300.0, e2e_p99_s=600.0)


@pytest.fixture(autouse=True)
def safe_slo():
    prev = (tslo.set_slo_targets(tslo.SLOTargets(**SAFE_SLO)),
            jslo.set_slo_targets(jslo.SLOTargets(**SAFE_SLO)))
    yield
    tslo.set_slo_targets(prev[0])
    jslo.set_slo_targets(prev[1])


class FakeClock:
    """A clock advanced by hand, or by ``step`` on every read."""

    def __init__(self, t: float = 0.0, step: float = 0.0):
        self.t, self.step = float(t), float(step)

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# Trace generation and the replay clock
# ---------------------------------------------------------------------------

TRACES = {
    "burst": dict(seed=3, duration_s=120.0, base_sessions_per_s=0.5, think_time_s=5.0,
                  session_max_turns=6, bursts=((40.0, 20.0, 8.0),), interactive_deadline_s=2.0,
                  max_tokens_choices=(4, 8)),
    "overlapping_bursts": dict(seed=11, duration_s=300.0, base_sessions_per_s=0.3,
                               bursts=((50.0, 100.0, 3.0), (80.0, 40.0, 5.0)),
                               batch_deadline_s=30.0),
    "diurnal_capped": dict(seed=7, duration_s=7200.0, diurnal_period_s=3600.0,
                           diurnal_phase_s=900.0, diurnal_amplitude=0.9, max_events=300,
                           interactive_frac=0.4),
    "flat": dict(seed=0, duration_s=600.0, diurnal_amplitude=0.0, session_tail_alpha=2.5),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_is_the_reference_byte_for_byte(name, tmp_path):
    paths = {}
    for pkg, p in PKGS.items():
        cfg = p["replay"].TraceConfig(**TRACES[name])
        events = p["replay"].generate_trace(cfg)
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        p["replay"].write_trace(str(paths[pkg]), events, cfg)
        assert p["replay"].read_trace(str(paths[pkg])) == events
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    assert len(paths["t"].read_text().splitlines()) > 1
    with pytest.raises(ValueError):
        treplay.generate_trace(treplay.TraceConfig(**TRACES[name]), prompts=())


def test_replay_clock_and_report_match_the_reference():
    for p in PKGS.values():
        clock = FakeClock(t=5.0)
        rc = p["replay"].ReplayClock(compression=60.0, clock=clock)
        clock.advance(0.5)
        assert rc.now() == 30.0 == rc()
        with pytest.raises(ValueError):
            p["replay"].ReplayClock(compression=0.0)
    reports = []
    for p in PKGS.values():
        r = p["replay"].ReplayReport(events=5, accepted=4, gate_sheds=1,
                                     outcomes={"completed": 3, "shed": 2},
                                     ttft_by_qos={"interactive": [0.1, 0.4, 0.2]},
                                     compression=4.0)
        reports.append((r.summary(), r.lost, r.terminal, r.shed_rate(),
                        r.slo_attainment(0.25), r.slo_attainment(1.0, qos="batch")))
    assert reports[0] == reports[1]


# ---------------------------------------------------------------------------
# The autoscaler on stub fleets: the same signals, the same clock
# ---------------------------------------------------------------------------


class _StubSched:
    def __init__(self):
        self.pool = type("P", (), {"occupancy": 0})()
        self.queue = []
        self._pending = []
        self.num_slots = 2


class _StubReplica:
    def __init__(self, name):
        self.name = name
        self.fenced = False
        self.sched = _StubSched()


class _StubFleet:
    """The surface the autoscaler reads and drives on a ReplicaSet."""

    def __init__(self, S, n=1):
        self.replicas = [_StubReplica(f"r{i}") for i in range(n)]
        self.queue = []
        self._pending = []
        self.serving = S(enabled=True, queue_capacity=10)
        self.shed_controller = None
        self._fleet_labels = {}
        self.burn = 0.0
        self.router = type("R", (), {"load": staticmethod(
            lambda rep: rep.sched.pool.occupancy / 2)})()
        self.deny_next_add = False
        self._seq = n

    def _max_replica_burn(self):
        return self.burn

    def add_replica(self):
        if self.deny_next_add:
            self.deny_next_add = False
            return None
        rep = _StubReplica(f"r{self._seq}")
        self._seq += 1
        self.replicas.append(rep)
        return rep

    def retire_replica(self, rep):
        self.replicas.remove(rep)
        return 0


def _autoscaler_walk(pkg: str, seed: int) -> list:
    """A random script of burn, queue depth, slot occupancy, fences,
    denials and clock steps through one Autoscaler; every decision, the
    membership and the target gauge after each step, then the counters."""
    p = PKGS[pkg]
    rng = random.Random(seed)
    clock = FakeClock()
    out = []
    with p["tel"].use_registry() as reg, p["tel"].use_flight_recorder():
        fleet = _StubFleet(p["S"], n=rng.randint(1, 4))
        cfg = p["A"](enabled=True, min_replicas=rng.choice([1, 2]),
                     max_replicas=rng.choice([2, 3, 4]), up_window_s=1.0, down_window_s=3.0,
                     cooldown_s=2.0, eval_interval_s=rng.choice([0.0, 0.25]),
                     up_overload_level=1)
        auto = p["serving"].Autoscaler(fleet, cfg, clock=clock)
        for _ in range(80):
            op = rng.random()
            if op < 0.2:
                fleet.burn = rng.choice([0.0, 0.3, 1.0, 2.5, 9.0])
            elif op < 0.35:
                fleet.queue = [None] * rng.choice([0, 1, 5, 9])
            elif op < 0.45:
                for rep in fleet.replicas:
                    rep.sched.pool.occupancy = rng.choice([0, 0, 1, 2])
            elif op < 0.5:
                fleet.deny_next_add = True
            elif op < 0.55 and len(fleet.replicas) > 1:
                rng.choice(fleet.replicas).fenced = rng.random() < 0.5
            elif op < 0.6:
                fleet.shed_controller = (type("C", (), {"level": rng.choice([0, 1, 2])})()
                                         if rng.random() < 0.7 else None)
            else:
                clock.advance(rng.choice([0.1, 0.5, 1.1, 2.5]))
            action = auto.maybe_tick() if rng.random() < 0.5 else auto.tick()
            out.append((clock.t, action, [r.name for r in fleet.replicas],
                        auto._target_gauge().value))
        out.append((auto.scale_ups, auto.scale_downs, auto.denied, auto.signals()))
        out.append(sorted((c["labels"]["direction"], c["value"])
                          for c in p["tel"].snapshot(reg)["counters"]
                          if c["name"] == "autoscale_events_total"))
    return out


@pytest.mark.parametrize("seed", range(10))
def test_autoscaler_decisions_match_the_reference(seed):
    assert _autoscaler_walk("t", seed) == _autoscaler_walk("j", seed)


def test_autoscaler_walks_cover_every_decision():
    """The scripts above scale up, scale down and are refused a standby."""
    seen = set()
    for seed in range(10):
        walk = _autoscaler_walk("t", seed)
        seen |= {step[1] for step in walk[:-2] if step[1]}
        seen |= {d for d, n in walk[-1] if n}
    assert seen >= {"up", "down", "up_denied"}


def test_autoscaler_bounds_validated():
    for p in PKGS.values():
        for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2)):
            with pytest.raises(ValueError):
                p["serving"].Autoscaler(_StubFleet(p["S"]), p["A"](enabled=True, **kw))


# ---------------------------------------------------------------------------
# The replay driver against a stub streaming fleet
# ---------------------------------------------------------------------------


class _StreamFleet:
    """A streaming surface that admits up to ``cap`` requests at a time,
    sheds every fifth interactive arrival once with a retry-after, and
    completes the oldest admitted request every fourth tick."""

    def __init__(self, M, Result, cap=2):
        self.settings = M(temperature=0.0, max_tokens=4)
        self.Result, self.cap = Result, cap
        self.live, self.results, self.shed_once = [], {}, set()
        self.offers = []
        self.ticks = 0

    def submit(self, request, restamp=True, count_rejection=True):
        self.offers.append((request.id, count_rejection))
        n = int(request.id.split("_t")[0][-3:])
        if request.qos == "interactive" and n % 5 == 0 and request.id not in self.shed_once:
            self.shed_once.add(request.id)
            self.results[request.id] = self.Result(id=request.id, ok=False,
                                                   finish_reason="shed", retry_after_s=0.5)
            return False
        if len(self.live) >= self.cap:
            return False
        self.live.append(request)
        return True

    def tick(self):
        self.ticks += 1
        if not self.live or self.ticks % 4:
            return False
        req = self.live.pop(0)
        self.results[req.id] = self.Result(id=req.id, ok=True, tokens=np.asarray(
            [len(req.prompt), req.row_seed % 97, req.settings.max_tokens], np.int32),
            finish_reason="length", ttft_s=0.01 * len(req.prompt))
        return True

    def take_result(self, request_id):
        return self.results.pop(request_id, None)

    @property
    def has_work(self):
        return bool(self.live)

    def drain(self):
        while self.live:
            self.tick()


def test_replay_driver_matches_the_reference():
    cfg = dict(seed=5, duration_s=40.0, base_sessions_per_s=0.8, think_time_s=2.0,
               session_max_turns=4, max_tokens_choices=(4, 6), interactive_frac=0.6,
               bursts=((10.0, 8.0, 6.0),))
    reports = []
    for p in PKGS.values():
        events = p["replay"].generate_trace(p["replay"].TraceConfig(**cfg))
        fleet = _StreamFleet(p["M"], p["serving"].Result)
        with p["tel"].use_registry() as reg:
            rep = p["replay"].ReplayDriver(fleet, events, compression=2.0,
                                           clock=FakeClock(step=0.01), poll_s=0.0,
                                           tail_s=1.0, keep_results=True).run()
            counters = sorted((c["name"], tuple(sorted(c["labels"].items())), c["value"])
                              for c in p["tel"].snapshot(reg)["counters"])
        summary = rep.summary()
        del summary["wall_s"]
        reports.append((summary, rep.tokens, sorted(rep.results), fleet.offers, counters))
    assert reports[0] == reports[1]
    assert reports[0][0]["lost"] == 0 and reports[0][0]["backpressured"] > 0


# ---------------------------------------------------------------------------
# Real fleets: a replay burst scales 1 -> 2 -> 1
# ---------------------------------------------------------------------------

ELASTIC = dict(enabled=True, min_replicas=1, max_replicas=2, up_queue_frac=0.25,
               up_window_s=0.2, down_queue_frac=0.0, down_load_frac=0.5, down_window_s=0.6,
               cooldown_s=0.4, eval_interval_s=0.0)
BURST = dict(seed=2, duration_s=1.0, base_sessions_per_s=0.5, think_time_s=0.05,
             session_max_turns=3, bursts=((0.1, 0.1, 300.0),), max_tokens_choices=(4, 8),
             interactive_frac=0.5)
REPLAY_PROMPTS = ("the quick brown fox", "hello there friend", "zz zz zz",
                  "recommend ten films please")


def _elastic_replay(pkg: str) -> dict:
    p = PKGS[pkg]
    jeng, teng = _engines()
    events = p["replay"].generate_trace(p["replay"].TraceConfig(**BURST),
                                        prompts=REPLAY_PROMPTS)
    driver_clock = FakeClock(step=0.02)
    decisions = []
    with p["tel"].use_registry() as reg, p["tel"].use_timeline(), \
            p["tel"].use_incident_manager():
        fleet = p["serving"].ReplicaSet(
            teng if pkg == "t" else jeng, p["S"](**dict(SERVING, queue_capacity=2)),
            settings=p["M"](temperature=0.0, max_tokens=8), fleet=p["F"](replicas=1),
            resilience=p["R"](enabled=True), integrity=p["I"](canary_max_tokens=8))
        # the controller on the driver's clock, read without stepping it
        auto = p["serving"].Autoscaler(fleet, p["A"](**ELASTIC), clock=lambda: driver_clock.t)
        real = auto.tick

        def tick(now=None):
            action = real(now)
            if action:
                decisions.append((round(driver_clock.t, 6), action,
                                  [r.name for r in fleet.replicas]))
            return action

        auto.tick = tick
        fleet.autoscaler = auto
        retired = []
        real_retire = fleet.retire_replica

        def retire(rep):
            retired.append((rep.name, sorted(rep.assigned)))
            out = real_retire(rep)
            if pkg == "t":
                assert rep.sched._cache is None and rep.sched._prev_logits is None
            return out

        fleet.retire_replica = retire
        report = p["replay"].ReplayDriver(fleet, events, compression=1.0, clock=driver_clock,
                                          poll_s=0.0, tail_s=1.5).run()
        snap = p["tel"].snapshot(reg)
    # wall seconds and the TTFT percentiles are the host clock's
    summary = {k: v for k, v in report.summary().items()
               if k != "wall_s" and not k.startswith("ttft_")}
    return {"decisions": decisions, "summary": summary, "tokens": report.tokens,
            "retired": retired, "snap": snap, "events": len(events)}


def test_elastic_replay_matches_the_reference():
    got, want = _elastic_replay("t"), _elastic_replay("j")
    assert got["decisions"] == want["decisions"]
    assert [d[1] for d in got["decisions"]] == ["up", "down"]
    assert got["summary"] == want["summary"] and got["tokens"] == want["tokens"]
    assert got["retired"] == want["retired"]
    assert got["summary"]["lost"] == 0 and got["summary"]["accepted"] == got["events"]
    assert check_autoscale(got["snap"]) == []
    # every row is the port engine's own greedy row
    _, teng = _engines()
    events = treplay.generate_trace(treplay.TraceConfig(**BURST), prompts=REPLAY_PROMPTS)
    for ev in events[:6]:
        ref = teng.generate([ev.prompt], ModelSettings(temperature=0.0, max_tokens=ev.max_tokens),
                            row_seeds=[ev.row_seed]).tokens[0]
        row = list(got["tokens"][ev.id])
        assert row == [int(t) for t in ref[:len(row)]]


def test_retirement_migrates_in_flight_work_with_parity():
    """The victim holds live rows when it retires: they migrate with their
    ids and row seeds and finish with the engine's tokens; the retired
    replica's pool is freed and its work stays in the fleet's stats."""
    _, teng = _engines()
    settings = ModelSettings(temperature=0.0, max_tokens=8)
    prompts = ["the quick brown fox", "hello there friend", "one two three four",
               "pack my box with jugs", "five quacking zephyrs", "how vexingly quick"]
    with T.use_registry() as reg, T.use_timeline():
        fleet = tserving.ReplicaSet(teng, ServingConfig(**SERVING), settings=settings,
                                    fleet=FleetConfig(replicas=1),
                                    resilience=ResilienceConfig(enabled=True),
                                    integrity=IntegrityConfig(canary_max_tokens=8))
        assert fleet.add_replica().name == "r1"
        reqs = [tserving.Request(prompt=p, id=f"ret_{i}", settings=settings, row_seed=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            assert fleet.submit(r)
        victim = fleet.replicas[1]
        for _ in range(200):
            fleet.tick()
            if victim.sched.pool.occupancy:
                break
        assert victim.sched.pool.occupancy
        assert fleet.retire_replica(victim) >= 1
        assert victim.sched._cache is None and len(fleet.replicas) == 1
        fleet.drain()
        results = {r.id: fleet.take_result(r.id) for r in reqs}
        assert fleet.last_stats.completed == len(reqs)
        assert reg.read_value("fleet_retired_total", component="fleet", replica="r1") == 1
        assert reg.peek("fleet_fenced_total", component="fleet", replica="r1",
                        reason="retired") is None
        with pytest.raises(ValueError, match="last replica"):
            fleet.retire_replica(fleet.replicas[0])
        assert fleet.add_replica().name == "r2"  # names are never reused
    for req in reqs:
        ref = teng.generate([req.prompt], settings, row_seeds=[req.row_seed]).tokens[0]
        got = [int(t) for t in results[req.id].tokens]
        assert results[req.id].ok and got == [int(t) for t in ref[:len(got)]]


# ---------------------------------------------------------------------------
# The elastic-cycle gate
# ---------------------------------------------------------------------------


def _validator():
    spec = importlib.util.spec_from_file_location("validate_telemetry",
                                                  ROOT / "tools" / "validate_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("perturb", ["clean", "no_up", "no_down", "lost", "no_replay",
                                     "migration_lost", "not_whole", "no_fleet"])
def test_check_autoscale_finds_what_the_reference_gate_finds(perturb):
    with T.use_registry() as reg:
        for direction in ("up", "down", "up_denied"):
            if perturb != f"no_{direction}":
                reg.counter("autoscale_events_total", component="fleet",
                            direction=direction).inc()
        if perturb != "no_replay":
            reg.counter("replay_accepted_total", component="replay").inc(9)
            reg.counter("replay_terminal_total", component="replay",
                        outcome="completed").inc(8 if perturb == "lost" else 9)
        reg.counter("fleet_migrated_requests_total", component="fleet").inc(2)
        reg.counter("fleet_migrated_recovered_total", component="fleet").inc(
            1 if perturb == "migration_lost" else 2)
        if perturb != "no_fleet":
            reg.gauge("fleet_replicas", component="fleet").set(1)
            reg.gauge("fleet_healthy_replicas", component="fleet").set(
                0 if perturb == "not_whole" else 1)
        snap = T.snapshot(reg)
    got = check_autoscale(snap)
    assert got == _validator()._check_autoscale(snap)
    assert bool(got) == (perturb != "clean")
