"""The port's overload control (``serving/overload.py``, the QoS admission
queue, the scheduler's gate, shed and batch cap, the canary's shed branch,
the CLI's flags) against the JAX package's.

The contract: the same submission script through both
``ClassedAdmissionQueue``s gives the same pop order, rejections and class
depths (aging on an injected clock, per-class quotas); the same (depth,
burn, clock) sequence through both ``ShedController``s gives the same
level trajectory; both ``DeadlineEstimator``s give the same estimates from
the same histogram observations; both schedulers, overload armed, give the
same Results under a flood with a forced rung (the shed set, finish
reasons, retry-after hints to 1e-6 and the served rows' greedy tokens), the
same deadline shed without a prefill and the same rung-2 batch cap, and a
shed canary probe is inconclusive in both. Levels, counts and greedy
tokens are compared exactly.
"""

import dataclasses
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
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import OverloadConfig as JOverload  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.serving import overload as joverload  # noqa: E402
from fairness_llm_tpu.telemetry import slo as jslo  # noqa: E402
from fairness_llm_tpu.utils.ratelimit import RateLimiter as JRateLimiter  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings, OverloadConfig  # noqa: E402
from fairness_llm_tpu_torch.config import ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.serving import overload as toverload  # noqa: E402
from fairness_llm_tpu_torch.serving.queue import ClassedAdmissionQueue  # noqa: E402
from fairness_llm_tpu_torch.telemetry import slo as tslo  # noqa: E402
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter  # noqa: E402
from test_torch_serving import SERVING, FakeClock, _engines, greedy  # noqa: E402

QOS = ("interactive", "batch", "probe")
# Both packages' pieces, by name, so one script drives either.
PKGS = {
    "t": dict(serving=tserving, overload=toverload, tel=T, S=ModelSettings,
              O=OverloadConfig, Cfg=ServingConfig, Q=ClassedAdmissionQueue, RL=RateLimiter),
    "j": dict(serving=jserving, overload=joverload, tel=J, S=JSettings, O=JOverload,
              Cfg=JServingConfig, Q=jserving.ClassedAdmissionQueue, RL=JRateLimiter),
}


# The SLO targets of the scheduler tests: far above what a loaded CPU's
# first calls take, so that the wall-clock burn signal stays cold unless a
# test drives the burn gauge itself (the reference's overload tests do the
# same).
SAFE_SLO = dict(ttft_p95_s=300.0, e2e_p99_s=600.0)


@pytest.fixture(autouse=True)
def safe_slo():
    prev = (tslo.set_slo_targets(tslo.SLOTargets(**SAFE_SLO)),
            jslo.set_slo_targets(jslo.SLOTargets(**SAFE_SLO)))
    yield
    tslo.set_slo_targets(prev[0])
    jslo.set_slo_targets(prev[1])


# ---------------------------------------------------------------------------
# The classed queue, the controller and the estimator: the same inputs
# ---------------------------------------------------------------------------


def _queue_walk(pkg: str, seed: int) -> list:
    """A random script of submits, requeues, pops and expiry sweeps on a
    fake clock, with small class bounds, class and shared quotas and
    aging; returns every observable answer."""
    p = PKGS[pkg]
    rng = random.Random(seed)
    clock = FakeClock()
    ov = p["O"](enabled=True, interactive_capacity=5, batch_capacity=4, probe_capacity=2,
                interactive_per_minute=(6 if seed % 2 else None), batch_per_minute=5,
                aging_s=(2.0 if seed % 3 else 0.0))
    q = p["Q"](capacity=9, overload=ov, clock=clock,
               rate_limiter=(p["RL"](calls_per_minute=12, clock=clock) if seed % 4 == 1
                             else None))
    out, n = [], 0
    for _ in range(120):
        op = rng.random()
        if op < 0.5:
            r = p["serving"].Request(prompt="x", id=f"r{n}", qos=rng.choice(QOS),
                                     submitted_at=clock(),
                                     deadline_s=rng.choice([None, None, 1.5, 6.0]))
            n += 1
            out.append(("submit", r.id, q.submit(r)))
        elif op < 0.58:
            r = p["serving"].Request(prompt="x", id=f"q{n}", qos=rng.choice(QOS),
                                     submitted_at=clock())
            n += 1
            q.requeue(r)
        elif op < 0.78:
            out.append(("pop", [r.id for r in q.pop(rng.randint(1, 3))]))
        elif op < 0.85:
            out.append(("expired", [r.id for r in q.drain_expired()]))
        else:
            clock.t += rng.choice([0.25, 0.5, 1.0, 3.0, 30.0])
        out.append((len(q), q.full, q.class_depths(), q.rejected,
                    {c: q.class_full(c) for c in QOS}))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_classed_queue_matches_the_reference(seed):
    assert _queue_walk("t", seed) == _queue_walk("j", seed)


def _controller_walk(pkg: str, ops, cfg: dict) -> list:
    """``ops`` through one ShedController on a fake clock in a fresh
    registry: (level, rung, overloaded signal) after every evaluation, the
    transition counters and the gauge at the end."""
    p = PKGS[pkg]
    tel = p["tel"]
    clock = FakeClock()
    out = []
    with tel.use_registry() as reg, tel.use_timeline():
        ctl = p["overload"].ShedController(p["O"](**cfg), clock=clock)
        burn = reg.gauge("slo_burn_rate", component="serving", slo="error_rate",
                         window="fast")
        for op, val in ops:
            if op == "burn":
                burn.set(val)
            elif op == "depth":
                ctl.observe_queue_depth(val, capacity=100)
            elif op == "tick":
                clock.t += val
            elif op == "interactive":
                ctl.note_interactive()
            elif op == "maybe":
                out.append(("maybe", ctl.maybe_evaluate()))
            else:
                sig = ctl.overloaded()
                out.append((ctl.evaluate(), ctl.rung, sig, ctl.admits("batch"),
                            ctl.admits("probe"), ctl.batch_cap(40, "batch"),
                            ctl.retry_after(), ctl.retry_after(est_ttft=val)))
        snap = tel.snapshot(reg)
    out.append(sorted((c["labels"]["to"], c["value"]) for c in snap["counters"]
                      if c["name"] == "overload_transitions_total"))
    out.append([g["value"] for g in snap["gauges"] if g["name"] == "overload_level"])
    return out


CONTROLLER_CFG = dict(enabled=True, burn_threshold=2.0, queue_frac_threshold=0.5,
                      queue_window_s=1.0, healthy_window_s=3.0, eval_interval_s=0.5,
                      interactive_presence_s=10.0, batch_token_cap=7, retry_after_s=0.75)


def _random_ops(rng: random.Random, n: int) -> list:
    ops = []
    for _ in range(n):
        k = rng.random()
        if k < 0.15:
            ops.append(("burn", rng.choice([0.0, 1.0, 2.0, 5.0])))
        elif k < 0.35:
            ops.append(("depth", rng.randint(0, 100)))
        elif k < 0.55:
            ops.append(("tick", rng.choice([0.1, 0.5, 1.0, 2.5, 4.0])))
        elif k < 0.6:
            ops.append(("interactive", 0))
        elif k < 0.7:
            ops.append(("maybe", 0))
        else:
            ops.append(("eval", rng.choice([None, 0.2, 9.0])))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_shed_controller_matches_the_reference(seed):
    ops = _random_ops(random.Random(seed), 150)
    got = _controller_walk("t", ops, CONTROLLER_CFG)
    assert got == _controller_walk("j", ops, CONTROLLER_CFG)
    assert any(row[0] > 0 for row in got if len(row) == 8)  # the ladder moved


def test_shed_controller_property_matches_the_reference():
    """The reference's property sequences (tests/test_overload_property.py:
    burn, depth, tick and evaluate, the burn signal armed) through both
    controllers: the same level trajectory, and each evaluation moves one
    rung at most, with the signal."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    cfg = dict(enabled=True, burn_threshold=2.0, queue_frac_threshold=0.5,
               queue_window_s=1.0, healthy_window_s=3.0, eval_interval_s=0.0)
    ops_st = st.lists(st.one_of(
        st.tuples(st.just("burn"), st.floats(min_value=0.0, max_value=10.0, allow_nan=False)),
        st.tuples(st.just("depth"), st.integers(min_value=0, max_value=100)),
        st.tuples(st.just("tick"), st.floats(min_value=0.05, max_value=2.0, allow_nan=False)),
        st.tuples(st.just("eval"), st.just(None))), max_size=200)

    @hypothesis.settings(max_examples=50, deadline=None, database=None)
    @hypothesis.given(ops=ops_st)
    def check(ops):
        ops = [("interactive", 0)] + ops
        got = _controller_walk("t", ops, cfg)
        assert got == _controller_walk("j", ops, cfg)
        levels = [0] + [row[0] for row in got[:-2]]
        assert all(abs(b - a) <= 1 for a, b in zip(levels, levels[1:]))

    check()


def test_deadline_estimator_matches_the_reference():
    rng = random.Random(0)
    obs = [(rng.uniform(0.01, 0.4), rng.uniform(0.001, 0.05)) for _ in range(23)]
    got, want = [], []
    for pkg, out in (("t", got), ("j", want)):
        p = PKGS[pkg]
        with p["tel"].use_registry() as reg:
            est = p["overload"].DeadlineEstimator(safety=0.5, clock=lambda: 10.0)
            out.append(est.estimate_ttft_s(5, 2, 4))  # cold: None
            for i, (pf, tok) in enumerate(obs):
                reg.histogram("prefill_wall_s", component="serving").observe(pf)
                reg.histogram("per_output_token_s", component="serving").observe(tok)
                for ahead, slots, chunk in ((0, 2, 4), (7, 2, 4), (33, 16, 8)):
                    out.append(est.estimate_ttft_s(ahead, slots, chunk))
                for deadline, at in ((None, 9.0), (0.05, 9.99), (0.5, 9.9), (5.0, 9.0),
                                     (0.1, 9.0)):
                    r = p["serving"].Request(prompt="x", deadline_s=deadline, submitted_at=at)
                    out.append(est.infeasible(r, i, 2, 4))
    assert got == want
    assert any(v is not None for v in got[1:])


def test_overload_and_telemetry_config_match_the_reference():
    from fairness_llm_tpu.config import TelemetryConfig as JTelemetry
    from fairness_llm_tpu_torch.config import TelemetryConfig

    assert dataclasses.asdict(OverloadConfig()) == dataclasses.asdict(JOverload())
    assert dataclasses.asdict(TelemetryConfig()) == dataclasses.asdict(JTelemetry())
    # The early headroom clamp reads the memory ledger, ported (A7(b)).
    assert dataclasses.asdict(OverloadConfig(headroom_cap_frac=0.2)) == \
        dataclasses.asdict(JOverload(headroom_cap_frac=0.2))


def test_cli_overload_and_telemetry_flags_match_the_reference():
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    base = ["--phase", "1"]
    for argv in (["--overload"], ["--continuous", "--shed-burn-threshold", "2"],
                 ["--continuous", "--overload", "--shed-burn-threshold", "0"],
                 ["--continuous", "--overload", "--shed-healthy-window", "-1"],
                 ["--continuous", "--overload", "--batch-token-cap", "0"],
                 ["--slo-ttft-p95", "0"], ["--slo-e2e-p99", "-1"], ["--slo-error-rate", "0"],
                 ["--achievable-gbps", "0"]):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.config_from_args(cli.build_parser().parse_args(base + argv))
    args = base + ["--continuous", "--overload", "--shed-burn-threshold", "3.5",
                   "--shed-healthy-window", "0.5", "--batch-token-cap", "9", "--fairness-obs",
                   "--slo-ttft-p95", "1.5", "--slo-e2e-p99", "20", "--slo-error-rate", "0.05",
                   "--trace-out", "/tmp/t.json", "--achievable-gbps", "9"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args))
    want = jcli.config_from_args(jcli.build_parser().parse_args(args))
    assert dataclasses.asdict(got.overload) == dataclasses.asdict(want.overload)
    assert dataclasses.asdict(got.telemetry) == dataclasses.asdict(want.telemetry)
    assert got.telemetry.achievable_gbps == 9.0
    assert tcli.NOT_PORTED == ()


# ---------------------------------------------------------------------------
# Both schedulers, overload armed
# ---------------------------------------------------------------------------

# tiny-test's serving pool of the other port tests, with a queue of 6. The
# controller evaluates every loop iteration and its windows outlast the
# serve, and aging is off (the queue tests age on a fake clock), so that
# the trajectory follows the loop, not the wall clock.
FLOOD_SERVING = dict(SERVING, queue_capacity=6)
FLOOD_OVERLOAD = dict(enabled=True, queue_frac_threshold=0.75, queue_window_s=300.0,
                      healthy_window_s=300.0, eval_interval_s=0.0, batch_token_cap=3,
                      aging_s=0.0)
FLOOD_PROMPTS = ["the quick brown fox", "hi", "abc abc abc", "zz",
                 "recommend ten films please", "one two three"]


def _flood(pkg: str, rung: int = 0):
    """A batch flood with interactive and probe requests mixed in, through
    one scheduler armed with ``FLOOD_OVERLOAD``: first a submit() at the
    forced ``rung`` (the class gate), then serve(). Returns the Results,
    the levels the ladder passed, the stats and the shed counters."""
    p = PKGS[pkg]
    jeng, teng = _engines()
    eng = teng if pkg == "t" else jeng
    S = p["S"]
    reqs = []
    for i in range(14):
        qos = "interactive" if i % 5 == 2 else "probe" if i == 9 else "batch"
        reqs.append(p["serving"].Request(
            prompt=FLOOD_PROMPTS[i % len(FLOOD_PROMPTS)], id=f"f{i:02d}", qos=qos,
            settings=S(temperature=0.0, max_tokens=4 + i % 5)))
    with p["tel"].use_registry() as reg, p["tel"].use_timeline(), \
            p["tel"].use_incident_manager():
        sched = p["serving"].ContinuousScheduler(
            eng, p["Cfg"](**FLOOD_SERVING), settings=S(temperature=0.0, max_tokens=8),
            overload=p["O"](**FLOOD_OVERLOAD))
        ctl = sched.shed_controller
        levels = []
        real = ctl._transition

        def record(to, reason, now):
            levels.append(to)
            real(to, reason, now)

        ctl._transition = record
        if rung:
            ctl._transition(rung, "test", 0.0)
        early = [sched.submit(p["serving"].Request(prompt="hi", id=f"s{q}", qos=q,
                                                   settings=S(temperature=0.0, max_tokens=4)))
                 for q in QOS]
        early_res = [sched.take_result(f"s{q}") for q in QOS]
        if rung:
            ctl._transition(0, "test", 0.0)
        results = sched.serve(reqs)
        stats = sched.last_stats.as_dict()
        sheds = {tuple(sorted(c["labels"].items())): c["value"]
                 for c in p["tel"].snapshot(reg)["counters"] if c["name"] == "shed_total"}
    return early, early_res, results, levels, stats, sheds


def _result_view(r):
    if r is None:
        return None
    return (r.id, r.ok, r.finish_reason, [int(t) for t in r.tokens],
            None if r.retry_after_s is None else round(r.retry_after_s, 6))


@pytest.mark.parametrize("rung", [1, 3])
def test_flood_with_a_forced_rung_matches_the_reference_scheduler(rung):
    got = _flood("t", rung)
    want = _flood("j", rung)
    assert got[0] == want[0]  # the forced rung's submit() answers
    assert [_result_view(r) for r in got[1]] == [_result_view(r) for r in want[1]]
    assert [_result_view(r) for r in got[2]] == [_result_view(r) for r in want[2]]
    assert got[3:] == want[3:]
    interactive = {"f02", "f07", "f12"}
    shed = [r for r in got[2] if r.finish_reason == "shed"]
    assert shed and all(r.retry_after_s > 0 and r.id not in interactive for r in shed)
    assert all(r.ok for r in got[2] if r.id in interactive)
    assert max(got[3]) >= 2  # the ladder reached the batch cap


def test_doomed_deadline_sheds_without_prefill_like_the_reference():
    """With the histograms warm, a request whose deadline cannot cover one
    prefill sheds at submit() (deadline_infeasible) and no prefill runs
    for it; the pop-time recheck sheds a request whose deadline ran out
    while it waited."""
    out = {}
    for pkg in ("t", "j"):
        p = PKGS[pkg]
        jeng, teng = _engines()
        S = p["S"]
        with p["tel"].use_registry() as reg, p["tel"].use_incident_manager():
            for _ in range(5):
                reg.histogram("prefill_wall_s", component="serving").observe(0.05)
                reg.histogram("per_output_token_s", component="serving").observe(0.01)
            sched = p["serving"].ContinuousScheduler(
                teng if pkg == "t" else jeng, p["Cfg"](**SERVING),
                settings=S(temperature=0.0, max_tokens=8), overload=p["O"](enabled=True))
            ahead = [sched.submit(p["serving"].Request(prompt="hello there", id=f"a{i}",
                                                       settings=S(temperature=0.0,
                                                                  max_tokens=4)))
                     for i in range(5)]
            doomed = p["serving"].Request(prompt="the quick brown fox", id="doomed",
                                          deadline_s=0.001,
                                          settings=S(temperature=0.0, max_tokens=4))
            refused = sched.submit(doomed)
            res = sched.take_result("doomed")
            depth = len(sched.queue)
            stats = sched.drain().as_dict()
            sheds = {tuple(sorted(c["labels"].items())): c["value"]
                     for c in p["tel"].snapshot(reg)["counters"] if c["name"] == "shed_total"}
        out[pkg] = (ahead, refused, res.finish_reason, res.error.split("(")[0],
                    depth, stats["prefill_batches"], stats["completed"], stats["shed"], sheds)
    assert out["t"] == out["j"]
    assert out["t"][1] is False and out["t"][2] == "shed" and out["t"][4] == 5
    assert out["t"][7] == 1


def test_rung_two_batch_cap_matches_the_reference():
    caps = {}
    for pkg in ("t", "j"):
        p = PKGS[pkg]
        jeng, teng = _engines()
        S = p["S"]
        with p["tel"].use_registry(), p["tel"].use_incident_manager():
            sched = p["serving"].ContinuousScheduler(
                teng if pkg == "t" else jeng, p["Cfg"](**SERVING),
                settings=S(temperature=0.0, max_tokens=8),
                overload=p["O"](enabled=True, batch_token_cap=2))
            row = []
            for level in (0, 1, 2, 3, 0):
                sched.shed_controller._transition(level, "test", 0.0)
                row.append([sched._cap_for(p["serving"].Request(
                    prompt="x", qos=q, settings=S(temperature=0.0, max_tokens=m)))
                    for q in QOS for m in (1, 5, 8, 64)])
        caps[pkg] = row
    assert caps["t"] == caps["j"]
    assert caps["t"][2][4:8] == [1, 2, 2, 2]  # batch at rung 2


def test_shed_canary_probe_is_inconclusive_like_the_reference():
    """A probe shed at rung 3 counts a run, no mismatch, and leaves the
    decode breaker closed, in both packages."""
    from fairness_llm_tpu.integrity.canary import CanaryProbe as JProbe
    from fairness_llm_tpu.resilience import BreakerBoard as JBoard
    from fairness_llm_tpu_torch.integrity.canary import CanaryProbe
    from fairness_llm_tpu_torch.resilience import BreakerBoard

    jeng, teng = _engines()
    out = {}
    for pkg, eng, Probe, Board in (("t", teng, CanaryProbe, BreakerBoard),
                                   ("j", jeng, JProbe, JBoard)):
        p = PKGS[pkg]
        with p["tel"].use_registry() as reg, p["tel"].use_incident_manager():
            board = Board(failure_threshold=3, cooldown_s=60.0)
            sched = p["serving"].ContinuousScheduler(
                eng, p["Cfg"](**SERVING), settings=p["S"](temperature=0.0, max_tokens=8),
                overload=p["O"](enabled=True), breakers=board)
            kw = dict(max_tokens=8, every_n=1, board=board)
            probe = (Probe.record(eng, p["Cfg"](**SERVING), **kw) if pkg == "t"
                     else Probe.record(eng, **kw))
            verdicts = [probe.probe(sched)]
            sched.shed_controller._transition(3, "test", 0.0)
            verdicts.append(probe.probe(sched))
            out[pkg] = (verdicts, reg.read_value("canary_runs_total", component="serving"),
                        reg.read_value("canary_mismatch_total", component="serving"),
                        board.state("decode"),
                        reg.read_value("shed_total", component="serving",
                                       **{"class": "probe", "reason": "overload"}))
    assert out["t"] == out["j"] == ([True, True], 2, 0, "closed", 1)


def test_armed_and_healthy_serves_the_overload_off_rows():
    """Overload armed, no signal hot: every request is served, with the
    tokens of the overload-off scheduler (all classes, requeue included)."""
    from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector

    _, teng = _engines()
    reqs = lambda: [tserving.Request(prompt=p, id=f"h{i}", qos=QOS[i % 3],  # noqa: E731
                                     settings=greedy(4 + i))
                    for i, p in enumerate(FLOOD_PROMPTS)]
    rows = []
    for overload in (None, OverloadConfig(enabled=True)):
        with T.use_registry(), T.use_incident_manager():
            sched = tserving.ContinuousScheduler(
                teng, ServingConfig(**SERVING), settings=greedy(8), overload=overload,
                fault_injector=ScriptedFaultInjector(faults={("h1", "decode"): 1}))
            res = sched.serve(reqs())
            assert sched.shed_controller is None or sched.shed_controller.level == 0
            rows.append([(r.id, r.ok, r.finish_reason, r.retries, [int(t) for t in r.tokens])
                         for r in res])
    assert rows[0] == rows[1]
    assert all(r[1] for r in rows[1]) and rows[1][1][3] == 1
    assert isinstance(sched.queue, ClassedAdmissionQueue)
    assert np.all([len(r[4]) for r in rows[1]])
