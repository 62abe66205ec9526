"""The port's fault containment (``utils/failures.py``, ``resilience/``,
``integrity/numerics.py``, the scheduler's and the engine's containment
branches) against the JAX package's.

The contract: the same fixed-seed sequences through the breakers, the
ladder and the watchdog give the same states, transitions, levels and
counters in both packages; each package reads the other's serving journal;
one fault script through both schedulers gives every request the same
outcome, tokens and error, and the same stats and fault counters; a drain
preempts the same requests and the resume completes them with the
reference's tokens; the engines raise and contain a poisoned model alike
and retry a failed speculative call on the plain path. One rule is the
port's own: a fatal CUDA error is never contained. States, counters,
outcomes and greedy tokens are compared exactly.
"""

import contextlib
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import resilience as jres  # noqa: E402
from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu import telemetry as J  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ResilienceConfig as JResilience  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.utils import failures as jfail  # noqa: E402
from fairness_llm_tpu_torch import resilience as tres  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings, ResilienceConfig  # noqa: E402
from fairness_llm_tpu_torch.config import ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.utils import failures as tfail  # noqa: E402
from test_torch_serving import SERVING, FakeClock, _engines, greedy  # noqa: E402

PROMPTS = {
    "a": "the quick brown fox",
    "b": "hi",
    "c": "abc abc abc abc abc abc",
    "d": "zz",
    "e": "recommend ten films please",
    "f": "one two three one two three",
}
# One script of every fault kind: a prefill fault and a decode fault that
# requeue once, a request that faults twice (failed), a NaN and a hang.
SCRIPT = dict(faults={("a", "prefill"): 1, ("b", "decode"): 1, "c": 2},
              corruptions={("d", "decode"): 1}, hangs={("f", "decode"): 1})
# The paged script keeps to the faults both packages contain by releasing
# the riders only: the reference rebuilds its whole arena after any
# contained decode-chunk fault (its donated buffers may be consumed), which
# the port does only when the device call itself raised.
PAGED_SCRIPT = dict(faults={("a", "prefill"): 1, ("b", "decode"): 1, "c": 2},
                    hangs={("f", "prefill"): 1})
RES = dict(enabled=True, max_step_seconds=1000.0, breaker_threshold=50)
# Counters a fault script moves, read from both registries.
FAULT_COUNTERS = ("faults_total", "numerics_faults_total", "watchdog_hangs_total",
                  "serving_requeues_by_cause_total", "breaker_failures_total",
                  "prefix_cache_hit_tokens_total", "prefix_cache_miss_tokens_total",
                  "prefix_cache_cow_total")


@contextlib.contextmanager
def guards(*engines):
    """Numerics guards on for the shared engines, off again after."""
    for e in engines:
        e.numerics_guards = True
    try:
        yield
    finally:
        for e in engines:
            e.numerics_guards = False


def _counters(snap, names=FAULT_COUNTERS):
    return {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
            for c in snap["counters"] if c["name"] in names}


def _outcomes(results):
    return {r.id: (r.ok, r.finish_reason, [int(t) for t in r.tokens], r.error, r.retries)
            for r in results}


def _serve_both(script, serving=SERVING, res=RES, prompts=PROMPTS, caps=None):
    """The same requests and fault script through the port's and the
    reference's scheduler, each in its own registry. Returns (port results,
    reference results, port snapshot, reference snapshot, schedulers)."""
    jeng, teng = _engines()
    caps = caps or {rid: 6 + 2 * (i % 3) for i, rid in enumerate(prompts)}
    out = []
    for pkg, eng, mod in (("t", teng, tserving), ("j", jeng, jserving)):
        S, R, Cfg, F, Tel = ((ModelSettings, ResilienceConfig, ServingConfig, tfail, T)
                             if pkg == "t" else
                             (JSettings, JResilience, JServingConfig, jfail, J))
        with Tel.use_registry() as reg, Tel.use_incident_manager():
            sched = mod.ContinuousScheduler(
                eng, Cfg(**serving), settings=S(temperature=0.0, max_tokens=8),
                fault_injector=F.ScriptedFaultInjector(**script), resilience=R(**res))
            results = sched.serve([mod.Request(prompt=p, id=rid, settings=S(
                temperature=0.0, max_tokens=caps[rid])) for rid, p in prompts.items()])
            out.append((results, Tel.snapshot(reg), sched))
    (tr, ts, tsched), (jr, js, jsched) = out
    return tr, jr, ts, js, tsched, jsched


# ---------------------------------------------------------------------------
# Breakers, the ladder and the watchdog: the same inputs in both packages
# ---------------------------------------------------------------------------


def _breaker_walk(mod, reg_mod, seed: int):
    """A fixed-seed random sequence of allow/record_failure/record_success/
    trip and clock advances on a BreakerBoard with an injected clock: every
    state, ladder level and answer along the way, and the counters."""
    rng = random.Random(seed)
    clock = FakeClock()
    trail = []
    with reg_mod.use_registry() as reg:
        board = mod.BreakerBoard(failure_threshold=rng.randint(1, 3),
                                 cooldown_s=rng.choice([0.0, 1.0, 2.5]), clock=clock)
        for _ in range(60):
            stage = rng.choice(mod.STAGES)
            op = rng.choice(["allow", "fail", "fail", "ok", "tick", "trip"])
            if op == "allow":
                trail.append(("allow", stage, board.allow(stage)))
            elif op == "fail":
                board.record_failure(stage)
            elif op == "ok":
                board.record_success(stage)
            elif op == "trip":
                board.trip(stage)
            else:
                clock.t += rng.choice([0.5, 1.0, 3.0])
            trail.append((op, stage, board.state(stage), board.ladder.level,
                          board.ladder.rung, board.open_count(),
                          board.seconds_until_probe(stage)))
        snap = reg_mod.snapshot(reg)
    return trail, _counters(snap, ("breaker_transitions_total", "breaker_failures_total",
                                   "degradation_transitions_total"))


@pytest.mark.parametrize("seed", range(6))
def test_breaker_board_and_ladder_match_the_reference(seed):
    assert _breaker_walk(tres, T, seed) == _breaker_walk(jres, J, seed)


WATCHDOG_CASES = [
    # (max_step_seconds, [(elapsed, extra_s, classify, budget_scale), ...])
    (2.0, [(1.0, 0.0, True, 1.0), (2.5, 0.0, True, 1.0), (2.5, 0.0, False, 1.0),
           (0.1, 5.0, False, 1.0), (3.0, 0.0, True, 2.0), (5.0, 0.0, True, 2.0)]),
    (0.0, [(100.0, 0.0, True, 1.0), (0.0, 10.0, True, 1.0)]),
]


def _watchdog_walk(mod, reg_mod, limit, steps):
    clock = FakeClock()
    out = []
    with reg_mod.use_registry() as reg:
        wd = mod.StepWatchdog(limit, clock=clock)
        for elapsed, extra, classify, scale in steps:
            wd.arm("decode")
            clock.t += elapsed
            try:
                out.append(round(wd.observe("decode", extra_s=extra, classify=classify,
                                            budget_scale=scale), 9))
            except Exception as e:  # noqa: BLE001 — the classification is compared
                out.append(type(e).__name__)
        out.append(wd.stalled(now=clock.t + limit + 1.0))
        snap = reg_mod.snapshot(reg)
    return out, _counters(snap, ("watchdog_hangs_total",))


@pytest.mark.parametrize("limit,steps", WATCHDOG_CASES)
def test_watchdog_matches_the_reference(limit, steps):
    assert _watchdog_walk(tres, T, limit, steps) == _watchdog_walk(jres, J, limit, steps)


def test_first_use_exempts_new_keys_and_kernel_loads(monkeypatch):
    from fairness_llm_tpu_torch.ops import _build
    from fairness_llm_tpu_torch.resilience import watchdog

    key = ("test", object())
    loads = _build.load_events
    assert watchdog.first_use(key, loads)
    assert not watchdog.first_use(key, loads)
    monkeypatch.setattr(_build, "load_events", loads + 1)
    assert watchdog.first_use(key, loads)


def test_injector_budgets_and_schedules_match_the_reference():
    def walk(mod, reg_mod):
        clock = FakeClock()
        with reg_mod.use_registry() as reg:
            inj = mod.ScriptedFaultInjector(
                faults={("r", "decode"): 1, "s": 2}, hangs={"h": 1}, hang_seconds=7.0,
                corruptions={("c", "decode"): 1}, corruption_mode="inf",
                faults_at={"t": 2.0}, replica_crashes={"r0": 1}, replica_hangs_at={"r1": 3.0},
                clock=clock)
            out = []
            for rid, stage in [("r", "prefill"), ("r", "decode"), ("r", "decode"), ("s", "x"),
                               ("s", "y"), ("s", "z"), ("t", "decode")]:
                try:
                    inj.maybe_fail(rid, stage)
                    out.append(None)
                except mod.DecodeFault as e:
                    out.append(str(e))
            clock.t = 2.5
            for rid in ("t", "t"):
                try:
                    inj.maybe_fail(rid, "decode")
                    out.append(None)
                except mod.DecodeFault as e:
                    out.append(str(e))
            out += [inj.maybe_hang("h", "decode"), inj.maybe_hang("h", "decode"),
                    inj.maybe_corrupt("c", "decode"), inj.maybe_corrupt("c", "decode")]
            out += [inj.maybe_replica_fault("r0"), inj.maybe_replica_fault("r0"),
                    inj.maybe_replica_fault("r1")]
            clock.t = 4.0
            out += [inj.maybe_replica_fault("r1"), inj.fired, inj.hangs_fired,
                    inj.corruptions_fired, inj.replica_faults_fired]
            return out, _counters(reg_mod.snapshot(reg))

    assert walk(tfail, T) == walk(jfail, J)
    for mod in (tfail, jfail):
        with pytest.raises(ValueError):
            mod.ScriptedFaultInjector(corruption_mode="garbage")


def test_flip_bit_flips_one_bit(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(bytes(4))
    with T.use_registry() as reg:
        tfail.ScriptedFaultInjector.flip_bit(str(path), 10)
        assert path.read_bytes() == bytes([0, 4, 0, 0])
        assert reg.peek("faults_total", component="integrity", kind="injected_bitflip",
                        stage="artifact").value == 1
    with pytest.raises(ValueError):
        tfail.ScriptedFaultInjector.flip_bit(str(path), 64)


# ---------------------------------------------------------------------------
# The serving journal, both ways
# ---------------------------------------------------------------------------


def _journal_requests(mod, S):
    return [mod.Request(prompt=f"prompt {i}", id=f"j{i}", row_seed=1000 + i,
                        settings=S(temperature=0.0, max_tokens=8 + i), deadline_s=60.0,
                        qos="batch", group="g", attribute="gender", pair_id=f"p{i}")
            for i in range(4)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_journal(tmp_path, writer):
    w_res, w_serving, w_s = ((tres, tserving, ModelSettings) if writer == "port"
                             else (jres, jserving, JSettings))
    j = w_res.ServingJournal(str(tmp_path), rotate_every=3)
    for r in _journal_requests(w_serving, w_s):
        j.record_submitted(r)
    j.record_terminal("j1", "completed")
    j.record_terminal("j3", "failed")
    j.close()
    tj, jj = tres.ServingJournal(str(tmp_path)), jres.ServingJournal(str(tmp_path))
    assert tj.unfinished() == jj.unfinished()
    assert [r["id"] for r in tj.unfinished()] == ["j0", "j2"]

    def fields(r):
        return (r.prompt, r.id, dataclasses.asdict(r.settings), r.row_seed, r.qos, r.group,
                r.attribute, r.pair_id, round(r.deadline_s))

    assert [fields(r) for r in tj.to_requests()] == [fields(r) for r in jj.to_requests()]
    tj.close()
    jj.close()


def test_journal_refuses_a_future_schema(tmp_path):
    (tmp_path / tres.JOURNAL_FILENAME).write_text(
        '{"kind": "submitted", "id": "x", "schema_version": 99}\n')
    with pytest.raises(tres.drain.JournalSchemaError):
        tres.ServingJournal(str(tmp_path)).unfinished()


# ---------------------------------------------------------------------------
# The scheduler: one fault script through both packages
# ---------------------------------------------------------------------------


def test_fault_script_matches_the_reference_scheduler():
    jeng, teng = _engines()
    with guards(jeng, teng):
        tr, jr, ts, js, tsched, jsched = _serve_both(SCRIPT)
    assert _outcomes(tr) == _outcomes(jr)
    assert {r.id: r.ok for r in tr} == {rid: rid != "c" for rid in PROMPTS}
    assert next(r for r in tr if r.id == "c").finish_reason == "failed"
    assert tsched.last_stats.as_dict() == jsched.last_stats.as_dict()
    assert tsched.last_stats.requeued > 0 and tsched.last_stats.failed >= 1
    assert _counters(ts) == _counters(js)
    names = {k[0] for k in _counters(ts)}
    assert {"numerics_faults_total", "watchdog_hangs_total",
            "serving_requeues_by_cause_total"} <= names


def test_paged_fault_script_matches_the_reference_scheduler():
    paged = dict(SERVING, paged_kv=True, kv_block_size=16)
    tr, jr, ts, js, tsched, jsched = _serve_both(PAGED_SCRIPT, serving=paged)
    assert _outcomes(tr) == _outcomes(jr)
    assert tsched.last_stats.as_dict() == jsched.last_stats.as_dict()
    assert _counters(ts) == _counters(js)
    assert ("watchdog_hangs_total", (("component", "serving"), ("stage", "prefill"))) in \
        _counters(ts)


def test_paged_numerics_and_hang_keep_the_arena():
    """A NaN and a hang in paged decode chunks: the outcomes, tokens and
    fault counters equal the reference's, but where the reference rebuilds
    its arena the port releases only the riders, so their requeued
    prefills hit the blocks they cached the first time."""
    from test_torch_paged import FAMILY

    jeng, teng = _engines()
    paged = dict(SERVING, paged_kv=True, kv_block_size=16)
    prompts = {f"p{i}": p for i, p in enumerate(FAMILY[:4])}
    script = dict(corruptions={("p1", "decode"): 1}, hangs={("p3", "decode"): 1})
    with guards(jeng, teng):
        tr, jr, ts, js, tsched, jsched = _serve_both(script, serving=paged, prompts=prompts)
    assert _outcomes(tr) == _outcomes(jr)
    faults = ("faults_total", "numerics_faults_total", "watchdog_hangs_total",
              "serving_requeues_by_cause_total")
    assert _counters(ts, faults) == _counters(js, faults)
    hits = [_counters(s, ("prefix_cache_hit_tokens_total",)) for s in (ts, js)]
    assert sum(hits[0].values()) > sum(hits[1].values())
    assert len(tsched.pool.paged.index) > 0


def test_drain_preempts_the_same_requests_and_resume_finishes_them(tmp_path):
    """A drain with grace 0 after the first decode chunk preempts the same
    requests in both packages into their journals; resuming each journal
    gives the reference's uninterrupted tokens."""
    jeng, teng = _engines()
    S = dict(SERVING, num_slots=2)
    caps = {rid: 12 for rid in PROMPTS}
    want = {}
    for rid, p in PROMPTS.items():
        want[rid] = [int(t) for t in jeng.generate([p], JSettings(temperature=0.0,
                                                                 max_tokens=12)).tokens[0]]
    preempted, resumed = {}, {}
    for pkg, eng, mod, res_mod, Sm, R, Cfg, Tel in (
            ("t", teng, tserving, tres, ModelSettings, ResilienceConfig, ServingConfig, T),
            ("j", jeng, jserving, jres, JSettings, JResilience, JServingConfig, J)):
        journal = res_mod.ServingJournal(str(tmp_path / pkg))
        with Tel.use_registry():
            sched = mod.ContinuousScheduler(eng, Cfg(**S), settings=Sm(temperature=0.0,
                                                                        max_tokens=12),
                                            resilience=R(enabled=True), journal=journal)
            real = sched._decode

            def decode_then_drain(stats, real=real, sched=sched):
                moved = real(stats)
                sched.request_drain(grace_s=0.0)
                return moved

            sched._decode = decode_then_drain
            results = sched.serve([mod.Request(prompt=p, id=rid, settings=Sm(
                temperature=0.0, max_tokens=caps[rid])) for rid, p in PROMPTS.items()])
            preempted[pkg] = sorted(r.id for r in results if r.finish_reason == "preempted")
            assert sched.last_stats.preempted == len(preempted[pkg])
            assert sorted(r["id"] for r in journal.unfinished()) == preempted[pkg]
            out = res_mod.resume_serving(eng, journal, serving=Cfg(**S),
                                         resilience=R(enabled=True))
            resumed[pkg] = {rid: [int(t) for t in r.tokens] for rid, r in out.items()}
            assert journal.unfinished() == []
            journal.close()
    assert preempted["t"] == preempted["j"] and preempted["t"]
    assert resumed["t"] == resumed["j"]
    for rid, toks in resumed["t"].items():
        assert toks == want[rid][:len(toks)]


def test_queue_close_refuses_and_counts():
    def walk(mod):
        q = mod.AdmissionQueue(capacity=4)
        out = [q.submit(mod.Request(prompt="a", id="a"))]
        q.close()
        out += [q.submit(mod.Request(prompt="b", id="b")), q.closed, q.rejected, len(q)]
        q.requeue(mod.Request(prompt="c", id="c"))
        q.reopen()
        out += [q.submit(mod.Request(prompt="d", id="d")), [r.id for r in q.pop(5)]]
        return out

    assert walk(tserving) == walk(jserving)


# ---------------------------------------------------------------------------
# The engine: numerics guards, containment and the speculative retry
# ---------------------------------------------------------------------------


def _poisoned_engines():
    """Both packages' engines with the final norm's scale set to NaN, so
    that every forward gives NaN logits; guards on."""
    import jax.numpy as jnp

    from fairness_llm_tpu.models.configs import get_model_config as jget
    from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    jeng, teng = _engines()
    j = JEngine(jget("tiny-test"), params=jeng.params, numerics_guards=True)
    j.params = dict(j.params)
    j.params["final_norm"] = {"scale": jnp.full_like(jeng.params["final_norm"]["scale"],
                                                     jnp.nan)}
    t = DecodeEngine(teng.config, params={k: v.clone() for k, v in
                                          teng.model.state_dict().items()},
                     device="cpu", numerics_guards=True)
    with torch.no_grad():
        t.model.final_norm.scale.fill_(float("nan"))
    return j, t


def test_poisoned_engine_raises_and_is_contained_like_the_reference():
    j, t = _poisoned_engines()
    out = {}
    for pkg, eng, S, F, Tel in (("t", t, ModelSettings, tfail, T),
                                ("j", j, JSettings, jfail, J)):
        g = S(temperature=0.0, max_tokens=8)
        with Tel.use_registry() as reg:
            with pytest.raises(F.NumericsFault):
                eng.generate(["hello"], g)

            def gen(prompts, settings=None, seed=0, keys=None, prefix_ids=None, eng=eng, g=g):
                return eng.generate(prompts, g, seed=seed).texts

            sentinels = F.with_failure_containment(gen)(["a", "b"])
            out[pkg] = (sentinels, _counters(Tel.snapshot(reg), (
                "numerics_faults_total", "contained_chunk_failures_total")))
    assert out["t"] == out["j"]
    assert out["t"][0] == [None, None]


def test_failed_speculative_call_retries_on_the_plain_path(monkeypatch):
    from fairness_llm_tpu.config import SpeculationConfig as JSpec
    from fairness_llm_tpu_torch.config import SpeculationConfig
    from fairness_llm_tpu_torch.runtime import engine as tengine_mod

    jeng, teng = _engines()
    prompt = ["one two three one two three one two"]
    out = {}
    real_build = tengine_mod.build_spec_decode
    calls = {"n": 0}

    def failing_build(*a, **k):
        entry, loop = real_build(*a, **k)

        def bad_loop(*la, **lk):
            calls["n"] += 1
            raise RuntimeError("verify window fault")
        return entry, bad_loop

    monkeypatch.setattr(tengine_mod, "build_spec_decode", failing_build)
    real_spec_fn = jeng._spec_decode_fn

    def j_failing_spec_fn(*a, **k):
        def run(*ra, **rk):
            raise RuntimeError("verify window fault")
        return run

    for pkg, eng, S, Sp, mod, Tel in (("t", teng, ModelSettings, SpeculationConfig, tres, T),
                                      ("j", jeng, JSettings, JSpec, jres, J)):
        with Tel.use_registry() as reg:
            eng.breakers = mod.BreakerBoard(failure_threshold=3, component="engine")
            if pkg == "j":
                monkeypatch.setattr(jeng, "_spec_decode_fn", j_failing_spec_fn)
            try:
                got = eng.generate(prompt, S(temperature=0.0, max_tokens=8),
                                   speculation=Sp(enabled=True))
                plain = eng.generate(prompt, S(temperature=0.0, max_tokens=8))
                out[pkg] = ([int(x) for x in got.tokens[0]], eng.breakers.breakers[
                    "speculate"].consecutive_failures, _counters(Tel.snapshot(reg)))
                assert np.array_equal(got.tokens, plain.tokens)
            finally:
                eng.breakers = None
                if pkg == "j":
                    monkeypatch.setattr(jeng, "_spec_decode_fn", real_spec_fn)
    assert calls["n"] == 1
    assert out["t"] == out["j"]
    assert out["t"][2][("faults_total", (("component", "engine"), ("kind", "device"),
                                         ("stage", "speculate")))] == 1


def test_spec_breaker_sheds_and_restores_speculation():
    _, teng = _engines()
    from fairness_llm_tpu_torch.config import SpeculationConfig

    spec = SpeculationConfig(enabled=True)
    teng.speculation = spec
    try:
        teng.shed_speculation()
        teng.shed_speculation()
        assert teng.speculation is None and teng._spec_shed
        teng.restore_speculation()
        assert teng.speculation is spec and not teng._spec_shed
    finally:
        teng.speculation = None


# ---------------------------------------------------------------------------
# The sweep, the CLI, and the port's own rule: fatal CUDA errors raise
# ---------------------------------------------------------------------------


class _FlakyBackend:
    """A backend whose ``generate`` raises for its first ``n`` calls."""

    use_shared_prefix = False

    def __init__(self, inner, n: int, error=RuntimeError):
        self.inner, self.n, self.error, self.name = inner, n, error, inner.name

    def generate(self, prompts, settings=None, seed=0, keys=None, prefix_ids=None):
        if self.n > 0:
            self.n -= 1
            raise self.error("flaky backend")
        return self.inner.generate(prompts, settings, seed=seed, keys=keys,
                                   prefix_ids=prefix_ids)


@pytest.mark.parametrize("faults", [1, 2], ids=["retried", "sentinels"])
def test_decode_sweep_with_a_faulting_backend_matches_the_reference(tmp_path, faults):
    from fairness_llm_tpu.config import Config as JConfig
    from fairness_llm_tpu.pipeline import backends as jbackends
    from fairness_llm_tpu.pipeline import phase1 as jphase1
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline import backends as tbackends
    from fairness_llm_tpu_torch.pipeline import phase1 as tphase1

    jeng, teng = _engines()
    prompts = list(PROMPTS.values())[:4]
    keys = list(PROMPTS)[:4]
    out = {}
    for pkg, eng, B, P, C, S in (
            ("t", teng, tbackends, tphase1, Config, ModelSettings),
            ("j", jeng, jbackends, jphase1, JConfig, JSettings)):
        cfg = C(results_dir=str(tmp_path / pkg), decode_batch_size=2, checkpoint_every=2)
        backend = _FlakyBackend(B.EngineBackend(eng, name="tiny-test"), faults)
        out[pkg] = P.decode_sweep(backend, prompts, keys, cfg, "phase1",
                                  settings=S(temperature=0.0, max_tokens=6))
    assert out["t"] == out["j"]
    errors = [k for k, v in out["t"].items() if "error" in v]
    assert errors == ([] if faults == 1 else keys[:2])


def test_cli_resilience_flags_match_the_reference():
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    args = ["--phase", "1", "--continuous", "--max-step-seconds", "30", "--breaker-threshold",
            "4", "--breaker-cooldown", "2.5", "--serving-journal", "/tmp/j", "--drain-grace",
            "1", "--numerics-guards", "--canary-every", "3", "--no-verify-manifests"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args))
    want = jcli.config_from_args(jcli.build_parser().parse_args(args))
    assert dataclasses.asdict(got.resilience) == dataclasses.asdict(want.resilience)
    assert dataclasses.asdict(got.integrity) == dataclasses.asdict(want.integrity)
    for bad in (["--serving-journal", "/tmp/j"], ["--drain-grace", "1"],
                ["--canary-every", "2"], ["--continuous", "--max-step-seconds", "0"],
                ["--continuous", "--breaker-threshold", "0"],
                ["--continuous", "--breaker-cooldown", "-1"],
                ["--continuous", "--drain-grace", "-1"],
                ["--continuous", "--canary-every", "0"]):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.config_from_args(cli.build_parser().parse_args(["--phase", "1"] + bad))
    with pytest.raises(SystemExit, match="--incidents requires --telemetry-dir"):
        tcli.main(["--phase", "1", "--no-save", "--device", "cpu", "--incidents"])


FATAL = torch.AcceleratorError("CUDA error: device-side assert triggered")


def _fatal_count(reg, component, stage):
    c = reg.peek("faults_total", component=component, kind="device_fatal", stage=stage)
    return None if c is None else c.value


@pytest.mark.parametrize("error,fatal", [
    (FATAL, True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("decode_attention: CUDA error 700 at launch"), True),
    (RuntimeError("plain fault"), False),
    (torch.OutOfMemoryError("CUDA out of memory"), False),
], ids=["accelerator", "cuda-text", "launch-text", "runtime", "oom"])
def test_fatal_device_error_predicate(error, fatal):
    from fairness_llm_tpu_torch.ops._build import KernelError

    assert tfail.is_fatal_device_error(error) is fatal
    assert tfail.is_fatal_device_error(KernelError("kernel build failed"))


def test_serve_raises_a_fatal_device_error_and_contains_a_plain_one(monkeypatch):
    _, teng = _engines()
    for error, contained in ((torch.AcceleratorError("CUDA error: device-side assert"),
                              False), (RuntimeError("plain fault"), True)):
        with T.use_registry() as reg, T.use_incident_manager():
            sched = tserving.ContinuousScheduler(teng, ServingConfig(**SERVING),
                                                 settings=greedy(8))

            def boom(*a, error=error, **k):
                raise error

            monkeypatch.setattr(sched, "_step", boom)
            reqs = [tserving.Request(prompt="hello", id="x", settings=greedy(8))]
            if contained:
                (res,) = sched.serve(reqs)
                assert res.finish_reason == "failed" and "plain fault" in res.error
                assert _fatal_count(reg, "serving", "decode") is None
            else:
                with pytest.raises(torch.AcceleratorError):
                    sched.serve(reqs)
                assert _fatal_count(reg, "serving", "decode") == 1


def test_generate_and_decode_sweep_raise_a_fatal_device_error(monkeypatch, tmp_path):
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline import backends as tbackends
    from fairness_llm_tpu_torch.pipeline import phase1 as tphase1
    from fairness_llm_tpu_torch.runtime import engine as tengine_mod

    _, teng = _engines()
    real = tengine_mod.build_engine_decode

    def fatal_build(*a, **k):
        entry, loop = real(*a, **k)

        def bad(*la, **lk):
            raise torch.AcceleratorError("CUDA error: device-side assert triggered")
        return entry, bad

    monkeypatch.setattr(tengine_mod, "build_engine_decode", fatal_build)
    with T.use_registry() as reg, T.use_incident_manager():
        with pytest.raises(torch.AcceleratorError):
            teng.generate(["hello"], greedy(4))
        assert _fatal_count(reg, "engine", "decode") == 1
        cfg = Config(results_dir=str(tmp_path), decode_batch_size=2)
        with pytest.raises(torch.AcceleratorError):
            tphase1.decode_sweep(tbackends.EngineBackend(teng, name="tiny-test"),
                                 ["a", "b"], ["k0", "k1"], cfg, "phase1",
                                 settings=greedy(4))
        # counted once, where it was first seen; never as a contained failure
        assert _fatal_count(reg, "engine", "decode") == 2
        assert _fatal_count(reg, "pipeline", "generate") is None
        assert reg.peek("contained_chunk_failures_total", component="pipeline",
                        error_type="AcceleratorError") is None
    # a plain error in the sweep is contained as the reference contains it
    backend = _FlakyBackend(tbackends.EngineBackend(teng, name="tiny-test"), 2)
    monkeypatch.setattr(tengine_mod, "build_engine_decode", real)
    out = tphase1.decode_sweep(backend, ["a", "b"], ["k0", "k1"],
                               Config(results_dir=str(tmp_path), decode_batch_size=2),
                               "phase1", settings=greedy(4))
    assert all(v.get("error") == "decode_failed" for v in out.values())
