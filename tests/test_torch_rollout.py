"""The port's rolling upgrade (``serving/rollout.py``, the ``rollout``
subcommand, the rollout section of ``telemetry-report``) against the JAX
package's.

The contract: the same states and legal edges; both controllers, driven
over stub fleets by the same gate and fault scripts on the same injected
clock, take the same edges and roll back for the same cause; over both real
fleets a clean upgrade completes with the same pins, and a new replica's
crash rolls back with its work migrated back and its pins restamped, each
request's tokens those of a single version; ``render_rollout_report`` and
``check_rollout`` give the reference's text and problems for the same
snapshot. The CLI exits 0 on a copy of a study checkpoint and 2, with the
manifest named and no request lost, on a copy with one flipped byte.
"""

import importlib.util
import pathlib
import random
import shutil

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
from fairness_llm_tpu.config import RolloutConfig as JRollout  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServing  # noqa: E402
from fairness_llm_tpu.integrity.manifest import IntegrityError as JIntegrityError  # noqa: E402
from fairness_llm_tpu.serving import rollout as jrollout  # noqa: E402
from fairness_llm_tpu.telemetry import slo as jslo  # noqa: E402
from fairness_llm_tpu.utils.failures import ScriptedFaultInjector as JInjector  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch import telemetry as T  # noqa: E402
from fairness_llm_tpu_torch.config import (  # noqa: E402
    FleetConfig,
    IntegrityConfig,
    ModelSettings,
    ResilienceConfig,
    RolloutConfig,
    ServingConfig,
)
from fairness_llm_tpu_torch.integrity.manifest import IntegrityError  # noqa: E402
from fairness_llm_tpu_torch.serving import rollout as trollout  # noqa: E402
from fairness_llm_tpu_torch.telemetry import slo as tslo  # noqa: E402
from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector  # noqa: E402
from test_torch_serving import SERVING, _engines  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {
    "t": dict(serving=tserving, rollout=trollout, tel=T, RC=RolloutConfig, F=FleetConfig,
              S=ServingConfig, R=ResilienceConfig, I=IntegrityConfig, M=ModelSettings,
              Inj=ScriptedFaultInjector, IE=IntegrityError),
    "j": dict(serving=jserving, rollout=jrollout, tel=J, RC=JRollout, F=JFleet, S=JServing,
              R=JResilience, I=JIntegrity, M=JSettings, Inj=JInjector, IE=JIntegrityError),
}
SAFE_SLO = dict(ttft_p95_s=300.0, e2e_p99_s=600.0)
WINDOW_S = 1.0


@pytest.fixture(autouse=True)
def safe_slo():
    prev = (tslo.set_slo_targets(tslo.SLOTargets(**SAFE_SLO)),
            jslo.set_slo_targets(jslo.SLOTargets(**SAFE_SLO)))
    yield
    tslo.set_slo_targets(prev[0])
    jslo.set_slo_targets(prev[1])


def test_states_and_edges_are_the_reference():
    assert trollout.ROLLOUT_STATES == jrollout.ROLLOUT_STATES
    assert trollout.LEGAL_TRANSITIONS == jrollout.LEGAL_TRANSITIONS
    assert trollout.TERMINAL_STATES == jrollout.TERMINAL_STATES


# ---------------------------------------------------------------------------
# Stub fleets: the same gate and fault scripts
# ---------------------------------------------------------------------------


class _Replica:
    def __init__(self, name, version, B=None):
        self.name = name
        self.version = version
        self.fenced = False
        self.fence_reason = None
        board = B.BreakerBoard(failure_threshold=1, cooldown_s=300.0,
                               labels={"replica": name}) if B else None
        self.sched = type("S", (), {"breakers": board})()


class _Router:
    def __init__(self):
        self.traffic = []

    def set_version_traffic(self, version, fraction=0.0):
        self.traffic.append(None if version is None or fraction <= 0.0
                            else (version, round(fraction, 9)))

    def load(self, rep):
        return 0.0


class _Fleet:
    """The surface RolloutController drives on a ReplicaSet."""

    def __init__(self, B, n=2):
        self.B = B
        self.version = "v0"
        self.replicas = [_Replica(f"r{i}", "v0", B) for i in range(n)]
        self.router = _Router()
        self.name = None
        self.autoscaler = object()
        self.rollout = None
        self.refuse_add = False
        self._seq = n
        self._engine_pool = [object()]
        self._rep_serving = None
        self.log = []

    def add_replica(self, engine=None, version=None, serving=None):
        self.log.append(("add", version))
        if self.refuse_add:
            return None
        rep = _Replica(f"r{self._seq}", version or self.version, self.B)
        self._seq += 1
        self.replicas.append(rep)
        return rep

    def retire_replica(self, rep):
        self.log.append(("retire", rep.name))
        self.replicas.remove(rep)
        return 0

    def _fence(self, rep, reason):
        self.log.append(("fence", rep.name, reason))
        rep.fenced = True
        rep.fence_reason = reason


def _bad_engine(p, what):
    def build():
        if what == "manifest":
            raise p["IE"]("integrity check failed for model.safetensors: sha256 mismatch")
        raise OSError("checkpoint directory vanished")
    return build


def _rollout_walk(pkg: str, ops, n: int, gate: str = "") -> dict:
    """Drive one controller over a stub fleet: ``ops`` of ticks, window
    steps, fences, canary mismatches, open breakers, burn, fairness
    alerts, pair divergences and refused standbys, then tick it to a
    terminal state. Returns every edge, the fleet's calls, the traffic
    split, the final state and cause, and the rollout counters."""
    from importlib import import_module

    p = PKGS[pkg]
    breaker = import_module(("fairness_llm_tpu_torch" if pkg == "t" else "fairness_llm_tpu")
                            + ".resilience.breaker")
    with p["tel"].use_registry() as reg, p["tel"].use_fairness_monitor() as mon, \
            p["tel"].use_incident_manager(), p["tel"].use_timeline():
        fleet = _Fleet(breaker, n=n)
        clock = {"t": 0.0}
        kw = dict(engine_fn=_bad_engine(p, gate)) if gate in ("manifest", "prepare") \
            else dict(engine=object())
        ro = p["rollout"].RolloutController(
            fleet, "v1", config=p["RC"](enabled=True, canary_window_s=WINDOW_S,
                                        traffic_steps=2),
            clock=lambda: clock["t"], **kw)
        edges = []
        real = ro._transition

        def spy(to, now, cause=None):
            edges.append((ro.state, to, round(now, 6)))
            real(to, now=now, cause=cause)

        ro._transition = spy
        ro.start()
        for op in ops:
            if ro.state in p["rollout"].TERMINAL_STATES:
                break
            new = ro.new_replicas
            if op == "tick":
                ro.tick()
            elif op == "window":
                clock["t"] += WINDOW_S + 0.01
                ro.tick()
            elif op == "fence" and new:
                fleet._fence(new[-1], "replica_crash")
            elif op == "breaker" and new:
                new[-1].sched.breakers.trip("decode")
            elif op == "canary" and new:
                reg.gauge("canary_last_ok", component="serving", replica=new[-1].name).set(0.0)
            elif op == "burn" and new:
                reg.gauge("slo_burn_rate", component="serving", replica=new[-1].name,
                          slo="error_rate", window="fast").set(5.0)
            elif op == "alert":
                reg.counter("fairness_alerts_total", component="fairness",
                            attribute="gender", signal="impaired_rate").inc()
            elif op == "pair" and new:
                mon.pairs_divergent += 1
                mon.divergent.append({"pair_id": "p7", "members": {
                    "a": {"replica": "r0"}, "b": {"replica": new[-1].name}}})
            elif op == "refuse":
                fleet.refuse_add = True
            elif op == "allow":
                fleet.refuse_add = False
            clock["t"] += 0.01
        for _ in range(40):
            if ro.state in p["rollout"].TERMINAL_STATES:
                break
            clock["t"] += WINDOW_S + 0.01
            ro.tick()
        assert ro.tick() is False  # terminal states absorb
        counters = sorted((c["name"], tuple(sorted(c["labels"].items())), c["value"])
                          for c in p["tel"].snapshot(reg)["counters"]
                          if c["labels"].get("component") == "rollout")
        return {"edges": edges, "fleet": fleet.log, "traffic": fleet.router.traffic,
                "state": ro.state, "cause": ro.cause, "version": fleet.version,
                "replicas": [(r.name, r.version, r.fenced) for r in fleet.replicas],
                "counters": counters}


GATES = {
    "complete": ([], 2),
    "standby_refused": (["refuse"], 2),
    "fence": (["tick", "window", "fence"], 2),
    "breaker": (["tick", "tick", "breaker"], 3),
    "canary": (["tick", "window", "window", "tick", "canary"], 2),
    "slo_burn": (["tick", "tick", "burn"], 2),
    "fairness_alert": (["tick", "window", "alert"], 2),
    "pair_divergence": (["tick", "tick", "pair"], 2),
    "manifest": ([], 2),
    "prepare": ([], 2),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gates_match_the_reference(gate):
    ops, n = GATES[gate]
    got = _rollout_walk("t", ops, n, gate)
    assert got == _rollout_walk("j", ops, n, gate)
    if gate == "complete":
        assert got["state"] == "complete" and got["version"] == "v1"
    else:
        cause = {"standby_refused": "canary", "fence": "watchdog"}.get(gate, gate)
        assert got["state"] == "rolled_back" and got["cause"].startswith(cause + ":")
        assert got["version"] == "v0" and {v for _, v, _ in got["replicas"]} == {"v0"}


OPS = ["tick", "window", "window", "fence", "canary", "breaker", "burn", "alert", "pair",
       "refuse", "allow"]


@pytest.mark.parametrize("seed", range(8))
def test_random_scripts_match_the_reference(seed):
    rng = random.Random(seed)
    # gate ops rarer than ticks, so that some scripts complete
    weights = [6, 6, 6, 1, 1, 1, 1, 1, 1, 1, 2]
    ops = rng.choices(OPS, weights=weights, k=rng.randint(4, 40))
    n = rng.randint(2, 4)
    got = _rollout_walk("t", ops, n)
    assert got == _rollout_walk("j", ops, n)
    assert all(e[:2] in trollout.LEGAL_TRANSITIONS for e in got["edges"])


# ---------------------------------------------------------------------------
# Real fleets: a clean upgrade and a new replica's crash
# ---------------------------------------------------------------------------

PROMPTS = ["the quick brown fox", "hello there friend", "abc abc abc abc",
           "one two three one two", "recommend ten films please", "name five good books",
           "zz zz zz", "pack my box with jugs", "five quacking zephyrs", "how vexingly quick"]
TOKENS = 8


def _real_rollout(pkg: str, crash: bool) -> dict:
    """A config-only rollout v0 -> v1 of a one-replica fleet (the new
    replicas share the engine) while ten greedy requests stream in, the
    controller on an injected clock that steps once a fleet tick; with
    ``crash`` the v1 standby crashes after three health polls."""
    p = PKGS[pkg]
    jeng, teng = _engines()
    eng = teng if pkg == "t" else jeng
    settings = p["M"](temperature=0.0, max_tokens=TOKENS)
    with p["tel"].use_registry() as reg, p["tel"].use_timeline(), \
            p["tel"].use_incident_manager(), p["tel"].use_fairness_monitor():
        fleet = p["serving"].ReplicaSet(
            eng, p["S"](**SERVING), settings=settings, fleet=p["F"](replicas=1),
            resilience=p["R"](enabled=True), integrity=p["I"](canary_max_tokens=8),
            fault_injector=p["Inj"](replica_crashes={"r1": 3}) if crash else None)
        clock = {"t": 0.0}
        ro = p["rollout"].RolloutController(
            fleet, "v1", engine=eng, config=p["RC"](enabled=True, canary_window_s=0.05,
                                                    traffic_steps=2),
            clock=lambda: clock["t"])
        edges = []
        real = ro._transition

        def spy(to, now, cause=None):
            edges.append((ro.state, to))
            real(to, now=now, cause=cause)

        ro._transition = spy
        ro.start()
        pending = [p["serving"].Request(prompt=pr, id=f"ro{i}", settings=settings,
                                        row_seed=500 + i) for i, pr in enumerate(PROMPTS)]
        results, outstanding = {}, []
        for _ in range(2000):
            if not (ro.active or pending or outstanding or fleet.has_work):
                break
            if pending and fleet.submit(pending[0]):
                outstanding.append(pending.pop(0).id)
            fleet.tick()
            clock["t"] += 0.01
            for rid in list(outstanding):
                res = fleet.take_result(rid)
                if res is not None:
                    results[rid] = res
                    outstanding.remove(rid)
        snap = p["tel"].snapshot(reg)
    return {"edges": edges, "state": ro.state, "cause": ro.cause,
            "pins": {rid: fleet.request_version(rid) for rid in sorted(results)},
            "rows": {rid: [int(t) for t in r.tokens] for rid, r in results.items()},
            "ok": all(r.ok for r in results.values()) and len(results) == len(PROMPTS),
            "replicas": [(r.name, r.version) for r in fleet.replicas],
            "counters": sorted((c["name"], tuple(sorted(c["labels"].items())), c["value"])
                               for c in snap["counters"]
                               if c["labels"].get("component") in ("rollout", "fleet")),
            "snap": snap, "report": p["rollout"].render_rollout_report(snap)}


@pytest.mark.parametrize("crash", [False, True], ids=["complete", "new_replica_crash"])
def test_real_rollout_matches_the_reference(crash):
    got, want = _real_rollout("t", crash), _real_rollout("j", crash)
    for key in ("edges", "state", "cause", "pins", "rows", "ok", "replicas", "counters",
                "report"):
        assert got[key] == want[key], key
    assert got["ok"]
    _, teng = _engines()
    for i, prompt in enumerate(PROMPTS):
        ref = teng.generate([prompt], ModelSettings(temperature=0.0, max_tokens=TOKENS),
                            row_seeds=[500 + i]).tokens[0]
        row = got["rows"][f"ro{i}"]
        assert row == [int(t) for t in ref[:len(row)]]
    counters = {(name, dict(labels).get("to") or dict(labels).get("cause")): v
                for name, labels, v in got["counters"]}
    if crash:
        assert got["state"] == "rolled_back" and got["cause"].startswith("watchdog:")
        assert got["replicas"] == [("r0", "v0")]
        assert counters[("rollout_rollbacks_total", "watchdog")] == 1
        # the crashed v1 replica's unfinished work came back to v0, its
        # pins restamped (a request that finished on v1 keeps its pin)
        assert counters[("rollout_affinity_restamped_total", None)] >= 1
        assert counters[("fleet_migrated_requests_total", None)] == \
            counters[("fleet_migrated_recovered_total", None)] >= 1
    else:
        assert got["state"] == "complete" and got["replicas"] == [("r1", "v1")]
        assert set(got["pins"].values()) == {"v0", "v1"}
    assert "ROLLOUTS" in got["report"]


# ---------------------------------------------------------------------------
# The rollout gate and the CLI
# ---------------------------------------------------------------------------


def _validator():
    spec = importlib.util.spec_from_file_location("validate_telemetry",
                                                  ROOT / "tools" / "validate_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("perturb", ["clean", "no_complete", "no_rollback", "no_cause",
                                     "mid_wave", "migration_lost"])
def test_check_rollout_finds_what_the_reference_gate_finds(perturb):
    with T.use_registry() as reg:
        if perturb != "no_complete":
            reg.counter("rollout_transitions_total", component="rollout", to="complete").inc()
        if perturb != "no_rollback":
            reg.counter("rollout_transitions_total", component="rollout",
                        to="rolled_back").inc()
            if perturb != "no_cause":
                reg.counter("rollout_rollbacks_total", component="rollout",
                            cause="manifest").inc()
        reg.gauge("rollout_state", component="rollout").set(
            3 if perturb == "mid_wave" else trollout.ROLLOUT_STATES.index("complete"))
        reg.counter("fleet_migrated_requests_total", component="fleet").inc(4)
        reg.counter("fleet_migrated_recovered_total", component="fleet").inc(
            3 if perturb == "migration_lost" else 4)
        snap = T.snapshot(reg)
    got = trollout.check_rollout(snap)
    assert got == _validator()._check_rollout(snap)
    assert bool(got) == (perturb != "clean")
    assert trollout.render_rollout_report(snap) == jrollout.render_rollout_report(snap)


def test_cli_rollout_complete_and_manifest_rollback(tmp_path, capsys):
    """To a copy of the checkpoint with a new version id: exit 0. To a
    copy with one flipped byte: exit 2, cause manifest, before any replica
    of the new version joins. No request is lost either time, and the
    snapshot holding both passes the rollout gate."""
    from fairness_llm_tpu_torch.cli import main as tcli

    src = ROOT / "checkpoints" / "tiny-llama-study"
    good, bad = tmp_path / "good", tmp_path / "bad"
    shutil.copytree(src, good)
    shutil.copytree(src, bad)
    blob = bytearray((bad / "model.safetensors").read_bytes())
    blob[len(blob) // 2] ^= 0x01
    (bad / "model.safetensors").write_bytes(bytes(blob))
    base = ["rollout", "--model", "tiny-llama-study", "--weights-dir", str(src), "--device",
            "cpu", "--requests", "6", "--max-new-tokens", "8", "--canary-window", "0.01",
            "--slo-ttft-p95", "300", "--slo-e2e-p99", "600"]
    tel = tmp_path / "tel"
    with T.use_registry(), T.use_timeline(), T.use_incident_manager(), \
            T.use_fairness_monitor():
        capsys.readouterr()
        assert tcli.main(base + ["--to-checkpoint", str(good), "--to-version", "v9"]) == 0
        out = capsys.readouterr().out
        assert "state=complete" in out and "served 6/6" in out
        assert tcli.main(base + ["--to-checkpoint", str(bad), "--to-version", "v10",
                                 "--telemetry-dir", str(tel)]) == 2
        out = capsys.readouterr().out
        assert "state=rolled_back cause=manifest:" in out and "served 6/6" in out
    snap = T.load_snapshot(str(tel))
    joined = {g["labels"]["version"]: g["value"] for g in snap["gauges"]
              if g["name"] == "rollout_version_replicas"}
    assert joined["v10"] == 0
    assert trollout.check_rollout(snap) == []
    assert tcli.main(["telemetry-report", str(tel), "--require-rollout"]) == 0
    assert "rollbacks: manifestx1" in capsys.readouterr().out
    assert (tel / "incidents").is_dir()
    np.testing.assert_array_equal(np.frombuffer(blob, np.uint8)[:16],
                                  np.frombuffer((src / "model.safetensors").read_bytes()[:16],
                                                np.uint8))
