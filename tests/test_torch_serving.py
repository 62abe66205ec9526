"""The port's continuous-batching serving core against its own engine and
against the JAX package's server.

The contract: a request decodes the same tokens through the port's
``ContinuousScheduler`` as through the port's ``DecodeEngine.generate``
alone, for every prompt within the serving budget, and the same tokens as
the reference ``ContinuousScheduler`` for every prompt, an over-budget one
(which both sides left-truncate) included. The host-side pieces (request,
queue, rate limiter, slot pool, counters) go through the same sequences of
calls in both packages and must give the same answers.
"""

import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu.config import ModelSettings as JSettings  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu.utils.profiling import ServingStats as JStats  # noqa: E402
from fairness_llm_tpu.utils.ratelimit import RateLimiter as JRateLimiter  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings, ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.sampling import SamplerSettings  # noqa: E402
from fairness_llm_tpu_torch.runtime.stepbuilder import build_serve_step  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import params_from_jax  # noqa: E402
from fairness_llm_tpu_torch.utils.profiling import ServingStats  # noqa: E402
from fairness_llm_tpu_torch.utils.ratelimit import RateLimiter  # noqa: E402
from test_torch_phase1 import _drop_times, assert_same_record  # noqa: E402

NAME = "tiny-test"
# tiny-test: max_seq_len 256, cap 32 -> a prompt budget of 192 tokens.
SERVING = dict(enabled=True, num_slots=2, queue_capacity=64, max_prompt_len=192,
               max_new_tokens=32, decode_chunk=4)
SCFG = ServingConfig(**SERVING)
# The reference's mixed prompt set (tests/test_serving.py). The fourth is
# 196 byte tokens, over the 192-token budget: both servers left-truncate it.
MIXED_PROMPTS = [
    "the quick brown fox",
    "hi",
    "abc abc abc abc abc abc",
    "a long prompt that shifts padding " * 5 + "and lands in a big bucket",
    "zz",
    "recommend ten films please",
    "one two three one two three",
]
OVER_BUDGET = 3


def greedy(m: int) -> ModelSettings:
    return ModelSettings(temperature=0.0, max_tokens=m)


def budgets():
    return [8 + 2 * (i % 5) for i in range(len(MIXED_PROMPTS))]


@functools.lru_cache(maxsize=None)
def _engines(weight_quant: str = "none", kv_cache_quant: bool = False):
    """The reference engine and the port's on the CPU, same weights."""
    jcfg = dataclasses.replace(get_model_config(NAME), weight_quant=weight_quant,
                               kv_cache_quant=kv_cache_quant)
    jeng = JEngine(jcfg, seed=0)
    tcfg = dataclasses.replace(tconfigs.get_model_config(NAME), weight_quant=weight_quant,
                               kv_cache_quant=kv_cache_quant)
    teng = DecodeEngine(tcfg, params=params_from_jax(jax.device_get(jeng.params), tcfg),
                        device="cpu")
    return jeng, teng


def _serve(engine, prompts=MIXED_PROMPTS, caps=None, settings=None, serving=SCFG, **kw):
    caps = caps or budgets()
    settings = settings or greedy(max(caps))
    sched = tserving.ContinuousScheduler(engine, serving, settings=settings)
    reqs = [tserving.Request(prompt=p, settings=dataclasses.replace(settings, max_tokens=m),
                             **kw) for p, m in zip(prompts, caps)]
    return sched, reqs, sched.serve(reqs)


def _assert_equals_engine(engine, reqs, results, skip=()):
    """Every result equals ``engine.generate([prompt])`` with the request's
    settings and row seed, tokens and text."""
    for i, (req, res) in enumerate(zip(reqs, results)):
        if i in skip:
            continue
        assert res.ok, res.error
        seeds = None if req.row_seed is None else [req.row_seed]
        ref = engine.generate([req.prompt], req.settings, row_seeds=seeds)
        n = len(res.tokens)
        assert n > 0
        np.testing.assert_array_equal(res.tokens, ref.tokens[0][:n], err_msg=f"request {i}")
        assert np.all(ref.tokens[0][n:] == engine.tokenizer.pad_id)
        assert res.text == ref.texts[0]


# ---------------------------------------------------------------------------
# Request, queue, rate limiter, slot pool, counters: the same calls in both
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rate_limiter_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    clocks = FakeClock(), FakeClock()
    got = RateLimiter(3, 10.0, clock=clocks[0])
    want = JRateLimiter(3, 10.0, clock=clocks[1])
    for _ in range(60):
        dt = float(rng.choice([0.0, 1.0, 4.0, 11.0]))
        for c in clocks:
            c.t += dt
        op = rng.choice(["try", "can"])
        if op == "try":
            assert got.try_acquire() == want.try_acquire()
        else:
            assert got.can_acquire() == want.can_acquire()
        assert list(got._times) == list(want._times)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_queue_matches_the_reference(seed):
    """Capacity and rate refusals, FIFO, requeue at the front, expiry."""
    rng = np.random.default_rng(seed)
    clocks = FakeClock(), FakeClock()
    got = tserving.AdmissionQueue(4, RateLimiter(6, 30.0, clock=clocks[0]))
    want = jserving.AdmissionQueue(4, JRateLimiter(6, 30.0, clock=clocks[1]))
    for i in range(80):
        for c in clocks:
            c.t += float(rng.choice([0.0, 2.0, 16.0]))
        op = rng.choice(["submit", "submit", "requeue", "pop", "expire"])
        deadline = float(rng.choice([-1.0, 0.0, 100.0]))
        deadline = None if deadline < 0 else deadline
        if op in ("submit", "requeue"):
            a = tserving.Request(prompt=f"p{i}", id=f"r{i}", deadline_s=deadline,
                                 submitted_at=0.0)
            b = jserving.Request(prompt=f"p{i}", id=f"r{i}", deadline_s=deadline,
                                 submitted_at=0.0)
            if op == "submit":
                assert got.submit(a) == want.submit(b)
            else:
                got.requeue(a)
                want.requeue(b)
        elif op == "pop":
            n = int(rng.integers(1, 4))
            assert [r.id for r in got.pop(n)] == [r.id for r in want.pop(n)]
        else:
            now = float(rng.choice([0.0, 1.0]))
            assert [r.id for r in got.drain_expired(now)] == \
                [r.id for r in want.drain_expired(now)]
        assert len(got) == len(want) and got.full == want.full
        assert got.rejected == want.rejected


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_pool_matches_the_reference(seed):
    """alloc (lowest free first, None when full), release (double release
    raises), and pending invalidations cancelled by reuse."""
    rng = np.random.default_rng(seed)
    got, want = tserving.SlotPool(4), jserving.SlotPool(4)
    for i in range(200):
        op = rng.choice(["alloc", "release", "release", "take"])
        if op == "alloc":
            a = got.alloc(tserving.SlotState(request=tserving.Request(prompt="p"), base=64,
                                             real_len=i))
            b = want.alloc(jserving.SlotState(request=jserving.Request(prompt="p"), base=64,
                                              real_len=i))
            assert a == b
        elif op == "release":
            slot = int(rng.integers(0, 4))
            if slot in want.live_slots():
                assert got.release(slot).real_len == want.release(slot).real_len
            else:
                with pytest.raises(KeyError):
                    got.release(slot)
        else:
            assert got.take_invalidations() == want.take_invalidations()
        assert got.live_slots() == want.live_slots()
        assert got.pending_invalidation == want.pending_invalidation
        assert (got.occupancy, got.free_count) == (want.occupancy, want.free_count)


def test_request_matches_the_reference():
    for qos in ("interactive", "batch", "probe"):
        a = tserving.Request(prompt="x", qos=qos, deadline_s=1.0, submitted_at=5.0)
        b = jserving.Request(prompt="x", qos=qos, deadline_s=1.0, submitted_at=5.0)
        for now in (5.5, 6.0, 7.0):
            assert a.expired(now) == b.expired(now)
    assert tserving.QOS_CLASSES == jserving.QOS_CLASSES
    with pytest.raises(ValueError, match="qos"):
        tserving.Request(prompt="x", qos="bulk")
    assert not tserving.Request(prompt="x").expired()
    assert tserving.Result(id="a", ok=True).tokens.dtype == np.int32


def test_serving_stats_match_the_reference():
    fields = dict(num_slots=8, admitted=3, decode_steps=10, decoded_tokens=25,
                  occupancy_sum=20, queue_depth_max=4, loop_iterations=5, queue_depth_sum=10)
    other = dict(num_slots=8, admitted=2, decode_steps=5, decoded_tokens=10,
                 occupancy_sum=10, queue_depth_max=7, loop_iterations=2, queue_depth_sum=2)
    got = ServingStats(**fields).merge(ServingStats(**other))
    want = JStats(**fields).merge(JStats(**other))
    assert got.as_dict() == want.as_dict()
    assert ServingStats.from_dict(got.as_dict()) == got
    assert ServingStats().as_dict() == JStats().as_dict()


def test_serving_config_matches_the_reference_and_refuses_later_slices():
    assert {f.name for f in dataclasses.fields(ServingConfig)} == \
        {f.name for f in dataclasses.fields(JServingConfig)}
    got, want = ServingConfig(), JServingConfig()
    for f in dataclasses.fields(ServingConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    # the paged KV cache and tensor-parallel serving are ported
    for kw in (dict(paged_kv=True), dict(kv_block_size=32), dict(kv_blocks=64), dict(tp=2)):
        assert dataclasses.asdict(ServingConfig(**kw)) == dataclasses.asdict(JServingConfig(**kw))


# ---------------------------------------------------------------------------
# The scheduler against the port's engine and the reference scheduler
# ---------------------------------------------------------------------------


def test_server_matches_engine_greedy_mixed_lengths():
    """Two slots, so most rows ride recycled slots; per-request budgets."""
    _, teng = _engines()
    sched, reqs, results = _serve(teng)
    assert len(teng.tokenizer.encode(MIXED_PROMPTS[OVER_BUDGET])) > sched.prompt_budget
    _assert_equals_engine(teng, reqs, results, skip=(OVER_BUDGET,))
    assert [len(r.tokens) for r in results] == budgets()  # random weights: no EOS
    stats = sched.last_stats
    assert stats.admitted == stats.completed == len(MIXED_PROMPTS)
    assert stats.decoded_tokens == sum(budgets())
    assert stats.decode_steps < sum(budgets())  # rows overlapped
    assert sched.pool.occupancy == 0


def test_server_matches_the_reference_scheduler():
    """Every prompt, the over-budget one included, and the counters."""
    jeng, teng = _engines()
    sched, _, got = _serve(teng)
    jsched = jserving.ContinuousScheduler(jeng, JServingConfig(**SERVING),
                                          settings=JSettings(temperature=0.0, max_tokens=16))
    want = jsched.serve([jserving.Request(prompt=p, settings=JSettings(temperature=0.0,
                                                                       max_tokens=m))
                         for p, m in zip(MIXED_PROMPTS, budgets())])
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=f"request {i}")
        assert (a.text, a.finish_reason, a.prompt_tokens) == \
            (b.text, b.finish_reason, b.prompt_tokens)
    assert got[OVER_BUDGET].prompt_tokens == sched.prompt_budget
    assert sched.last_stats.as_dict() == jsched.last_stats.as_dict()


def test_server_parity_with_early_eos():
    """EOS mid-decode evicts the row with the EOS token kept, nothing after
    (an EOS id taken from the greedy stream, as the reference's test does)."""
    _, teng = _engines()
    plain = teng.generate([MIXED_PROMPTS[0]], greedy(16))
    eos = int(plain.tokens[0][5])
    tok = ByteTokenizer(512)
    tok.eos_id = eos
    eng2 = DecodeEngine(teng.config, params=teng.model.state_dict(), tokenizer=tok,
                        device="cpu")
    sched, reqs, results = _serve(eng2, prompts=MIXED_PROMPTS[:1], caps=[16])
    res = results[0]
    assert res.finish_reason == "eos" and res.tokens[-1] == eos
    assert len(res.tokens) <= 6
    _assert_equals_engine(eng2, reqs, results)
    assert sched.last_stats.decoded_tokens == len(res.tokens)


def test_sampled_tokens_equal_the_engine_for_the_same_row_seeds():
    _, teng = _engines()
    settings = ModelSettings(temperature=0.7, max_tokens=12, top_k=50)
    prompts = [p for i, p in enumerate(MIXED_PROMPTS) if i != OVER_BUDGET]
    caps = [12] * len(prompts)
    seeds = list(np.random.default_rng(0).integers(0, 2**32, len(prompts)))
    sched = tserving.ContinuousScheduler(teng, SCFG, settings=settings)
    reqs = [tserving.Request(prompt=p, settings=settings, row_seed=int(s))
            for p, s in zip(prompts, seeds)]
    _assert_equals_engine(teng, reqs, sched.serve(reqs))
    greedy_out = _serve(teng, prompts=prompts, caps=caps)[2]
    assert any(a.text != b.text for a, b in zip(sched.serve(reqs), greedy_out))


@pytest.mark.parametrize("fuse", [1, 3])
def test_fused_steps_give_the_same_tokens(fuse):
    _, teng = _engines()
    sched, reqs, results = _serve(teng, serving=dataclasses.replace(SCFG, fuse_steps=fuse))
    _assert_equals_engine(teng, reqs, results, skip=(OVER_BUDGET,))
    # eviction waits for the fused boundary: fewer scheduler iterations
    base = _serve(teng)[0].last_stats
    assert sched.last_stats.decoded_tokens == base.decoded_tokens
    if fuse > 1:
        assert sched.last_stats.loop_iterations < base.loop_iterations


def test_short_request_in_a_recycled_slot_equals_its_solo_run():
    """One slot: a long prompt decodes 30 tokens there, then a short one
    takes the slot. Its prefill re-invalidates the row past its own bucket,
    so the long tenant's keys stay dark and the short request decodes as
    it does alone."""
    _, teng = _engines()
    one = dataclasses.replace(SCFG, num_slots=1)
    long_prompt = MIXED_PROMPTS[OVER_BUDGET][:150]
    _, _, both = _serve(teng, prompts=[long_prompt, MIXED_PROMPTS[0]], caps=[30, 12],
                        serving=one)
    _, _, alone = _serve(teng, prompts=[MIXED_PROMPTS[0]], caps=[12], serving=one)
    np.testing.assert_array_equal(both[1].tokens, alone[0].tokens)


def test_serve_step_reset_mask_and_offset_check():
    """The step's entry clears released rows' key_valid and lengths; a live
    row whose write offset runs past the cache raises from the host-side
    check before any write."""
    _, teng = _engines()
    cfg = teng.config
    step = build_serve_step(teng.model, SamplerSettings(temperature=0.0),
                            teng.tokenizer.pad_id, teng.tokenizer.eos_id, num_slots=2,
                            chunk=2)
    cache = ttr.init_cache(cfg, 2, 16)
    cache.key_valid[:, :4] = True
    cache.lengths[:] = 4
    logits = torch.zeros(2, cfg.vocab_size)
    live, reset = np.array([True, False]), np.array([False, True])
    out = step(cache, logits, [0, 0], np.zeros(2), np.array([4, 0]), np.array([2, 1]),
               live, reset)
    assert out.steps == 2 and list(out.emitted) == [2, 0] and out.row_steps == 2
    assert not cache.key_valid[1].any() and int(cache.lengths[1]) == 0
    assert cache.key_valid[0, :6].all() and int(cache.lengths[0]) == 6
    with pytest.raises(ValueError, match="max_len 16"):
        step(cache, logits, [0, 0], np.zeros(2), np.array([15, 0]), np.array([4, 1]),
             live, np.zeros(2, bool))


def test_loops_read_no_offsets_back(monkeypatch):
    """Neither loop's forward reads its write offsets back to the host (the
    bounds check moved to the loops' host copies); both still give their
    tokens: the server the engine's, speculation plain greedy's."""
    from fairness_llm_tpu_torch.config import SpeculationConfig

    _, teng = _engines()
    prompts = MIXED_PROMPTS[:3]
    plain = teng.generate(prompts, greedy(10), share_prefix=False)

    def refuse(*a, **k):
        raise AssertionError("a forward read write_offsets back to the host")

    monkeypatch.setattr(torch, "aminmax", refuse)
    spec = teng.generate(prompts, greedy(10), share_prefix=False,
                         speculation=SpeculationConfig(enabled=True, draft_len=3))
    np.testing.assert_array_equal(spec.tokens, plain.tokens)
    _, reqs, results = _serve(teng, prompts=prompts, caps=[10] * 3)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.tokens, plain.tokens[i][:len(r.tokens)])


@pytest.mark.parametrize("mode", ["int8-weights", "int8-kv-cache"])
def test_quantized_configs_server_equals_engine(mode):
    jeng, teng = _engines(**({"weight_quant": "int8"} if mode == "int8-weights"
                             else {"kv_cache_quant": True}))
    sched, reqs, results = _serve(teng)
    _assert_equals_engine(teng, reqs, results, skip=(OVER_BUDGET,))
    if mode == "int8-kv-cache":
        assert sched._cache.layers[0].k.dtype == torch.int8


def test_submit_drain_take_result_and_rejections():
    _, teng = _engines()
    sched = tserving.ContinuousScheduler(teng, dataclasses.replace(SCFG, queue_capacity=1),
                                         settings=greedy(8))
    assert sched.submit(tserving.Request(prompt=MIXED_PROMPTS[0], settings=greedy(8),
                                         id="direct"))
    assert not sched.submit(tserving.Request(prompt="b", settings=greedy(8), id="b"))
    stats = sched.drain()
    assert stats.completed == 1 and stats.rejected == 1
    res = sched.take_result("direct")
    ref = teng.generate([MIXED_PROMPTS[0]], greedy(8))
    np.testing.assert_array_equal(res.tokens, ref.tokens[0])
    assert sched.take_result("direct") is None
    assert sched.drain().rejected == 0  # reported once
    with pytest.raises(ValueError, match="duplicate request ids"):
        sched.serve([tserving.Request(prompt="a", id="x"), tserving.Request(prompt="b", id="x")])
    with pytest.raises(ValueError, match="sampler"):
        sched.submit(tserving.Request(prompt="x", settings=ModelSettings(temperature=0.9)))


def test_deadlines_expire_in_the_queue():
    _, teng = _engines()
    sched, _, results = _serve(teng, prompts=MIXED_PROMPTS[:3], caps=[8, 8, 8],
                               deadline_s=0.0)
    assert [r.finish_reason for r in results] == ["deadline"] * 3
    assert not any(r.ok for r in results)
    assert sched.last_stats.expired == 3 and sched.last_stats.admitted == 0


# ---------------------------------------------------------------------------
# ServingBackend, backend_for, the phases and the CLI
# ---------------------------------------------------------------------------


def test_serving_backend_matches_engine_backend_greedy():
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, shared_prefix_ids

    _, teng = _engines()
    prompts = [p for i, p in enumerate(MIXED_PROMPTS) if i != OVER_BUDGET]
    keys = [f"profile_{i}" for i in range(len(prompts))]
    sb = tserving.ServingBackend(teng, SCFG)
    ref = EngineBackend(teng).generate(prompts, greedy(8), seed=7, keys=keys)
    assert sb.generate(prompts, greedy(8), seed=7, keys=keys) == ref
    assert sb.serve_totals.admitted == len(prompts)
    assert sb.last_output.stats["serving"]["completed"] == len(prompts)
    assert shared_prefix_ids(sb, prompts * 2) is None  # use_shared_prefix is False
    sb.generate(prompts[:2], greedy(4))
    assert sb.serve_totals.admitted == len(prompts) + 2  # merged across calls
    sb.serve_totals = None  # the phases' reset
    sb.generate(prompts[:1], greedy(4))
    assert sb.serve_totals.admitted == 1
    assert sb.generate([], greedy(4)) == []


def test_backend_for_returns_a_serving_backend():
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline import backends as B

    on = Config(serving=ServingConfig(enabled=True, num_slots=2))
    assert isinstance(B.backend_for(NAME, on, allow_random=True, device="cpu"),
                      tserving.ServingBackend)
    assert isinstance(B.backend_for(NAME, Config(), allow_random=True, device="cpu"),
                      B.EngineBackend)


ROOT = pathlib.Path(__file__).resolve().parents[1]
STUDY_MODEL = "tiny-llama-study"


@pytest.fixture(scope="module")
def study_sweeps(tmp_path_factory):
    """The greedy --quick sweep (15 profiles, 1 neutral prompt, 32 tokens)
    on the study checkpoint: the reference with --continuous, the port
    through a ServingBackend and through its engine path, on the CPU."""
    from fairness_llm_tpu import config as jconfig
    from fairness_llm_tpu.pipeline import phase1 as jphase1
    from fairness_llm_tpu_torch import config as tconfig
    from fairness_llm_tpu_torch.pipeline import backends as tbackends
    from fairness_llm_tpu_torch.pipeline import phase1 as tphase1

    d = tmp_path_factory.mktemp("serving_sweeps")

    def cfg(mod, serving, tag):
        settings = tuple((n, mod.ModelSettings(temperature=0.0, max_tokens=32)
                          if n == STUDY_MODEL else s) for n, s in mod.Config().model_settings)
        return mod.Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(d / tag),
                          profiles_per_combo=1, model_settings=settings,
                          serving=mod.ServingConfig(enabled=serving))

    want = jphase1.run_phase1(cfg(jconfig, True, "ref"), STUDY_MODEL)
    runs = {}
    for serving in (True, False):
        c = cfg(tconfig, serving, f"port_{serving}")
        backend = tbackends.backend_for(STUDY_MODEL, c, device="cpu")
        runs[serving] = (tphase1.run_phase1(c, STUDY_MODEL, backend=backend), backend)
    return runs[True], runs[False][0], want


def _raw(record):
    return {k: v["raw_response"] for k, v in record["recommendations"].items()}


def test_study_sweep_through_the_server_equals_engine_and_reference(study_sweeps):
    (got, backend), engine_path, want = study_sweeps
    assert isinstance(backend, tserving.ServingBackend)
    assert type(backend.engine.tokenizer).__name__ == "HFTokenizer"
    assert len(_raw(got)) == 15
    assert _raw(got) == _raw(engine_path) == _raw(want)
    assert got["neutral_recommendations"] == engine_path["neutral_recommendations"] \
        == want["neutral_recommendations"]
    assert_same_record(got["metrics"], want["metrics"])
    assert_same_record(_drop_times(got)["metadata"], _drop_times(want)["metadata"])
    serving = got["metadata"]["serving"]
    assert serving["admitted"] == serving["completed"] == 16
    assert engine_path["metadata"]["serving"] is None


def test_phase2_and_phase3_record_and_reset_serving_totals(tmp_path):
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline import backends as B
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.pipeline.phase2 import run_phase2
    from fairness_llm_tpu_torch.pipeline.phase3 import run_phase3

    settings = tuple((n, ModelSettings(temperature=0.0, max_tokens=8) if n == STUDY_MODEL
                      else s) for n, s in Config().model_settings)
    cfg = Config(weights_dir=str(ROOT / "checkpoints"), results_dir=str(tmp_path),
                 profiles_per_combo=1, model_settings=settings,
                 serving=ServingConfig(enabled=True, num_slots=4))
    backend = B.backend_for(STUDY_MODEL, cfg, device="cpu")
    p1 = run_phase1(cfg, STUDY_MODEL, backend=backend, save=False)
    p2 = run_phase2(cfg, models=[STUDY_MODEL], num_items=6, num_comparisons=4,
                    backends={STUDY_MODEL: backend}, save=False)
    served = p2["model_results"][STUDY_MODEL]["serving"]
    assert served["completed"] == served["admitted"] > 0
    assert served["admitted"] != p1["metadata"]["serving"]["admitted"]  # reset per phase
    run_phase3(cfg, phase1_results=p1, model_name=STUDY_MODEL, backend=backend, save=False)
    # phase 3's own sweep: one request a profile
    assert backend.serve_totals.admitted == p1["metadata"]["num_profiles"]


def test_cli_continuous_runs(tmp_path, capsys):
    import json

    from fairness_llm_tpu_torch.cli import main as tcli

    args = ["--phase", "1", "--quick", "--model", STUDY_MODEL, "--weights-dir",
            str(ROOT / "checkpoints"), "--device", "cpu", "--continuous", "--slots", "4",
            "--fuse-steps", "2", "--max-new-tokens", "8", "--results-dir", str(tmp_path)]
    assert tcli.main(args) == 0
    rec = json.loads((tmp_path / "phase1" / "phase1_results.json").read_text())
    assert rec["metadata"]["serving"]["num_slots"] == 4
    assert rec["metadata"]["serving"]["completed"] == 16
    assert "PHASE 1 SUMMARY" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--tp", "--achievable-gbps", "--replicas", "--autoscale",
                                  "--mesh"])
def test_cli_refuses_the_later_serving_flags(flag):
    """Every serving flag is ported. --tp and --mesh tp=2 are refused in
    one process, as a world smaller than the mesh is, naming the ranks to
    launch (tests/test_torch_tp.py runs them over gloo ranks). The fleet's
    (--replicas, --autoscale) are refused, as the reference refuses them,
    without --continuous; the roofline's --achievable-gbps parses as the
    reference's."""
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    value = {"--autoscale": [], "--mesh": ["tp=2"]}.get(flag, ["2"])
    if flag == "--achievable-gbps":
        argv = ["--phase", "1", "--continuous", flag] + value
        got = tcli.config_from_args(tcli.build_parser().parse_args(argv)).telemetry
        want = jcli.config_from_args(jcli.build_parser().parse_args(argv)).telemetry
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return
    if flag in ("--replicas", "--autoscale"):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit, match="--continuous"):
                cli.config_from_args(cli.build_parser().parse_args(["--phase", "1", flag]
                                                                   + value))
        return
    with pytest.raises((SystemExit, ValueError), match="torchrun --nproc-per-node 2"):
        tcli.main(["--phase", "1", "--quick", "--no-save", "--device", "cpu", "--model",
                   "tiny-llama-study", "--weights-dir", str(ROOT / "checkpoints"),
                   "--continuous", flag] + value)


def test_cli_serving_checks_match_the_reference():
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    for argv in (["--slots", "2"], ["--fuse-steps", "2"], ["--continuous", "--slots", "0"],
                 ["--continuous", "--fuse-steps", "0"],
                 ["--continuous", "--fuse-steps", "2", "--speculate"]):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.config_from_args(cli.build_parser().parse_args(["--phase", "1"] + argv))
    args = ["--phase", "1", "--continuous", "--slots", "3", "--fuse-steps", "2"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args)).serving
    want = jcli.config_from_args(jcli.build_parser().parse_args(args)).serving
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
