"""The port's paged KV cache (``serving/paged.py`` and the scheduler's
``paged_kv`` mode) against the JAX package's and against the port's own
engine.

The contract, as for the non-paged core (``tests/test_torch_serving.py``):
a request decodes the same tokens through the port's paged scheduler as
through ``DecodeEngine.generate`` alone for every prompt within the
serving budget, and the same tokens as the reference's paged scheduler for
every prompt, the over-budget one included. The radix index and the block
allocator go through the same call sequences in both packages and must
give the same answers, and a serve leaves the same block accounting and
prefix-cache counters in both packages' registries.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers on
# one machine, and OpenMP pools of every core in each spin against the
# others (the port's tests ran 4x slower oversubscribed).
torch.set_num_threads(1)

from fairness_llm_tpu import serving as jserving  # noqa: E402
from fairness_llm_tpu.config import ServingConfig as JServingConfig  # noqa: E402
from fairness_llm_tpu.serving import paged as jpaged  # noqa: E402
from fairness_llm_tpu.telemetry import use_registry as j_use_registry  # noqa: E402
from fairness_llm_tpu_torch import serving as tserving  # noqa: E402
from fairness_llm_tpu_torch.config import ServingConfig  # noqa: E402
from fairness_llm_tpu_torch.models import configs as tconfigs  # noqa: E402
from fairness_llm_tpu_torch.models.transformer import init_cache  # noqa: E402
from fairness_llm_tpu_torch.serving import paged as tpaged  # noqa: E402
from fairness_llm_tpu_torch.telemetry import use_registry  # noqa: E402
from test_torch_serving import (  # noqa: E402
    MIXED_PROMPTS,
    OVER_BUDGET,
    ROOT,
    STUDY_MODEL,
    _engines,
    greedy,
)

PAGED = dict(enabled=True, num_slots=2, queue_capacity=64, max_prompt_len=192,
             max_new_tokens=32, decode_chunk=4, paged_kv=True, kv_block_size=16)
PCFG = ServingConfig(**PAGED)
# The reference's counterfactual-shaped family (tests/test_paged_kv.py): one
# long shared stem, short divergent tails, as phase 1's prompts.
STEM = ("Recommend 5 movies. The user enjoyed Alien, Heat, Fargo, Clue, "
        "Tron, Big, Jaws, Up. Genres: drama, thriller. Profile: ")
FAMILY = [STEM + tail for tail in (
    "male 18-24", "female 18-24", "nonbinary 18-24", "male 25-34",
    "female 25-34", "nonbinary 25-34", "male 35-44", "female 35-44",
)]
PROMPTS = MIXED_PROMPTS + FAMILY
# Counters and gauges of the paged manager, read from both registries.
PAGED_COUNTERS = ("prefix_cache_hit_tokens_total", "prefix_cache_miss_tokens_total",
                  "prefix_cache_cow_total", "kv_blocks_evicted_total")
PAGED_GAUGES = ("kv_blocks_free", "kv_block_occupancy", "kv_blocks_cached",
                "prefix_cache_hit_ratio")


def caps():
    return [8 + 2 * (i % 5) for i in range(len(PROMPTS))]


def _paged_invariant(paged):
    """free + live-private + tree-owned == num_blocks, no id twice."""
    tree = []
    stack = [paged.index.root]
    while stack:
        node = stack.pop()
        for child in node.children.values():
            tree.append(child.block)
            stack.append(child)
    private = [b for blocks in paged._private.values() for b in blocks]
    every = list(paged._free) + private + tree
    assert len(every) == len(set(every)), "block id aliased"
    assert len(every) == paged.num_blocks


def _accounting(paged, reg):
    """What a serve leaves behind: the allocator's state and the paged
    manager's counters and gauges in ``reg``."""
    out = {"free": paged.free_blocks, "cached": paged.index.cached_blocks(),
           "nodes": len(paged.index), "hit_ratio": paged.hit_ratio}
    for name in PAGED_COUNTERS + PAGED_GAUGES:
        m = reg.peek(name, component="paged_kv")
        out[name] = None if m is None else m.value
    hist = reg.peek("matched_prefix_len", component="paged_kv")
    out["matched_prefix_len"] = None if hist is None else (hist.count, hist.sum)
    return out


# ---------------------------------------------------------------------------
# The radix index and the block allocator: the same calls in both packages
# ---------------------------------------------------------------------------


def _radix_match_insert_refcount(mod):
    idx = mod.RadixIndex(4)
    ids = list(range(10))
    m = idx.match(ids)
    out = [len(m.nodes), m.cow_len]
    held, promoted = idx.insert(ids, [100, 101], m.nodes)
    out += [promoted, [n.refs for n in held]]
    m2 = idx.match(ids)
    out += [[n.block for n in m2.nodes], [n.refs for n in held]]
    idx.release(m2.nodes)
    idx.release(held)
    return out + [[n.refs for n in held], len(idx), idx.cached_blocks()]


def _radix_caps_at_len_minus_one(mod):
    idx = mod.RadixIndex(4)
    ids = list(range(8))
    held, _ = idx.insert(ids, [7, 8], idx.match(ids).nodes)
    m = idx.match(ids)
    out = [[n.block for n in m.nodes], m.cow_src_block, m.cow_len, m.matched(4),
           m.cow_node.refs]
    idx.release(m.nodes + [m.cow_node])
    idx.release(held)
    return out


def _radix_cow_partial_match(mod):
    idx = mod.RadixIndex(4)
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    held, _ = idx.insert(a, [0, 1], idx.match(a).nodes)
    m = idx.match([1, 2, 3, 4, 5, 6, 99, 98, 97])
    out = [[n.block for n in m.nodes], m.cow_src_block, m.cow_len, m.matched(4),
           idx.evict_lru()]
    idx.release(m.nodes + [m.cow_node])
    idx.release(held)
    return out + [idx.evict_lru(), idx.evict_lru(), idx.evict_lru()]


def _radix_evict_lru_leaf_first(mod):
    idx = mod.RadixIndex(2)
    a, b = [1, 2, 3, 4, 5], [1, 2, 9, 9, 9]
    ha, _ = idx.insert(a, [10, 11], idx.match(a).nodes)
    mb = idx.match(b)
    hb, promoted = idx.insert(b, [mb.nodes[0].block, 12], mb.nodes)
    idx.release(ha)
    idx.release(hb)
    return [promoted] + [idx.evict_lru() for _ in range(4)] + [len(idx)]


def _radix_evict_skips_referenced(mod):
    idx = mod.RadixIndex(2)
    a = [1, 2, 3, 4, 5]
    held, _ = idx.insert(a, [0, 1], idx.match(a).nodes)
    out = [idx.evict_lru()]
    idx.release(held)
    return out + [idx.evict_lru(), idx.evict_lru(), idx.evict_lru()]


def _paged_admit_commit_release(mod):
    paged = mod.PagedKV(num_slots=2, blocks_per_slot=4, block_size=4)
    ids = list(range(14))
    plan = paged.admit(0, ids)
    paged.commit(0, ids)
    plan2 = paged.admit(1, ids)
    paged.commit(1, ids)
    out = [dataclasses.astuple(plan), dataclasses.astuple(plan2), paged.free_blocks,
           paged.write_table_for(1)]
    paged.release(0)
    out += [paged.free_blocks, sorted(paged._free)[:4], paged.table_for(0)]
    paged.release(1)
    _paged_invariant(paged)
    return out + [paged.index.cached_blocks(), paged.hit_ratio]


def _paged_exhaustion_and_eviction(mod):
    paged = mod.PagedKV(num_slots=2, blocks_per_slot=4, block_size=4, num_blocks=5)
    a, b = list(range(10)), list(range(100, 110))
    out = [dataclasses.astuple(paged.admit(0, a))]
    paged.commit(0, a)
    out.append(paged.admit(1, b))
    _paged_invariant(paged)
    paged.release(0)
    out.append(dataclasses.astuple(paged.admit(1, b)))
    paged.commit(1, b)
    _paged_invariant(paged)
    paged.release(1)
    return out + [paged.free_blocks, len(paged.index)]


def _paged_cow_pinned_until_commit(mod):
    paged = mod.PagedKV(num_slots=2, blocks_per_slot=3, block_size=4, num_blocks=6)
    p1, p2 = [1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 99, 98, 97]
    p3 = [50, 51, 52, 53, 54, 55, 56, 57, 58]
    paged.admit(0, p1)
    paged.commit(0, p1)
    paged.release(0)
    out = [dataclasses.astuple(paged.admit(0, p2)), paged.admit(1, p3),
           paged._cow[0].refs]
    paged.commit(0, p2)
    out += [0 in paged._cow, dataclasses.astuple(paged.admit(1, p3))]
    _paged_invariant(paged)
    paged.release(0)
    paged.abort(1)
    _paged_invariant(paged)
    return out + [paged.free_blocks]


def _paged_reset(mod):
    paged = mod.PagedKV(num_slots=2, blocks_per_slot=3, block_size=4)
    ids = list(range(9))
    paged.admit(0, ids)
    paged.commit(0, ids)
    paged.reset()
    return [paged.free_blocks, len(paged.index), paged.table_for(0),
            dataclasses.astuple(paged.admit(1, ids))]


@pytest.mark.parametrize("scenario", [
    _radix_match_insert_refcount, _radix_caps_at_len_minus_one, _radix_cow_partial_match,
    _radix_evict_lru_leaf_first, _radix_evict_skips_referenced, _paged_admit_commit_release,
    _paged_exhaustion_and_eviction, _paged_cow_pinned_until_commit, _paged_reset,
], ids=lambda f: f.__name__.lstrip("_"))
def test_host_side_matches_the_reference(scenario):
    """Each scenario of the reference's own unit tests, through both
    packages, with its counters read from each package's registry."""
    with use_registry() as treg:
        got = scenario(tpaged)
    with j_use_registry() as jreg:
        want = scenario(jpaged)
    assert got == want
    tsnap = {(m.name, tuple(sorted(m.labels.items()))): getattr(m, "value", None)
             for m in treg.instruments()}
    jsnap = {(m.name, tuple(sorted(m.labels.items()))): getattr(m, "value", None)
             for m in jreg.instruments()}
    assert tsnap == jsnap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_paged_sequence_matches_the_reference(seed):
    """A random run of admit / commit / abort / release over prompts that
    share prefixes, in a scarce arena: every plan, table, write table and
    count equal in both packages."""
    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, 50, size=n)) for n in (9, 13, 20)]
    with use_registry() as treg, j_use_registry() as jreg:
        pkgs = [tpaged.PagedKV(num_slots=4, blocks_per_slot=6, block_size=4, num_blocks=14),
                jpaged.PagedKV(num_slots=4, blocks_per_slot=6, block_size=4, num_blocks=14)]
        state = {}  # slot -> "planned" | "committed"
        for _ in range(150):
            slot = int(rng.integers(0, 4))
            if slot not in state:
                stem = stems[int(rng.integers(0, 3))]
                ids = [int(t) for t in stem[:int(rng.integers(3, len(stem) + 1))]]
                ids += [int(t) for t in rng.integers(50, 60, size=int(rng.integers(1, 6)))]
                plans = [p.admit(slot, ids) for p in pkgs]
                assert [None if x is None else dataclasses.astuple(x) for x in plans] == \
                    [None if x is None else dataclasses.astuple(x) for x in plans[::-1]]
                if plans[0] is not None:
                    state[slot] = ("planned", ids)
            elif state[slot][0] == "planned":
                if rng.random() < 0.8:
                    for p in pkgs:
                        p.commit(slot, state[slot][1])
                    state[slot] = ("committed", state[slot][1])
                else:
                    for p in pkgs:
                        p.abort(slot)
                    del state[slot]
            else:
                assert pkgs[0].write_table_for(slot) == pkgs[1].write_table_for(slot)
                for p in pkgs:
                    p.release(slot)
                del state[slot]
            got, want = pkgs
            assert (got.free_blocks, got.hit_ratio, len(got.index),
                    got.index.cached_blocks()) == \
                (want.free_blocks, want.hit_ratio, len(want.index), want.index.cached_blocks())
            assert got._tables == want._tables
            _paged_invariant(got)
        assert _accounting(got, treg) == _accounting(want, jreg)


def test_slot_pool_routes_release_through_paged():
    paged = tpaged.PagedKV(num_slots=2, blocks_per_slot=4, block_size=4)
    pool = tserving.SlotPool(2, paged=paged)
    s = pool.alloc(tserving.SlotState(request=tserving.Request(prompt="x"), base=5,
                                      real_len=5))
    ids = list(range(5))
    assert paged.admit(s, ids) is not None
    paged.commit(s, ids)
    pool.release(s)
    assert paged.table_for(s) is None
    assert pool.pending_invalidation == []  # paged: no row reset rides a step
    _paged_invariant(paged)


# ---------------------------------------------------------------------------
# The device side: the arena, its sink block, gather and scatter
# ---------------------------------------------------------------------------


def test_gather_scatter_round_trip_and_the_sink():
    """A view scattered through write tables and gathered again reads back
    what was written; entries naming the sink leave their block alone, and
    no table reads the sink."""
    cfg = dataclasses.replace(tconfigs.get_model_config("tiny-test"), num_layers=2)
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_cache_quant=quant)
        arena = tpaged.init_arena(c, num_blocks=6, block_size=4, num_slots=2, device="cpu")
        assert arena.num_blocks == 6 and arena.key_valid.shape[0] == 7
        g = torch.Generator().manual_seed(0)
        for t in arena.tensors():
            t.copy_(torch.randint(-50, 50, t.shape, generator=g).to(t.dtype))
        before = [t.clone() for t in arena.tensors()]
        view = init_cache(c, 3, 12, device="cpu")  # 3 rows (one spare), 3 blocks a row
        tables = torch.tensor([[0, 1, 2], [0, 3, 4]])
        wtables = torch.tensor([[6, 1, 2], [6, 3, 6]])  # block 0 shared, 4 read-only
        v = tpaged.gather_view(arena, tables, arena.lengths, view)
        assert v.key_valid.shape == (2, 12) and v.lengths is arena.lengths
        for lc, big in zip(v.layers, arena.layers):
            assert torch.equal(lc.k[1, 4:8], big.k[3])
        for lc in v.layers:
            lc.k.fill_(7)
            lc.v.fill_(7)
        tpaged.scatter_view(arena, v, wtables)
        k0 = arena.layers[0].k
        assert all((lc.k[[1, 2, 3]] == 7).all() for lc in arena.layers)
        for block in (0, 4, 5):  # shared, read-only, in no table
            assert torch.equal(k0[block], before[0][block])
        v2 = tpaged.gather_view(arena, tables, arena.lengths, view)
        assert (v2.layers[0].k[0, 4:] == 7).all()
        assert torch.equal(v2.layers[0].k[0, :4], before[0][0])


def test_last_token_head_equals_full_logits_at_last_idx():
    """The paged prefill's logits at each row's last real token, through
    ``last_idx``, equal the ``[nb, S, V]`` logits then taken at ``last_idx``
    (exactly, on the CPU)."""
    _, teng = _engines()
    for weight_quant in ("none", "int8"):
        eng = _engines(weight_quant=weight_quant)[1] if weight_quant != "none" else teng
        B, S = 4, 24
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, 200, (B, S), generator=g)
        pos = torch.arange(S)[None].expand(B, S)
        valid = torch.arange(S)[None] < torch.tensor([5, 24, 1, 17])[:, None]
        last = torch.tensor([4, 23, 0, 16])
        full, _ = eng.model(tok, pos, valid)
        one, _ = eng.model(tok, pos, valid, last_idx=last)
        assert one.shape == (B, 1, full.shape[-1])
        assert torch.equal(one[:, 0], full[torch.arange(B), last])


# ---------------------------------------------------------------------------
# The paged scheduler against the port's engine and the reference's
# ---------------------------------------------------------------------------


def _serve(engine, prompts=PROMPTS, budgets=None, serving=PCFG, **kw):
    budgets = budgets or caps()
    settings = greedy(max(budgets))
    sched = tserving.ContinuousScheduler(engine, serving, settings=settings)
    reqs = [tserving.Request(prompt=p, settings=greedy(m), **kw)
            for p, m in zip(prompts, budgets)]
    return sched, reqs, sched.serve(reqs)


def _assert_equals_engine(engine, reqs, results, skip=()):
    for i, (req, res) in enumerate(zip(reqs, results)):
        if i in skip:
            continue
        assert res.ok, res.error
        ref = engine.generate([req.prompt], req.settings)
        n = len(res.tokens)
        assert n > 0
        np.testing.assert_array_equal(res.tokens, ref.tokens[0][:n], err_msg=f"request {i}")
        assert np.all(ref.tokens[0][n:] == engine.tokenizer.pad_id)
        assert res.text == ref.texts[0]


@pytest.fixture(scope="module")
def served():
    """The mixed prompts and the family through the reference's paged
    scheduler and the port's, each under its package's fresh registry."""
    jeng, teng = _engines()
    with use_registry() as treg:
        sched, reqs, got = _serve(teng)
        tacc = _accounting(sched.pool.paged, treg)
    with j_use_registry() as jreg:
        jsched = jserving.ContinuousScheduler(jeng, JServingConfig(**PAGED),
                                              settings=_jgreedy(max(caps())))
        jreqs = [jserving.Request(prompt=p, settings=_jgreedy(m))
                 for p, m in zip(PROMPTS, caps())]
        want = jsched.serve(jreqs)
        jacc = _accounting(jsched.pool.paged, jreg)
    return sched, reqs, got, tacc, jsched, want, jacc


def _jgreedy(m):
    from fairness_llm_tpu.config import ModelSettings as JSettings

    return JSettings(temperature=0.0, max_tokens=m)


def test_paged_server_matches_engine_greedy_mixed_lengths(served):
    sched, reqs, got, *_ = served
    _, teng = _engines()
    assert len(teng.tokenizer.encode(PROMPTS[OVER_BUDGET])) > sched.prompt_budget
    _assert_equals_engine(teng, reqs, got, skip=(OVER_BUDGET,))
    stats = sched.last_stats
    assert stats.admitted == stats.completed == len(PROMPTS)
    assert stats.decoded_tokens == sum(caps())
    assert sched.pool.occupancy == 0
    _paged_invariant(sched.pool.paged)


def test_paged_server_matches_the_reference_scheduler(served):
    """Every prompt, the over-budget one included, and the counters."""
    sched, _, got, _, jsched, want, _ = served
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {i}")
        assert (g.text, g.finish_reason, g.prompt_tokens) == \
            (w.text, w.finish_reason, w.prompt_tokens)
    keep = ("admitted", "completed", "prefill_batches", "prefill_tokens", "decode_steps",
            "decoded_tokens", "occupancy_sum")
    assert {k: sched.last_stats.as_dict()[k] for k in keep} == \
        {k: jsched.last_stats.as_dict()[k] for k in keep}
    assert sched.cache_len == jsched.cache_len
    assert sched.pool.paged.num_blocks == jsched.pool.paged.num_blocks


def test_block_accounting_matches_the_reference(served):
    *_, tacc, _, _, jacc = served
    assert tacc == jacc
    assert tacc["prefix_cache_hit_ratio"] > 0.5 and tacc["prefix_cache_cow_total"] >= 1


def test_scarce_arena_churn_and_eviction_match_the_reference():
    """The family through two slots and one slot's blocks plus two, so that
    admissions wait on blocks, freed blocks recycle and cached leaves are
    evicted: tokens equal the engine, accounting the reference's."""
    jeng, teng = _engines()
    bps = tserving.ContinuousScheduler(teng, PCFG, settings=greedy(8)).pool.paged.blocks_per_slot
    scarce = dict(PAGED, kv_blocks=bps + 2)
    prompts = FAMILY + MIXED_PROMPTS[:3] + FAMILY[:2]
    with use_registry() as treg:
        sched, reqs, got = _serve(teng, prompts, [8] * len(prompts),
                                  ServingConfig(**scarce))
        tacc = _accounting(sched.pool.paged, treg)
    _assert_equals_engine(teng, reqs, got)
    _paged_invariant(sched.pool.paged)
    with j_use_registry() as jreg:
        jsched = jserving.ContinuousScheduler(jeng, JServingConfig(**scarce),
                                              settings=_jgreedy(8))
        jsched.serve([jserving.Request(prompt=p, settings=_jgreedy(8)) for p in prompts])
        jacc = _accounting(jsched.pool.paged, jreg)
    assert tacc == jacc
    assert tacc["kv_blocks_evicted_total"] >= 1


def test_cow_at_divergence_never_mutates_the_source():
    """Two prompts diverging inside a block copy on write; serving the
    first again must give its tokens again (a copy written into the shared
    source would decode it through the second's prefix)."""
    _, teng = _engines()
    a, b = FAMILY[0], FAMILY[1]
    with use_registry() as reg:
        sched = tserving.ContinuousScheduler(teng, PCFG, settings=greedy(8))
        res = {}
        for key, p in (("a", a), ("b", b), ("a2", a), ("b2", b)):
            req = tserving.Request(prompt=p, settings=greedy(8))
            res[key] = sched.serve([req])[0]
            if key in ("a", "b"):
                _assert_equals_engine(teng, [req], [res[key]])
        assert reg.peek("prefix_cache_cow_total", component="paged_kv").value >= 1
    np.testing.assert_array_equal(res["a2"].tokens, res["a"].tokens)
    np.testing.assert_array_equal(res["b2"].tokens, res["b"].tokens)
    assert sched.pool.paged.hit_ratio > 0.5  # the repeats hit the cache


def test_twin_release_keeps_shared_blocks_readable():
    """The short twin finishes and releases while the long one still reads
    the shared prefix blocks; both equal the engine."""
    _, teng = _engines()
    sched, reqs, got = _serve(teng, FAMILY[:2], [2, 24])
    _assert_equals_engine(teng, reqs, got)


def test_paged_parity_independent_of_pool_composition():
    _, teng = _engines()
    target = FAMILY[2]
    _, _, alone = _serve(teng, [target], [12])
    crowd = MIXED_PROMPTS[:2] + [target] + FAMILY[:3]
    _, _, crowded = _serve(teng, crowd, [6, 6, 12, 10, 10, 10])
    np.testing.assert_array_equal(alone[0].tokens, crowded[2].tokens)


@pytest.mark.parametrize("mode", ["int8-weights", "int8-kv-cache"])
def test_quantized_configs_paged_equal_engine_and_reference(mode):
    kw = dict(weight_quant="int8") if mode == "int8-weights" else dict(kv_cache_quant=True)
    jeng, teng = _engines(**kw)
    prompts = FAMILY[:4] + MIXED_PROMPTS[:2]
    budgets = [8] * len(prompts)
    sched, reqs, got = _serve(teng, prompts, budgets)
    if mode == "int8-kv-cache":
        assert sched._arena.layers[0].k.dtype == torch.int8
        assert sched._arena.layers[0].k_scale.shape == sched._arena.key_valid.shape + (
            teng.config.num_kv_heads,)
    _assert_equals_engine(teng, reqs, got)
    jsched = jserving.ContinuousScheduler(jeng, JServingConfig(**PAGED), settings=_jgreedy(8))
    want = jsched.serve([jserving.Request(prompt=p, settings=_jgreedy(8)) for p in prompts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_paged_sampled_tokens_equal_the_non_paged_server():
    """t=0.7 with row seeds: the paged layout changes no sampled token."""
    from fairness_llm_tpu_torch.config import ModelSettings

    _, teng = _engines()
    s = ModelSettings(temperature=0.7, max_tokens=8)
    out = []
    for serving in (PCFG, dataclasses.replace(PCFG, paged_kv=False)):
        sched = tserving.ContinuousScheduler(teng, serving, settings=s)
        out.append(sched.serve([tserving.Request(prompt=p, settings=s, row_seed=i)
                                for i, p in enumerate(FAMILY[:4])]))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_failed_paged_decode_resets_the_arena_and_index(monkeypatch):
    """A decode chunk whose call raises (twice: the request is requeued once,
    then fails) leaves no cached prefix, no live slot and a zeroed arena
    behind, and the scheduler serves again afterwards."""
    _, teng = _engines()
    sched = tserving.ContinuousScheduler(teng, PCFG, settings=greedy(8))
    first = sched.serve([tserving.Request(prompt=FAMILY[0], settings=greedy(8))])[0]
    assert len(sched.pool.paged.index) > 0
    real = sched._step

    def boom(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(sched, "_step", boom)
    (failed,) = sched.serve([tserving.Request(prompt=FAMILY[1], settings=greedy(8))])
    assert failed.finish_reason == "failed" and "kernel fault" in failed.error
    assert sched.last_stats.requeued == 1
    assert sched.pool.occupancy == 0 and len(sched.pool.paged.index) == 0
    assert sched.pool.paged.free_blocks == sched.pool.paged.num_blocks
    assert not sched._arena.key_valid.any()
    monkeypatch.setattr(sched, "_step", real)
    again = sched.serve([tserving.Request(prompt=FAMILY[0], settings=greedy(8))])[0]
    np.testing.assert_array_equal(again.tokens, first.tokens)


def test_failed_paged_prefill_releases_its_group(monkeypatch):
    from fairness_llm_tpu_torch.serving import scheduler as sched_mod

    _, teng = _engines()

    def broken(model):
        def run(*a, **k):
            raise RuntimeError("prefill fault")
        return run

    monkeypatch.setattr(sched_mod, "build_paged_prefill", broken)
    sched = tserving.ContinuousScheduler(teng, PCFG, settings=greedy(8))
    (failed,) = sched.serve([tserving.Request(prompt=FAMILY[0], settings=greedy(8))])
    assert failed.finish_reason == "failed" and "prefill fault" in failed.error
    assert sched.pool.occupancy == 0 and len(sched.pool.paged.index) == 0
    _paged_invariant(sched.pool.paged)
    assert sched.pool.paged.free_blocks == sched.pool.paged.num_blocks


# ---------------------------------------------------------------------------
# Configuration, CLI and the study sweep
# ---------------------------------------------------------------------------


def test_paged_config_and_cli_checks_match_the_reference():
    from fairness_llm_tpu.cli import main as jcli
    from fairness_llm_tpu_torch.cli import main as tcli

    assert dataclasses.asdict(ServingConfig(**PAGED, kv_blocks=40)) == \
        dataclasses.asdict(JServingConfig(**PAGED, kv_blocks=40))
    for argv in (["--paged-kv"], ["--continuous", "--kv-block-size", "8"],
                 ["--continuous", "--kv-blocks", "8"],
                 ["--continuous", "--paged-kv", "--kv-block-size", "0"],
                 ["--continuous", "--paged-kv", "--kv-blocks", "0"]):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.config_from_args(cli.build_parser().parse_args(["--phase", "1"] + argv))
    args = ["--phase", "1", "--continuous", "--slots", "3", "--paged-kv", "--kv-block-size",
            "8", "--kv-blocks", "99"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(args)).serving
    want = jcli.config_from_args(jcli.build_parser().parse_args(args)).serving
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_paged_study_sweep_equals_the_engine_path(tmp_path):
    """The greedy --quick sweep on the study checkpoint through the paged
    server equals the port's engine path, with prefix reuse above 0.5."""
    from fairness_llm_tpu_torch import config as tconfig
    from fairness_llm_tpu_torch.pipeline import backends as tbackends
    from fairness_llm_tpu_torch.pipeline import phase1 as tphase1

    def cfg(serving, tag):
        settings = tuple((n, tconfig.ModelSettings(temperature=0.0, max_tokens=16)
                          if n == STUDY_MODEL else s)
                         for n, s in tconfig.Config().model_settings)
        return tconfig.Config(weights_dir=str(ROOT / "checkpoints"),
                              results_dir=str(tmp_path / tag), profiles_per_combo=1,
                              model_settings=settings, serving=serving)

    records = {}
    for tag, serving in (("paged", ServingConfig(enabled=True, paged_kv=True)),
                         ("engine", ServingConfig())):
        c = cfg(serving, tag)
        backend = tbackends.backend_for(STUDY_MODEL, c, device="cpu")
        with use_registry() as reg:
            records[tag] = tphase1.run_phase1(c, STUDY_MODEL, backend=backend, save=False)
        if tag == "paged":
            ratio = reg.peek("prefix_cache_hit_ratio", component="paged_kv").value
    got, want = records["paged"], records["engine"]
    assert {k: v["raw_response"] for k, v in got["recommendations"].items()} == \
        {k: v["raw_response"] for k, v in want["recommendations"].items()}
    assert got["metadata"]["serving"]["completed"] == 16
    assert ratio > 0.5, ratio
