"""The port's ring attention (``parallel/ring.py``) and its sequence-parallel
scoring and engine against the JAX package's ``ring_attention_sharded``,
``full_attention_reference`` and single-process runs.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's sp ranks are four gloo processes on 127.0.0.1, spawned once for
the module (``torch_tp_worker.py``, mode ``ring``), over two meshes: sp=4
and dp=2 x sp=2. Attention agrees within 1e-5 in f32 (causal, full, GQA,
sliding window); scores within 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers.
torch.set_num_threads(1)

import torch_tp_worker as W  # noqa: E402
from fairness_llm_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as jget_config  # noqa: E402
from fairness_llm_tpu.parallel import ring as jring  # noqa: E402
from fairness_llm_tpu.parallel import sharding as jshd  # noqa: E402
from fairness_llm_tpu.runtime.engine import DecodeEngine as JEngine  # noqa: E402
from fairness_llm_tpu.runtime.scoring import score_texts as jscore_texts  # noqa: E402
from fairness_llm_tpu_torch.config import ModelSettings  # noqa: E402
from fairness_llm_tpu_torch.models import transformer as ttr  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.parallel import ring  # noqa: E402
from fairness_llm_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from fairness_llm_tpu_torch.runtime.scoring import score_texts  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import build_model, params_from_jax  # noqa: E402

ATOL = 1e-5
MESHES = {"sp4": dict(sp=4), "dp2sp2": dict(dp=2, sp=2)}
CASE_IDS = [c[0] for c in W.RING_CASES]


def _jmesh(axes):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jshd.make_mesh(JMeshConfig(**axes))


def _reference_ring(axes, case):
    """The reference's sharded ring over the same inputs; with a window,
    its ``ring_attention`` under the same ``shard_map`` specs."""
    from jax.sharding import PartitionSpec as P

    q, k, v, pos, valid = W.ring_inputs(case)
    mesh, causal, window = _jmesh(axes), case[6], case[7]
    if window is None:
        return np.asarray(jring.ring_attention_sharded(mesh, q, k, v, pos, valid,
                                                       causal=causal))
    qkv, seq = P("dp", "sp", "tp", None), P("dp", "sp")
    fn = jshd.compat_shard_map(
        functools.partial(jring.ring_attention, axis_name="sp", causal=causal, window=window),
        mesh, in_specs=(qkv, qkv, qkv, seq, seq, seq), out_specs=qkv)
    return np.asarray(fn(q, k, v, pos, pos, valid))


@pytest.fixture(scope="module")
def engines():
    cfg = get_model_config(W.MODEL)
    jeng = JEngine(jget_config(W.MODEL), seed=0)
    params = params_from_jax(jax.device_get(jeng.params), cfg)
    return jeng, DecodeEngine(cfg, params=params, device="cpu"), params


@pytest.fixture(scope="module")
def ranks(engines, tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    torch.save(engines[2], out / "params.pt")
    r = W.Ranks(out, W.spawn(out, 4, "ring"), "ring")
    yield r
    r.kill()


@pytest.mark.parametrize("case", W.RING_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_equals_the_references(ranks, mesh, case):
    """Every rank's assembled output equals the reference's sharded ring on
    the same mesh, and the dense oracle (the reference's where it applies:
    it has no window; the port's with the window), within 1e-5."""
    q, k, v, pos, valid = W.ring_inputs(case)
    want = _reference_ring(MESHES[mesh], case)
    name, causal, window = case[0], case[6], case[7]
    rep = q.shape[2] // k.shape[2]
    if window is None:
        dense = np.asarray(jring.full_attention_reference(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2), pos, valid,
            causal=causal))
    else:
        dense = ring.full_attention_reference(
            *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pos).long(),
            torch.from_numpy(valid), causal=causal, window=window).numpy()
    np.testing.assert_allclose(want, dense, rtol=0, atol=ATOL)
    for r in range(4):
        got = ranks[r][(mesh, name)]
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", W.RING_CASES, ids=CASE_IDS)
def test_one_rank_ring_is_dense_attention(case):
    """With no group the ring is one block: the dense oracle within 1e-5,
    in f32 and (the block's result cast back) in bf16."""
    q, k, v, pos, valid = (torch.from_numpy(a) for a in W.ring_inputs(case))
    pos = pos.long()
    want = ring.full_attention_reference(q, k, v, pos, valid, causal=case[6], window=case[7])
    got = ring.ring_attention(q, k, v, pos, pos, valid, causal=case[6], window=case[7])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    got16 = ring.ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos, pos, valid,
                                causal=case[6], window=case[7])
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want.numpy(), rtol=0, atol=5e-2)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_sp_scoring_equals_sp1_and_the_reference(ranks, engines, mesh, impl):
    """Scoring with the sequence split over sp (ring attention over the sp
    group), for the default attention and for ``attention_impl="ring"``:
    the single-process scores within 1e-5 and the reference's."""
    jeng, teng, _ = engines
    one, ref = score_texts(teng, W.SCORE_TEXTS), jscore_texts(jeng, W.SCORE_TEXTS)
    key = "scores" if impl == "xla" else "ring_scores"
    for r in range(4):
        got = ranks[r][(mesh, key)]
        np.testing.assert_allclose(got.log_likelihoods, one.log_likelihoods, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.token_counts, one.token_counts)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sp_engine_decodes_as_one_process(ranks, engines, mesh):
    """A decode step's sequence is one token: the sp ranks decode their dp
    block's rows alike, the single-process engine's greedy tokens."""
    want = engines[1].generate(W.PROMPTS, ModelSettings(temperature=0.0,
                                                        max_tokens=W.M)).tokens
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][(mesh, "generate")], want)


def test_ring_model_forward_equals_dense_and_refuses_a_cache(engines):
    """``attention_impl="ring"`` on one process: the no-cache forward's
    logits equal the dense model's within 1e-5; with a cache it raises, as
    the reference's does."""
    cfg = get_model_config(W.MODEL)
    params = engines[2]
    dense = build_model(cfg, params, torch.device("cpu"), torch.float32)
    rcfg = dataclasses.replace(cfg, attention_impl="ring")
    rmodel = build_model(rcfg, params, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(3, 512, (2, 24)))
    valid = torch.ones(2, 24, dtype=torch.bool)
    valid[1, :6] = False
    pos = (torch.cumsum(valid.long(), 1) - 1).clamp_min(0)
    want, _ = dense(tokens, pos, valid)
    got, _ = rmodel(tokens, pos, valid)
    m = valid[..., None]
    np.testing.assert_allclose((got * m).numpy(), (want * m).numpy(), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="no-cache"):
        rmodel(tokens, pos, valid, ttr.init_cache(rcfg, 2, 32))
