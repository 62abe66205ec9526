"""The port's training (``train/step.py``, ``train/checkpoint.py``) against
the JAX package's ``make_train_step`` and its own single-process step.

One f32 step on the committed tiny-llama-study checkpoint: the loss, every
gradient and the updated parameters (AdamW) equal the reference's within
1e-5 relative (to each tensor's largest value). The dp and (dp=2, sp=2)
sequence-parallel steps run in four gloo processes spawned once for the
module (``torch_tp_worker.py``, mode ``train``) and equal the plain step,
with the reference's own tolerance for that comparison (plain SGD: loss
2e-5 relative, parameters 2e-5).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread a test process: the suite runs in several workers.
torch.set_num_threads(1)

import torch_tp_worker as W  # noqa: E402
from fairness_llm_tpu.models.configs import get_model_config as jget_config  # noqa: E402
from fairness_llm_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from fairness_llm_tpu.runtime import weights as jweights  # noqa: E402
from fairness_llm_tpu.train import make_train_step as jmake_train_step  # noqa: E402
from fairness_llm_tpu.train.step import cross_entropy_loss as jcross_entropy  # noqa: E402
from fairness_llm_tpu_torch.config import MeshConfig  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import init_params, params_from_jax  # noqa: E402
from fairness_llm_tpu_torch.train import make_train_step, train_loop  # noqa: E402
from fairness_llm_tpu_torch.train.checkpoint import (  # noqa: E402
    MAX_TO_KEEP,
    restore_train_state,
    save_train_state,
)
from fairness_llm_tpu_torch.train.step import (  # noqa: E402
    cross_entropy_loss,
    make_sequence_parallel_train_step,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
PLAIN_RTOL = PLAIN_ATOL = 2e-5  # tests/test_ring_training.py's


def _close(got, want, rtol=RTOL):
    """Within ``rtol`` of the tensor's largest magnitude, elementwise."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale)


def _study_batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(3, 512, (3, 33)).astype(np.int32)
    valid = np.ones((3, 33), bool)
    valid[1, :7] = False
    return tokens, valid


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def study():
    """The reference's one step on tiny-llama-study (loss, gradients,
    updated parameters) and the port's, from the same tensors."""
    name = "tiny-llama-study"
    jcfg, cfg = jget_config(name), get_model_config(name)
    tree = jweights.load_checkpoint(jcfg, str(ROOT / "checkpoints" / name))
    tokens, valid = _study_batch()

    def loss_fn(p):  # make_train_step's own loss_fn
        positions = jnp.maximum(jnp.cumsum(valid[:, :-1].astype(jnp.int32), axis=1) - 1, 0)
        logits, _ = JTransformer(jcfg).apply({"params": p}, tokens[:, :-1], positions,
                                             valid[:, :-1])
        return jcross_entropy(logits, tokens[:, 1:], valid[:, :-1] & valid[:, 1:])

    jloss, jgrads = jax.value_and_grad(loss_fn)(tree)
    # before the step, which donates its state
    params = params_from_jax(jax.device_get(tree), cfg)
    jinit, jstep = jmake_train_step(jcfg)
    jstate, jloss_step = jstep(jinit(jax.random.key(0), params=tree), tokens, valid)
    init, step = make_train_step(cfg, device="cpu")
    state, loss = step(init(params=params), tokens, valid)
    return {"jloss": float(jloss), "jloss_step": float(jloss_step), "jgrads": _flat(jgrads),
            "jparams": _flat(jstate.params), "loss": float(loss), "state": state,
            "params": params}


def test_study_step_loss_equals_the_reference(study):
    assert study["loss"] == pytest.approx(study["jloss_step"], rel=RTOL)
    assert study["loss"] == pytest.approx(study["jloss"], rel=RTOL)


def test_study_step_gradients_equal_the_reference(study):
    got = {k: v.grad.numpy() for k, v in study["state"].params.items()}
    assert sorted(got) == sorted(study["jgrads"])
    for k, want in study["jgrads"].items():
        _close(got[k], want)


def test_study_step_updated_params_equal_the_reference(study):
    """The updated parameters equal the reference's step's. Adam's first
    step moves a parameter by about lr * g / (|g| + 1e-8): where |g| is
    near that eps, f32 rounding of g (the gradients agree to 1e-5 of each
    tensor's scale) moves the update by up to lr, so those elements (|g|
    below 1e-5) are held by the next test, on the same gradients."""
    got = {k: v.detach().numpy() for k, v in study["state"].params.items()}
    for k, want in study["jparams"].items():
        sure = np.abs(study["jgrads"][k]) >= 1e-5
        _close(got[k][sure], want[sure])
        assert not np.array_equal(got[k], study["params"][k].numpy()) or \
            not study["jgrads"][k].any(), k
    assert study["state"].step == 1


def test_adamw_update_equals_optax_adamw(study):
    """``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)`` is
    ``optax.adamw(3e-4, weight_decay=0.01)``: given the port's gradients,
    optax's update of the starting parameters is the port's, every element
    within 1e-5 of the tensor's scale."""
    import optax

    start = {k: jnp.asarray(v.numpy()) for k, v in study["params"].items()}
    grads = {k: jnp.asarray(v.grad.numpy()) for k, v in study["state"].params.items()}
    opt = optax.adamw(3e-4, weight_decay=0.01)
    updates, _ = opt.update(grads, opt.init(start), start)
    want = optax.apply_updates(start, updates)
    for k, v in study["state"].params.items():
        _close(v.detach().numpy(), want[k])


def test_cross_entropy_loss_equals_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5))
    valid = rng.random((2, 5)) > 0.3
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid)))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                   torch.from_numpy(valid)))
    assert got == pytest.approx(want, rel=1e-6)


def test_remat_equals_no_remat():
    cfg = get_model_config("tiny-test")
    tokens, valid = W.train_batch(2, b=4, s=12)
    states = []
    for remat in (False, True):
        init, step = make_train_step(cfg, remat=remat, device="cpu")
        states.append(step(init(2), tokens, valid))
    (a, la), (b, lb) = states
    assert float(la) == float(lb)
    for k, v in a.params.items():
        np.testing.assert_array_equal(v.grad.numpy(), b.params[k].grad.numpy())
        np.testing.assert_array_equal(v.detach().numpy(), b.params[k].detach().numpy())


def test_train_loop_loss_decreases():
    tokens, valid = W.train_batch(0, b=8, s=16)
    state, losses = train_loop(get_model_config("tiny-test"), [(tokens, valid)] * 8, 8,
                               device="cpu", log_every=0)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state.step == 8


def test_training_refuses_int8_and_tp():
    cfg = get_model_config("tiny-test")
    with pytest.raises(ValueError, match="serving-only"):
        make_train_step(get_model_config("llama3-8b-int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(cfg, mesh=MeshConfig(tp=2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sequence_parallel_train_step(cfg, MeshConfig(dp=2, tp=2), device="cpu")


# ---------------------------------------------------------------------------
# The four ranks: dp and sp steps against the plain one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    torch.save(init_params(get_model_config(W.MODEL), 0, torch.device("cpu")), out / "params.pt")
    r = W.Ranks(out, W.spawn(out, 4, "train"), "train")
    yield r
    r.kill()


def _plain(out, opt_name):
    cfg = get_model_config(W.MODEL)
    params = torch.load(out / "params.pt")
    opt = None if opt_name == "adamw" else (
        lambda ps: torch.optim.SGD(list(ps), lr=W.TRAIN_LR))
    init, step = make_train_step(cfg, optimizer=opt, device="cpu")
    state, loss = step(init(params=params), *W.train_batch())
    return state, float(loss)


@pytest.mark.parametrize("name", ["sp", "dp"])
def test_parallel_step_equals_the_plain_step(ranks, name):
    """The (dp=2, sp=2) sequence-parallel step (ring attention, loss and
    gradients summed over dp and sp) and the dp=4 step, with plain SGD:
    every rank's loss, gradients and parameters equal one process's plain
    step (the reference's ring-training tolerance)."""
    state, loss = _plain(ranks.out, "sgd")
    for r in range(4):
        got = ranks[r][(name, "sgd")]
        assert got["loss"] == pytest.approx(loss, rel=PLAIN_RTOL)
        assert got["step"] == 1
        for k, v in state.params.items():
            np.testing.assert_allclose(got["params"][k], v.detach().numpy(), rtol=0,
                                       atol=PLAIN_ATOL)
            np.testing.assert_allclose(got["grads"][k], v.grad.numpy(), rtol=0,
                                       atol=PLAIN_ATOL)


@pytest.mark.parametrize("name", ["sp", "dp"])
def test_parallel_adamw_step_and_its_loss_curve(ranks, name):
    """With AdamW the loss equals the plain step's and falls over four
    steps on one batch; the ranks agree with each other exactly."""
    _, loss = _plain(ranks.out, "adamw")
    for r in range(4):
        assert ranks[r][(name, "adamw")]["loss"] == pytest.approx(loss, rel=PLAIN_RTOL)
        losses = ranks[r][(name, "losses")]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert losses == ranks[0][(name, "losses")]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state(seed=0, steps=1):
    cfg = get_model_config("tiny-test")
    init, step = make_train_step(cfg, device="cpu")
    state = init(seed)
    for _ in range(steps):
        state, _ = step(state, *W.train_batch(seed, b=2, s=9))
    return state, init


def _flip_byte(path: pathlib.Path) -> None:
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def test_checkpoint_round_trip(tmp_path):
    state, init = _state(steps=2)
    save_train_state(str(tmp_path), state)
    assert (tmp_path / "manifest_2.json").exists() and (tmp_path / "2").is_dir()
    got = restore_train_state(str(tmp_path), init(7))
    assert got is not None and got.step == 2
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(got.model.state_dict()[k].numpy(), v.numpy())
    want_opt, got_opt = state.optimizer.state_dict(), got.optimizer.state_dict()
    for i, s in want_opt["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(got_opt["state"][i][name].numpy(), s[name].numpy())


def test_checkpoint_falls_back_past_a_flipped_byte(tmp_path):
    """A step whose file no longer matches its manifest is skipped for the
    next older one; with every step corrupt, None."""
    old, init = _state(steps=1)
    save_train_state(str(tmp_path), old)
    new, _ = _state(steps=3)
    save_train_state(str(tmp_path), new)
    _flip_byte(tmp_path / "3" / "train_state.pt")
    got = restore_train_state(str(tmp_path), init(9))
    assert got is not None and got.step == 1
    for k, v in old.model.state_dict().items():
        np.testing.assert_array_equal(got.model.state_dict()[k].numpy(), v.numpy())
    _flip_byte(tmp_path / "1" / "train_state.pt")
    assert restore_train_state(str(tmp_path), init(9)) is None
    assert restore_train_state(str(tmp_path / "empty"), init(9)) is None


def test_checkpoint_falls_back_past_a_failed_load_and_keeps_three(tmp_path):
    """A step with no manifest whose file will not load is skipped too; the
    three newest steps are kept, with their manifests only."""
    state, init = _state(steps=1)
    for s in (1, 2, 3, 4):
        save_train_state(str(tmp_path), state, step=s)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "2", "3", "4", "manifest_2.json", "manifest_3.json", "manifest_4.json"]
    assert MAX_TO_KEEP == 3
    (tmp_path / "manifest_4.json").unlink()
    (tmp_path / "4" / "train_state.pt").write_bytes(b"not a checkpoint")
    got = restore_train_state(str(tmp_path), init(3))
    assert got is not None and got.step == 1  # step 3 holds the state saved at step 1
    assert restore_train_state(str(tmp_path), init(3), step=4) is None
