"""The port's training (``train/step.py``, ``train/checkpoint.py``) against
the JAX package's ``make_train_step`` and its own single-process step.

One f32 step on the committed tiny-llama-study checkpoint: the loss, every
gradient and the updated parameters (AdamW) equal the reference's within
1e-5 relative (to each tensor's largest value). The dp, (dp=2, sp=2)
sequence-parallel and tensor-parallel steps run in four gloo processes
spawned once for the module (``torch_tp_worker.py``, mode ``train``) and
equal the plain step, with the reference's own tolerance for that
comparison (plain SGD: loss 2e-5 relative, parameters 2e-5); the tp steps
also equal a live reference step on a JAX mesh of the same shape. Train
checkpoints saved at tp=2 restore at tp=1 and tp=2, and one saved at tp=1
at tp=2.
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
from fairness_llm_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from fairness_llm_tpu.parallel import sharding as jshd  # noqa: E402
from fairness_llm_tpu.train import make_train_step as jmake_train_step  # noqa: E402
from fairness_llm_tpu.train.step import (  # noqa: E402
    make_sequence_parallel_train_step as jmake_sp_train_step,
)
from fairness_llm_tpu.train.step import cross_entropy_loss as jcross_entropy  # noqa: E402
from fairness_llm_tpu_torch.config import MeshConfig  # noqa: E402
from fairness_llm_tpu_torch.models.configs import get_model_config  # noqa: E402
from fairness_llm_tpu_torch.parallel import sharding as shd  # noqa: E402
from fairness_llm_tpu_torch.runtime.weights import init_params, params_from_jax  # noqa: E402
from fairness_llm_tpu_torch.train import make_train_step, train_loop  # noqa: E402
from fairness_llm_tpu_torch.train.checkpoint import (  # noqa: E402
    MAX_TO_KEEP,
    global_state,
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


def test_training_refuses_int8():
    with pytest.raises(ValueError, match="serving-only"):
        make_train_step(get_model_config("llama3-8b-int8"), device="cpu")


# ---------------------------------------------------------------------------
# The four ranks: dp and sp steps against the plain one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, spawned after a tp=1 checkpoint (two AdamW steps)
    is saved for them to restore at tp=2; ``tp1`` is its global state."""
    out = tmp_path_factory.mktemp("train")
    cfg = get_model_config(W.MODEL)
    params = init_params(cfg, 0, torch.device("cpu"))
    torch.save(params, out / "params.pt")
    init, step = make_train_step(cfg, device="cpu")
    state = init(params=params)
    for _ in range(2):
        state, _ = step(state, *W.train_batch())
    save_train_state(str(out / "ckpt_tp1"), state)
    r = W.Ranks(out, W.spawn(out, 4, "train"), "train")
    r.tp1 = W._arrays(global_state(state))
    yield r
    r.kill()


def _start(out, name: str = W.MODEL):
    cfg = W.train_config(name)
    if name == "twice":
        return cfg, init_params(cfg, 0, torch.device("cpu"))
    return cfg, torch.load(out / "params.pt")


def _plain(out, opt_name, name: str = W.MODEL):
    cfg, params = _start(out, name)
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
# The four ranks: the tp steps against the plain one and the reference's
# ---------------------------------------------------------------------------

TP_NAMES = [name for name, _, _ in W.TP_TRAIN]


def _rank_part(cfg, tensors, tp_rank):
    """A tp rank's part of full tensors (all of them without tp)."""
    if tp_rank is None:
        return tensors
    tp, rank = tp_rank
    return shd.rank_params(cfg, tensors, shd.tp_layout(cfg, MeshConfig(tp=tp), rank), "cpu")


@pytest.mark.parametrize("name", TP_NAMES)
def test_tp_step_equals_the_plain_step(ranks, name):
    """One plain-SGD step at tp=4 (kv heads held by two ranks each), dp=2 x
    tp=2, tp=2 x sp=2 (the ring over local heads), the sequence-parallel
    step at tp=2 x sp=2 (parameters whole) and dp=2 x tp=2 with a kv head
    held twice by one rank: every rank's loss equals the plain step's, and
    its gradients and updated parameters equal its part of the plain
    step's (``rank_params``)."""
    cfg, _ = _start(ranks.out, name)
    state, loss = _plain(ranks.out, "sgd", name)
    want_p = {k: v.detach() for k, v in state.params.items()}
    want_g = {k: v.grad for k, v in state.params.items()}
    for r in range(4):
        got = ranks[r][(name, "sgd")]
        assert got["loss"] == pytest.approx(loss, rel=PLAIN_RTOL)
        assert got["step"] == 1
        if name != "sp_tp2sp2":
            axes = W.TP_TRAIN[TP_NAMES.index(name)][2]
            grid = np.arange(4).reshape([axes.get(a, 1) for a in ("dp", "tp", "sp")])
            assert got["tp_rank"] == (axes["tp"], int(np.argwhere(grid == r)[0][1]))
        part_p, part_g = (_rank_part(cfg, t, got["tp_rank"]) for t in (want_p, want_g))
        assert sorted(got["params"]) == sorted(part_p)
        for k in part_p:
            assert got["params"][k].shape == tuple(part_p[k].shape), k
            np.testing.assert_allclose(got["grads"][k], part_g[k].numpy(), rtol=0,
                                       atol=PLAIN_ATOL, err_msg=k)
            np.testing.assert_allclose(got["params"][k], part_p[k].numpy(), rtol=0,
                                       atol=PLAIN_ATOL, err_msg=k)


@pytest.mark.parametrize("name", TP_NAMES)
def test_tp_adamw_losses_fall_and_ranks_agree(ranks, name):
    """Under AdamW the first loss is the plain step's, the loss falls over
    four steps, and every rank's losses equal rank 0's exactly."""
    _, loss = _plain(ranks.out, "adamw", name)
    for r in range(4):
        losses = ranks[r][(name, "losses")]
        assert losses[0] == pytest.approx(loss, rel=PLAIN_RTOL)
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert losses == ranks[0][(name, "losses")]


def _jax_tree(params):
    """The flax tree of a port state dict (the names are its paths)."""
    tree = {}
    for name, t in params.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(t.numpy())
    return tree


@pytest.mark.parametrize("name", [n for n in TP_NAMES if n != "twice"])
def test_tp_step_equals_the_reference_step(ranks, name):
    """The reference's step (``make_train_step``, or for the sequence-
    parallel entry ``make_sequence_parallel_train_step``, with
    ``optax.sgd``) on a JAX mesh of the same shape over 4 of the 8 virtual
    devices, from the same parameters: its loss equals every rank's, and
    its updated parameters the tp ranks' gathered ones."""
    import optax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg, params = _start(ranks.out, name)
    tree = _jax_tree(params)
    for k, v in params_from_jax(jax.device_get(tree), cfg).items():
        np.testing.assert_array_equal(v.numpy(), params[k].numpy())
    _, kind, axes = W.TP_TRAIN[TP_NAMES.index(name)]
    jmesh = jshd.make_mesh(JMeshConfig(**axes), devices=jax.devices()[:4])
    jcfg = jget_config(W.MODEL)
    if kind == "step":
        jinit, jstep = jmake_train_step(jcfg, optimizer=optax.sgd(W.TRAIN_LR), mesh=jmesh)
    else:
        jinit, jstep = jmake_sp_train_step(jcfg, jmesh, optimizer=optax.sgd(W.TRAIN_LR))
    tokens, valid = W.train_batch()
    jstate, jloss = jstep(jinit(jax.random.key(0), params=tree), tokens.astype(np.int32),
                          valid)
    want = _flat(jax.device_get(jstate.params))
    for r in range(4):
        got = ranks[r][(name, "sgd")]
        assert got["loss"] == pytest.approx(float(jloss), rel=PLAIN_RTOL)
        assert sorted(got["global"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["global"][k], v, rtol=0, atol=PLAIN_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _same_state(got, want):
    """Two ``global_state``s (as arrays) hold the same step, tensors and
    optimizer entries, exactly."""
    assert got is not None and got["step"] == want["step"]
    assert sorted(got["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    assert sorted(got["opt_state"]["state"]) == sorted(want["opt_state"]["state"])
    for n, st in want["opt_state"]["state"].items():
        assert sorted(got["opt_state"]["state"][n]) == sorted(st)
        for key, v in st.items():
            np.testing.assert_array_equal(got["opt_state"]["state"][n][key], v,
                                          err_msg=f"{n} {key}")
    assert got["opt_state"]["param_groups"] == want["opt_state"]["param_groups"]


def test_tp2_checkpoint_restores_at_tp1(ranks):
    """Saved at dp=2 x tp=2 (full tensors gathered over tp, rank 0 writing),
    the state restores in one process with the same full tensors and AdamW
    moments."""
    saved = ranks[0]["ckpt_saved"]
    assert saved["step"] == 4 and "exp_avg" in saved["opt_state"]["state"]["embedding"]
    for r in range(1, 4):
        _same_state(ranks[r]["ckpt_saved"], saved)
    init, _ = make_train_step(get_model_config(W.MODEL), device="cpu")
    back = restore_train_state(str(ranks.out / "ckpt_tp2"), init(9))
    _same_state(W._arrays(global_state(back)), saved)


def test_tp2_checkpoint_restores_at_tp2(ranks):
    for r in range(4):
        _same_state(ranks[r]["ckpt_tp2_at_tp2"], ranks[0]["ckpt_saved"])


def test_tp2_checkpoint_falls_back_past_a_flipped_byte(ranks):
    """At tp=2 a step-5 file with a flipped byte is skipped on every rank
    for step 4, the state saved there."""
    for r in range(4):
        _same_state(ranks[r]["ckpt_flip_at_tp2"], ranks[0]["ckpt_saved"])


def test_tp1_checkpoint_restores_at_tp2(ranks):
    """A state saved in one process restores at dp=2 x tp=2: every rank's
    gathered state is the saved one."""
    for r in range(4):
        _same_state(ranks[r]["ckpt_tp1_at_tp2"], ranks.tp1)


def test_replica_group_is_built_once_a_mesh(monkeypatch):
    """The dp x sp plane's groups are made on a mesh's first call, one for
    every tp coordinate in order, and every later step built on that mesh
    reuses the rank's group."""
    import torch.distributed as dist

    made = []

    def new_group(ranks):
        made.append(ranks)
        return object()

    monkeypatch.setattr(dist, "new_group", new_group)

    class Mesh:  # dp=2, tp=2, sp=2; this rank's tp coordinate is 1
        mesh = torch.arange(8).reshape(2, 2, 2)
        mesh_dim_names = ("dp", "tp", "sp")
        shape = (2, 2, 2)

        def get_local_rank(self, axis):
            return 1

    mesh = Mesh()
    group = shd.replica_group(mesh)
    assert made == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert shd.replica_group(mesh) is group and len(made) == 2
    assert shd.replica_group(Mesh()) is not group and len(made) == 4


@pytest.mark.parametrize("name,tp", [("tiny-test", 2), ("tiny-test", 4), ("tiny-test", 8),
                                     ("tiny-gpt2", 2), ("tiny-gpt2", 4),
                                     ("tiny-llama-study", 2), ("twice", 2)])
def test_gather_params_inverts_rank_params(monkeypatch, name, tp):
    """Every tp rank's ``rank_params`` of the full tensors, each placed by
    ``gather_params`` (its all-reduce left out), sum to the full tensors:
    each element is written by exactly one rank, a kv head that several
    ranks hold (tp=4) or one rank holds twice (``twice``) once."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    cfg = W.train_config(name) if name == "twice" else get_model_config(name)
    full = init_params(cfg, 3, torch.device("cpu"))
    total = {k: torch.zeros_like(v) for k, v in full.items()}
    cut = set()
    for r in range(tp):
        layout = shd.tp_layout(cfg, MeshConfig(tp=tp), r)
        part = shd.rank_params(cfg, full, layout, "cpu")
        for k, v in shd.gather_params(cfg, part, layout).items():
            if v.data_ptr() == part[k].data_ptr():  # held whole: returned as it is
                np.testing.assert_array_equal(v.numpy(), full[k].numpy(), err_msg=k)
            else:
                cut.add(k)
                total[k] += v
    assert cut, "nothing was cut"
    for k in cut:
        np.testing.assert_array_equal(total[k].numpy(), full[k].numpy(), err_msg=k)


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


@pytest.mark.parametrize("keys", ["index", "partial"])
def test_checkpoint_refuses_optimizer_state_not_keyed_by_name(tmp_path, keys):
    """A step whose optimizer state is keyed by index (the optimizer's own
    ``state_dict``) or holds entries for only some parameters passes its
    manifest but is not half restored: the restore falls back to the older
    step, and with no older step gives None."""
    from fairness_llm_tpu_torch.integrity.manifest import write_manifest

    old, init = _state(steps=1)
    save_train_state(str(tmp_path), old)
    new, _ = _state(steps=3)
    save_train_state(str(tmp_path), new)
    path = tmp_path / "3" / "train_state.pt"
    blob = torch.load(path, weights_only=True)
    if keys == "index":
        blob["opt_state"] = new.optimizer.state_dict()
    else:
        dropped = sorted(blob["opt_state"]["state"])[0]
        del blob["opt_state"]["state"][dropped]
    torch.save(blob, path)
    write_manifest(str(tmp_path / "3"), path=str(tmp_path / "manifest_3.json"))
    got = restore_train_state(str(tmp_path), init(9))
    assert got is not None and got.step == 1
    for k, v in old.model.state_dict().items():
        np.testing.assert_array_equal(got.model.state_dict()[k].numpy(), v.numpy())
    assert restore_train_state(str(tmp_path), init(9), step=3) is None


def _counting_all_reduce(monkeypatch, scale=1.0):
    """``dist.all_reduce`` in this one process: multiplies in place by
    ``scale`` (a sum over ``scale`` equal ranks) and counts its calls."""
    import torch.distributed as dist

    calls = []

    def fake(t, group=None):
        calls.append(tuple(t.shape))
        t.mul_(scale)

    monkeypatch.setattr(dist, "all_reduce", fake)
    return calls


def test_tp_collectives_keep_serving_and_give_megatron_gradients(monkeypatch):
    """Without autograd ``reduce`` is the in-place all-reduce it was (the
    same tensor back, one call) and ``copy`` is nothing; under autograd
    ``reduce`` sums into a fresh tensor whose gradient passes through, and
    ``copy``'s gradient is summed over the group (here two equal ranks)."""
    calls = _counting_all_reduce(monkeypatch, scale=2.0)
    layout = shd.tp_layout(get_model_config("tiny-test"), MeshConfig(tp=2), 0)
    par = shd.ModelParallel(tp_group=None, layout=layout)
    t = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        u = torch.ones(3)
        assert par.reduce(u) is u and u.tolist() == [2.0] * 3
        assert par.copy(t) is t
    assert len(calls) == 1
    y = par.reduce(t * 1.0)
    assert y.tolist() == [2.0] * 3 and len(calls) == 2
    y.sum().backward()
    assert t.grad.tolist() == [1.0] * 3 and len(calls) == 2
    t.grad = None
    z = par.copy(t)
    assert len(calls) == 2
    z.sum().backward()
    assert t.grad.tolist() == [2.0] * 3 and len(calls) == 3


@pytest.mark.parametrize("tp,forward,backward", [
    (2, 6, 5),  # o and down a layer, embedding, logits; f at q/k/v, gate/up, head
    (4, 6, 5),  # q heads shard, kv heads replicate: the same collectives
    (8, 4, 3),  # attention whole: no sum after o, no f at q/k/v
])
def test_tp_forward_collectives_by_layout(monkeypatch, tp, forward, backward):
    """The tp forward of tiny-test (2 layers) at a rank's widths makes the
    same all-reduces with and without autograd, and its backward one more
    a projection input whose output the layout shards (f): a replicated
    branch gets none."""
    from fairness_llm_tpu_torch.runtime.weights import build_model

    calls = _counting_all_reduce(monkeypatch)
    cfg = get_model_config("tiny-test")
    layout = shd.tp_layout(cfg, MeshConfig(tp=tp), 1)
    par = shd.ModelParallel(tp_group=None, layout=layout)
    local = shd.rank_params(cfg, init_params(cfg, 0, torch.device("cpu")), layout, "cpu")
    model = build_model(cfg, local, torch.device("cpu"), torch.float32, par=par)
    tokens, valid = W.train_batch(b=2, s=9)
    tokens, valid = torch.from_numpy(tokens), torch.from_numpy(valid)
    pos = (torch.cumsum(valid.long(), 1) - 1).clamp_min(0)
    with torch.no_grad():
        model(tokens, pos, valid)
    assert len(calls) == forward
    model.requires_grad_(True)
    logits, _ = model(tokens, pos, valid)
    assert len(calls) == 2 * forward
    logits.sum().backward()
    assert len(calls) == 2 * forward + backward
