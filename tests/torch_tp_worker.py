"""One rank of the port's tensor-parallel, ring and training CPU tests
(``tests/test_torch_tp.py``, ``test_torch_ring.py``, ``test_torch_train.py``).

``spawn(out_dir, world, mode)`` starts ``world`` copies of this file with the
environment ``torchrun`` gives a rank (``MASTER_ADDR=127.0.0.1``, a free
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). Each rank joins a gloo group through
``parallel.multihost.initialize_distributed``, runs the ``mode``'s paths
and pickles what it got to ``<out_dir>/<mode>.rank<r>.pkl``:

- ``tp``: tiny-test over a tp mesh (world 2: the engine, the serving grid,
  int8 weights, scoring, the cost ledger's collectives, the CLI's ``--tp 2``
  and ``--mesh tp=2``; world 8: tp=8, where attention replicates, and
  dp=2 x tp=4, where kv heads replicate, with one training step there);
- ``ring``: ``ring_attention_sharded`` at sp=4 and at dp=2 x sp=2, scoring
  and the engine over the same meshes;
- ``train``: the (dp=2, sp=2) sequence-parallel step and the dp=4 step;
  the tp steps of ``TP_TRAIN``; checkpoints saved and restored at
  (dp=2, tp=2), the fallback past a flipped byte there, and the restore of
  a tp=1 checkpoint the test process saved (``ckpt_tp1``).

The inputs are made here from numpy seeds (the weights from the file the
test process saved), so the test process rebuilds the same ones for the
JAX package and the port's single-process runs. It imports torch and the
port, never JAX: the test process holds the reference side.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
from typing import List

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = "tiny-test"
STUDY = "tiny-llama-study"
# The reference's tests/test_stepbuilder.py prompts: a near-duplicate family
# and mixed lengths, enough that a 2-slot pool recycles every slot.
PROMPTS = [
    "recommend movies for a user who likes drama and history",
    "recommend movies for a user who likes drama and comedy",
    "recommend movies for a user who likes drama and action",
    "the quick brown fox",
    "one two three one two three one",
    "zz zz zz",
]
M = 8  # tokens a request
GRID = [(paged, fuse) for paged in (False, True) for fuse in (1, 4)]
SCORE_TEXTS = [f"The film number {i} is " + "good " * (i % 4) for i in range(7)]
# ring inputs: (name, batch, seq, q heads, kv heads, head dim, causal, window)
RING_CASES = [
    ("causal", 2, 32, 4, 4, 16, True, None),
    ("full", 2, 32, 4, 4, 16, False, None),
    ("gqa", 2, 32, 8, 2, 16, True, None),
    ("gqa_window", 2, 32, 8, 2, 16, True, 7),
]
TRAIN_LR = 0.1  # plain SGD, as the reference's ring-training test compares


def ring_inputs(case):
    """q, k, v [B, S, H(kv), D] float32, positions and validity (row 0
    left-padded by 5) from a seed."""
    name, B, S, H, Hkv, D, _, _ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0, :5] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return q, k, v, pos, valid


def train_batch(seed: int = 0, b: int = 4, s: int = 17):
    """The reference's ring-training batch: row 0 left-padded by 4."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 512, size=(b, s)).astype(np.int64)
    valid = np.ones((b, s), dtype=bool)
    valid[0, :4] = False
    return tokens, valid


def cli_args(results_dir: str, flags: List[str]) -> List[str]:
    """The tiny-llama-study sweep at t=0.7 through the CLI."""
    return ["--phase", "1", "--quick", "--model", STUDY, "--weights-dir",
            str(ROOT / "checkpoints"), "--data-dir", str(ROOT / "data" / "ml-1m"),
            "--device", "cpu", "--results-dir", results_dir] + flags


def serving_config(tp: int, paged: bool = False, fuse: int = 1):
    from fairness_llm_tpu_torch.config import ServingConfig

    return ServingConfig(enabled=True, num_slots=2, queue_capacity=64, max_prompt_len=192,
                         max_new_tokens=32, decode_chunk=2, fuse_steps=fuse, paged_kv=paged,
                         kv_block_size=16, tp=tp)


def serve(engine, tp: int, paged: bool = False, fuse: int = 1, prompts=PROMPTS):
    """The prompts served greedily: (tokens by request, the scheduler)."""
    from fairness_llm_tpu_torch.config import ModelSettings
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request

    greedy = ModelSettings(temperature=0.0, max_tokens=M)
    sched = ContinuousScheduler(engine, serving_config(tp, paged, fuse), settings=greedy)
    res = sched.serve([Request(id=f"g{i}", prompt=p, settings=greedy)
                       for i, p in enumerate(prompts)])
    assert all(r.ok for r in res), [(r.id, r.finish_reason, r.error) for r in res]
    return [np.asarray(r.tokens) for r in res], sched


def files_under(path: pathlib.Path) -> List[str]:
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(out_dir: pathlib.Path, world: int, mode: str) -> List[subprocess.Popen]:
    """Start the ranks; each writes its log to ``<out_dir>/<mode>.rank<r>.log``."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        log = open(out_dir / f"{mode}{world}.rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, __file__, str(out_dir), mode], env=env,
                                      stdout=log, stderr=subprocess.STDOUT, cwd=str(out_dir)))
        log.close()
    return procs


def _tp(out: pathlib.Path, rank: int, world: int) -> dict:
    import dataclasses

    import torch

    from fairness_llm_tpu_torch.cli import main as cli
    from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.scoring import score_texts
    from fairness_llm_tpu_torch.runtime.weights import quantize_params
    from fairness_llm_tpu_torch.telemetry import snapshot, use_registry
    from fairness_llm_tpu_torch.telemetry.costmodel import check_costmodel
    from fairness_llm_tpu_torch.telemetry.timeline import set_attribution, use_timeline
    from fairness_llm_tpu_torch.train.step import make_train_step

    cfg = get_model_config(MODEL)
    params = torch.load(out / "params.pt")
    greedy = ModelSettings(temperature=0.0, max_tokens=M)
    res: dict = {}
    if world == 8:
        for name, axes in (("tp8", dict(tp=8)), ("dp2tp4", dict(dp=2, tp=4))):
            eng = DecodeEngine(cfg, params=params, device="cpu", mesh=make_mesh(MeshConfig(**axes)))
            res[name] = {"batch": eng.generate(PROMPTS, greedy).tokens,
                         "local": (eng.model.config.num_heads, eng.model.config.num_kv_heads,
                                   eng.model.config.d_ff, eng.model.config.vocab_size)}
            if name == "tp8":
                res[name]["served"] = serve(eng, 8, prompts=PROMPTS[:3])[0]
        # one plain-SGD training step on the reference's own test mesh
        init, step = make_train_step(
            cfg, optimizer=lambda ps: torch.optim.SGD(list(ps), lr=TRAIN_LR),
            mesh=make_mesh(MeshConfig(dp=2, tp=4)), device="cpu")
        state, loss = step(init(params=params), *train_batch())
        res["train_dp2tp4"] = {
            "loss": float(loss), "tp_rank": (state.layout.tp, state.layout.rank),
            "params": {k: v.detach().numpy().copy() for k, v in state.params.items()},
            "grads": {k: v.grad.numpy().copy() for k, v in state.params.items()}}
        return res
    mesh = make_mesh(MeshConfig(tp=2))
    eng = DecodeEngine(cfg, params=params, device="cpu", mesh=mesh)
    res["local"] = (eng.model.config.num_heads, eng.model.config.num_kv_heads,
                    eng.model.config.d_ff, eng.model.config.vocab_size)
    res["batch"] = eng.generate(PROMPTS, greedy).tokens
    res["single"] = {p: eng.generate([p], greedy).tokens[0] for p in PROMPTS}
    res["sampled"] = eng.generate(PROMPTS, ModelSettings(temperature=0.7, max_tokens=M),
                                  seed=3).tokens
    res["grid"] = {}
    for paged, fuse in GRID:
        toks, sched = serve(eng, 2, paged, fuse)
        res["grid"][(paged, fuse)] = {"tokens": toks, "label": sched._program,
                                      "keys": sorted(map(repr, sched._programs))}
    res["scores"] = score_texts(eng, SCORE_TEXTS)
    qcfg = dataclasses.replace(cfg, weight_quant="int8")
    qeng = DecodeEngine(qcfg, params=quantize_params(params), device="cpu", mesh=mesh)
    res["int8"] = qeng.generate(PROMPTS, greedy).tokens
    prev = set_attribution(True)
    try:
        with use_registry() as reg, use_timeline():
            toks, _ = serve(eng, 2, fuse=2, prompts=PROMPTS[:4])
            snap = snapshot(reg)
    finally:
        set_attribution(prev)
    res["telemetry"] = {"tokens": toks, "snapshot": snap, "problems": check_costmodel(snap)}
    for name, flags in (("cli_tp", ["--continuous", "--tp", "2"]),
                        ("cli_mesh", ["--mesh", "tp=2"])):
        d = out / f"{name}{rank}"
        res[name] = {"rc": cli.main(cli_args(str(d), flags)), "files": files_under(d)}
    return res


def _ring(out: pathlib.Path, rank: int, world: int) -> dict:
    import dataclasses

    import torch

    from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.ring import ring_attention_sharded
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.scoring import score_texts

    cfg = get_model_config(MODEL)
    params = torch.load(out / "params.pt")
    res: dict = {}
    for mesh_name, axes in (("sp4", dict(sp=4)), ("dp2sp2", dict(dp=2, sp=2))):
        mesh = make_mesh(MeshConfig(**axes))
        for case in RING_CASES:
            q, k, v, pos, valid = (torch.from_numpy(a) for a in ring_inputs(case))
            res[(mesh_name, case[0])] = ring_attention_sharded(
                mesh, q, k, v, pos.long(), valid, causal=case[6], window=case[7]).numpy()
        eng = DecodeEngine(cfg, params=params, device="cpu", mesh=mesh)
        res[(mesh_name, "scores")] = score_texts(eng, SCORE_TEXTS)
        res[(mesh_name, "generate")] = eng.generate(
            PROMPTS, ModelSettings(temperature=0.0, max_tokens=M)).tokens
        ring_eng = DecodeEngine(dataclasses.replace(cfg, attention_impl="ring"), params=params,
                                device="cpu", mesh=mesh)
        res[(mesh_name, "ring_scores")] = score_texts(ring_eng, SCORE_TEXTS)
    return res


# The tp training meshes of the four-rank world: (name, step kind, axes).
# make_train_step at tp=4 (q heads shard, kv heads replicate: each kv head's
# gradient is summed over the ranks that hold it), dp=2 x tp=2 and tp=2 x
# sp=2 (the ring over each rank's local heads); the sequence-parallel step
# at tp=2 x sp=2 (parameters whole, the tp ranks computing the same step).
# ``twice`` is tiny-test with 6 q heads over 3 kv heads at dp=2 x tp=2: kv
# heads replicate and rank 0's q heads 0-2 read kv heads (0, 0, 1), so it
# holds kv head 0 twice.
TP_TRAIN = [("tp4", "step", dict(tp=4)), ("dp2tp2", "step", dict(dp=2, tp=2)),
            ("tp2sp2", "step", dict(tp=2, sp=2)), ("sp_tp2sp2", "sp", dict(tp=2, sp=2)),
            ("twice", "step", dict(dp=2, tp=2))]


def train_config(name: str):
    """The model of a ``TP_TRAIN`` entry."""
    import dataclasses

    from fairness_llm_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL)
    if name == "twice":
        cfg = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3)
    return cfg


def _arrays(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _train(out: pathlib.Path, rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist

    from fairness_llm_tpu_torch.config import MeshConfig
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh
    from fairness_llm_tpu_torch.runtime.weights import init_params
    from fairness_llm_tpu_torch.train.checkpoint import (
        global_state,
        restore_train_state,
        save_train_state,
    )
    from fairness_llm_tpu_torch.train.step import (
        make_sequence_parallel_train_step,
        make_train_step,
    )

    cfg = get_model_config(MODEL)
    params = torch.load(out / "params.pt")
    tokens, valid = train_batch()

    def sgd(ps):
        return torch.optim.SGD(list(ps), lr=TRAIN_LR)

    def build(kind, mesh, opt=None, model=cfg):
        if kind == "step":
            return make_train_step(model, optimizer=opt, mesh=mesh, device="cpu")
        return make_sequence_parallel_train_step(model, mesh, optimizer=opt, device="cpu")

    def four_steps(init, step, start=params):
        state, losses = init(params=start), []
        for _ in range(4):
            state, loss = step(state, tokens, valid)
            losses.append(float(loss))
        return state, losses

    res: dict = {}
    for name, kind, axes in (("sp", "sp", dict(dp=2, sp=2)), ("dp", "step", dict(dp=4))):
        mesh = make_mesh(MeshConfig(**axes))
        for opt_name, opt in (("sgd", sgd), ("adamw", None)):
            init, step = build(kind, mesh, opt)
            state = init(params=params)
            state, loss = step(state, tokens, valid)
            res[(name, opt_name)] = {
                "loss": float(loss), "step": state.step,
                "params": {k: v.detach().numpy().copy() for k, v in state.params.items()},
                "grads": {k: v.grad.numpy().copy() for k, v in state.params.items()}}
        res[(name, "losses")] = four_steps(*build(kind, mesh))[1]
    for name, kind, axes in TP_TRAIN:
        mesh = make_mesh(MeshConfig(**axes))
        model = train_config(name)
        start = params if model == cfg else init_params(model, 0, torch.device("cpu"))
        init, step = build(kind, mesh, sgd, model)
        state, loss = step(init(params=start), tokens, valid)
        lay = state.layout
        res[(name, "sgd")] = {
            "loss": float(loss), "step": state.step,
            "tp_rank": None if lay is None else (lay.tp, lay.rank),
            "params": {k: v.detach().numpy().copy() for k, v in state.params.items()},
            "grads": {k: v.grad.numpy().copy() for k, v in state.params.items()},
            "global": _arrays(state.global_params())}
        init, step = build(kind, mesh, model=model)
        state, losses = four_steps(init, step, start)
        res[(name, "losses")] = losses
        if name != "dp2tp2":
            continue
        # checkpoints at tp=2: the AdamW state after four steps
        save_train_state(str(out / "ckpt_tp2"), state)
        res["ckpt_saved"] = _arrays(global_state(state))
        back = restore_train_state(str(out / "ckpt_tp2"), init(seed=9))
        res["ckpt_tp2_at_tp2"] = None if back is None else _arrays(global_state(back))
        save_train_state(str(out / "ckpt_flip"), state)
        state, _ = step(state, tokens, valid)
        save_train_state(str(out / "ckpt_flip"), state)
        if rank == 0:
            flip_byte(out / "ckpt_flip" / "5" / "train_state.pt")
        dist.barrier()
        back = restore_train_state(str(out / "ckpt_flip"), init(seed=9))
        res["ckpt_flip_at_tp2"] = None if back is None else _arrays(global_state(back))
        back = restore_train_state(str(out / "ckpt_tp1"), init(seed=9))
        res["ckpt_tp1_at_tp2"] = None if back is None else _arrays(global_state(back))
    return res


def flip_byte(path: pathlib.Path) -> None:
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def run_rank(out: pathlib.Path, mode: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from fairness_llm_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"tp": _tp, "ring": _ring, "train": _train}[mode](out, rank, world)
    with open(out / f"{mode}{world}.rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


class Ranks:
    """The spawned ranks of one world; the first read waits for them."""

    def __init__(self, out: pathlib.Path, procs, mode: str):
        self.out, self.procs, self.mode, self._res = out, procs, mode, None

    def __getitem__(self, rank: int) -> dict:
        if self._res is None:
            codes = [p.wait(timeout=900) for p in self.procs]
            world = len(self.procs)
            logs = "\n".join((self.out / f"{self.mode}{world}.rank{r}.log").read_text()[-3000:]
                             for r in range(world))
            assert codes == [0] * world, logs
            self._res = [pickle.loads((self.out / f"{self.mode}{world}.rank{r}.pkl").read_bytes())
                         for r in range(world)]
        return self._res[rank]

    def __len__(self) -> int:
        return len(self.procs)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    run_rank(pathlib.Path(sys.argv[1]), sys.argv[2])
