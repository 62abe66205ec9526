"""One rank of the port's data-parallel CPU tests (``tests/test_torch_parallel.py``).

``spawn(out_dir, world)`` starts ``world`` copies of this file with the
environment ``torchrun`` gives a rank (``MASTER_ADDR=127.0.0.1``, a free
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). Each rank joins a gloo group through
``parallel.multihost.initialize_distributed``, runs the port's dp=2 paths
on the CPU (the mesh, the sharded metric counts, the engine, scoring, a
phase-1 study through ``run_phase1`` and one through the CLI) and pickles
what it got to ``<out_dir>/rank<r>.pkl``. The inputs are made here from
numpy seeds, so the test process rebuilds the same ones for the JAX
package and the port's single-process run.

It imports torch and the port, never JAX: the test process holds the
reference side.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
from typing import Dict, List

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = "tiny-test"
STUDY = "tiny-llama-study"
NUM_COUNT_CASES = 20
GEN_TOKENS = 12
# Generate calls: (name, prompts, temperature, generate kwargs).
PREFIX = "You are a movie recommender. The user has watched: " + ", ".join(
    f"Title {i}" for i in range(12)) + ". "


def gen_cases() -> List[tuple]:
    five = [f"prompt {i}: " + "abc" * (i + 1) for i in range(5)]
    return [
        ("greedy5", five, 0.0, {}),
        ("greedy3", five[:3], 0.0, {}),
        ("prefix", [PREFIX + f"Recommend {k} films." for k in range(5)], 0.0,
         {"share_prefix": True}),
        ("sampled", five + ["one more"], 0.7, {"seed": 3}),
        ("sampled_rows", five[:3], 0.7, {"row_seeds": [11, 22, 33]}),
    ]


SCORE_TEXTS = [f"The film number {i} is " + "good " * (i % 4) for i in range(7)]
SCORE_PROMPTS = ["Rate it: "] * 3 + ["Another prompt, longer: "] * 2
SCORE_CONTS = ["yes", "no", "maybe so", "the best film", "fine"]


def count_case(i: int):
    """[N, V] per-list counts, owners and the group count of case ``i``;
    N is even for even ``i`` and odd for odd ``i``."""
    rng = np.random.default_rng(1000 + i)
    n = 2 * int(rng.integers(1, 20)) + (i % 2)
    v = int(rng.integers(1, 30))
    g = int(rng.integers(1, 6))
    counts = rng.integers(0, 4, (n, v)).astype(np.float32)
    owners = rng.integers(0, g, n).astype(np.int32)
    return counts, owners, g


def rec_groups():
    """Seeded group -> recommendation lists, and the relevant titles."""
    rng = np.random.default_rng(7)
    titles = [f"Movie {i} (19{50 + i})" for i in range(25)]
    groups: Dict[str, List[List[str]]] = {}
    for g in ("male", "female", "non-binary"):
        groups[g] = [list(rng.choice(titles, size=int(rng.integers(0, 8)), replace=True))
                     for _ in range(int(rng.integers(2, 7)))]
    return groups, set(titles[:6])


def study_config(results_dir: str, config_cls, settings_cls):
    """``tests/test_pipeline_sharded.py``'s study settings, decoding
    greedily (the two frameworks cannot share a sampling stream)."""
    return config_cls(results_dir=results_dir, data_dir="/nonexistent", profiles_per_combo=1,
                      max_new_tokens=24,
                      model_settings=((MODEL, settings_cls(temperature=0.0, max_tokens=128)),))


def cli_args(results_dir: str, mesh: bool) -> List[str]:
    """The tiny-llama-study sweep at t=0.7 through the CLI."""
    args = ["--phase", "1", "--quick", "--model", STUDY, "--weights-dir",
            str(ROOT / "checkpoints"), "--data-dir", str(ROOT / "data" / "ml-1m"),
            "--device", "cpu", "--results-dir", results_dir]
    return args + (["--mesh", "dp=2"] if mesh else [])


def files_under(path: pathlib.Path) -> List[str]:
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(out_dir: pathlib.Path, world: int = 2) -> List[subprocess.Popen]:
    """Start the ranks; each writes its log to ``<out_dir>/rank<r>.log``."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        log = open(out_dir / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, __file__, str(out_dir)], env=env,
                                      stdout=log, stderr=subprocess.STDOUT, cwd=str(out_dir)))
        log.close()
    return procs


def run_rank(out: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from fairness_llm_tpu_torch.cli import main as cli
    from fairness_llm_tpu_torch.config import Config, MeshConfig, ModelSettings
    from fairness_llm_tpu_torch.metrics.sharded import (
        demographic_parity_on_mesh,
        equal_opportunity_on_mesh,
        mesh_group_counts_fn,
    )
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.multihost import (
        initialize_distributed,
        make_multihost_mesh,
    )
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations, score_texts

    res: dict = {"initialized": initialize_distributed()}
    rank = dist.get_rank()
    res["backend"] = dist.get_backend()
    mesh = make_multihost_mesh(MeshConfig(dp=2))
    res["mesh"] = mesh.mesh.tolist()
    res["mesh_tp"] = make_mesh(MeshConfig(tp=2)).mesh.tolist()

    reduce = mesh_group_counts_fn(mesh)
    res["counts"] = [reduce(*count_case(i)).numpy() for i in range(NUM_COUNT_CASES)]
    groups, relevant = rec_groups()
    res["dp_on_mesh"] = demographic_parity_on_mesh(mesh, groups)
    res["eo_on_mesh"] = equal_opportunity_on_mesh(mesh, groups, relevant)

    cfg = get_model_config(MODEL)
    params = torch.load(out / "params.pt")
    engine = DecodeEngine(cfg, params=params, device="cpu", mesh=mesh)
    res["gen"] = {}
    for name, prompts, temp, kw in gen_cases():
        o = engine.generate(prompts, ModelSettings(temperature=temp, max_tokens=GEN_TOKENS),
                            **kw)
        res["gen"][name] = {"tokens": o.tokens, "texts": o.texts, "stats": o.stats}
    res["score_texts"] = score_texts(engine, SCORE_TEXTS)
    res["score_cont"] = score_prompted_continuations(engine, SCORE_PROMPTS, SCORE_CONTS)

    study_dir = out / f"study{rank}"
    res["phase1"] = run_phase1(study_config(str(study_dir), Config, ModelSettings),
                               MODEL, backend=EngineBackend(engine, name=MODEL), save=True)
    res["study_files"] = files_under(study_dir)

    cli_dir = out / f"cli{rank}"
    res["cli_rc"] = cli.main(cli_args(str(cli_dir), mesh=True))
    res["cli_files"] = files_under(cli_dir)
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(pathlib.Path(sys.argv[1]))
