"""Train-state checkpoints with a verified restore (counterpart of
``fairness_llm_tpu/train/checkpoint.py``).

The reference saves through orbax, whose checkpoint holds global arrays
that a restore places onto the template's sharding; the port keeps those
semantics through ``torch.save``: step ``s`` is
``<dir>/<s>/train_state.pt`` holding the full model tensors by name, the
optimizer's state with its per-parameter entries by parameter name (the
AdamW moments full, the step counts as they are) and the step. At tp > 1
every rank gathers the full tensors over its tp group
(``TrainState.gather``), rank 0 of the world writes them and all ranks
meet at a barrier; a restore cuts each rank's part from the file
(``TrainState.cut``), so a state saved at one tp restores at another.
Each saved step gets a sha256 manifest written outside its directory,
``<dir>/manifest_<s>.json`` (``integrity/manifest.write_manifest``), as the
reference keeps its manifests outside orbax's step directories. The three
newest steps are kept (orbax's ``max_to_keep=3`` there); an evicted step's
manifest goes with it.

``restore_train_state`` tries the newest step (or the one asked for) first;
a step whose manifest fails verification, or whose load raises, is
skipped with a warning for the next older one, and None comes back when no
step restores: resuming a corrupt train state is worse than losing a few
steps. A restored state is loaded into ``template`` (a freshly built
state, which supplies the model and the optimizer) only after its file
loaded whole, its tensors matched the template's names and full shapes,
and its optimizer state held an entry for every parameter name or none
(a file whose entries are keyed by index is refused, not half restored).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import List, Optional

import torch

from fairness_llm_tpu_torch.integrity.manifest import (
    IntegrityError,
    verify_manifest,
    write_manifest,
)
from fairness_llm_tpu_torch.train.step import TrainState

logger = logging.getLogger(__name__)

MAX_TO_KEEP = 3
STATE_FILE = "train_state.pt"


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"manifest_{step}.json")


def _steps(directory: str) -> List[int]:
    root = os.path.abspath(directory)
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.isdir(os.path.join(root, d)))


def _param_names(state: TrainState) -> List[str]:
    """The parameter names in the optimizer's order (the indices of its
    state dict)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _is_moment(v, shape) -> bool:
    return isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(shape)


def global_state(state: TrainState) -> dict:
    """What a checkpoint holds of ``state``: ``params``, the full tensors by
    name; ``opt_state``, the optimizer's per-parameter entries by name (a
    tensor of its parameter's shape gathered full) and its groups'
    settings; ``step``. At tp > 1 a collective over the tp group: every
    rank calls it."""
    params = state.model.state_dict()
    opt = state.optimizer.state_dict()
    order = _param_names(state)
    per = {order[i]: dict(st) for i, st in opt["state"].items()}
    keys = sorted({k for n, st in per.items() for k, v in st.items()
                   if _is_moment(v, params[n].shape)})
    for key in keys:
        full = state.gather({n: st[key] for n, st in per.items()
                             if _is_moment(st.get(key), params[n].shape)})
        for n, t in full.items():
            per[n][key] = t.cpu()
    groups = [{k: v for k, v in g.items() if k != "params"} for g in opt["param_groups"]]
    return {"params": {n: t.cpu() for n, t in state.gather(params).items()},
            "opt_state": {"state": per, "param_groups": groups}, "step": int(state.step)}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> None:
    """Save ``state`` as step ``step`` (default ``state.step``), write its
    manifest, and drop the steps (and manifests) past the newest
    ``MAX_TO_KEEP``. Under a process group every rank calls it: the full
    tensors are gathered, rank 0 writes, and the ranks meet at a barrier."""
    blob = global_state(state)
    if _rank() == 0:
        _write(directory, blob, int(state.step) if step is None else int(step))
    _barrier()


def _write(directory: str, blob: dict, step: int) -> None:
    root = os.path.abspath(directory)
    step_dir = os.path.join(root, str(step))
    tmp = step_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(blob, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(step_dir, ignore_errors=True)
    os.replace(tmp, step_dir)
    write_manifest(step_dir, path=_manifest_path(directory, step))
    kept = set(_steps(directory)[-MAX_TO_KEEP:])
    for s in _steps(directory):
        if s not in kept:
            shutil.rmtree(os.path.join(root, str(s)), ignore_errors=True)
    for fname in os.listdir(root):
        if fname.startswith("manifest_") and fname.endswith(".json"):
            try:
                s = int(fname[len("manifest_"):-len(".json")])
            except ValueError:
                continue
            if s not in kept:
                try:
                    os.unlink(os.path.join(root, fname))
                except OSError:
                    pass
    logger.info("saved train state at step %d to %s", step, directory)


def _load_into(path: str, template: TrainState) -> TrainState:
    """Load the file's full tensors into ``template``, each rank's part cut
    from them."""
    from fairness_llm_tpu_torch.runtime.weights import param_shapes

    blob = torch.load(path, map_location="cpu", weights_only=True)
    params = blob["params"]
    want = param_shapes(template.config or template.model.config)
    if set(params) != set(want) or any(tuple(params[k].shape) != tuple(want[k]) for k in want):
        raise ValueError(f"{path}: tensors do not match the template's model")
    template.model.load_state_dict(template.cut(params))
    opt = template.optimizer.state_dict()
    saved = blob["opt_state"]
    if len(saved["param_groups"]) != len(opt["param_groups"]):
        raise ValueError(f"{path}: optimizer groups do not match the template's")
    names = _param_names(template)
    if saved["state"] and set(saved["state"]) != set(names):
        # keyed otherwise (by index, as files from before the tp format), or
        # with entries for some parameters only: a partial restore is no restore
        raise ValueError(f"{path}: optimizer state is not keyed by the template's "
                         "parameter names, one entry each")
    state = {}
    for i, name in enumerate(names):
        st = saved["state"].get(name)
        if st is None:
            continue
        state[i] = {k: (template.cut({name: v})[name] if _is_moment(v, params[name].shape)
                        else v) for k, v in st.items()}
    groups = [dict(g, **s) for g, s in zip(opt["param_groups"], saved["param_groups"])]
    template.optimizer.load_state_dict({"state": state, "param_groups": groups})
    template.step = int(blob["step"])
    return template


def restore_train_state(directory: str, template: TrainState,
                        step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the newest (or the given) step into ``template``, falling
    back past a step that fails its manifest or its load; None when no step
    restores. At tp > 1 every rank restores its own part from the same
    file."""
    candidates = [step] if step is not None else sorted(_steps(directory), reverse=True)
    for s in candidates:
        step_dir = os.path.join(os.path.abspath(directory), str(s))
        manifest = _manifest_path(directory, s)
        if os.path.exists(manifest):
            try:
                verify_manifest(step_dir, manifest_path=manifest, kind="train_checkpoint")
            except IntegrityError as e:
                logger.warning("train checkpoint step %d failed integrity check (%s); "
                               "trying an older step", s, e)
                continue
        try:
            restored = _load_into(os.path.join(step_dir, STATE_FILE), template)
        except Exception as e:  # noqa: BLE001 — fall back past a bad step
            logger.warning("restore of train checkpoint step %d failed (%s); trying an "
                           "older step", s, e)
            continue
        logger.info("restored train state step %d from %s", s, directory)
        return restored
    logger.warning("no restorable train checkpoint under %s", directory)
    return None
