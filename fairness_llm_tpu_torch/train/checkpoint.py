"""Train-state checkpoints with a verified restore (counterpart of
``fairness_llm_tpu/train/checkpoint.py``).

The reference saves through orbax; the port through ``torch.save``: step
``s`` is ``<dir>/<s>/train_state.pt`` holding the model's state dict, the
optimizer's (its moments and step counts) and the step. Each saved step
gets a sha256 manifest written outside its directory,
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
loaded whole and its tensors matched the template's names and shapes.
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


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> None:
    """Save ``state`` as step ``step`` (default ``state.step``), write its
    manifest, and drop the steps (and manifests) past the newest
    ``MAX_TO_KEEP``."""
    root = os.path.abspath(directory)
    step = int(state.step) if step is None else int(step)
    step_dir = os.path.join(root, str(step))
    tmp = step_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
                "step": int(state.step)}, os.path.join(tmp, STATE_FILE))
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
    blob = torch.load(path, map_location="cpu", weights_only=True)
    params, want = blob["params"], template.model.state_dict()
    if set(params) != set(want) or any(params[k].shape != want[k].shape for k in want):
        raise ValueError(f"{path}: tensors do not match the template's model")
    template.model.load_state_dict(params)
    template.optimizer.load_state_dict(blob["opt_state"])
    template.step = int(blob["step"])
    return template


def restore_train_state(directory: str, template: TrainState,
                        step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the newest (or the given) step into ``template``, falling
    back past a step that fails its manifest or its load; None when no step
    restores."""
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
