"""Next-token training step, loop and the sequence-parallel step
(counterpart of ``fairness_llm_tpu/train/step.py``).

The reference jits one functional step (``jax.value_and_grad`` and an
optax update) and lets GSPMD insert the collectives. Here the step is
autograd and ``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)`` over one
parameter group, which with its defaults is ``optax.adamw(3e-4,
weight_decay=0.01)``: bias-corrected moments with betas (0.9, 0.999), eps
outside the square root, and the decay decoupled from the moments on every
parameter. ``TrainState`` holds the model (its parameters are the train
state's params), the optimizer (its moments) and the step count, and the
step updates them in place.

- ``remat=True`` runs the whole forward under ``torch.utils.checkpoint``
  (the reference's whole-forward ``jax.checkpoint``): its activations are
  recomputed in the backward, and the gradients are the same.
- dp (a mesh with dp > 1): each rank takes its contiguous block of the
  batch's rows; its loss is its rows' summed token loss over the global
  count of target tokens, so the loss and the gradients summed over the
  ranks (explicit all-reduces) are the global mean's.
- sp (``make_sequence_parallel_train_step``, or an sp mesh): the model
  attends through ring attention over the sp group (``parallel/ring.py``,
  whose hop has a backward), each rank takes its block of the shifted
  sequence, padded up to an sp multiple as the reference pads it, and the
  loss and the gradients are summed over (dp, sp) as the reference's
  ``step.py:178-237`` does.
- tp (``make_train_step`` on a mesh with tp > 1): the parameters, and so
  their gradients and AdamW moments (Adam is elementwise), are cut by the
  decode path's rules, as the reference's ``make_train_step`` shards them:
  each rank holds ``parallel.sharding.rank_params`` of the full ones and
  builds its model at ``TPLayout.local_config`` over its ``ModelParallel``,
  as the engine does for tp decoding. The forward's tp sums are autograd
  functions (``ModelParallel.reduce`` and ``copy``), so every tp rank
  computes the same loss and holds the whole gradient of what it holds,
  but for a kv head that several ranks hold, whose shares
  ``sharding.sum_kv_copy_grads`` sums. The loss and the gradients are then
  summed over the rank's dp x sp plane (``sharding.replica_group``), not
  over the world, which would add different shards together. With sp the
  ring runs over each rank's local heads. ``TrainState.global_params``
  gathers the full parameters back.
- ``make_sequence_parallel_train_step`` on a mesh with tp > 1 does what the
  reference's ``shard_map`` does there: the parameters stay whole on every
  rank, the tp ranks compute the same step, and the sums run over (dp, sp).
- int8 weights are refused as the reference refuses them: train in float
  and quantize after.

The training forward passes no cache and ``left_padded=False``, so
attention takes the dense (or ring) branch: the hand-written kernels have
no backward, and the reference's flash gate also needs ``left_padded``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch

from fairness_llm_tpu_torch.device import resolve_device
from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.transformer import Transformer
from fairness_llm_tpu_torch.parallel.sharding import (
    ModelParallel,
    axis_group,
    axis_rank,
    axis_size,
    batch_sharding,
    gather_params,
    model_parallel,
    rank_params,
    replica_group,
    sum_kv_copy_grads,
)
from fairness_llm_tpu_torch.runtime.weights import build_model, init_params

logger = logging.getLogger(__name__)

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def default_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4, weight_decay=0.01)``'s counterpart: one group."""
    return torch.optim.AdamW(list(params), lr=3e-4, weight_decay=0.01)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state's), the optimizer (its
    moments) and the step count; ``config`` is the full model's config and
    ``par`` the rank's ``ModelParallel`` (None in one process), whose tp
    layout says which part of each full tensor the rank holds."""

    model: Transformer
    optimizer: torch.optim.Optimizer
    step: int = 0
    config: Optional[ModelConfig] = None
    par: Optional[ModelParallel] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by the port's names (``runtime/weights``): at tp
        > 1 the rank's own tensors."""
        return dict(self.model.named_parameters())

    @property
    def layout(self):
        """The rank's ``TPLayout``, or None without tp."""
        return None if self.par is None else self.par.layout

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The full tensors of ``tensors`` (the rank's parameters, or
        tensors of their shapes by the same names): gathered over the tp
        group (``sharding.gather_params``; every tp rank must call it), or
        the tensors themselves, detached, at tp = 1."""
        if self.layout is None:
            return {k: v.detach() for k, v in tensors.items()}
        return gather_params(self.config, tensors, self.layout, self.par.tp_group)

    def cut(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``gather``'s inverse: the rank's part of full tensors, on the
        model's device."""
        dev = next(self.model.parameters()).device
        if self.layout is None:
            return {k: v.to(dev) for k, v in tensors.items()}
        return rank_params(self.config, tensors, self.layout, dev)

    def global_params(self) -> Dict[str, torch.Tensor]:
        """The full parameters (``gather`` of ``params``)."""
        return self.gather(self.params)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy over the valid positions (targets
    already shifted): the summed loss over ``count`` (default: the valid
    positions here, at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if count is None:
        count = valid.sum().clamp_min(1)
    return -torch.where(valid, picked, torch.zeros_like(picked)).sum() / count


def _refuse(model_config: ModelConfig) -> None:
    if model_config.weight_quant != "none":
        raise ValueError(f"weight_quant={model_config.weight_quant!r} is serving-only; "
                         "train in float and quantize the result")


def _build_step(model_config: ModelConfig, optimizer: Optional[OptimizerFactory],
                mesh: Optional[Any], remat: bool, ring: bool, shard_tp: bool,
                device: Optional[Union[str, torch.device]]):
    _refuse(model_config)
    dev = resolve_device(device)
    make_opt = optimizer or default_optimizer
    cfg = dataclasses.replace(model_config, attention_impl="ring") if ring else model_config
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    replicas = dp * sp
    if shard_tp:
        par = model_parallel(model_config, mesh)
    else:
        par = ModelParallel(sp_group=axis_group(mesh, "sp")) if sp > 1 else None
    layout = None if par is None else par.layout
    group = replica_group(mesh) if replicas > 1 else None

    def init_state(seed: int = 0, params: Optional[Mapping[str, torch.Tensor]] = None,
                   param_dtype: torch.dtype = torch.float32) -> TrainState:
        """A fresh state: ``params`` (the full model's state dict, copied)
        or random ones from ``seed``, stored in ``param_dtype`` (float32 by
        default, as the reference's flax parameters); at tp > 1 the rank
        keeps its part (``rank_params``)."""
        if params is None:
            params = init_params(model_config, seed, dev, param_dtype)
        if layout is not None:
            params = rank_params(model_config, params, layout, dev)
        params = {k: v.detach().to(device=dev, dtype=param_dtype).clone()
                  for k, v in params.items()}
        model = build_model(cfg, params, dev, param_dtype, par=par)
        model.requires_grad_(True)
        return TrainState(model=model, optimizer=make_opt(model.parameters()), step=0,
                          config=model_config, par=par)

    def forward(model, inputs, positions, avalid):
        def run(i, p, v):
            return model(i, p, v)[0]

        if remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(run, inputs, positions, avalid, use_reentrant=False)
        return run(inputs, positions, avalid)

    def train_step(state: TrainState, tokens, valid) -> Tuple[TrainState, torch.Tensor]:
        """One step on ``tokens``/``valid`` [B, S] (the global batch on every
        rank); returns the state, updated in place, and the loss."""
        tokens = torch.as_tensor(tokens, device=dev).long()
        valid = torch.as_tensor(valid, device=dev).bool()
        B = tokens.shape[0]
        if B % dp:
            raise ValueError(f"batch {B} must divide dp={dp}")
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        avalid = valid[:, :-1]
        tvalid = avalid & valid[:, 1:]
        pad = (-inputs.shape[1]) % sp
        if pad:
            inputs, targets, avalid, tvalid = (
                torch.nn.functional.pad(t, (0, pad)) for t in (inputs, targets, avalid, tvalid))
        positions = (torch.cumsum(avalid.long(), dim=1) - 1).clamp_min(0)
        rows = batch_sharding(mesh, B)
        L = inputs.shape[1] // sp
        cols = slice(axis_rank(mesh, "sp") * L, (axis_rank(mesh, "sp") + 1) * L)
        local = [t[rows, cols] for t in (inputs, targets, positions, avalid, tvalid)]
        count = tvalid.sum().clamp_min(1).float()
        state.optimizer.zero_grad(set_to_none=True)
        logits = forward(state.model, local[0], local[2], local[3])
        loss = cross_entropy_loss(logits, local[1], local[4], count=count)
        loss.backward()
        loss = loss.detach()
        if layout is not None:
            sum_kv_copy_grads(model_config, state.params, layout, par.tp_group)
        if replicas > 1:
            import torch.distributed as dist

            for p in state.model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
            dist.all_reduce(loss, group=group)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return init_state, train_step


def make_train_step(model_config: ModelConfig, optimizer: Optional[OptimizerFactory] = None,
                    mesh: Optional[Any] = None, remat: bool = False,
                    device: Optional[Union[str, torch.device]] = None):
    """Build ``(init_state, train_step)``: ``train_step(state, tokens,
    valid) -> (state, loss)``. ``optimizer`` makes the optimizer from the
    parameters (default AdamW as above). With a mesh (``parallel.
    make_mesh`` over the ``torchrun`` world) the batch splits over dp, at
    sp > 1 the sequence over sp through the ring, and at tp > 1 the
    parameters over tp. ``device=None`` is the card."""
    return _build_step(model_config, optimizer, mesh, remat,
                       ring=axis_size(mesh, "sp") > 1, shard_tp=True, device=device)


def train_loop(model_config: ModelConfig, batches: Iterable[Tuple[Any, Any]], num_steps: int,
               mesh: Optional[Any] = None, optimizer: Optional[OptimizerFactory] = None,
               seed: int = 0, remat: bool = False, log_every: int = 10,
               device: Optional[Union[str, torch.device]] = None):
    """Minimal loop: init, iterate batches, return (state, losses)."""
    init_state, step = make_train_step(model_config, optimizer, mesh, remat, device=device)
    state = init_state(seed)
    losses = []
    for i, (tokens, valid) in enumerate(batches):
        if i >= num_steps:
            break
        state, loss = step(state, tokens, valid)
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            logger.info("train step %d: loss %.4f", i, losses[-1])
    return state, losses


def make_sequence_parallel_train_step(model_config: ModelConfig, mesh: Any,
                                      optimizer: Optional[OptimizerFactory] = None,
                                      device: Optional[Union[str, torch.device]] = None):
    """The step with explicit sequence parallelism: attention through ring
    passes over the mesh's sp group, activations split over (dp, sp),
    parameters replicated (whole on every rank, also where the mesh has a
    tp axis, whose ranks then compute the same step), the loss and the
    gradients summed over (dp, sp). Returns ``(init_state, step)`` like
    ``make_train_step``; the batch must divide dp, and the shifted sequence
    is padded up to an sp multiple."""
    return _build_step(model_config, optimizer, mesh, remat=False, ring=True, shard_tp=False,
                       device=device)
