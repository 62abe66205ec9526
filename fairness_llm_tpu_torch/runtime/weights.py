"""Parameters for the port's ``Transformer``: conversion from a flax tree and
random initialisation (counterparts of the reference's param handling in
``runtime/weights.py`` and ``models/transformer.init_params_lowmem``).

The state dict keeps the flax names joined by dots
(``layer_0.attn.q_proj.kernel``) and the flax ``[in, out]`` kernel layout,
so a flax tree maps onto it one to one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.transformer import Transformer


def param_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    """Every parameter name of ``Transformer(cfg)`` with its shape; nothing is
    allocated."""
    with torch.device("meta"):
        model = Transformer(cfg)
    return {name: p.shape for name, p in model.named_parameters()}


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: numpy has no native one
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict from a flax param tree given as nested dicts of
    numpy arrays (``jax.device_get(params)``). Raises when the names or shapes
    do not match the model's."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                flat[name] = _to_tensor(val)

    walk(tree, "")
    want = param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"flax tree does not match {cfg.name}: missing "
            f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}"
        )
    for name, shape in want.items():
        if flat[name].shape != shape:
            raise ValueError(f"{name}: shape {tuple(flat[name].shape)} != {tuple(shape)}")
    return flat


def init_params(cfg: ModelConfig, seed: int, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Random parameters made straight in ``dtype`` on ``device``, with the
    families the reference's low-memory init uses: norm scales one, biases
    zero, every other tensor N(0, 0.02). Parameter i draws from its own
    generator seeded from (seed, i)."""
    dtype = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for i, (name, shape) in enumerate(param_shapes(cfg).items()):
        if name.endswith("scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 1_000_003 + i)
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            out[name] = t.mul_(0.02)
    return out


def build_model(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                device: torch.device, dtype: torch.dtype) -> Transformer:
    """A ``Transformer`` holding ``params`` moved to ``device``; float
    parameters are stored in ``dtype``. No other copy is made."""
    with torch.device("meta"):
        model = Transformer(cfg)
    state = {
        name: t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
        for name, t in params.items()
    }
    model.load_state_dict(state, strict=True, assign=True)
    model.requires_grad_(False)
    return model.eval()
