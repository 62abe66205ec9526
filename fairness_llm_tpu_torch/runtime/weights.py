"""Parameters for the port's ``Transformer``: conversion from a flax tree,
random initialisation and int8 (de)quantization of a state dict
(counterparts of the reference's param handling in ``runtime/weights.py``
and ``models/transformer.init_params_lowmem``).

The state dict keeps the flax names joined by dots
(``layer_0.attn.q_proj.kernel``) and the flax ``[in, out]`` kernel layout,
so a flax tree maps onto it one to one. Under ``weight_quant == "int8"`` a
projection holds ``<base>.kernel_q`` (int8) and ``<base>.kernel_scale``
(float32) instead of ``<base>.kernel``; both keep their dtype whatever the
storage dtype of the float parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.transformer import Transformer
from fairness_llm_tpu_torch.ops.quant_matmul import dequantize_weight, quantize_weight

# The reference's random int8 init: round(N(0, 1) * 42) clipped to +-127,
# under a nominal scale of 0.02 / 42, so the dequantized values are ~N(0, 0.02).
_INT8_STD = 42.0
_NOMINAL_SCALE = 0.02 / 42.0


def param_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    """Every parameter name of ``Transformer(cfg)`` with its shape; nothing is
    allocated."""
    with torch.device("meta"):
        model = Transformer(cfg)
    return {name: p.shape for name, p in model.named_parameters()}


def _fixed_dtype(name: str) -> Optional[torch.dtype]:
    """The dtype an int8 projection's tensors keep, else None (float)."""
    if name.endswith("kernel_q"):
        return torch.int8
    if name.endswith("kernel_scale"):
        return torch.float32
    return None


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
        fixed = _fixed_dtype(name)
        if fixed is not None and flat[name].dtype != fixed:
            raise ValueError(f"{name}: dtype {flat[name].dtype} != {fixed}")
    return flat


def init_params(cfg: ModelConfig, seed: int, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Random parameters made straight in ``dtype`` on ``device``, with the
    families the reference's low-memory init uses: int8 kernels
    round(N(0, 1) * 42) clipped to +-127 under a scale of 0.02 / 42 (these
    two rules come before the generic ones), norm scales one, biases zero,
    every other tensor N(0, 0.02). Parameter i draws from its own generator
    seeded from (seed, i)."""
    dtype = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for i, (name, shape) in enumerate(param_shapes(cfg).items()):
        if name.endswith("kernel_q"):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 1_000_003 + i)
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = t.mul_(_INT8_STD).round_().clamp_(-127, 127).to(torch.int8)
        elif name.endswith("kernel_scale"):
            out[name] = torch.full(shape, _NOMINAL_SCALE, dtype=torch.float32, device=device)
        elif name.endswith("scale"):
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
    parameters are stored in ``dtype``, int8 kernels and their f32 scales
    keep their dtypes. No other copy is made."""
    with torch.device("meta"):
        model = Transformer(cfg)
    state = {
        name: t.to(device=device,
                   dtype=_fixed_dtype(name) or (dtype if t.is_floating_point() else t.dtype))
        for name, t in params.items()
    }
    model.load_state_dict(state, strict=True, assign=True)
    model.requires_grad_(False)
    return model.eval()


def _quant_base(name: str) -> Optional[str]:
    """For a float kernel's name, the base name of the ``QuantDense`` that
    replaces it under ``weight_quant="int8"``, else None: every projection
    kernel and the untied ``lm_head``; embeddings, norms and biases stay
    float."""
    if name.endswith(".kernel"):
        return name[: -len(".kernel")]
    if name == "lm_head":
        return "lm_head"
    return None


def quantize_params(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float state dict -> the ``weight_quant="int8"`` layout: each kernel
    becomes ``<base>.kernel_q`` and ``<base>.kernel_scale``."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        base = _quant_base(name)
        if base is None:
            out[name] = t
        else:
            out[f"{base}.kernel_q"], out[f"{base}.kernel_scale"] = quantize_weight(t)
    return out


def dequantize_params(params: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_params`` (up to the quantization's rounding).
    Biases stay; an ``lm_head`` left with nothing else becomes the bare
    float leaf again."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        if name.endswith(".kernel_scale"):
            continue
        if not name.endswith(".kernel_q"):
            out[name] = t
            continue
        base = name[: -len(".kernel_q")]
        w = dequantize_weight(t, params[f"{base}.kernel_scale"], dtype)
        rest = [n for n in params if n.startswith(base + ".")
                and not n.endswith((".kernel_q", ".kernel_scale"))]
        out[base if base == "lm_head" and not rest else f"{base}.kernel"] = w
    return out
