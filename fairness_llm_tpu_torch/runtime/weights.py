"""Parameters for the port's ``Transformer``: HF safetensors checkpoints,
conversion from a flax tree, random initialisation and int8
(de)quantization of a state dict (counterparts of the reference's
``runtime/weights.py`` and ``models/transformer.init_params_lowmem``).

``load_checkpoint`` maps an HF checkpoint's layout onto the state dict,
reading it with the port's own safetensors reader (``safetensors_io``):

- llama/mistral: ``model.layers.{i}.self_attn.q_proj.weight`` etc., stored
  [out, in] and transposed into the [in, out] kernels;
- gemma: llama's names, tied embeddings, RMSNorm ``weight`` stored so that
  the scale is ``1 + weight``;
- qwen2: llama's names plus biases on q/k/v;
- gpt2: Conv1D kernels already [in, out] (no transpose), ``c_attn`` holding
  q, k and v side by side along the out axis (split three ways), learned
  ``wpe`` positions.

The state dict keeps the flax names joined by dots
(``layer_0.attn.q_proj.kernel``) and the flax ``[in, out]`` kernel layout,
so a flax tree maps onto it one to one. ``save_checkpoint_hf`` writes the
inverse: a state dict as an HF-layout ``model.safetensors`` and its sha256
``manifest.json``. Under ``weight_quant == "int8"`` a
projection holds ``<base>.kernel_q`` (int8) and ``<base>.kernel_scale``
(float32) instead of ``<base>.kernel``; both keep their dtype whatever the
storage dtype of the float parameters.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fairness_llm_tpu_torch.device import resolve_device
from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.transformer import Transformer
from fairness_llm_tpu_torch.ops.quant_matmul import dequantize_weight, quantize_weight
from fairness_llm_tpu_torch.runtime.safetensors_io import (INDEX_FILENAME, SafetensorsFile,
                                                           read_header, save_file)

logger = logging.getLogger(__name__)

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
    round(N(0, 1) * 42) clipped to +-127 under a scale of 0.02 / 42 (a
    ``kernel_scale`` is not a norm scale), norm scales one, biases zero,
    every other tensor N(0, 0.02). Parameter i draws from its own generator
    seeded from (seed, i), so the order of the draws changes no value: the
    largest tensors are drawn first, while the device is still empty. An
    int8 kernel's float32 draw (4.2 GB for llama3-70b's lm_head) then never
    sits on top of the other ~70 GB. The dict keeps the model's order."""
    dtype = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    shapes = list(param_shapes(cfg).items())
    drawn: Dict[str, torch.Tensor] = {}
    for i in sorted(range(len(shapes)), key=lambda j: -shapes[j][1].numel()):
        name, shape = shapes[i]
        drawn[name] = _draw(name, shape, seed * 1_000_003 + i, device, dtype)
    return {name: drawn[name] for name, _ in shapes}


def _draw(name: str, shape: torch.Size, seed: int, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    """One parameter of ``init_params``, its random families drawn from a
    generator seeded with ``seed``."""
    if name.endswith("kernel_scale"):
        return torch.full(shape, _NOMINAL_SCALE, dtype=torch.float32, device=device)
    if name.endswith("scale"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name.endswith("bias"):
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if name.endswith("kernel_q"):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(_INT8_STD).round_().clamp_(-127, 127).to(torch.int8)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(0.02)


def build_model(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                device: torch.device, dtype: torch.dtype, par=None) -> Transformer:
    """A ``Transformer`` holding ``params`` moved to ``device``; float
    parameters are stored in ``dtype``, int8 kernels and their f32 scales
    keep their dtypes. No other copy is made. ``par`` (a
    ``parallel.sharding.ModelParallel``) with a tp layout builds the rank's
    model: ``params`` are then ``parallel.sharding.rank_params``', at the
    layout's widths."""
    if par is not None and par.layout is not None:
        cfg = par.layout.local_config(cfg)
    with torch.device("meta"):
        model = Transformer(cfg)
    state = {
        name: t.to(device=device,
                   dtype=_fixed_dtype(name) or (dtype if t.is_floating_point() else t.dtype))
        for name, t in params.items()
    }
    model.load_state_dict(state, strict=True, assign=True)
    model.requires_grad_(False)
    model.set_parallel(par)
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


# ---------------------------------------------------------------------------
# HF checkpoints: state-dict name -> (HF tensor name, transform)
# ---------------------------------------------------------------------------

Transform = Callable[[torch.Tensor], torch.Tensor]


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t()


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def _llama_map(cfg: ModelConfig) -> Dict[str, Tuple[str, Transform]]:
    """Also mistral (the same names) and, with the changes below, gemma and
    qwen2."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embedding": ("model.embed_tokens.weight", _ident),
        "final_norm.scale": ("model.norm.weight", _ident),
    }
    if not cfg.tie_embeddings:
        m["lm_head"] = ("lm_head.weight", _t)
    for i in range(cfg.num_layers):
        p, h = f"layer_{i}", f"model.layers.{i}"
        m[f"{p}.attn_norm.scale"] = (f"{h}.input_layernorm.weight", _ident)
        m[f"{p}.mlp_norm.scale"] = (f"{h}.post_attention_layernorm.weight", _ident)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            m[f"{p}.attn.{proj}.kernel"] = (f"{h}.self_attn.{proj}.weight", _t)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[f"{p}.mlp.{proj}.kernel"] = (f"{h}.mlp.{proj}.weight", _t)
    return m


def _gemma_map(cfg: ModelConfig) -> Dict[str, Tuple[str, Transform]]:
    plus_one: Transform = lambda x: x + 1.0  # noqa: E731 - gemma's RMSNorm convention
    m = _llama_map(cfg)
    for key, (name, _tf) in list(m.items()):
        if key.endswith("norm.scale"):
            m[key] = (name, plus_one)
    return m


def _qwen2_map(cfg: ModelConfig) -> Dict[str, Tuple[str, Transform]]:
    """Qwen2: llama's names plus biases on the q/k/v projections only."""
    m = _llama_map(cfg)
    for i in range(cfg.num_layers):
        p, h = f"layer_{i}", f"model.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj"):
            m[f"{p}.attn.{proj}.bias"] = (f"{h}.self_attn.{proj}.bias", _ident)
    return m


def _gpt2_map(cfg: ModelConfig) -> Dict[str, Tuple[str, Transform]]:
    """GPT-2's Conv1D stores [in, out]; ``c_attn`` holds q, k, v along out."""
    d = cfg.d_model

    def _qkv(part: int) -> Transform:
        return lambda x: x[..., part * d:(part + 1) * d]

    m: Dict[str, Tuple[str, Transform]] = {
        "embedding": ("wte.weight", _ident),
        "pos_embedding": ("wpe.weight", _ident),
        "final_norm.scale": ("ln_f.weight", _ident),
        "final_norm.bias": ("ln_f.bias", _ident),
    }
    for i in range(cfg.num_layers):
        p, h = f"layer_{i}", f"h.{i}"
        m[f"{p}.attn_norm.scale"] = (f"{h}.ln_1.weight", _ident)
        m[f"{p}.attn_norm.bias"] = (f"{h}.ln_1.bias", _ident)
        m[f"{p}.mlp_norm.scale"] = (f"{h}.ln_2.weight", _ident)
        m[f"{p}.mlp_norm.bias"] = (f"{h}.ln_2.bias", _ident)
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            m[f"{p}.attn.{proj}.kernel"] = (f"{h}.attn.c_attn.weight", _qkv(j))
            m[f"{p}.attn.{proj}.bias"] = (f"{h}.attn.c_attn.bias", _qkv(j))
        m[f"{p}.attn.o_proj.kernel"] = (f"{h}.attn.c_proj.weight", _ident)
        m[f"{p}.attn.o_proj.bias"] = (f"{h}.attn.c_proj.bias", _ident)
        m[f"{p}.mlp.up_proj.kernel"] = (f"{h}.mlp.c_fc.weight", _ident)
        m[f"{p}.mlp.up_proj.bias"] = (f"{h}.mlp.c_fc.bias", _ident)
        m[f"{p}.mlp.down_proj.kernel"] = (f"{h}.mlp.c_proj.weight", _ident)
        m[f"{p}.mlp.down_proj.bias"] = (f"{h}.mlp.c_proj.bias", _ident)
    return m


_FAMILY_MAPS = {
    "llama": _llama_map,
    "mistral": _llama_map,
    "gemma": _gemma_map,
    "gpt2": _gpt2_map,
    "qwen": _qwen2_map,
}


def family_of(cfg: ModelConfig) -> str:
    name = cfg.name.lower()
    for fam in ("llama", "mistral", "gemma", "gpt2", "qwen"):
        if fam in name.replace("-", ""):
            return fam
    # tiny test configs: pick by flags
    if cfg.qkv_bias:
        return "qwen"
    return "gpt2" if cfg.pos_emb == "learned" else "llama"


def hf_name_map(cfg: ModelConfig, family: Optional[str] = None) -> Dict[str, Tuple[str, Transform]]:
    return _FAMILY_MAPS[family or family_of(cfg)](cfg)


def _strip_prefix(name: str, tensors: Mapping[str, str]) -> str:
    """Resolve ``name`` against the checkpoint's names, which some
    checkpoints prefix with ``transformer.`` (gpt2) or ``model.``."""
    if name in tensors:
        return name
    for prefix in ("transformer.", "model."):
        if prefix + name in tensors:
            return prefix + name
    raise KeyError(f"tensor '{name}' not found in checkpoint (have {len(tensors)} tensors)")


def _checkpoint_index(path: str) -> Dict[str, str]:
    """Tensor name -> file name for a safetensors checkpoint directory, from
    ``model.safetensors.index.json`` when the checkpoint is sharded."""
    index_file = os.path.join(path, INDEX_FILENAME)
    if os.path.exists(index_file):
        with open(index_file) as f:
            return json.load(f)["weight_map"]
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    out: Dict[str, str] = {}
    for fname in files:
        header, _ = read_header(os.path.join(path, fname))
        out.update((name, fname) for name in header if name != "__metadata__")
    return out


def load_checkpoint(
    cfg: ModelConfig,
    path: str,
    family: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    verify: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """An HF safetensors checkpoint directory -> the port's state dict on
    ``device`` (None means CUDA).

    ``verify`` checks the directory's sha256 ``manifest.json`` first, when
    there is one: a corrupt or truncated file raises ``IntegrityError``
    naming it before any tensor is read. Tensors stream one at a time: each
    is copied out of the mapped file, moved to the device, transformed, and
    stored as ``dtype`` (default: bf16 for a bf16 config, else f32). Under
    ``weight_quant == "int8"`` each projection kernel and an untied
    ``lm_head`` is quantized as it arrives, so no float copy of the tree
    exists."""
    from fairness_llm_tpu_torch.integrity.manifest import maybe_verify_manifest

    dev = resolve_device(device)
    if verify:
        maybe_verify_manifest(path, kind="weights")
    dtype = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    weight_map = _checkpoint_index(path)
    quant = cfg.weight_quant == "int8"
    files: Dict[str, SafetensorsFile] = {}
    params: Dict[str, torch.Tensor] = {}
    try:
        for ours, (hf_name, transform) in hf_name_map(cfg, family).items():
            hf_name = _strip_prefix(hf_name, weight_map)
            fname = weight_map[hf_name]
            if fname not in files:
                files[fname] = SafetensorsFile(os.path.join(path, fname))
            x = transform(files[fname].get_tensor(hf_name).to(dev)).contiguous()
            base = _quant_base(ours) if quant else None
            if base is not None:
                params[f"{base}.kernel_q"], params[f"{base}.kernel_scale"] = quantize_weight(x)
                logger.debug("loaded %s <- %s %s (int8)", base, hf_name, tuple(x.shape))
                del x  # the float copy goes before the next tensor is read
                continue
            params[ours] = x.to(dtype)
            logger.debug("loaded %s <- %s %s", ours, hf_name, tuple(x.shape))
    finally:
        for f in files.values():
            f.close()
    return params


# Embeddings are stored [rows, d_model] on both sides: never transposed.
_EMBEDDINGS = ("embed_tokens.weight", "wte.weight", "wpe.weight")


def save_checkpoint_hf(cfg: ModelConfig, params: Mapping[str, torch.Tensor], path: str,
                       family: Optional[str] = None) -> None:
    """Write ``params`` (a state dict on any device) under ``path`` as an
    HF-layout ``model.safetensors`` plus its ``manifest.json``: the inverse
    of ``load_checkpoint``'s mapping. gpt2's q/k/v parts are joined back
    into ``c_attn`` and its Conv1D kernels written as they are; gemma's
    norms are written as ``scale - 1``; every other 2-D tensor but the
    embeddings is transposed to [out, in]; a tied head is absent. An int8
    tree is written dequantized to float32 (``dequantize_params``, the whole
    tree at once on its device), embeddings and norms in their own dtype.
    The file is written a tensor at a time (``safetensors_io.save_file``),
    and hashed for the manifest as it is written; the manifest also lists
    any other file already under ``path``."""
    from fairness_llm_tpu_torch.integrity.manifest import write_manifest

    if cfg.weight_quant == "int8":
        params = dequantize_params(params)
    family = family or family_of(cfg)
    out: Dict[str, torch.Tensor] = {}
    fused: Dict[str, list] = {}
    for ours, (hf_name, _tf) in hf_name_map(cfg, family).items():
        x = params.get(ours)
        if x is None:
            continue
        x = x.detach()
        if family == "gpt2":
            if ".c_attn." in hf_name:
                part = ("q_proj", "k_proj", "v_proj").index(ours.split(".")[-2])
                fused.setdefault(hf_name, [None, None, None])[part] = x
                continue
            out[hf_name] = x  # Conv1D: already [in, out]
        elif family == "gemma" and hf_name.endswith("norm.weight"):
            out[hf_name] = x - 1.0
        elif x.dim() == 2 and not hf_name.endswith(_EMBEDDINGS):
            out[hf_name] = x.t()  # a view: the writer copies it one tensor at a time
        else:
            out[hf_name] = x
    for hf_name, parts in fused.items():
        out[hf_name] = torch.cat(parts, dim=-1)
    os.makedirs(path, exist_ok=True)
    digest = save_file(out, os.path.join(path, "model.safetensors"))
    write_manifest(path, digests={"model.safetensors": digest})
