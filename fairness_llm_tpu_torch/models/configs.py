"""Model-family configurations (the port's own copy of
``fairness_llm_tpu/models/configs.py``; importing the reference would pull
in JAX and flax through its package ``__init__``).

Architecture hyperparameters for the open-weight families named in
``BASELINE.json.configs`` (Llama-3-8B/70B, Mistral-7B, Gemma-7B, GPT-2-small)
plus tiny test configs. All sizes are public-knowledge architecture constants.

Flags rather than subclasses select family behavior:
- ``pos_emb``: "rope" (llama/mistral/gemma) or "learned" (gpt2)
- ``norm``: "rmsnorm" or "layernorm"
- ``mlp``: "glu" (SwiGLU/GeGLU) or "mlp" (GPT-2's fc->gelu->proj)
- ``embed_scale``: Gemma multiplies embeddings by sqrt(d_model)
- ``sliding_window``: Mistral's local attention span
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    d_model: int
    d_ff: int
    head_dim: int
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    pos_emb: str = "rope"  # "rope" | "learned"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp: str = "glu"  # "glu" | "mlp"
    use_bias: bool = False  # biases on attention + MLP projections (gpt2 family)
    qkv_bias: bool = False  # biases ONLY on q/k/v projections (qwen2 family)
    activation: str = "silu"  # "silu" | "gelu" | "gelu_tanh"
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # mistral
    eos_token_id: int = 2
    pad_token_id: int = 0
    dtype: str = "bfloat16"
    # Flash-attention kernel (ops/flash_attention.py) for the left-padded
    # prefill with no shared prefix.
    use_flash_attention: bool = True
    # int8 KV cache with f32 per-(slot, head) scales (init_cache builds it;
    # the decode kernel reads it as K2q, the paged arena's blocks hold it).
    kv_cache_quant: bool = False
    # Decode-attention kernel (ops/decode_attention.py) for cached
    # single-token steps without a sliding window. Off by default, as in the
    # reference; the port's chip run sets it.
    use_decode_attention_kernel: bool = False
    # Weight-only int8 serving: every projection and an untied lm_head store
    # int8 kernels with f32 per-channel scales and run through the int8-weight
    # kernel (ops/quant_matmul.py).
    weight_quant: str = "none"  # "none" | "int8"
    # "xla": the dense, flash and decode-kernel paths; "ring": ring attention
    # over the sp group on the no-cache path (parallel/ring.py).
    attention_impl: str = "xla"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def approx_param_count(self) -> int:
        """Parameter-count estimate from the architecture constants."""
        embed = self.vocab_size * self.d_model
        attn = self.d_model * (2 * self.q_dim + 2 * self.kv_dim)
        mlp_in = 2 if self.mlp == "glu" else 1
        mlp = self.d_model * self.d_ff * (mlp_in + 1)
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * (attn + mlp)


MODEL_CONFIGS = {
    # Tiny config for tests/CI: fast to init, exercises GQA + RoPE + GLU path.
    "tiny-test": ModelConfig(
        name="tiny-test", vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        d_model=64, d_ff=128, head_dim=16, max_seq_len=256, eos_token_id=1,
        dtype="float32",
    ),
    # Tiny GPT-2-style config: learned positions + layernorm + gelu MLP path.
    "tiny-gpt2": ModelConfig(
        name="tiny-gpt2", vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=4,
        d_model=64, d_ff=256, head_dim=16, max_seq_len=256, pos_emb="learned",
        norm="layernorm", mlp="mlp", use_bias=True, activation="gelu_tanh",
        tie_embeddings=True, eos_token_id=1, dtype="float32",
    ),
    # Tiny *study* configs: match the transformers-built checkpoints committed
    # under checkpoints/ (tools/build_tiny_study_checkpoints.py). These exist
    # so the full --all study can run through the REAL weights path
    # (backend_for -> load_checkpoint -> HFTokenizer -> EngineBackend) end to
    # end without pretrained weights in the environment — the reference's
    # inference layer was always a real model (phase1_bias_detection.py:180-188),
    # and results/real_weights/ holds the committed record. Swapping in actual
    # Llama weights is then a config change, not new code. vocab 512 matches
    # the committed BPE tokenizer; eos/pad 0 = its <|endoftext|>.
    "tiny-llama-study": ModelConfig(
        name="tiny-llama-study", vocab_size=512, num_layers=4, num_heads=4,
        num_kv_heads=2, d_model=128, d_ff=256, head_dim=32, max_seq_len=1024,
        eos_token_id=0, pad_token_id=0, dtype="float32",
        use_flash_attention=False,
    ),
    "tiny-gpt2-study": ModelConfig(
        name="tiny-gpt2-study", vocab_size=512, num_layers=4, num_heads=4,
        num_kv_heads=4, d_model=128, d_ff=512, head_dim=32, max_seq_len=1024,
        pos_emb="learned", norm="layernorm", mlp="mlp", use_bias=True,
        activation="gelu_tanh", tie_embeddings=True, eos_token_id=0,
        pad_token_id=0, dtype="float32", use_flash_attention=False,
    ),
    "gpt2-small": ModelConfig(
        name="gpt2-small", vocab_size=50257, num_layers=12, num_heads=12,
        num_kv_heads=12, d_model=768, d_ff=3072, head_dim=64, max_seq_len=1024,
        pos_emb="learned", norm="layernorm", mlp="mlp", use_bias=True,
        activation="gelu_tanh", tie_embeddings=True, eos_token_id=50256,
        pad_token_id=50256,
    ),
    # Llama-3.2 small models: the single-chip-friendly members of the family
    # (1B/3B fit a v5e chip in bf16 with room for KV cache and batch).
    "llama32-1b": ModelConfig(
        name="llama32-1b", vocab_size=128256, num_layers=16, num_heads=32,
        num_kv_heads=8, d_model=2048, d_ff=8192, head_dim=64, max_seq_len=8192,
        rope_theta=500000.0, tie_embeddings=True, eos_token_id=128001,
        pad_token_id=128001,
    ),
    "llama32-3b": ModelConfig(
        name="llama32-3b", vocab_size=128256, num_layers=28, num_heads=24,
        num_kv_heads=8, d_model=3072, d_ff=8192, head_dim=128, max_seq_len=8192,
        rope_theta=500000.0, tie_embeddings=True, eos_token_id=128001,
        pad_token_id=128001,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, num_layers=32, num_heads=32,
        num_kv_heads=8, d_model=4096, d_ff=14336, head_dim=128, max_seq_len=8192,
        rope_theta=500000.0, eos_token_id=128001, pad_token_id=128001,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab_size=128256, num_layers=80, num_heads=64,
        num_kv_heads=8, d_model=8192, d_ff=28672, head_dim=128, max_seq_len=8192,
        rope_theta=500000.0, eos_token_id=128001, pad_token_id=128001,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, num_layers=32, num_heads=32,
        num_kv_heads=8, d_model=4096, d_ff=14336, head_dim=128, max_seq_len=8192,
        rope_theta=1000000.0, sliding_window=4096, eos_token_id=2, pad_token_id=0,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b", vocab_size=256000, num_layers=28, num_heads=16,
        num_kv_heads=16, d_model=3072, d_ff=24576, head_dim=256, max_seq_len=8192,
        activation="gelu_tanh", embed_scale=True, tie_embeddings=True,
        eos_token_id=1, pad_token_id=0,
    ),
    # Qwen2/2.5: llama-like (RMSNorm + SwiGLU + RoPE + GQA) with biases on
    # the q/k/v projections only (qkv_bias).
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b", vocab_size=151936, num_layers=24, num_heads=14,
        num_kv_heads=2, d_model=896, d_ff=4864, head_dim=64, max_seq_len=8192,
        rope_theta=1000000.0, norm_eps=1e-6, qkv_bias=True, tie_embeddings=True,
        eos_token_id=151643, pad_token_id=151643,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, num_layers=28, num_heads=28,
        num_kv_heads=4, d_model=3584, d_ff=18944, head_dim=128, max_seq_len=8192,
        rope_theta=1000000.0, norm_eps=1e-6, qkv_bias=True,
        eos_token_id=151643, pad_token_id=151643,
    ),
}

# int8 weight-only serving variants, DERIVED from their base entries so a fix
# to a base architecture constant needs applying once.
for _base in ("llama3-8b", "llama3-70b", "mistral-7b", "gemma-7b", "qwen2-7b"):
    _cfg = MODEL_CONFIGS[_base]
    MODEL_CONFIGS[f"{_base}-int8"] = dataclasses.replace(
        _cfg, name=f"{_base}-int8", weight_quant="int8"
    )
del _base, _cfg


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]
