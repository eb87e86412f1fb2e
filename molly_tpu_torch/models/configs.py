"""Model configuration dataclasses + published-checkpoint presets.

Jax-free copies of ``molly_tpu.models.configs`` (importing that module runs
``molly_tpu/models/__init__.py``, which imports jax), plus ``FusionConfig``
(``molly_tpu/models/fusion.py``) and ``GenerationConfig``
(``molly_tpu/inference/engine.py``). ``tests/test_torch_models.py`` holds
every field and preset against the JAX originals, so the copies cannot drift.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Qwen3Config:
    """Qwen3 dense decoder (HF transformers modeling_qwen3.py is the spec)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 40960
    # runtime knobs (the training-side ones are carried for parity with
    # the JAX config; the inference port reads only dtype)
    dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "full"
    remat_skip_layers: int = 0
    context_parallel: bool = False
    context_parallel_prepermuted: bool = False
    context_parallel_zigzag: bool = False
    # mixture of experts (0 = dense); the MoE slice is not ported yet
    num_experts: int = 0
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    router_aux_coef: float = 1e-3
    expert_parallel: bool = False
    ep_capacity_factor: float = 2.0

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


@dataclass(frozen=True)
class EsmConfig:
    """ESM-family bidirectional encoder (ESM-2 and nucleotide-transformer;
    HF modeling_esm.py is the spec)."""

    vocab_size: int = 33
    hidden_size: int = 320
    intermediate_size: int = 1280
    num_hidden_layers: int = 6
    num_attention_heads: int = 20
    position_embedding_type: str = "rotary"  # "rotary" | "absolute"
    mlp_type: str = "gelu"  # "gelu" | "swiglu"
    mlp_bias: bool = True
    emb_layer_norm_before: bool = False
    token_dropout: bool = True
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    mask_token_id: int = 32
    max_position_embeddings: int = 1026
    dtype: str = "bfloat16"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class FusionConfig:
    text: Qwen3Config
    dna_rna: EsmConfig
    protein: EsmConfig
    dna_rna_k_tokens: int = 128
    protein_k_tokens: int = 128


@dataclass(frozen=True)
class GenerationConfig:
    """Defaults mirror the reference launch scripts."""

    max_new_tokens: int = 3072
    do_sample: bool = True
    temperature: float = 0.8
    top_p: float = 0.95
    top_k: int = 20
    repetition_penalty: float = 1.1
    eos_token_id: int = 0
    pad_token_id: int = 0


# ---------------- presets: published checkpoints ----------------

QWEN3_PRESETS = {
    "qwen3-0.6b": Qwen3Config(hidden_size=1024, intermediate_size=3072,
                              num_hidden_layers=28, num_attention_heads=16,
                              num_key_value_heads=8, tie_word_embeddings=True),
    "qwen3-1.7b": Qwen3Config(hidden_size=2048, intermediate_size=6144,
                              num_hidden_layers=28, num_attention_heads=16,
                              num_key_value_heads=8, tie_word_embeddings=True),
    "qwen3-4b": Qwen3Config(hidden_size=2560, intermediate_size=9728,
                            num_hidden_layers=36, num_attention_heads=32,
                            num_key_value_heads=8, tie_word_embeddings=True),
    "qwen3-8b": Qwen3Config(hidden_size=4096, intermediate_size=12288,
                            num_hidden_layers=36, num_attention_heads=32,
                            num_key_value_heads=8, tie_word_embeddings=False),
    "qwen3-30b-a3b": Qwen3Config(hidden_size=2048, intermediate_size=768,
                                 num_hidden_layers=48,
                                 num_attention_heads=32,
                                 num_key_value_heads=4,
                                 tie_word_embeddings=False,
                                 num_experts=128, num_experts_per_tok=8),
    "qwen3-moe-mini": Qwen3Config(hidden_size=2048, intermediate_size=768,
                                  num_hidden_layers=24,
                                  num_attention_heads=16,
                                  num_key_value_heads=8,
                                  tie_word_embeddings=True,
                                  num_experts=32, num_experts_per_tok=8),
}

ESM_PRESETS = {
    "esm2-8m": EsmConfig(vocab_size=33, hidden_size=320, intermediate_size=1280,
                         num_hidden_layers=6, num_attention_heads=20),
    "esm2-150m": EsmConfig(vocab_size=33, hidden_size=640,
                           intermediate_size=2560, num_hidden_layers=30,
                           num_attention_heads=20),
    "esm2-650m": EsmConfig(vocab_size=33, hidden_size=1280,
                           intermediate_size=5120, num_hidden_layers=33,
                           num_attention_heads=20),
    "nt-500m": EsmConfig(vocab_size=4107, hidden_size=1280,
                         intermediate_size=5120, num_hidden_layers=24,
                         num_attention_heads=20, mask_token_id=2,
                         token_dropout=True, mlp_type="swiglu",
                         mlp_bias=False,
                         max_position_embeddings=2050),
}


def tiny_qwen3(**kw) -> Qwen3Config:
    """Small config for tests/smoke runs."""
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, dtype="float32")
    base.update(kw)
    return Qwen3Config(**base)


def tiny_esm(**kw) -> EsmConfig:
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, dtype="float32")
    base.update(kw)
    return EsmConfig(**base)
