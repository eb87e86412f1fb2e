"""Model configuration dataclasses + published-checkpoint presets.

Jax-free copies of ``molly_tpu.models.configs`` (importing that module runs
``molly_tpu/models/__init__.py``, which imports jax), plus ``FusionConfig``
(``molly_tpu/models/fusion.py``) and ``GenerationConfig``
(``molly_tpu/inference/engine.py``). ``tests/test_torch_models.py`` holds
every field and preset against the JAX originals, so the copies cannot drift.

``DeepseekV3Config`` has no JAX original: the port's second decoder
architecture (``models.deepseek_v3``), which ``FusionConfig.text`` may hold
in place of a ``Qwen3Config`` (``models.decoders`` finds the module by the
type).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
    # mixture of experts (Qwen3-MoE family; 0 = dense). num_experts > 0
    # replaces the dense SwiGLU MLP of every layer with a dropless top-k
    # sparse FFN (ops.moe); intermediate_size is then the PER-EXPERT width.
    # expert_parallel: the experts stay on the ranks of the mesh's expert
    # axis (ops.moe.moe_mlp_expert_sharded, capacity ep_capacity_factor).
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
class DeepseekV3Config:
    """DeepSeek-V3-family decoder (HF transformers modeling_deepseek_v3.py
    is the spec): multi-head latent attention without q compression (q
    projected to heads of qk_nope + qk_rope; one latent of kv_lora_rank and
    one rotary key shared by every head, RMSNorm on the latent, kv_b_proj
    decompressing k_nope and v per head), interleaved rotary on the rope
    part, the first ``first_k_dense_replace`` layers a dense SwiGLU and the
    rest ``num_experts`` routed SwiGLU experts (sigmoid scores; the top
    ``num_experts_per_tok`` of score + correction bias; weights the unbiased
    scores, normalised, times ``routed_scaling_factor``) beside
    ``n_shared_experts`` shared ones, run as one SwiGLU of that many times
    the expert width. The names are the published config's, but the routed
    expert count: ``num_experts`` (published ``n_routed_experts``)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264    # the dense layers' SwiGLU width
    moe_intermediate_size: int = 1408  # one routed or shared expert's
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    rope_interleave: bool = True
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    attention_bias: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        unsupported = {
            "q_lora_rank": (self.q_lora_rank, None),
            "n_group": (self.n_group, 1), "topk_group": (self.topk_group, 1),
            "scoring_func": (self.scoring_func, "sigmoid"),
            "topk_method": (self.topk_method, "noaux_tc"),
            "rope_interleave": (self.rope_interleave, True),
            "hidden_act": (self.hidden_act, "silu"),
            "attention_bias": (self.attention_bias, False)}
        for name, (got, want) in unsupported.items():
            if got != want:
                raise ValueError(
                    f"DeepseekV3Config: {name}={got!r} is not supported "
                    f"(only {want!r}: q compression and group-limited "
                    f"routing are not ported)")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """One cached token's width: the latent and the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


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


def tiny_moe(**kw) -> Qwen3Config:
    """Small MoE config for tests/smoke runs (4 experts, top-2)."""
    base = dict(num_experts=4, num_experts_per_tok=2)
    base.update(kw)
    return tiny_qwen3(**base)


def tiny_deepseek_v3(**kw) -> DeepseekV3Config:
    """Small DeepSeek-V3-family config for tests: one dense layer, then
    MoE layers of 8 routed experts (top-2) and 2 shared."""
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                moe_intermediate_size=16, num_hidden_layers=3,
                num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, num_experts=8,
                num_experts_per_tok=2, n_shared_experts=2,
                first_k_dense_replace=1, routed_scaling_factor=2.446,
                dtype="float32")
    base.update(kw)
    return DeepseekV3Config(**base)


def tiny_esm(**kw) -> EsmConfig:
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, dtype="float32")
    base.update(kw)
    return EsmConfig(**base)
