"""The benchmark's plain reference of the DeepSeek-V3-family decoder
(``h100_bench/reference/deepseek_v3.py``) held against HF transformers'
``DeepseekV3ForCausalLM`` on the same weights, in float32 on the CPU: the
guard against guessed equations. The reference imports nothing of
transformers; this test runs the transformers side in a subprocess (with
``USE_TF=0 USE_FLAX=0``, so that TensorFlow stays out, and so that neither
transformers nor JAX enters this worker's module table). The weights cross
as a ``torch.save`` file in the program's tree layout, which the
subprocess maps onto HF's module names (linear weights transposed; the
rotary weights in their published, interleaved layout)."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch

from h100_bench.reference import deepseek_v3 as ref
from molly_tpu_torch.models import deepseek_v3
from molly_tpu_torch.models.configs import tiny_deepseek_v3

ROOT = Path(__file__).resolve().parents[1]

HF_SIDE = r"""
import sys
import torch
from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

blob = torch.load(sys.argv[1])
text, p, embeds = blob["text"], blob["params"], blob["embeds"]
cfg = DeepseekV3Config(
    vocab_size=text["vocab_size"], hidden_size=text["hidden_size"],
    intermediate_size=text["intermediate_size"],
    moe_intermediate_size=text["moe_intermediate_size"],
    num_hidden_layers=text["num_hidden_layers"],
    num_attention_heads=text["num_attention_heads"],
    num_key_value_heads=text["num_attention_heads"],
    n_shared_experts=text["n_shared_experts"],
    n_routed_experts=text["num_experts"],
    routed_scaling_factor=text["routed_scaling_factor"],
    kv_lora_rank=text["kv_lora_rank"], q_lora_rank=None,
    qk_rope_head_dim=text["qk_rope_head_dim"],
    v_head_dim=text["v_head_dim"],
    qk_nope_head_dim=text["qk_nope_head_dim"], n_group=1, topk_group=1,
    num_experts_per_tok=text["num_experts_per_tok"],
    first_k_dense_replace=text["first_k_dense_replace"],
    norm_topk_prob=text["norm_topk_prob"], rms_norm_eps=text["rms_norm_eps"],
    rope_theta=text["rope_theta"], rope_scaling=None,
    tie_word_embeddings=False,
    max_position_embeddings=8192,
    attn_implementation="eager")
model = DeepseekV3ForCausalLM(cfg).eval()
lay, dense, moe = p["layers"], p["dense"], p["moe"]
Ld = text["first_k_dense_replace"]
with torch.no_grad():
    m = model.model
    m.embed_tokens.weight.copy_(p["embed"])
    m.norm.weight.copy_(p["final_norm"])
    model.lm_head.weight.copy_(p["lm_head"].T)
    for i, layer in enumerate(m.layers):
        layer.input_layernorm.weight.copy_(lay["input_norm"][i])
        layer.post_attention_layernorm.weight.copy_(lay["post_attn_norm"][i])
        a = layer.self_attn
        a.q_proj.weight.copy_(lay["q_proj"][i].T)
        a.kv_a_proj_with_mqa.weight.copy_(lay["kv_a_proj"][i].T)
        a.kv_a_layernorm.weight.copy_(lay["kv_norm"][i])
        a.kv_b_proj.weight.copy_(lay["kv_b_proj"][i].T)
        a.o_proj.weight.copy_(lay["o_proj"][i].T)
        if i < Ld:
            for name in ("gate_proj", "up_proj", "down_proj"):
                getattr(layer.mlp, name).weight.copy_(dense[name][i].T)
            continue
        j = i - Ld
        layer.mlp.gate.weight.copy_(moe["router"][j].T)
        layer.mlp.gate.e_score_correction_bias.copy_(moe["correction_bias"][j])
        for e, ex in enumerate(layer.mlp.experts):
            ex.gate_proj.weight.copy_(moe["expert_gate"][j, e].T)
            ex.up_proj.weight.copy_(moe["expert_up"][j, e].T)
            ex.down_proj.weight.copy_(moe["expert_down"][j, e].T)
        sh = layer.mlp.shared_experts
        sh.gate_proj.weight.copy_(moe["shared_gate"][j].T)
        sh.up_proj.weight.copy_(moe["shared_up"][j].T)
        sh.down_proj.weight.copy_(moe["shared_down"][j].T)
    assert cfg.rope_interleave
    logits = [model(inputs_embeds=e[None]).logits[0] for e in embeds]
torch.save(logits, sys.argv[2])
"""


def test_the_reference_follows_transformers_deepseek_v3(tmp_path):
    """Logits of two unpadded sequences agree to 1e-6 of their largest
    magnitude (~0.7): both sides compute in float32 from the same weights,
    so they differ by the order of float32 sums alone (measured 5e-8). The
    latent norm at the layers' eps 1e-5 in place of its own 1e-6 leaves
    6e-6, the rotary without the interleave 2e-4, the choice without the
    correction bias 3e-3, and a bf16 rounding anywhere ~4e-3: each fails.
    The bias is drawn nonzero, so the choice of experts goes through it."""
    cfg = tiny_deepseek_v3(num_hidden_layers=3)
    params = deepseek_v3.init_params(cfg, torch.Generator().manual_seed(7))
    text = dataclasses.asdict(cfg)
    g = torch.Generator().manual_seed(8)
    embeds = [torch.randn(n, cfg.hidden_size, generator=g) for n in (9, 14)]
    blob, out = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save({"text": text, "params": params, "embeds": embeds}, blob)
    env = dict(os.environ, USE_TF="0", USE_FLAX="0", USE_TORCH="1")
    res = subprocess.run([sys.executable, "-c", HF_SIDE, str(blob), str(out)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    hf = torch.load(out)
    with torch.no_grad():
        mine = ref.decoder_logits(params, text, embeds,
                                  [(0, e.shape[0]) for e in embeds])
    for a, b in zip(mine, hf):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), \
            float((a - b).abs().max())
