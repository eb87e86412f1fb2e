"""Port param trees -> HF-format checkpoints, the counterpart of
``molly_tpu/models/hf_export.py`` (the inverse of ``hf_import``).

Linears are transposed back to torch's [out, in] and the stacked [L, ...]
layer axis (and [L, E, ...] expert axis) is unstacked into per-layer and
per-expert keys, so a checkpoint trained here loads in HF transformers and a
PEFT adapter in the reference's PEFT stack. The state dicts hold views of
the params (no copy); ``save_hf_checkpoint`` writes them with this module's
own safetensors writer (no ``safetensors`` package): each tensor made
contiguous on its own before its bytes are taken, since a transposed view's
storage is not in the order its header describes.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, Optional

import torch

from .configs import Qwen3Config
from .hf_import import ST_DTYPES, peft_target_path

_ST_NAMES = {dt: name for name, dt in ST_DTYPES.items()}


def qwen3_to_hf_state(params: Dict[str, Any],
                      cfg: Qwen3Config) -> Dict[str, torch.Tensor]:
    """The port's stacked tree -> the HF Qwen3ForCausalLM (dense) or
    Qwen3MoeForCausalLM (``cfg.num_experts``) key layout, as views."""
    state: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    lp = params["layers"]
    L = cfg.num_hidden_layers
    per_layer = {
        "input_layernorm.weight": ("input_norm", False),
        "post_attention_layernorm.weight": ("post_attn_norm", False),
        "self_attn.q_proj.weight": ("q_proj", True),
        "self_attn.k_proj.weight": ("k_proj", True),
        "self_attn.v_proj.weight": ("v_proj", True),
        "self_attn.o_proj.weight": ("o_proj", True),
        "self_attn.q_norm.weight": ("q_norm", False),
        "self_attn.k_norm.weight": ("k_norm", False),
    }
    if cfg.num_experts:
        for i in range(L):
            state[f"model.layers.{i}.mlp.gate.weight"] = lp["router"][i].T
            for j in range(cfg.num_experts):
                for hf_name, ours in (("gate_proj", "expert_gate"),
                                      ("up_proj", "expert_up"),
                                      ("down_proj", "expert_down")):
                    state[f"model.layers.{i}.mlp.experts.{j}."
                          f"{hf_name}.weight"] = lp[ours][i, j].T
    else:
        per_layer.update({
            "mlp.gate_proj.weight": ("gate_proj", True),
            "mlp.up_proj.weight": ("up_proj", True),
            "mlp.down_proj.weight": ("down_proj", True),
        })
    for i in range(L):
        for hf_key, (ours, transpose) in per_layer.items():
            a = lp[ours][i]
            state[f"model.layers.{i}.{hf_key}"] = a.T if transpose else a
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = params["lm_head"].T
    return state


def peft_lora_to_hf_state(lora: Dict[str, Any],
                          cfg: Qwen3Config) -> Dict[str, torch.Tensor]:
    """``models.lora`` tree -> PEFT adapter keys (the inverse of
    ``hf_import.peft_lora_from_hf``): a [L, in, r] -> per-layer
    ``lora_A.weight`` [r, in], b [L, r, out] -> ``lora_B.weight`` [out, r];
    expert stacks [L, E, in, r] unstack to ``mlp.experts.{j}.*`` keys. Each
    tensor is contiguous, in the adapter's dtype."""
    pre = "base_model.model.model.layers.{i}."
    state: Dict[str, torch.Tensor] = {}
    for target, ab in lora["layers"].items():
        a, b = ab["a"].detach(), ab["b"].detach()
        if target.startswith("expert_"):
            hf_t = target.replace("expert_", "") + "_proj"
            for i in range(a.shape[0]):
                for j in range(a.shape[1]):
                    k = pre.format(i=i) + f"mlp.experts.{j}.{hf_t}"
                    state[k + ".lora_A.weight"] = a[i, j].T.contiguous()
                    state[k + ".lora_B.weight"] = b[i, j].T.contiguous()
        else:
            for i in range(a.shape[0]):
                k = pre.format(i=i) + peft_target_path(target)
                state[k + ".lora_A.weight"] = a[i].T.contiguous()
                state[k + ".lora_B.weight"] = b[i].T.contiguous()
    return state


def write_safetensors(path: str, state: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None,
                      float_dtype: Optional[torch.dtype] = None) -> int:
    """Write ``state`` (tensors on any device, with any strides) as one
    ``.safetensors`` file; returns the bytes written. ``float_dtype`` stores
    every floating tensor in that dtype, each converted only as its bytes
    are written. The header is padded with spaces to a multiple of 8 bytes,
    the byte ranges follow one another in header order, and
    ``__metadata__`` is a map of strings, as ``safetensors.safe_open``
    requires."""
    def stored(t):
        return (float_dtype if float_dtype is not None
                and t.is_floating_point() else t.dtype)

    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in state.items():
        dt = stored(t)
        if dt not in _ST_NAMES:
            raise ValueError(f"{name!r}: dtype {dt} has no safetensors name")
        n = t.numel() * torch.empty((), dtype=dt).element_size()
        header[name] = {"dtype": _ST_NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in state.values():
            if t.numel():
                # contiguous in the header's order before the bytes are
                # taken: a transposed view's storage is not
                t = t.detach().to(stored(t)).contiguous().cpu()
                f.write(t.view(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def save_hf_checkpoint(path: str, params: Dict[str, Any],
                       cfg: Qwen3Config) -> None:
    """Write ``model.safetensors`` and a ``config.json`` HF can read. Every
    floating leaf is stored as fp32, as the JAX package stores the port's
    dtypes (bf16 has no numpy dtype there). The free space on ``path``'s
    disk is checked first."""
    os.makedirs(path, exist_ok=True)
    state = qwen3_to_hf_state(params, cfg)
    need = sum(t.numel() * (4 if t.is_floating_point() else t.element_size())
               for t in state.values())
    free = shutil.disk_usage(path).free
    if need > free:
        raise OSError(f"{path}: the checkpoint needs {need / 1e9:.2f} GB and "
                      f"the disk has {free / 1e9:.2f} GB free")
    write_safetensors(os.path.join(path, "model.safetensors"), state,
                      metadata={"format": "pt"}, float_dtype=torch.float32)
    config = {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": "silu",
        "torch_dtype": "float32",
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
