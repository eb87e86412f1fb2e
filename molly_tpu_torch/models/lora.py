"""LoRA adapters as a factored-param dict (PEFT-equivalent), the counterpart
of ``molly_tpu/models/lora.py``.

Recipe: every Linear of the Qwen3 decoder except the lm head (q/k/v/o,
gate/up/down), alpha = 64, dropout 0.05, gaussian-init A, zero-init B,
frozen encoders, trainable projectors.

Representation: ``lora["layers"][target] = {"a": [L, d_in, r],
"b": [L, r, d_out]}`` — stacked on the layer axis like the base params.
Effective weight is ``W + (alpha/r) * a @ b``; applied as the low-rank
bypass ``y = x@W + scale * (drop(x) @ a) @ b`` (never materializes W + dW).
The bypass products are plain ``torch.matmul``, as they are plain XLA there.

Not ported yet (they belong to serving and MoE): the per-row adapter bank
lookup (``lora_slots``) and the expert-stacked targets; the functions
assert that they are absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .configs import Qwen3Config

LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 64.0
    dropout: float = 0.05
    targets: tuple = LORA_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def target_dims(cfg: Qwen3Config) -> Dict[str, tuple]:
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "q_proj": (H, cfg.q_dim),
        "k_proj": (H, cfg.kv_dim),
        "v_proj": (H, cfg.kv_dim),
        "o_proj": (cfg.q_dim, H),
        "gate_proj": (H, I),
        "up_proj": (H, I),
        "down_proj": (I, H),
    }


def init_lora(cfg: Qwen3Config, lora_cfg: LoraConfig,
              generator: torch.Generator, dtype=torch.float32,
              device="cpu") -> Dict[str, Any]:
    """Gaussian A (std 1/r, PEFT's init_lora_weights='gaussian'), zero B.
    ``generator`` must live on ``device``."""
    assert not cfg.num_experts, "expert LoRA targets are not ported yet"
    dims = target_dims(cfg)
    L, r = cfg.num_hidden_layers, lora_cfg.r
    layers = {}
    for name in lora_cfg.targets:
        assert name in dims, f"unknown or unported LoRA target {name!r}"
        d_in, d_out = dims[name]
        a = torch.randn((L, d_in, r), generator=generator,
                        dtype=torch.float32, device=device)
        layers[name] = {
            "a": (a / r).to(dtype),
            "b": torch.zeros((L, r, d_out), dtype=dtype, device=device),
        }
    return {"layers": layers}


def apply_lora(x: torch.Tensor, base_out: torch.Tensor,
               lora_layer: Optional[Dict[str, torch.Tensor]], scale: float,
               dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None,
               lora_slots=None) -> torch.Tensor:
    """base_out = x @ W already computed; adds the low-rank bypass. Dropout
    on the bypass input draws its keep mask from ``generator`` (on x's
    device); no generator, no dropout."""
    assert lora_slots is None, "multi-LoRA banks are not ported yet"
    if lora_layer is None:
        return base_out
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < (1.0 - dropout_rate)
        x = torch.where(keep, x / (1.0 - dropout_rate),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    a, b = lora_layer["a"], lora_layer["b"]
    if x.dtype != a.dtype:  # fp32 adapters on a bf16 stream promote, as in JAX
        x = x.to(torch.promote_types(x.dtype, a.dtype))
    delta = (x @ a.to(x.dtype)) @ b.to(x.dtype)
    return base_out + scale * delta.to(base_out.dtype)


def apply_lora_fused(x: torch.Tensor, fused_out: torch.Tensor,
                     lora_layer: Dict[str, Dict[str, torch.Tensor]],
                     parts, scale: float, dropout_rate: float = 0.0,
                     generator_for: Optional[Callable[[str], Any]] = None,
                     lora_slots=None) -> torch.Tensor:
    """Low-rank bypass around a FUSED projection (qkv_proj / gateup_proj):
    each target's delta — computed from the SAME input x — lands on its own
    column slice of the fused output.

    parts: ((target_name, width), ...) covering fused_out's last dim in
    order. Targets absent from ``lora_layer`` contribute zero columns.
    generator_for: optional callable name -> dropout generator."""
    deltas = []
    any_hit = False
    lead = fused_out.shape[:-1]
    for name, width in parts:
        zeros = torch.zeros(lead + (width,), dtype=fused_out.dtype,
                            device=fused_out.device)
        ab = lora_layer.get(name)
        if ab is None:
            deltas.append(zeros)
            continue
        any_hit = True
        gen = generator_for(name) if generator_for is not None else None
        deltas.append(apply_lora(x, zeros, ab, scale, dropout_rate, gen,
                                 lora_slots=lora_slots))
    if not any_hit:
        return fused_out
    return fused_out + torch.cat(deltas, dim=-1)


def stack_adapters(adapters, scales=None) -> Dict[str, Any]:
    """Stack N unmerged adapters into a multi-LoRA bank: {"layers": {t:
    {"a": [L, N+1, d, r], "b": [L, N+1, r, o]}}}; index 0 is the BASE MODEL
    (zero delta), adapter i lives at index i+1. Per-adapter scale is folded
    into the stacked ``b`` so the bank applies with scale 1.0."""
    assert adapters, "need at least one adapter"
    targets = sorted(adapters[0]["layers"])
    scales = scales or [1.0] * len(adapters)
    layers: Dict[str, Any] = {}
    for t in targets:
        a0 = adapters[0]["layers"][t]["a"]
        assert a0.ndim == 3, "multi-LoRA bank supports dense targets only"
        ab_a = [torch.zeros_like(a0)]
        ab_b = [torch.zeros_like(adapters[0]["layers"][t]["b"])]
        for ad, sc in zip(adapters, scales):
            assert sorted(ad["layers"]) == targets, "target sets differ"
            assert ad["layers"][t]["a"].shape == a0.shape, (
                f"rank/shape mismatch on {t}")
            ab_a.append(ad["layers"][t]["a"])
            ab_b.append(ad["layers"][t]["b"] * sc)
        layers[t] = {"a": torch.stack(ab_a, dim=1),
                     "b": torch.stack(ab_b, dim=1)}
    return {"layers": layers}


def merge_lora(params: Dict[str, Any], lora: Dict[str, Any],
               lora_cfg: LoraConfig) -> Dict[str, Any]:
    """Fold adapters into the base weights of a decoder param dict (for
    export / fast inference), PEFT's merge_and_unload. An int8 base
    (``quantize_for_training``) is dequantized, merged, and handed back as a
    dense weight in the model dtype."""
    out = dict(params)
    new_layers = dict(out["layers"])
    for name, ab in lora["layers"].items():
        assert ab["a"].ndim == 3, "expert LoRA targets are not ported yet"
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * lora_cfg.scale
        base = new_layers[name]
        if isinstance(base, dict) and "w_q" in base:
            dense = base["w_q"].float() * base["scale"][..., None, :]
            new_layers[name] = (dense + delta).to(params["embed"].dtype)
        else:
            new_layers[name] = (base.float() + delta).to(base.dtype)
    out["layers"] = new_layers
    return out
