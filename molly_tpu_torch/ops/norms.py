"""Normalization ops, the counterpart of ``molly_tpu/ops/norms.py``.

``rms_norm`` goes through the RMSNorm kernel's wrapper
(``ops/rmsnorm_triton.py``): the Triton kernel on a CUDA tensor, its plain
version on a CPU tensor. ``layer_norm`` is plain PyTorch, as it is plain XLA
in the JAX package.
"""

from __future__ import annotations

import torch

# RMSNorm matching HF Qwen3RMSNorm (fp32 accumulation, weight applied after
# the cast back to the input dtype); weight [H] or stacked per head
from .rmsnorm_triton import rms_norm  # noqa: F401


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm matching torch.nn.LayerNorm (fp32 stats)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (xf.to(dtype) * weight + bias).to(dtype)
