"""Carry weights across from the JAX package: a ``molly_tpu`` param pytree
(``fusion.init_params``, ``qwen3.quantize_for_decode``, ...) whose leaves the
caller has already turned into numpy arrays becomes the port's params.

The port keeps the JAX layouts and names (stacked [L, ...] leaves, [in, out]
linears, ``{kernel, bias}`` projectors, ``{w_q, scale}`` int8 dicts, the
fused decode names ``qkv_proj`` / ``gateup_proj`` / ``qk_norm`` /
``lm_head_q``), so conversion is a tree map that only changes the array
type. bfloat16 leaves (numpy's ml_dtypes ``bfloat16``) cross as raw 16-bit
words. Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Map every numpy leaf of a nested dict to a torch tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return _to_tensor(tree, device)
    raise TypeError(f"params_from_jax: unsupported leaf {type(tree)!r}; "
                    f"apply np.asarray to every leaf first")
