"""Carry weights across from the JAX package: a ``molly_tpu`` param pytree
(``fusion.init_params``, ``qwen3.quantize_for_decode``, ...) whose leaves the
caller has already turned into numpy arrays becomes the port's params.

The port keeps the JAX layouts and names (stacked [L, ...] leaves, [in, out]
linears, ``{kernel, bias}`` projectors, ``{w_q, scale}`` int8 dicts — the
decode ones and the per-layer stacked int8 training base of
``quantize_for_training`` — the fused decode names ``qkv_proj`` /
``gateup_proj`` / ``qk_norm`` / ``lm_head_q``, and the ``"lora"`` subtree
``{"layers": {target: {a, b}}}``), so conversion is a tree map that only
changes the array type. ``opt_state_from_numpy`` does the same for Adam
moments given as numpy trees. bfloat16 leaves (numpy's ml_dtypes ``bfloat16``) cross as raw 16-bit
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


def opt_state_from_numpy(mu: Any, nu: Any, count: int, params: Any,
                         train_cfg) -> dict:
    """An optimizer state for ``training.trainer`` from Adam moments given
    as numpy trees shaped like ``params`` (frozen subtrees may be absent or
    hold anything: only the trainable leaves are read, in tree order, each
    onto its parameter's device and dtype)."""
    from ..training.trainer import trainable_mask

    mask = trainable_mask(params, train_cfg)

    def leaves(tree, like, out):
        if isinstance(like, dict):
            for k in like:
                leaves(tree[k], like[k], out)
        else:
            out.append(_to_tensor(np.asarray(tree), like.device).to(
                like.dtype))
        return out

    def any_true(m):
        return any(any_true(v) for v in m.values()) if isinstance(
            m, dict) else bool(m)

    def pick(tree):
        out = []
        for k in params:  # the mask is uniform under each top-level key
            if any_true(mask[k]):
                leaves(tree[k], params[k], out)
        return out

    return {"mu": pick(mu), "nu": pick(nu), "count": int(count)}
