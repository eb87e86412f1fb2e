"""Dropless top-k mixture-of-experts MLP, the counterpart of
``molly_tpu/ops/moe.py`` on one device (``moe_mlp_expert_sharded`` belongs
to the multi-device slice).

Design (sort + grouped matmul, not a capacity / one-hot dispatch):

  1. router: [T, H] x [H, E] -> softmax probs (fp32), top-k per token
  2. sort the T*k (token, choice) pairs by expert id (stable) -> contiguous
     per-expert groups whose sizes are data
  3. three grouped GEMMs (gate / up / down, ``ops.grouped_gemm``) run on
     the ragged groups: no [T, E, capacity] tensor exists and no token is
     dropped
  4. inverse-permute back to [T, k, H] and combine with the routing
     weights (a gather, not a scatter-add)

Nothing between the router and the combine reads a tensor on the host: the
group sizes stay on the device (``scatter_add_``, not ``bincount``, which
synchronizes on a card). The load-balance and router-z aux losses are
computed only when ``with_aux`` asks (the no-cache forward): an eager
decode tick would otherwise pay ~10 small ops a layer for values it drops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .grouped_gemm import grouped_gemm
from .lce import _mm
from .quant import quantize_int8


def quantize_experts(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stacked expert weights [..., E, K, N] -> int8 + per-(expert, column)
    fp32 scales [..., E, N]: the ``ops.quant`` weight-only scheme, stacked
    (the JAX package's layout, so the converter stays a tree map)."""
    return quantize_int8(w)


class _MmF32(torch.autograd.Function):
    """``ops.lce._mm`` (operands in their storage dtype, an fp32 result that
    is never rounded) with a backward: the card's
    ``torch.mm(..., out_dtype=float32)`` has no derivative of its own. The
    gradients are fp32 products, handed back in each operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.float32)
        da = (g @ b.to(torch.float32).T).to(a.dtype)
        db = (a.to(torch.float32).T @ g).to(b.dtype)
        return da, db


def _n_experts(w) -> int:
    return (w["w_q"] if isinstance(w, dict) else w).shape[0]


def _grouped_dot(lhs: torch.Tensor, rhs, group_sizes: torch.Tensor
                 ) -> torch.Tensor:
    """[M, K] x [G, K, N] with per-group row counts -> [M, N] fp32. rhs may
    be a ``quantize_experts`` dict: the kernel converts the int8 tiles as it
    loads them and applies the scale to its accumulator. Operands of two
    floating types promote, as in JAX; a bf16 lhs over an fp32 rhs (fp32
    adapters on a bf16 stream) goes to the kernel as it is, which widens it
    exactly (no fp32 copy), and its gradient comes back in bf16, rounded
    once as the cast's would be."""
    if isinstance(rhs, dict):
        return grouped_gemm(lhs, rhs["w_q"], group_sizes, scale=rhs["scale"])
    if lhs.dtype != rhs.dtype and not (lhs.dtype == torch.bfloat16
                                       and rhs.dtype == torch.float32):
        dt = torch.promote_types(lhs.dtype, rhs.dtype)
        lhs, rhs = lhs.to(dt), rhs.to(dt)
    return grouped_gemm(lhs, rhs, group_sizes)


def router_topk(x: torch.Tensor, router_w: torch.Tensor, k: int,
                norm_topk_prob: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Routing: (weights [T, k] fp32, expert ids [T, k], probs [T, E] fp32,
    logits [T, E] fp32). The product takes its operands in x's dtype and
    gives an fp32 result that is never rounded to bf16 (a rounded logit
    changes which experts run); the softmax is in fp32. ``torch.topk`` does
    not promise ``jax.lax.top_k``'s tie order (lower index first); ties do
    not occur with real-valued weights."""
    w = router_w.to(x.dtype)
    logits = x @ w if x.dtype == torch.float32 else _MmF32.apply(x, w)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    if norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    return topw, topi, probs, logits


def _lora_grouped(xs: torch.Tensor, ab, group_sizes: torch.Tensor,
                  scale: float, dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Grouped low-rank bypass: scale * (drop(xs) @ a_e) @ b_e with each
    row's own expert's adapter: two more grouped products over the same
    groups as the base GEMM (expert-stacked adapters, ``models.lora``)."""
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(xs.shape, generator=generator, device=xs.device,
                          dtype=torch.float32) < (1.0 - dropout_rate)
        xs = torch.where(keep, xs / (1.0 - dropout_rate),
                         torch.zeros((), dtype=xs.dtype, device=xs.device))
    t = _grouped_dot(xs, ab["a"], group_sizes)          # [M, r] fp32
    return scale * _grouped_dot(t.to(xs.dtype), ab["b"], group_sizes)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up, w_down, *,
            num_experts_per_tok: int, norm_topk_prob: bool = True,
            lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
            lora_scale: float = 1.0, lora_dropout: float = 0.0,
            generator_for=None, with_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Sparse SwiGLU FFN. x [T, H]; router_w [H, E]; w_gate / w_up
    [E, H, I]; w_down [E, I, H] -> (out [T, H] in x.dtype, aux-loss dict or
    None without ``with_aux``).

    Operands stay in their storage dtype for the grouped GEMMs, with fp32
    accumulation and fp32 results. The stacks may be ``quantize_experts``
    dicts. ``lora`` is an optional {"expert_gate" / "expert_up" /
    "expert_down": {"a" [E, d, r], "b" [E, r, d]}} adapter dict;
    ``generator_for`` maps a target name to its dropout generator.

    ``w_up=None`` means ``w_gate`` is a FUSED [E, H, 2I] gate-and-up stack
    (``qwen3.quantize_for_decode``): one grouped GEMM instead of two. Fused
    stacks are post-merge serving weights; adapters are not applied."""
    T, H = x.shape
    E = _n_experts(w_gate)
    k = num_experts_per_tok
    topw, topi, probs, logits = router_topk(x, router_w, k, norm_topk_prob)

    flat_e = topi.reshape(T * k)               # expert id per (token, choice)
    # stable, so the sorted row order (and with it the order in which the
    # weight gradient sums a group's rows) is defined
    order = torch.sort(flat_e, stable=True).indices
    tok = order // k                           # source token per sorted row
    xs = x[tok]                                # [T*k, H] gathered operands
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    group_sizes = counts.to(torch.int32)

    lora = lora or {}

    def bypass(base, inp, name):
        if name not in lora:
            return base
        gen = generator_for(name) if generator_for is not None else None
        return base + _lora_grouped(inp, lora[name], group_sizes, lora_scale,
                                    lora_dropout, gen)

    if w_up is None:  # fused gate-and-up stack
        assert not lora, "fused expert stacks are post-merge (no adapters)"
        gu = _grouped_dot(xs, w_gate, group_sizes)      # [T*k, 2I] fp32
        g, u = gu.chunk(2, dim=-1)
    else:
        g = bypass(_grouped_dot(xs, w_gate, group_sizes), xs, "expert_gate")
        u = bypass(_grouped_dot(xs, w_up, group_sizes), xs, "expert_up")
    h = (F.silu(g) * u).to(x.dtype)
    y = bypass(_grouped_dot(h, w_down, group_sizes), h,
               "expert_down")                           # [T*k, H] fp32

    # combine: inverse permutation (a gather) back to (token, choice) order,
    # weight, and sum the k choices in fp32
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    y = y[inv].reshape(T, k, H)
    out = (y * topw.to(y.dtype)[..., None]).sum(dim=1).to(x.dtype)
    if not with_aux:
        return out, None

    # Switch-Transformer load-balance loss: E * sum_e f_e * P_e with f_e the
    # fraction of routed (token, choice) pairs on expert e and P_e the mean
    # router prob; 1.0 at perfect balance
    f = counts.to(torch.float32) / (T * k)
    lb = E * (f * probs.mean(dim=0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out, {"load_balance": lb, "router_z": z}


def moe_mlp_reference(x, router_w, w_gate, w_up, w_down, *,
                      num_experts_per_tok, norm_topk_prob=True):
    """Naive dense reference (every expert on every token, masked combine):
    O(T * E) compute; a test oracle only."""
    topw, topi, _, _ = router_topk(x, router_w, num_experts_per_tok,
                                   norm_topk_prob)
    E = w_gate.shape[0]
    xf = x.to(torch.float32)
    g = torch.einsum("th,ehi->eti", xf, w_gate.to(torch.float32))
    u = torch.einsum("th,ehi->eti", xf, w_up.to(torch.float32))
    h = (F.silu(g) * u).to(x.dtype).to(torch.float32)
    ys = torch.einsum("eti,eih->eth", h, w_down.to(torch.float32))
    onehot = F.one_hot(topi, E).to(torch.float32)        # [T, k, E]
    w_e = (onehot * topw[..., None]).sum(dim=1)          # [T, E]
    return torch.einsum("eth,te->th", ys, w_e).to(x.dtype)
