"""Dropless top-k mixture-of-experts MLP, and its expert-parallel form
(``moe_mlp_expert_sharded``): the counterpart of ``molly_tpu/ops/moe.py``.

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
Under a mesh whose batch axes hold other tokens they are the global batch's
(``_aux_losses``), as GSPMD computes them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..parallel.sharding import BATCH_AXES, SEQ_AXIS
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
                norm_topk_prob: bool = True, scoring: str = "softmax",
                correction_bias: Optional[torch.Tensor] = None,
                routed_scale: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Routing: (weights [T, k] fp32, expert ids [T, k], probs [T, E] fp32,
    logits [T, E] fp32). The product takes its operands in x's dtype and
    gives an fp32 result that is never rounded to bf16 (a rounded logit
    changes which experts run); the softmax is in fp32. ``torch.topk`` does
    not promise ``jax.lax.top_k``'s tie order (lower index first); ties do
    not occur with real-valued weights.

    ``scoring="sigmoid"`` is DeepSeek-V3's router (``topk_method``
    ``noaux_tc`` with one group; no JAX original): probs are the sigmoid
    scores, the k experts are those of the highest score +
    ``correction_bias`` [E] (the bias steers the choice only), their
    weights the unbiased scores, normalised (with HF's 1e-20 in the
    denominator) under ``norm_topk_prob``, times ``routed_scale``."""
    w = router_w.to(x.dtype)
    logits = x @ w if x.dtype == torch.float32 else _MmF32.apply(x, w)
    if scoring == "sigmoid":
        probs = torch.sigmoid(logits.to(torch.float32))
        choice = probs if correction_bias is None else probs + correction_bias
        topi = torch.topk(choice, k, dim=-1).indices
        topw = probs.gather(-1, topi)
        if norm_topk_prob:
            topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
        return topw * routed_scale, topi, probs, logits
    if scoring != "softmax":
        raise ValueError(f"router_topk: scoring {scoring!r}")
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
    T = x.shape[0]
    E = _n_experts(w_gate)
    k = num_experts_per_tok
    topw, topi, probs, logits = router_topk(x, router_w, k, norm_topk_prob)
    out, counts = moe_experts(x, topw, topi, w_gate, w_up, w_down, lora=lora,
                              lora_scale=lora_scale,
                              lora_dropout=lora_dropout,
                              generator_for=generator_for)
    if not with_aux:
        return out, None
    return out, _aux_losses(counts, probs, logits, T, k, E)


def moe_experts(x: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                w_gate, w_up, w_down, *,
                lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                lora_scale: float = 1.0, lora_dropout: float = 0.0,
                generator_for=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_mlp`` after its router: x [T, H] through the experts of the
    routing ``topi`` [T, k], combined with the weights ``topw`` [T, k] fp32
    -> (out [T, H] in x.dtype, rows per expert [E] int64 on the device).
    The stacks and ``lora`` are as ``moe_mlp`` takes them."""
    T, H = x.shape
    E = _n_experts(w_gate)
    k = topi.shape[1]
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
    return out, counts


def _aux_losses(counts, probs, logits, T: int, k: int, E: int
                ) -> Dict[str, torch.Tensor]:
    """Switch-Transformer load-balance loss E * sum_e f_e * P_e (f_e the
    fraction of routed (token, choice) pairs on expert e, P_e the mean
    router prob; 1.0 at perfect balance) and the router z-loss. Under a mesh
    whose batch axes hold other tokens, both are the global batch's: the
    counts, prob sums and z sums are summed over those axes (the prob and z
    sums with their gradients), every rank holding as many tokens."""
    mesh = comm.current_mesh()
    group = mesh.group(*BATCH_AXES) if mesh is not None else None
    lse2 = torch.logsumexp(logits, dim=-1).square()
    if group is None:
        f = counts.to(torch.float32) / (T * k)
        lb = E * (f * probs.mean(dim=0)).sum()
        return {"load_balance": lb, "router_z": lse2.mean()}
    n_tok = T * mesh.size(*BATCH_AXES)
    f = comm.all_reduce(counts, group).to(torch.float32) / (n_tok * k)
    p_mean = comm.all_reduce_sum(probs.sum(dim=0), group) / n_tok
    z = comm.all_reduce_sum(lse2.sum(), group) / n_tok
    return {"load_balance": E * (f * p_mean).sum(), "router_z": z}


def _split_gateup(w):
    """A fused [E, H, 2I] gate-and-up stack (or its int8 dict) back into
    its gate and up halves."""
    if isinstance(w, dict):
        wq, sc = w["w_q"].chunk(2, dim=-1), w["scale"].chunk(2, dim=-1)
        return ({"w_q": wq[0], "scale": sc[0]},
                {"w_q": wq[1], "scale": sc[1]})
    return w.chunk(2, dim=-1)


def _global_routing(topi: torch.Tensor, mesh, batch_axes, seq_len
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global batch's expert ids [T_g, k], the global index [T] of each
    of this rank's tokens). ``topi`` [T, k] holds this rank's share of the
    tokens over ``batch_axes``: rows of the (data, fsdp) coordinate's block
    and, on a ``seq`` axis, the coordinate's part of each row's
    ``seq_len``-token sequence. The global order is JAX's: row-major over
    the whole batch [B_g, S_g], flattened."""
    T, k = topi.shape
    own = torch.arange(T, device=topi.device)
    bgroup = mesh.group(*batch_axes) if batch_axes else None
    if bgroup is None:
        return topi, own
    n_s = mesh.size(SEQ_AXIS) if SEQ_AXIS in batch_axes else 1
    n_r = mesh.size(*batch_axes) // n_s
    S = seq_len if n_s > 1 else T
    B = T // S
    # group order: the row coordinate major, the seq coordinate minor
    topi_g = comm.all_gather(topi, 0, bgroup).reshape(
        n_r, n_s, B, S, k).transpose(1, 2).reshape(-1, k)
    r = mesh.index(*(a for a in batch_axes if a != SEQ_AXIS))
    j = mesh.index(SEQ_AXIS) if n_s > 1 else 0
    return topi_g, ((r * B + own // S) * n_s + j) * S + own % S


def moe_mlp_expert_sharded(
        x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up, w_down, *,
        num_experts_per_tok: int, norm_topk_prob: bool = True,
        capacity_factor: float = 2.0, axis_name: str = "expert",
        batch_axes: Tuple[str, ...] = (), seq_len: Optional[int] = None,
        lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        lora_scale: float = 1.0, lora_dropout: float = 0.0,
        generator_for=None, with_aux: bool = True
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Expert-parallel MoE MLP over the current mesh's ``axis_name``: the
    weights stay on their ranks, never gathered.

    ``x`` [T, H] and ``router_w`` are the same on every rank of the axis;
    ``w_gate`` / ``w_up`` [E/n, H, I], ``w_down`` [E/n, I, H] (or their int8
    dicts) and the expert adapters in ``lora`` are this rank's block of
    E/n experts (rank i holds experts i*E/n ..). The plan of the JAX
    package's shard_map:
      - routing is replicated math (tiny [T, E] tensors);
      - each rank compacts the (token, choice) pairs routed to ITS experts,
        grouped by expert in a stable sort, into a buffer of
        C = min(ceil(T * k * capacity_factor / n), T * k) rows (overflow
        rows are dropped: ``ep_dropped_frac`` counts them);
      - local grouped GEMMs over the C-row buffer (rows past the group
        sizes come out zero);
      - one all-reduce of the [T, H] partial outputs (identity backward:
        ``comm.reduce_from``); the replicated ``x`` and routing weights sum
        their gradients over the axis (``comm.reduce_grad``), so the
        router's gradient is the whole one on every rank.

    ``batch_axes`` names the mesh axes over which ``x`` holds only this
    rank's share of the tokens (the training forward: ``BATCH_AXES``).
    JAX's shard_map is manual over ``axis_name`` alone, so its T is the
    global batch's; here too the capacity, the pairs that overflow and
    ``ep_dropped_frac`` are the global batch's, from every rank's expert
    ids (one all-gather of the [T, k] ids), and each rank runs the kept
    pairs of its own tokens, in the global buffer's order, through a buffer
    of min(C, T * k) rows. ``seq_len``: ``x`` is [rows, seq_len] flattened,
    needed when a ``seq`` axis is among ``batch_axes``.

    With one rank on the axis (or no mesh) this is ``moe_mlp`` plus a zero
    ``ep_dropped_frac``. A fused gate-and-up stack is split back first."""
    mesh = comm.current_mesh()
    n_dev = mesh.size(axis_name) if mesh is not None else 1
    kw = dict(num_experts_per_tok=num_experts_per_tok,
              norm_topk_prob=norm_topk_prob, lora=lora,
              lora_scale=lora_scale, lora_dropout=lora_dropout,
              generator_for=generator_for, with_aux=with_aux)
    if n_dev <= 1:
        out, aux = moe_mlp(x, router_w, w_gate, w_up, w_down, **kw)
        if aux is not None:
            aux["ep_dropped_frac"] = torch.zeros((), dtype=torch.float32,
                                                 device=x.device)
        return out, aux
    if w_up is None:
        w_gate, w_up = _split_gateup(w_gate)
    group = mesh.group(axis_name)
    T, H = x.shape
    E_l = _n_experts(w_gate)
    E = E_l * n_dev
    k = num_experts_per_tok
    dev = x.device
    topw, topi, probs, logits = router_topk(x, router_w, k, norm_topk_prob)
    x_r = comm.reduce_grad(x, group)
    topw_r = comm.reduce_grad(topw, group)

    topi_g, gidx = _global_routing(topi, mesh, batch_axes, seq_len)
    T_g = topi_g.shape[0]
    C = int(min(max(math.ceil(T_g * k * capacity_factor / n_dev), 1),
                T_g * k))
    flat_e = topi_g.reshape(T_g * k) - mesh.index(axis_name) * E_l
    local = (flat_e >= 0) & (flat_e < E_l)
    key = torch.where(local, flat_e, torch.full_like(flat_e, E_l))
    # stable, as jnp.argsort: which rows overflow the buffer is defined
    sel = torch.sort(key, stable=True).indices[:C]
    sizes0 = torch.zeros(E_l + 1, dtype=torch.int64,
                         device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:E_l]
    cum = torch.cumsum(sizes0, dim=0).clamp(max=C)
    dropped = comm.all_reduce(sizes0.sum() - cum[-1], group)
    # this rank's tokens among the kept pairs, compacted in buffer order
    # (so still grouped by expert); the rest go to a dump slot
    owner = torch.full((T_g,), -1, dtype=torch.int64, device=dev)
    owner[gidx] = torch.arange(T, device=dev)
    lt = owner[sel // k]
    mine = local[sel] & (lt >= 0)
    C_l = min(C, T * k)
    slot = torch.where(mine, torch.cumsum(mine, dim=0) - 1,
                       torch.full_like(sel, C_l))
    pair = torch.full((C_l + 1,), T * k, dtype=torch.int64,
                      device=dev).index_put_((slot,), lt * k + sel % k)[:C_l]
    valid = pair < T * k
    e_of = torch.where(mine, key[sel], torch.full_like(sel, E_l))
    sizes = torch.zeros(E_l + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, e_of, torch.ones_like(e_of))[:E_l].to(torch.int32)
    pc = torch.where(valid, pair, torch.zeros_like(pair))
    xs = x_r[pc // k] * valid[:, None].to(x.dtype)

    lora = lora or {}

    def bypass(base, inp, name):
        if name not in lora:
            return base
        gen = generator_for(name) if generator_for is not None else None
        return base + _lora_grouped(inp, lora[name], sizes, lora_scale,
                                    lora_dropout, gen)

    g = bypass(_grouped_dot(xs, w_gate, sizes), xs, "expert_gate")
    u = bypass(_grouped_dot(xs, w_up, sizes), xs, "expert_up")
    h = (F.silu(g) * u).to(x.dtype)
    y = bypass(_grouped_dot(h, w_down, sizes), h, "expert_down")
    w_sel = topw_r.reshape(T * k)[pc] * valid
    # each kept row back to its (token, choice) slot (the slots are
    # distinct; the empty rows all land in the dropped last row), then the
    # k choices summed in fp32 as moe_mlp does
    pairs = y.new_zeros((T * k + 1, H)).index_put(
        (pair,), y * w_sel[:, None].to(y.dtype))[:T * k]
    out = comm.reduce_from(pairs.reshape(T, k, H).sum(dim=1), group)
    if not with_aux:
        return out.to(x.dtype), None
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, topi.reshape(T * k), torch.ones_like(topi.reshape(T * k)))
    aux = _aux_losses(counts, probs, logits, T, k, E)
    aux["ep_dropped_frac"] = dropped.to(torch.float32) / (T_g * k)
    return out.to(x.dtype), aux


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
