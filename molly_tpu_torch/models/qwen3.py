"""Qwen3 decoder (dense, and the Qwen3-MoE family) in PyTorch, the
counterpart of ``molly_tpu/models/qwen3.py``.

Params keep the JAX layout so the converter (``models.convert``) is a plain
tree map: every layer weight is STACKED on a leading [L, ...] axis, linear
weights are [in, out], int8 weights are ``{w_q, scale}`` dicts. Where JAX
scans over layers, this is a Python loop over the stacked weights. The KV
cache is the same single head-major array [L, B, Nkv, Smax, 2*Dh] (k ‖ v
on the minor dim); where JAX threads it functionally through the scan,
here each layer writes its new rows into it in place. The training side
(LoRA bypasses, remat, the int8 QLoRA base) rides the same ``_layer``.

With ``cfg.num_experts > 0`` every layer's MLP is the dropless top-k sparse
FFN of ``ops.moe`` over expert stacks ``expert_gate`` / ``expert_up``
[L, E, H, I] and ``expert_down`` [L, E, I, H] behind an fp32 ``router``
[L, H, E]; the no-cache forward hands the router's aux losses back in its
second slot.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import moe, quant
from ..ops.attention import dot_product_attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import PAGED_QUANT_MAX, paged_attention
from ..ops.rope import apply_rope, rope_cos_sin
from .configs import Qwen3Config
from .lora import apply_lora, apply_lora_fused

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_params(cfg: Qwen3Config, generator: torch.Generator,
                device="cpu") -> Params:
    """Random init, normal(0.02) like HF, drawn from ``generator`` (which
    must live on ``device``). Real runs convert a checkpoint instead."""
    dt = torch_dtype(cfg.dtype)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    Dq, Dkv, Dh = cfg.q_dim, cfg.kv_dim, cfg.head_dim

    def norm(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def lin(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(0.02).to(dt)

    def lin_stack(*shape):
        # an expert stack is drawn layer by layer into its preallocated
        # leaf: the fp32 draw of a whole [48, 128, 2048, 768] leaf would be
        # 38.7 GB beside its 19.3 GB bf16 copy
        out = torch.empty(shape, dtype=dt, device=device)
        for li in range(shape[0]):
            out[li] = lin(*shape[1:])
        return out

    params: Params = {
        "embed": lin(cfg.vocab_size, H),
        "layers": {
            "input_norm": norm(L, H),
            "post_attn_norm": norm(L, H),
            "q_proj": lin(L, H, Dq),
            "k_proj": lin(L, H, Dkv),
            "v_proj": lin(L, H, Dkv),
            "o_proj": lin(L, Dq, H),
            "q_norm": norm(L, Dh),
            "k_norm": norm(L, Dh),
        },
        "final_norm": norm(H),
    }
    lp = params["layers"]
    if cfg.num_experts:
        E = cfg.num_experts
        # router in fp32 (tiny; top-k is precision-sensitive), experts
        # stacked [L, E, H, I]
        lp["router"] = lin(L, H, E).to(torch.float32)
        lp["expert_gate"] = lin_stack(L, E, H, I)
        lp["expert_up"] = lin_stack(L, E, H, I)
        lp["expert_down"] = lin_stack(L, E, I, H)
    else:
        lp["gate_proj"] = lin(L, H, I)
        lp["up_proj"] = lin(L, H, I)
        lp["down_proj"] = lin(L, I, H)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(H, cfg.vocab_size)
    return params


def init_cache(cfg: Qwen3Config, batch: int, max_len: int, device="cpu",
               dtype=None, quant: Optional[str] = None
               ) -> Dict[str, torch.Tensor]:
    """Dense KV cache: ONE head-major array [L, B, Nkv, Smax, 2*Dh] with
    k ‖ v on the minor dim, in the model dtype.

    quant="int8": K/V are stored as int8 with one symmetric scale per
    (layer, row, head, column, k|v half) in ``kv_scale`` [..., Smax, 2].
    The scales factor out of both attention products (the k scale multiplies
    the logit column, the v scale folds into the softmax weights), so the
    products read the int8 values directly (``ops.attention``)."""
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
             max_len, 2 * cfg.head_dim)
    if quant == "int8":
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "kv_scale": torch.zeros(shape[:-1] + (2,),
                                        dtype=torch.float32, device=device)}
    assert quant is None, quant
    return {"kv": torch.zeros(shape, dtype=dt, device=device)}


def quantize_kv(kv_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, head, column, k|v-half) int8 quantization of
    fresh KV rows [..., S, 2*Dh] -> (int8 same shape, scales [..., S, 2])."""
    lead, two_dh = kv_new.shape[:-1], kv_new.shape[-1]
    halves = kv_new.float().reshape(lead + (2, two_dh // 2))
    scale = halves.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q8 = torch.round(halves / scale[..., None]).clamp(-127, 127)
    return q8.to(torch.int8).reshape(lead + (two_dh,)), scale


def quantize_page_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (Dh) dim in the paged kernel's
    convention: returns (int8 same shape, scales [..., 1] fp32) with
    dequant = w * scale / 127.5."""
    xf = x.float()
    h = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    w = torch.round(xf * (PAGED_QUANT_MAX / h)).clamp(-127, 127)
    return w.to(torch.int8), h


def _unstack_layers(lp: Params, n_layers: int):
    """The stacked [L, ...] weights as a list of L per-layer dicts. One
    ``unbind`` per leaf, so autograd stacks the L slice gradients once
    (indexing ``w[i]`` layer by layer would add a full-size zero-padded
    gradient into the stacked leaf L times)."""
    def unbind(w):
        if isinstance(w, dict):
            parts = {k: t.unbind(0) for k, t in w.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        return w.unbind(0)

    cols = {name: unbind(w) for name, w in lp.items()}
    return [{name: cols[name][i] for name in cols} for i in range(n_layers)]


def _generator_for(seeds, device):
    """name -> a fresh generator seeded for that LoRA target's dropout mask
    (or None). Seeding per (layer, target) keeps the masks the same when a
    checkpointed layer runs again in the backward pass."""
    if seeds is None:
        return lambda name: None

    def make(name):
        return torch.Generator(device=device).manual_seed(seeds[name])

    return make


def _attn_inputs(cfg: Qwen3Config, hidden, p, cos, sin, lora_layer=None,
                 lora_scale=1.0, lora_dropout=0.0, seeds=None,
                 lora_slots=None):
    """The part of a layer before attention: (q, k, v), q/k normed and
    rotated. lora_slots: [B] per-row adapter index into a stacked bank
    (multi-LoRA serving), or None."""
    B, S, H = hidden.shape
    Nq, Nkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    gen_for = _generator_for(seeds, hidden.device)

    x = rms_norm(hidden, p["input_norm"], cfg.rms_norm_eps)
    if "qkv_proj" in p:  # fused decode weights (quantize_for_decode)
        # q‖k stay contiguous out of the fused product, so the per-head-dim
        # q/k RMSNorm and RoPE run once each over [B, S, Nq+Nkv, Dh] with
        # the stacked qk_norm weights
        qkv = quant.linear(x, p["qkv_proj"])
        if lora_layer is not None:
            qkv = apply_lora_fused(
                x, qkv, lora_layer,
                (("q_proj", cfg.q_dim), ("k_proj", cfg.kv_dim),
                 ("v_proj", cfg.kv_dim)), lora_scale, lora_dropout, gen_for,
                lora_slots=lora_slots)
        qk = qkv[..., : cfg.q_dim + cfg.kv_dim].reshape(B, S, Nq + Nkv, Dh)
        v = qkv[..., cfg.q_dim + cfg.kv_dim:].reshape(B, S, Nkv, Dh)
        qk = rms_norm(qk, p["qk_norm"], cfg.rms_norm_eps)
        qk = apply_rope(qk, cos, sin)
        return qk[:, :, :Nq], qk[:, :, Nq:], v

    def proj(name):
        ll = lora_layer.get(name) if lora_layer is not None else None
        return apply_lora(x, quant.linear(x, p[name]), ll, lora_scale,
                          lora_dropout, gen_for(name), lora_slots=lora_slots)

    q = proj("q_proj").reshape(B, S, Nq, Dh)
    kk = proj("k_proj").reshape(B, S, Nkv, Dh)
    v = proj("v_proj").reshape(B, S, Nkv, Dh)
    # Qwen3 applies RMSNorm on the head dim of q/k before RoPE
    q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
    kk = rms_norm(kk, p["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), v


EXPERT_STACKS = ("expert_gate", "expert_up", "expert_down")


def _layer_tail(cfg: Qwen3Config, hidden, attn, p, lora_layer=None,
                lora_scale=1.0, lora_dropout=0.0, seeds=None,
                lora_slots=None, with_aux: bool = False):
    """The part of a layer after attention: output projection, residual,
    MLP (dense or sparse), residual. Returns (hidden, aux): aux is the
    [load_balance, router_z] pair of a sparse layer when ``with_aux`` asks
    for it (the no-cache forward), else None."""
    B, S, H = hidden.shape
    gen_for = _generator_for(seeds, hidden.device)

    def proj(x, name):
        ll = lora_layer.get(name) if lora_layer is not None else None
        return apply_lora(x, quant.linear(x, p[name]), ll, lora_scale,
                          lora_dropout, gen_for(name), lora_slots=lora_slots)

    hidden = hidden + proj(attn.reshape(B, S, -1), "o_proj")
    x = rms_norm(hidden, p["post_attn_norm"], cfg.rms_norm_eps)
    if "router" in p:  # sparse MoE FFN (dropless top-k, ops.moe)
        if cfg.expert_parallel:
            raise NotImplementedError(
                "expert_parallel (moe_mlp_expert_sharded over an expert "
                "mesh axis) is not ported: ROADMAP.md queue 1 item 11")
        moe_lora = None
        if lora_layer is not None:
            moe_lora = {k: lora_layer[k] for k in EXPERT_STACKS
                        if k in lora_layer} or None
        if "expert_gateup" in p:  # fused decode stack (w_up=None)
            wg, wu = p["expert_gateup"], None
            moe_lora = None  # serving weights are post-merge
        else:
            wg, wu = p["expert_gate"], p["expert_up"]
        out2d, aux = moe.moe_mlp(
            x.reshape(B * S, H), p["router"], wg, wu, p["expert_down"],
            num_experts_per_tok=cfg.num_experts_per_tok,
            norm_topk_prob=cfg.norm_topk_prob, lora=moe_lora,
            lora_scale=lora_scale, lora_dropout=lora_dropout,
            generator_for=gen_for, with_aux=with_aux)
        if aux is not None:
            aux = torch.stack([aux["load_balance"], aux["router_z"]])
        return hidden + out2d.reshape(B, S, H), aux
    if "gateup_proj" in p:  # fused decode weights
        gu = quant.linear(x, p["gateup_proj"])
        if lora_layer is not None:
            I = gu.shape[-1] // 2
            gu = apply_lora_fused(x, gu, lora_layer,
                                  (("gate_proj", I), ("up_proj", I)),
                                  lora_scale, lora_dropout, gen_for,
                                  lora_slots=lora_slots)
        gate, up = gu.chunk(2, dim=-1)
    else:
        gate, up = proj(x, "gate_proj"), proj(x, "up_proj")
    return hidden + proj(F.silu(gate) * up, "down_proj"), None


class PagedCache(NamedTuple):
    """One layer's view of a paged KV pool (``ops.paged_attention``; the
    pool and its allocator live in ``inference.paged``). All layers share
    ONE page space: page p of layer li lives at pool row
    ``li * pages_per_layer + p``, and the LAST pool row is a scratch page
    that absorbs the writes of inactive slots. ``forward_hidden`` does the
    index arithmetic once per step for all layers (``paged_layer_views``);
    a layer only stores and attends."""
    k_pages: torch.Tensor    # [Nkv, L * pages_per_layer + 1, P, Dh]
    v_pages: torch.Tensor
    table: torch.Tensor      # [B, pages_per_seq] int32, this layer's rows
    lengths: torch.Tensor    # [B] int32: attend over positions [0, len)
    write_page: torch.Tensor  # [B] pool row of this step's token
    write_off: torch.Tensor   # [B] its offset in that page
    # int8 pools: per-(head, page, offset) symmetric scales (|max| over the
    # Dh row, dequant = w * scale / 127.5), stored once per row; None for
    # pools in the model dtype
    k_scales: Optional[torch.Tensor] = None  # [Nkv, rows, P] fp32
    v_scales: Optional[torch.Tensor] = None


def paged_layer_views(cache: Dict[str, torch.Tensor], n_layers: int,
                      cache_index: torch.Tensor):
    """Every layer's ``PagedCache`` for one decode step. cache_index [B] is
    each slot's write POSITION (= tokens already held); < 0 marks an
    inactive slot, whose row goes to the scratch page. The page table holds
    layer-relative ids; no two active slots share a writable page (the
    allocator's invariant), while several inactive slots all write the
    scratch row, which nothing reads."""
    kp, table = cache["k_pages"], cache["page_table"]
    rows, P = kp.shape[1], kp.shape[2]
    idx = cache_index.long()
    live = idx >= 0
    safe = idx.clamp(min=0)
    page_of = table.gather(1, (safe // P)[:, None])[:, 0]
    layer0 = (torch.arange(n_layers, device=kp.device, dtype=table.dtype)
              * ((rows - 1) // n_layers))
    write_pages = torch.where(live, layer0[:, None] + page_of,
                              rows - 1).long()                  # [L, B]
    write_off = torch.where(live, safe % P, 0)
    tables = layer0[:, None, None] + table                      # [L, B, pps]
    return [PagedCache(kp, cache["v_pages"], tables[li], cache["lengths"],
                       write_pages[li], write_off, cache.get("k_scales"),
                       cache.get("v_scales")) for li in range(n_layers)]


def _paged_write_and_attend(cfg: Qwen3Config, q, kk, v, pc: PagedCache):
    """Paged decode (S == 1): store this token's K/V row of every slot in
    the slot's current page, in place, then attend over the slot's page
    chain (length-masked, no per-column valid bits). The store is one
    indexed write of a [Nkv, Dh] row per slot (the JAX package's
    gather/select/scatter form is a layout workaround for its compiler)."""
    assert q.shape[1] == 1, "paged KV is a decode-only path (S == 1)"
    page, off = pc.write_page, pc.write_off
    k_row = kk[:, 0].transpose(0, 1)  # [Nkv, B, Dh]
    v_row = v[:, 0].transpose(0, 1)
    if pc.k_scales is not None:  # int8 pool: quantize the fresh rows
        k_row, k_sc = quantize_page_rows(k_row)
        v_row, v_sc = quantize_page_rows(v_row)
        pc.k_scales[:, page, off] = k_sc[..., 0]
        pc.v_scales[:, page, off] = v_sc[..., 0]
    pc.k_pages[:, page, off] = k_row.to(pc.k_pages.dtype)
    pc.v_pages[:, page, off] = v_row.to(pc.v_pages.dtype)
    return paged_attention(q[:, 0], pc.k_pages, pc.v_pages, pc.lengths,
                           pc.table, scale=cfg.head_dim ** -0.5,
                           k_scales=pc.k_scales,
                           v_scales=pc.v_scales)[:, None]


def _layer(cfg: Qwen3Config, hidden, p, cos, sin, mask, causal,
           cache_kv, cache_index, lora_layer=None, lora_scale=1.0,
           lora_dropout=0.0, seeds=None, lora_slots=None,
           split_remat: bool = False):
    """One decoder layer. cache_kv: None; or (kv [L, B, Nkv, Smax, 2*Dh],
    kv_scale or None, layer index), the dense cache, whose new rows are
    written in place at the scalar ``cache_index``; or a ``PagedCache``
    (which carries its own write positions).
    seeds: LoRA target name -> dropout seed, or None for no dropout.
    split_remat: checkpoint the part before attention and the part after
    it, and leave the attention call outside (the ``attn`` / ``hot`` remat
    policies: the backward pass never re-runs flash attention).
    Returns (hidden, aux) as ``_layer_tail`` does; a sparse layer computes
    its aux losses only on the no-cache path."""
    Dh = cfg.head_dim
    lkw = (lora_layer, lora_scale, lora_dropout, seeds, lora_slots)
    if split_remat:
        q, kk, v = checkpoint(_attn_inputs, cfg, hidden, p, cos, sin, *lkw,
                              use_reentrant=False)
    else:
        q, kk, v = _attn_inputs(cfg, hidden, p, cos, sin, *lkw)

    if cache_kv is None:
        attn = dot_product_attention(q, kk, v, mask=mask, causal=causal,
                                     scale=Dh ** -0.5)
    elif isinstance(cache_kv, PagedCache):
        attn = _paged_write_and_attend(cfg, q, kk, v, cache_kv)
    else:
        # write ONLY the new token rows (k ‖ v) at cache_index, in place of
        # JAX's dynamic_update_slice, then read this layer's window
        if not isinstance(cache_index, int):
            raise NotImplementedError(
                "a per-row cache_index on the dense cache is not ported "
                "(ROADMAP.md, queue 1 item 9: speculative decoding and the "
                "offline ring); the serving ring writes one shared column")
        S = hidden.shape[1]
        ckv, csc, li = cache_kv
        kv_new = torch.cat([kk.transpose(1, 2), v.transpose(1, 2)], dim=-1)
        if csc is not None:  # int8 cache: quantize the fresh rows
            kv_new, sc_new = quantize_kv(kv_new)
            csc[li, :, :, cache_index:cache_index + S] = sc_new
        ckv[li, :, :, cache_index:cache_index + S] = kv_new.to(ckv.dtype)
        kv_l = ckv[li]
        attn = dot_product_attention(
            q, kv_l[..., :Dh], kv_l[..., Dh:], mask=mask, causal=causal,
            scale=Dh ** -0.5, q_offset=cache_index, kv_layout="bnsd",
            kv_scales=csc[li] if csc is not None else None)
    if split_remat:
        return checkpoint(_layer_tail, cfg, hidden, attn, p, *lkw,
                          cache_kv is None, use_reentrant=False)
    return _layer_tail(cfg, hidden, attn, p, *lkw, cache_kv is None)


REMAT_POLICIES = ("full", "attn", "hot")


def forward_hidden(
    params: Params,
    cfg: Qwen3Config,
    *,
    input_ids: Optional[torch.Tensor] = None,      # [B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, H]
    attention_mask: Optional[torch.Tensor] = None,  # [B, Skv] (S or Smax)
    positions: Optional[torch.Tensor] = None,      # [B, S] absolute positions
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Union[int, torch.Tensor] = 0,
    causal: bool = True,
    lora: Optional[Dict[str, Any]] = None,     # {"layers": {target: {a, b}}}
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,  # LoRA dropout stream
    lora_slots: Optional[torch.Tensor] = None,  # [B] adapter index per row
    output_hidden_states: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the decoder stack; returns (final hidden states, cache).

    ``output_hidden_states`` (no-cache path only) adds a third element: each
    layer's output [L, B, S, H] before the final norm, which the parity
    runner (``tools.parity``) holds against HF's ``hidden_states``.

    MoE models (``cfg.num_experts > 0``), no-cache path: the second slot
    (training has no KV cache) carries ``{"moe_aux": {"load_balance",
    "router_z"}}``, each the mean over the layers; the trainer folds the
    load-balance term into the loss. With a cache the aux losses are not
    computed at all.

    Without a cache this is a plain causal forward (training). With the
    dense cache ``{kv[, kv_scale]}``, the S new tokens are written at the
    scalar ``cache_index`` (in place) and attention runs over the whole
    cache (prefill: S = prompt length, index 0; decode: S = 1). With the
    paged cache ``{k_pages, v_pages, page_table, lengths[, k_scales,
    v_scales]}`` (decode only, S = 1), ``cache_index`` is a [B] tensor of
    write positions, < 0 for an inactive slot, and ``positions`` must be
    given. ``lora`` may be a stacked multi-LoRA bank (``lora.stack_adapters``)
    with ``lora_slots`` naming each row's adapter.

    Training memory: ``cfg.remat`` recomputes each layer in the backward
    pass with ``torch.utils.checkpoint`` where JAX uses ``jax.checkpoint``;
    the first ``cfg.remat_skip_layers`` layers stay unchecked. Policy
    ``full`` checkpoints the whole layer; ``attn`` and ``hot`` checkpoint
    the parts before and after attention and keep the attention call (its
    q, k, v, output and LSE) out of the recompute. ``dots`` is refused."""
    if output_hidden_states and cache is not None:
        raise ValueError("output_hidden_states is for the no-cache path")
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids)
    hidden = inputs_embeds
    B, S, _ = hidden.shape
    dev = hidden.device
    L = cfg.num_hidden_layers

    if positions is None:
        if attention_mask is not None and cache is None:
            # left/right-pad robust: position = #real tokens before me
            positions = torch.clamp(
                torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1,
                min=0)[:, :S]
        else:
            assert isinstance(cache_index, int), (
                "a per-row cache_index requires explicit positions")
            positions = (torch.arange(S, device=dev)[None, :]
                         + cache_index).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            dtype=hidden.dtype)

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (ROADMAP.md, "
            f"queue 1 item 8, left open: the 'dots' policy); use one of "
            f"{REMAT_POLICIES}")
    n_skip = min(cfg.remat_skip_layers, L)

    lora_layers = lora["layers"] if lora is not None else None
    all_seeds = None
    if lora_layers is not None and lora_dropout > 0.0 and \
            generator is not None:
        # one seed per (layer, target), drawn from the caller's stream
        all_seeds = torch.randint(
            0, 2 ** 62, (L, len(lora_layers)), generator=generator,
            device=generator.device).tolist()

    layer_params = _unstack_layers(params["layers"], L)
    lora_params = (_unstack_layers(lora_layers, L)
                   if lora_layers is not None else None)
    # paged pool: every layer reads the same table and lengths (host-managed
    # between dispatches) and writes its own rows of the shared pools
    paged = (paged_layer_views(cache, L, cache_index)
             if cache is not None and "k_pages" in cache else None)
    aux_layers, per_layer = [], []
    for li in range(L):
        p = layer_params[li]
        ll = lora_params[li] if lora_params is not None else None
        seeds = (dict(zip(lora_layers, all_seeds[li]))
                 if all_seeds is not None else None)
        if cache is None:
            cache_kv = None
        elif paged is not None:
            cache_kv = paged[li]
        else:
            cache_kv = (cache["kv"], cache.get("kv_scale"), li)
        args = (cfg, hidden, p, cos, sin, attention_mask, causal,
                cache_kv, cache_index, ll, lora_scale, lora_dropout, seeds,
                lora_slots)
        if remat and li >= n_skip:
            if cfg.remat_policy == "full":
                hidden, aux = checkpoint(_layer, *args, use_reentrant=False)
            else:
                hidden, aux = _layer(*args, split_remat=True)
        else:
            hidden, aux = _layer(*args)
        if aux is not None:
            aux_layers.append(aux)
        if output_hidden_states:
            per_layer.append(hidden)
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    if aux_layers:  # only without a cache
        lb, z = torch.stack(aux_layers).mean(dim=0)
        cache = {"moe_aux": {"load_balance": lb, "router_z": z}}
    if output_hidden_states:
        return hidden, cache, torch.stack(per_layer)
    return hidden, cache


def logits_from_hidden(params: Params, cfg: Qwen3Config,
                       hidden: torch.Tensor) -> torch.Tensor:
    if "lm_head_q" in params:  # int8 decode path (quantize_for_decode)
        return quant.int8_matmul(hidden, params["lm_head_q"])
    if "lm_head" in params:  # untied
        return hidden @ params["lm_head"]
    return hidden @ params["embed"].T  # tied embeddings


QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


def quantize_for_training(params: Params, cfg: Qwen3Config) -> Params:
    """QLoRA-style base quantization: int8 the frozen decoder linears
    (the MoE expert stacks included, the router not) IN
    PLACE of their storage in the model dtype, keeping names, embedding, lm
    head and norms untouched — so LoRA adapters (``models.lora``) apply on
    top and the trainer's loss path (fused LCE on the head in the model
    dtype) is unchanged. Only the adapters and projectors train."""
    new_layers = dict(params["layers"])
    for name in QUANT_TARGETS:
        if name in new_layers:
            new_layers[name] = quant.quantize_int8(new_layers[name])
    if "router" in new_layers:  # MoE: quantize the expert stacks too
        for name in EXPERT_STACKS:
            new_layers[name] = _quantize_stack(new_layers[name])
    return {**params, "layers": new_layers}


def _quantize_stack(w: torch.Tensor, out=None, col0: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """``moe.quantize_experts`` of a stacked [L, E, K, N] leaf, one layer at
    a time (the fp32 copy of a whole leaf is twice its size), into columns
    col0 .. col0 + N of ``out``'s preallocated ``w_q`` / ``scale`` when given
    (the fused gate-and-up stack)."""
    L, E, K, N = w.shape
    if out is None:
        out = {"w_q": torch.empty((L, E, K, N), dtype=torch.int8,
                                  device=w.device),
               "scale": torch.empty((L, E, N), dtype=torch.float32,
                                    device=w.device)}
    for li in range(L):
        q = moe.quantize_experts(w[li])
        out["w_q"][li, :, :, col0:col0 + N] = q["w_q"]
        out["scale"][li, :, col0:col0 + N] = q["scale"]
    return out


def _stacked_qk_norm(cfg: Qwen3Config, lp: Params) -> torch.Tensor:
    """q_norm/k_norm [L, Dh] -> [L, Nq+Nkv, Dh] so the fused branch norms
    q‖k in one op."""
    L, Dh = cfg.num_hidden_layers, cfg.head_dim
    qn = lp["q_norm"][:, None, :].expand(L, cfg.num_attention_heads, Dh)
    kn = lp["k_norm"][:, None, :].expand(L, cfg.num_key_value_heads, Dh)
    return torch.cat([qn, kn], dim=1)


def quantize_for_decode(params: Params, cfg: Qwen3Config,
                        moe_experts: bool = False,
                        donate: bool = False) -> Params:
    """Int8-quantize the layer linears + lm head for decode (weight-only,
    per-output-channel scales), merging q/k/v and gate/up into single
    products (the JAX function with fuse=True, the batch CLI's --int8). The
    embedding stays in the model dtype.

    An MoE decoder's gate and up stacks fuse into ``expert_gateup``
    [L, E, H, 2I]; ``moe_experts=True`` also quantizes the expert stacks
    (``moe.quantize_experts``; quantized BEFORE fusing: per-column scales
    make quantize(concat) == concat(quantize) exactly). The router stays
    fp32. The new stacks are built layer by layer into preallocated leaves.

    donate=True: the caller gives ``params`` up. Each source leaf is
    removed from ``params["layers"]`` as soon as its replacement exists, so
    that the old and new expert stacks are never all alive together (at
    qwen3-30b-a3b width the bf16 stacks are 58 GB)."""
    lp = params["layers"] if donate else dict(params["layers"])
    new_layers = dict(lp)

    def drop(*names):
        for name in names:
            del new_layers[name]
            lp.pop(name, None)

    if "router" in lp:
        down, gate, up = (lp[n] for n in ("expert_down", "expert_gate",
                                          "expert_up"))
        L, E, H, I = gate.shape
        if moe_experts:
            drop("expert_down")
            new_layers["expert_down"] = _quantize_stack(down)
            del down
            gu = {"w_q": torch.empty((L, E, H, 2 * I), dtype=torch.int8,
                                     device=gate.device),
                  "scale": torch.empty((L, E, 2 * I), dtype=torch.float32,
                                       device=gate.device)}
            _quantize_stack(gate, gu, 0)
            _quantize_stack(up, gu, I)
        else:  # fused [L, E, H, 2I] gate-and-up stack in the model dtype
            gu = torch.empty((L, E, H, 2 * I), dtype=gate.dtype,
                             device=gate.device)
            for li in range(L):
                gu[li, :, :, :I] = gate[li]
                gu[li, :, :, I:] = up[li]
        drop("expert_gate", "expert_up")
        del gate, up
        new_layers["expert_gateup"] = gu
    else:
        new_layers["gateup_proj"] = quant.quantize_int8(
            torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1))
        new_layers["down_proj"] = quant.quantize_int8(lp["down_proj"])
        del new_layers["gate_proj"], new_layers["up_proj"]
    new_layers["qkv_proj"] = quant.quantize_int8(
        torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1))
    new_layers["o_proj"] = quant.quantize_int8(lp["o_proj"])
    new_layers["qk_norm"] = _stacked_qk_norm(cfg, lp)
    for name in ("q_proj", "k_proj", "v_proj", "q_norm", "k_norm"):
        del new_layers[name]
    out = {**params, "layers": new_layers}
    head = (params["embed"].T if cfg.tie_word_embeddings
            else params["lm_head"])
    out["lm_head_q"] = quant.quantize_int8(head)
    out.pop("lm_head", None)
    return out


def forward_logits(params: Params, cfg: Qwen3Config, **kw) -> torch.Tensor:
    hidden, _ = forward_hidden(params, cfg, **kw)
    return logits_from_hidden(params, cfg, hidden)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    # clip out-of-vocab ids (JAX mode="clip") instead of failing the gather
    table = params["embed"]
    return table[input_ids.clamp(0, table.shape[0] - 1)]
