"""Qwen3 dense decoder in PyTorch, the counterpart of
``molly_tpu/models/qwen3.py``.

Params keep the JAX layout so the converter (``models.convert``) is a plain
tree map: every layer weight is STACKED on a leading [L, ...] axis, linear
weights are [in, out], int8 weights are ``{w_q, scale}`` dicts. Where JAX
scans over layers, this is a Python loop over the stacked weights. The KV
cache is the same single head-major array [L, B, Nkv, Smax, 2*Dh] (k ‖ v
on the minor dim); where JAX threads it functionally through the scan,
here each layer writes its new rows into it in place. The training side
(LoRA bypasses, remat, the int8 QLoRA base) rides the same ``_layer``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import quant
from ..ops.attention import dot_product_attention
from ..ops.norms import rms_norm
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
    if cfg.num_experts:
        raise NotImplementedError("MoE decoders are not ported yet")
    dt = torch_dtype(cfg.dtype)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    Dq, Dkv, Dh = cfg.q_dim, cfg.kv_dim, cfg.head_dim

    def norm(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def lin(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(0.02).to(dt)

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
            "gate_proj": lin(L, H, I),
            "up_proj": lin(L, H, I),
            "down_proj": lin(L, I, H),
        },
        "final_norm": norm(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(H, cfg.vocab_size)
    return params


def init_cache(cfg: Qwen3Config, batch: int, max_len: int, device="cpu",
               dtype=None) -> Dict[str, torch.Tensor]:
    """Dense KV cache: ONE head-major array [L, B, Nkv, Smax, 2*Dh] with
    k ‖ v on the minor dim, in the model dtype."""
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
             max_len, 2 * cfg.head_dim)
    return {"kv": torch.zeros(shape, dtype=dt, device=device)}


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
                 lora_scale=1.0, lora_dropout=0.0, seeds=None):
    """The part of a layer before attention: (q, k, v), q/k normed and
    rotated."""
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
                 ("v_proj", cfg.kv_dim)), lora_scale, lora_dropout, gen_for)
        qk = qkv[..., : cfg.q_dim + cfg.kv_dim].reshape(B, S, Nq + Nkv, Dh)
        v = qkv[..., cfg.q_dim + cfg.kv_dim:].reshape(B, S, Nkv, Dh)
        qk = rms_norm(qk, p["qk_norm"], cfg.rms_norm_eps)
        qk = apply_rope(qk, cos, sin)
        return qk[:, :, :Nq], qk[:, :, Nq:], v

    def proj(name):
        ll = lora_layer.get(name) if lora_layer is not None else None
        return apply_lora(x, quant.linear(x, p[name]), ll, lora_scale,
                          lora_dropout, gen_for(name))

    q = proj("q_proj").reshape(B, S, Nq, Dh)
    kk = proj("k_proj").reshape(B, S, Nkv, Dh)
    v = proj("v_proj").reshape(B, S, Nkv, Dh)
    # Qwen3 applies RMSNorm on the head dim of q/k before RoPE
    q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
    kk = rms_norm(kk, p["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), v


def _layer_tail(cfg: Qwen3Config, hidden, attn, p, lora_layer=None,
                lora_scale=1.0, lora_dropout=0.0, seeds=None):
    """The part of a layer after attention: output projection, residual,
    MLP, residual."""
    B, S, H = hidden.shape
    gen_for = _generator_for(seeds, hidden.device)

    def proj(x, name):
        ll = lora_layer.get(name) if lora_layer is not None else None
        return apply_lora(x, quant.linear(x, p[name]), ll, lora_scale,
                          lora_dropout, gen_for(name))

    hidden = hidden + proj(attn.reshape(B, S, -1), "o_proj")
    x = rms_norm(hidden, p["post_attn_norm"], cfg.rms_norm_eps)
    if "gateup_proj" in p:  # fused decode weights
        gu = quant.linear(x, p["gateup_proj"])
        if lora_layer is not None:
            I = gu.shape[-1] // 2
            gu = apply_lora_fused(x, gu, lora_layer,
                                  (("gate_proj", I), ("up_proj", I)),
                                  lora_scale, lora_dropout, gen_for)
        gate, up = gu.chunk(2, dim=-1)
    else:
        gate, up = proj(x, "gate_proj"), proj(x, "up_proj")
    return hidden + proj(F.silu(gate) * up, "down_proj")


def _layer(cfg: Qwen3Config, hidden, p, cos, sin, mask, causal,
           cache_kv, cache_index: int, lora_layer=None, lora_scale=1.0,
           lora_dropout=0.0, seeds=None, split_remat: bool = False):
    """One decoder layer. cache_kv: None, or (kv [L, B, Nkv, Smax, 2*Dh],
    layer index) — the layer's new rows are written into kv in place.
    seeds: LoRA target name -> dropout seed, or None for no dropout.
    split_remat: checkpoint the part before attention and the part after
    it, and leave the attention call outside (the ``attn`` / ``hot`` remat
    policies: the backward pass never re-runs flash attention)."""
    Dh = cfg.head_dim
    lkw = (lora_layer, lora_scale, lora_dropout, seeds)
    if split_remat:
        q, kk, v = checkpoint(_attn_inputs, cfg, hidden, p, cos, sin, *lkw,
                              use_reentrant=False)
    else:
        q, kk, v = _attn_inputs(cfg, hidden, p, cos, sin, *lkw)

    if cache_kv is None:
        attn = dot_product_attention(q, kk, v, mask=mask, causal=causal,
                                     scale=Dh ** -0.5)
    else:
        # write ONLY the new token rows (k ‖ v) at cache_index, in place of
        # JAX's dynamic_update_slice, then read this layer's window
        S = hidden.shape[1]
        ckv, li = cache_kv
        kv_new = torch.cat([kk.transpose(1, 2), v.transpose(1, 2)], dim=-1)
        ckv[li, :, :, cache_index:cache_index + S] = kv_new.to(ckv.dtype)
        kv_l = ckv[li]
        attn = dot_product_attention(
            q, kv_l[..., :Dh], kv_l[..., Dh:], mask=mask, causal=causal,
            scale=Dh ** -0.5, q_offset=cache_index, kv_layout="bnsd")
    if split_remat:
        return checkpoint(_layer_tail, cfg, hidden, attn, p, *lkw,
                          use_reentrant=False)
    return _layer_tail(cfg, hidden, attn, p, *lkw)


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
    cache_index: int = 0,
    causal: bool = True,
    lora: Optional[Dict[str, Any]] = None,     # {"layers": {target: {a, b}}}
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,  # LoRA dropout stream
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the decoder stack; returns (final hidden states, cache).

    Without a cache this is a plain causal forward (training). With the
    dense cache, the S new tokens are written at ``cache_index`` (in place)
    and attention runs over the whole cache (prefill: S = prompt length,
    index 0; decode: S = 1).

    Training memory: ``cfg.remat`` recomputes each layer in the backward
    pass with ``torch.utils.checkpoint`` where JAX uses ``jax.checkpoint``;
    the first ``cfg.remat_skip_layers`` layers stay unchecked. Policy
    ``full`` checkpoints the whole layer; ``attn`` and ``hot`` checkpoint
    the parts before and after attention and keep the attention call (its
    q, k, v, output and LSE) out of the recompute. ``dots`` is refused."""
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
    for li in range(L):
        p = layer_params[li]
        ll = lora_params[li] if lora_params is not None else None
        seeds = (dict(zip(lora_layers, all_seeds[li]))
                 if all_seeds is not None else None)
        args = (cfg, hidden, p, cos, sin, attention_mask, causal,
                None if cache is None else (cache["kv"], li), cache_index,
                ll, lora_scale, lora_dropout, seeds)
        if remat and li >= n_skip:
            if cfg.remat_policy == "full":
                hidden = checkpoint(_layer, *args, use_reentrant=False)
            else:
                hidden = _layer(*args, split_remat=True)
        else:
            hidden = _layer(*args)
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
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
    """QLoRA-style base quantization: int8 the frozen decoder linears IN
    PLACE of their storage in the model dtype, keeping names, embedding, lm
    head and norms untouched — so LoRA adapters (``models.lora``) apply on
    top and the trainer's loss path (fused LCE on the head in the model
    dtype) is unchanged. Only the adapters and projectors train."""
    new_layers = dict(params["layers"])
    for name in QUANT_TARGETS:
        if name in new_layers:
            new_layers[name] = quant.quantize_int8(new_layers[name])
    return {**params, "layers": new_layers}


def _stacked_qk_norm(cfg: Qwen3Config, lp: Params) -> torch.Tensor:
    """q_norm/k_norm [L, Dh] -> [L, Nq+Nkv, Dh] so the fused branch norms
    q‖k in one op."""
    L, Dh = cfg.num_hidden_layers, cfg.head_dim
    qn = lp["q_norm"][:, None, :].expand(L, cfg.num_attention_heads, Dh)
    kn = lp["k_norm"][:, None, :].expand(L, cfg.num_key_value_heads, Dh)
    return torch.cat([qn, kn], dim=1)


def quantize_for_decode(params: Params, cfg: Qwen3Config) -> Params:
    """Int8-quantize the layer linears + lm head for decode (weight-only,
    per-output-channel scales), merging q/k/v and gate/up into single
    products (the JAX function with fuse=True, the batch CLI's --int8). The
    embedding stays in the model dtype."""
    lp = params["layers"]
    new_layers = dict(lp)
    new_layers["qkv_proj"] = quant.quantize_int8(
        torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1))
    new_layers["gateup_proj"] = quant.quantize_int8(
        torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1))
    new_layers["down_proj"] = quant.quantize_int8(lp["down_proj"])
    new_layers["o_proj"] = quant.quantize_int8(lp["o_proj"])
    new_layers["qk_norm"] = _stacked_qk_norm(cfg, lp)
    for name in ("q_proj", "k_proj", "v_proj", "q_norm", "k_norm",
                 "gate_proj", "up_proj"):
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
