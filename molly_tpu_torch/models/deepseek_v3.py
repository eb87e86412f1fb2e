"""The DeepSeek-V3-family decoder (Moonlight-16B-A3B among them) in
PyTorch: multi-head latent attention over a compressed cache, a leading
dense SwiGLU layer and then sigmoid-routed experts beside shared ones. It
has no JAX original; HF transformers' ``modeling_deepseek_v3.py`` is the
spec, and ``h100_bench/reference/deepseek_v3.py`` is its plain float32
twin.

Params follow ``models.qwen3``'s conventions (linear weights [in, out],
layer weights stacked on a leading axis, int8 weights ``{w_q, scale}``):
``layers`` holds every layer's attention and norms [L, ...]; ``dense``
the SwiGLU of the first ``first_k_dense_replace`` layers; ``moe`` the
router [Lm, H, E] (fp32), its ``correction_bias`` [Lm, E] (fp32), the
expert stacks [Lm, E, H, I] / [Lm, E, I, H] and the shared experts'
SwiGLU [Lm, H, n_shared * I] of the rest.

Attention (no q compression): q = x W_q, [N, qk_nope ‖ qk_rope] a head;
x W_kv_a = [latent (kv_lora_rank) ‖ one rotary key (qk_rope) for every
head]; the latent is RMS-normed, and W_kv_b decompresses it to [k_nope ‖
v] a head. Both rotary parts take the interleaved rotary
(``ops.rope.apply_rope_interleaved``). The cache keeps the normed latent
and the rotated key, ``latent_dim`` values a token and layer, in ONE
array [L, B, Smax, kv_lora_rank + qk_rope]; nothing per head.

- Prefill (and the no-cache forward) decompresses K = [k_nope ‖ k_rope]
  and V from the latents and runs the flash kernel at q.k width qk_nope +
  qk_rope and v width v_head_dim, causal under the padding mask.
- Decode (S == 1 over the cache) runs the absorbed form: W_kv_b's k half
  is folded into q (``molly/mla/absorb``), the scores are one product of
  [q_absorbed ‖ q_rope] with the cached [latent ‖ k_rope] rows, the
  softmax weighs the latents, and W_kv_b's v half is applied to that
  (``molly/mla/latent_attn``). Products take bf16 operands with fp32
  results (``_bmm_f32``) and the softmax is fp32; the cache is never
  widened. It reads the padding mask and no host value: no sync.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import moe, quant
from ..ops.flash_attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_interleaved, rope_cos_sin
from ..utils import profiling
from .configs import DeepseekV3Config
from .qwen3 import _unstack_layers, embed_tokens, torch_dtype

Params = Dict[str, Any]

# kv_a_layernorm is built without an eps in modeling_deepseek_v3.py, so it
# takes DeepseekV3RMSNorm's default, not the config's rms_norm_eps
KV_NORM_EPS = 1e-6


def init_params(cfg: DeepseekV3Config, generator: torch.Generator,
                device="cpu") -> Params:
    """Random init, normal(0.02) like HF, drawn from ``generator`` (on
    ``device``). The correction bias is drawn too (HF starts it at zero;
    training sets it), so that it steers the choice. Real runs load a
    checkpoint instead."""
    dt = torch_dtype(cfg.dtype)
    H, L, N = cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads
    C, Dn, Dr, Dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    Ld = cfg.first_k_dense_replace
    Lm, E, I = L - Ld, cfg.num_experts, cfg.moe_intermediate_size

    def norm(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def lin(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(0.02).to(dt)

    def lin_stack(*shape):  # one layer at a time, as qwen3.init_params
        out = torch.empty(shape, dtype=dt, device=device)
        for li in range(shape[0]):
            out[li] = lin(*shape[1:])
        return out

    params: Params = {
        "embed": lin(cfg.vocab_size, H),
        "layers": {
            "input_norm": norm(L, H), "post_attn_norm": norm(L, H),
            "q_proj": lin(L, H, N * (Dn + Dr)),
            "kv_a_proj": lin(L, H, C + Dr), "kv_norm": norm(L, C),
            "kv_b_proj": lin(L, C, N * (Dn + Dv)),
            "o_proj": lin(L, N * Dv, H)},
        "dense": {"gate_proj": lin(Ld, H, cfg.intermediate_size),
                  "up_proj": lin(Ld, H, cfg.intermediate_size),
                  "down_proj": lin(Ld, cfg.intermediate_size, H)},
        "moe": {"router": lin(Lm, H, E).to(torch.float32),
                "correction_bias": lin(Lm, E).to(torch.float32),
                "expert_gate": lin_stack(Lm, E, H, I),
                "expert_up": lin_stack(Lm, E, H, I),
                "expert_down": lin_stack(Lm, E, I, H),
                "shared_gate": lin(Lm, H, cfg.n_shared_experts * I),
                "shared_up": lin(Lm, H, cfg.n_shared_experts * I),
                "shared_down": lin(Lm, cfg.n_shared_experts * I, H)},
        "final_norm": norm(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(H, cfg.vocab_size)
    return params


def init_cache(cfg: DeepseekV3Config, batch: int, max_len: int,
               device="cpu", quant: Optional[str] = None
               ) -> Dict[str, torch.Tensor]:
    """The latent cache: ONE array [L, B, Smax, kv_lora_rank + qk_rope]
    in the model dtype, each row a token's normed latent ‖ rotated key.
    Its bytes are the recording's ``mla_cache_bytes``."""
    if quant is not None:
        raise NotImplementedError("deepseek_v3: the latent cache has no "
                                  f"{quant} form")
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.latent_dim)
    kv = torch.zeros(shape, dtype=torch_dtype(cfg.dtype), device=device)
    profiling.count("mla_cache_bytes", kv.numel() * kv.element_size())
    return {"kv": kv}


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b [..., n, m] x [..., m, p] with an fp32 result from operands
    in their own dtype: on a card a bf16 product accumulates in fp32 and
    is never rounded (``out_dtype``); on the CPU the operands are widened,
    which gives the same products."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _swiglu(x, gate, up, down):
    return quant.linear(F.silu(quant.linear(x, gate))
                        * quant.linear(x, up), down)


def _attention(cfg: DeepseekV3Config, x, p, cos, sin, mask, cache, li,
               cache_index: int):
    """Multi-head latent attention of one layer over the normed input x
    [B, S, H]: the output before o_proj, [B, S, N * v_head_dim]. With a
    cache, the S new latent rows go in at ``cache_index`` first."""
    B, S, _ = x.shape
    N, C = cfg.num_attention_heads, cfg.kv_lora_rank
    Dn, Dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = cfg.qk_head_dim ** -0.5
    with profiling.span("molly/mla/q"):
        q = quant.linear(x, p["q_proj"]).view(B, S, N, cfg.qk_head_dim)
        q_rope = apply_rope_interleaved(q[..., Dn:], cos, sin)
    with profiling.span("molly/mla/latent"):
        kv_a = quant.linear(x, p["kv_a_proj"])            # [B, S, C + Dr]
        latent = torch.cat([rms_norm(kv_a[..., :C], p["kv_norm"],
                                     KV_NORM_EPS),
                            apply_rope_interleaved(kv_a[..., C:], cos, sin)],
                           dim=-1)
        if cache is not None:
            cache["kv"][li, :, cache_index:cache_index + S] = latent
    w_kvb = p["kv_b_proj"]                             # [C, N * (Dn + Dv)]
    if cache is not None and S == 1:
        rows = cache["kv"][li, :, :cache_index + 1]    # [B, Skv, C + Dr]
        w = w_kvb.view(C, N, Dn + Dv)
        with profiling.span("molly/mla/absorb"):
            # q_nope [N, B, Dn] x W_uk^T [N, Dn, C] -> [N, B, C]
            q_abs = _bmm_f32(q[:, 0, :, :Dn].transpose(0, 1),
                             w[..., :Dn].permute(1, 2, 0))
            q_lat = torch.cat([q_abs.transpose(0, 1).to(x.dtype),
                               q_rope[:, 0]], dim=-1)  # [B, N, C + Dr]
        with profiling.span("molly/mla/latent_attn"):
            s = _bmm_f32(q_lat, rows.transpose(1, 2)) * scale  # [B, N, Skv]
            if mask is not None:
                keep = mask[:, None, :rows.shape[1]] != 0
                s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
            probs = torch.softmax(s, dim=-1).to(x.dtype)
            o_lat = _bmm_f32(probs, rows[..., :C])     # [B, N, C]
            # [N, B, C] x W_uv [N, C, Dv] -> [N, B, Dv]
            o = _bmm_f32(o_lat.to(x.dtype).transpose(0, 1),
                         w[..., Dn:].transpose(0, 1))
            return o.transpose(0, 1).to(x.dtype).reshape(B, 1, N * Dv)
    Skv = latent.shape[1]
    with profiling.span("molly/mla/decompress"):
        kv = quant.linear(latent[..., :C], w_kvb).view(B, Skv, N, Dn + Dv)
        k = torch.cat([kv[..., :Dn], latent[:, :, None, C:].expand(
            B, Skv, N, cfg.qk_rope_head_dim)], dim=-1)
    qf = torch.cat([q[..., :Dn], q_rope], dim=-1)
    attn = flash_attention(qf, k, kv[..., Dn:],
                           mask[:, :Skv] if mask is not None else None,
                           True, scale)
    return attn.reshape(B, S, N * Dv)


def _mlp(cfg: DeepseekV3Config, x, li: int, dense, moe_p):
    """The FFN of layer li over x [B, S, H]: the dense SwiGLU, or the
    routed experts plus the shared ones."""
    B, S, H = x.shape
    Ld = cfg.first_k_dense_replace
    if li < Ld:
        d = dense[li]
        return _swiglu(x, d["gate_proj"], d["up_proj"], d["down_proj"])
    m = moe_p[li - Ld]
    x2 = x.reshape(B * S, H)
    k = cfg.num_experts_per_tok
    with profiling.span("molly/moe/router"):
        topw, topi, _, _ = moe.router_topk(
            x2, m["router"], k, cfg.norm_topk_prob, scoring="sigmoid",
            correction_bias=m["correction_bias"],
            routed_scale=cfg.routed_scaling_factor)
    with profiling.span("molly/moe/routed"):
        if "expert_gateup" in m:  # int8 fused gate-and-up stack
            wg, wu = m["expert_gateup"], None
        else:
            wg, wu = m["expert_gate"], m["expert_up"]
        routed, counts = moe.moe_experts(x2, topw, topi, wg, wu,
                                         m["expert_down"])
    if S > 1 and profiling.active():  # the prefill's load, read at close
        profiling.count("moe_expert_rows_max", counts.max())
        profiling.count("moe_expert_rows_mean", B * S * k / cfg.num_experts)
    with profiling.span("molly/moe/shared"):
        shared = _swiglu(x, m["shared_gate"], m["shared_up"],
                         m["shared_down"])
    return routed.reshape(B, S, H) + shared


def forward_hidden(
    params: Params,
    cfg: DeepseekV3Config,
    *,
    input_ids: Optional[torch.Tensor] = None,      # [B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, H]
    attention_mask: Optional[torch.Tensor] = None,  # [B, Skv] (S or Smax)
    positions: Optional[torch.Tensor] = None,      # [B, S]
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: int = 0,
):
    """Run the decoder stack; returns (final hidden states, cache), as
    ``qwen3.forward_hidden`` does for the dense cache: without a cache a
    plain causal forward; with ``init_cache``'s, the S new tokens' latent
    rows are written at the int ``cache_index`` (every row the same
    column): a prompt at 0, or one decode token, which attends over the
    cache's columns [0, cache_index] under ``attention_mask``."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids)
    hidden = inputs_embeds
    B, S, _ = hidden.shape
    if cache is not None and not (isinstance(cache_index, int)
                                  and (cache_index == 0 or S == 1)):
        raise ValueError("deepseek_v3: a cached forward is a prompt at "
                         "column 0 or one token at an int column")
    if positions is None:
        if attention_mask is not None and cache is None:
            positions = torch.clamp(
                torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1,
                min=0)[:, :S]
        else:
            positions = (torch.arange(S, device=hidden.device)[None, :]
                         + cache_index).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                            dtype=hidden.dtype)
    L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
    with profiling.span("molly/unstack"):
        layers = _unstack_layers(params["layers"], L)
        dense = _unstack_layers(params["dense"], cfg.first_k_dense_replace)
        moe_p = _unstack_layers(params["moe"],
                                L - cfg.first_k_dense_replace)
    for li in range(L):
        p = layers[li]
        with profiling.span("molly/layer"):
            x = rms_norm(hidden, p["input_norm"], eps)
            attn = _attention(cfg, x, p, cos, sin, attention_mask, cache,
                              li, cache_index)
            hidden = hidden + quant.linear(attn, p["o_proj"])
            x = rms_norm(hidden, p["post_attn_norm"], eps)
            hidden = hidden + _mlp(cfg, x, li, dense, moe_p)
    return rms_norm(hidden, params["final_norm"], eps), cache


def logits_from_hidden(params: Params, cfg: DeepseekV3Config,
                       hidden: torch.Tensor) -> torch.Tensor:
    if "lm_head_q" in params:  # int8 decode path (quantize_for_decode)
        return quant.int8_matmul(hidden, params["lm_head_q"])
    if "lm_head" in params:
        return hidden @ params["lm_head"]
    return hidden @ params["embed"].T  # tied embeddings


def quantize_for_decode(params: Params, cfg: DeepseekV3Config,
                        fuse: bool = True, moe_experts: bool = False,
                        donate: bool = False) -> Params:
    """Int8 weight-only (per-output-channel scales) for decode, as
    ``qwen3.quantize_for_decode``: q_proj, kv_a_proj, o_proj, the dense and
    shared SwiGLUs and the head; with ``moe_experts`` the expert stacks
    too, gate and up fused into ``expert_gateup`` [Lm, E, H, 2I] and built
    layer by layer. W_kv_b stays in the model dtype: decode reads its
    halves as views (``_attention``). The router, its bias, the norms and
    the embedding stay. ``donate``: the caller gives ``params`` up, and
    each bf16 expert stack is released once its int8 one exists. ``fuse``
    is taken for the signature's sake: there is nothing else to fuse."""
    del fuse
    out = dict(params) if not donate else params
    out["layers"] = dict(params["layers"])
    for name in ("q_proj", "kv_a_proj", "o_proj"):
        out["layers"][name] = quant.quantize_int8(out["layers"][name])
    out["dense"] = {k: quant.quantize_int8(w)
                    for k, w in params["dense"].items()}
    m = params["moe"] if donate else dict(params["moe"])
    for name in ("shared_gate", "shared_up", "shared_down"):
        m[name] = quant.quantize_int8(m[name])
    if moe_experts:
        gate, up = m.pop("expert_gate"), m.pop("expert_up")
        Lm, E, H, I = gate.shape
        gu = {"w_q": torch.empty((Lm, E, H, 2 * I), dtype=torch.int8,
                                 device=gate.device),
              "scale": torch.empty((Lm, E, 2 * I), dtype=torch.float32,
                                   device=gate.device)}
        for li in range(Lm):
            for col, w in ((0, gate), (I, up)):
                qw = moe.quantize_experts(w[li])
                gu["w_q"][li, :, :, col:col + I] = qw["w_q"]
                gu["scale"][li, :, col:col + I] = qw["scale"]
        del gate, up
        m["expert_gateup"] = gu
        down = m.pop("expert_down")
        m["expert_down"] = {
            "w_q": torch.empty(down.shape, dtype=torch.int8,
                               device=down.device),
            "scale": torch.empty(down.shape[:2] + down.shape[3:],
                                 dtype=torch.float32, device=down.device)}
        for li in range(Lm):
            qw = moe.quantize_experts(down[li])
            m["expert_down"]["w_q"][li] = qw["w_q"]
            m["expert_down"]["scale"][li] = qw["scale"]
        del down
    out["moe"] = m
    head = out.pop("lm_head", None)
    out["lm_head_q"] = quant.quantize_int8(
        params["embed"].T if head is None else head)
    return out
