"""The DeepSeek-V3-family decoder (HF transformers' ``modeling_deepseek_v3``,
4.57: Moonlight-16B-A3B among its configurations): everything of the
benchmark that depends on its equations, with the names ``qwen3.py`` has.

- the program's side of the configuration, as data;
- ``draw``: the decoder's weights in the program's tree layout, with
  token groups that give the routers a trained router's margins
  (``_groups``), so that the check reads arithmetic, not swapped experts;
- ``decoder_logits``: its float32 forward, equation by equation:
  RMSNorm (``rms_norm_eps``; the latent's ``kv_a_layernorm`` at the
  class default 1e-6, as it is built without an eps); multi-head latent
  attention without q compression (q to heads of qk_nope + qk_rope;
  ``kv_a_proj_with_mqa`` to the latent and one rotary key for all heads;
  ``kv_b_proj`` from the normed latent to k_nope and v a head; the
  interleaved rotary of ``apply_rotary_pos_emb_interleave`` on both rope
  parts, theta ``rope_theta`` over qk_rope dims; scale qk_head_dim^-0.5,
  ``rope_scaling`` null so no mscale); causal softmax attention; then the
  first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size`` and the rest ``DeepseekV3MoE``: fp32 router
  logits, sigmoid scores, the top k of scores + ``e_score_correction_bias``
  (one group: the group mask keeps every expert), the unbiased scores of
  those as weights, normalised with 1e-20 in the denominator, times
  ``routed_scaling_factor``, each expert's SwiGLU weighted and summed, and
  the shared experts' SwiGLU of ``n_shared_experts`` times the expert
  width added; the final norm and the untied head.
- ``token_flops``, ``attention_flops``, ``prefill_attention_calls``: the
  published (not absorbed) forward's model FLOPs, and the program's
  prefill attention calls, for ``mfu`` and the attention rooflines.

Departures, none in the arithmetic: the weights are the program's tree
(stacked [L, ...] layers, [in, out] linears, ``correction_bias`` for
``e_score_correction_bias``; ``num_experts`` for ``n_routed_experts``);
everything runs in float32 from the bf16 weights (HF rounds to bf16
between operations); the rotary's cos and sin are float32 (HF casts them
to the activations' dtype). Plain PyTorch: it imports nothing of the
program, of JAX or of transformers."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.model import f32, layer_f32, rms_norm, rope

# the port's text configuration class, its model module (whose
# ``quantize_for_decode`` is the int8 control), and its names for
# configuration keys where they differ
PROGRAM_CONFIG = "DeepseekV3Config"
PROGRAM_MODULE = "deepseek_v3"
PROGRAM_KEYS = {"n_routed_experts": "num_experts"}

# ``DeepseekV3RMSNorm(self.kv_lora_rank)``: no eps given, the class's 1e-6
KV_NORM_EPS = 1e-6


def sizes(text: Dict[str, Any]) -> Dict[str, int]:
    """H, L, N, C (latent), Dn, Dr, Dv, E, k, I (expert), Id (dense),
    Is (shared), Ld (dense layers), V."""
    return {"H": text["hidden_size"], "L": text["num_hidden_layers"],
            "N": text["num_attention_heads"], "C": text["kv_lora_rank"],
            "Dn": text["qk_nope_head_dim"], "Dr": text["qk_rope_head_dim"],
            "Dv": text["v_head_dim"],
            "E": int(text.get("num_experts", text.get("n_routed_experts"))),
            "k": text["num_experts_per_tok"],
            "I": text["moe_intermediate_size"],
            "Id": text["intermediate_size"],
            "Is": text["n_shared_experts"] * text["moe_intermediate_size"],
            "Ld": text["first_k_dense_replace"], "V": text["vocab_size"]}


def moe_layers(text: Dict[str, Any]) -> int:
    """Layers that run the routed experts: all but the first
    ``first_k_dense_replace`` (for the MoE GEMMs' roofline)."""
    return text["num_hidden_layers"] - text["first_k_dense_replace"]


def draw(d, text: Dict[str, Any]) -> Dict[str, Any]:
    """The decoder's weights from the drawer ``d`` (``harness.weights``)
    in the program's tree: ``layers`` (attention and norms, [L, ...]),
    ``dense`` ([Ld, ...]), ``moe`` ([L - Ld, ...]: router and correction
    bias in the model dtype's values, kept in float32 as the program keeps
    them; the bias nonzero, so that it steers the choice). The embedding
    and the routers carry the token groups of ``_groups``."""
    s = sizes(text)
    H, L, N, C = s["H"], s["L"], s["N"], s["C"]
    Dn, Dr, Dv, E, I = s["Dn"], s["Dr"], s["Dv"], s["E"], s["I"]
    Ld = s["Ld"]
    Lm = L - Ld
    layers = {"input_norm": d.ones(L, H), "post_attn_norm": d.ones(L, H),
              "q_proj": d.normal(L, H, N * (Dn + Dr)),
              "kv_a_proj": d.normal(L, H, C + Dr), "kv_norm": d.ones(L, C),
              "kv_b_proj": d.normal(L, C, N * (Dn + Dv)),
              "o_proj": d.normal(L, N * Dv, H)}
    dense = {"gate_proj": d.normal(Ld, H, s["Id"]),
             "up_proj": d.normal(Ld, H, s["Id"]),
             "down_proj": d.normal(Ld, s["Id"], H)}
    moe = {"router": d.normal(Lm, H, E).to(torch.float32),
           "correction_bias": d.normal(Lm, E).to(torch.float32),
           "expert_gate": d.normal(Lm, E, H, I),
           "expert_up": d.normal(Lm, E, H, I),
           "expert_down": d.normal(Lm, E, I, H),
           "shared_gate": d.normal(Lm, H, s["Is"]),
           "shared_up": d.normal(Lm, H, s["Is"]),
           "shared_down": d.normal(Lm, s["Is"], H)}
    out = {"layers": layers, "dense": dense, "moe": moe,
           "final_norm": d.ones(H)}
    if not text["tie_word_embeddings"]:
        out["lm_head"] = d.normal(H, s["V"])
    _groups(d, out, s)
    return out


# Token groups (``_groups``): ceil(E / k) orthonormal codes; each token's
# embedding row is its own part, normal(0, EMBED_STD) off the codes' span,
# plus its group's code times CODE_NORM; no matrix that writes the
# residual stream writes into that span; each MoE layer's router is
# ROUTER_STD x its normal(0, 0.02) draw plus ROUTER_GAIN x the codes in the
# columns of the k experts it gives each group. The routed experts' down
# projections are drawn at ROUTED_DOWN x normal(0, 0.02).
EMBED_STD = 0.6
CODE_NORM = 40.0
ROUTER_STD = 0.25
ROUTER_GAIN = 0.5
ROUTED_DOWN = 0.5


def _groups(d, out: Dict[str, Any], s: Dict[str, int]) -> None:
    """Give the drawn weights a trained router's margins. With every
    matrix normal(0, 0.02), a token's 6th and 7th experts lie so close
    that bf16 rounding swaps them in most served tokens, and a check
    against the float32 reference then reads the swaps, not the
    arithmetic. Here the router reads a span of ceil(E / k) orthonormal
    codes that only the embedding writes: o_proj and every down
    projection (dense, routed, shared) have that span taken out of their
    outputs, so a position's code part is the same in every layer. Each
    vocabulary token belongs to one group, drawn from the seed, and
    carries its code at CODE_NORM; each layer's router sends a group to k
    experts of its own (a permutation of the experts cut into groups of
    k, wrapping round at the end), far above the rest, so a text token's
    experts do not change under rounding in any layer. A position the
    encoders fill carries the projector's own small part in the span, the
    same in every layer, and routes by it with the router's reduced
    random part; the bf16 encoders move that part, so such positions
    still swap experts, and the routed experts' down projections are
    drawn at half the other matrices' scale, so that a swap weighs less
    beside the arithmetic the check reads. The token's own part is drawn at a
    size beside the code's, so that the first layer does not see the
    group alone.
    Embedding, routers and projections hold the model dtype's values."""
    H, E, k, V = s["H"], s["E"], s["k"], s["V"]
    K = -(-E // k)
    raw = torch.randn((K, H), generator=d.g, device=d.device,
                      dtype=torch.float64)
    codes = torch.empty_like(raw)
    for i in range(K):  # Gram-Schmidt, so that the span is exact
        v = raw[i] - codes[:i].T @ (codes[:i] @ raw[i])
        codes[i] = v / v.norm()
    codes = codes.to(torch.float32)                       # [K, H]
    group = torch.randint(K, (V,), generator=d.g, device=d.device)
    embed = out["embed"] = torch.empty((V, H), dtype=d.dtype,
                                       device=d.device)
    for r0 in range(0, V, 16384):  # bounds the float32 rows made at once
        rows = torch.randn((min(16384, V - r0), H), generator=d.g,
                           device=d.device) * EMBED_STD
        rows -= (rows @ codes.T) @ codes
        rows += CODE_NORM * codes[group[r0:r0 + 16384]]
        embed[r0:r0 + rows.shape[0]] = rows.to(embed.dtype)
    out["moe"]["expert_down"].mul_(ROUTED_DOWN)  # a power of two: exact
    for tree, name in (("layers", "o_proj"), ("dense", "down_proj"),
                       ("moe", "expert_down"), ("moe", "shared_down")):
        w = out[tree][name]                               # [L, ..., H]
        for i in range(w.shape[0]):
            wf = w[i].to(torch.float32)
            wf -= (wf @ codes.T) @ codes
            w[i] = wf.to(w.dtype)
    router = out["moe"]["router"]
    slot = torch.arange(K * k, device=d.device) % E
    for li in range(router.shape[0]):
        perm = torch.rand(E, generator=d.g, device=d.device).argsort()
        # column e gains the code of each group that e serves
        gain = torch.zeros((E, H), device=d.device).index_add_(
            0, perm[slot], codes.repeat_interleave(k, dim=0))
        router[li] = (router[li] * ROUTER_STD + ROUTER_GAIN * gain.T).to(
            d.dtype).to(torch.float32)


def rope_interleaved(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``apply_rotary_pos_emb_interleave`` at positions 0 .. S-1: x [S, n,
    D] viewed as D/2 pairs, the pairs' two members put apart ([evens ‖
    odds]), then the half-split rotary over D; the output stays in that
    order (HF's does, for q and k alike)."""
    S, n, D = x.shape
    x = x.view(S, n, D // 2, 2).transpose(-1, -2).reshape(S, n, D)
    return rope(x, theta)


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def _moe(x: torch.Tensor, p: Dict[str, Any], text: Dict[str, Any]
         ) -> torch.Tensor:
    """``DeepseekV3MoE.forward`` over x [T, H], one group."""
    k = text["num_experts_per_tok"]
    scores = (x @ p["router"]).sigmoid()
    idx = torch.topk(scores + p["correction_bias"], k, dim=-1).indices
    w = scores.gather(1, idx)
    if text["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * text["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for ex in torch.unique(idx).tolist():
        tok, slot = (idx == ex).nonzero(as_tuple=True)
        y = _swiglu(x[tok], p["expert_gate"][ex], p["expert_up"][ex],
                    p["expert_down"][ex])
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out + _swiglu(x, p["shared_gate"], p["shared_up"],
                         p["shared_down"])


def _attention(x: torch.Tensor, p: Dict[str, Any], text: Dict[str, Any],
               heads_at_once: int = 4) -> torch.Tensor:
    """``DeepseekV3Attention.forward`` over one unpadded sequence x [S, H]
    (causal), before o_proj: [S, N * Dv]."""
    s = sizes(text)
    S, N, C, Dn, Dr, Dv = (x.shape[0], s["N"], s["C"], s["Dn"], s["Dr"],
                           s["Dv"])
    theta = text["rope_theta"]
    q = (x @ p["q_proj"]).view(S, N, Dn + Dr)
    ckv = x @ p["kv_a_proj"]
    kv = (rms_norm(ckv[:, :C], p["kv_norm"], KV_NORM_EPS)
          @ p["kv_b_proj"]).view(S, N, Dn + Dv)
    k_rot = rope_interleaved(ckv[:, None, C:], theta)        # [S, 1, Dr]
    q = torch.cat([q[..., :Dn], rope_interleaved(q[..., Dn:], theta)], -1)
    k = torch.cat([kv[..., :Dn], k_rot.expand(S, N, Dr)], -1)
    v = kv[..., Dn:]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(S, N, Dv, device=x.device)
    for h0 in range(0, N, heads_at_once):  # a few heads bound the scores
        hs = slice(h0, h0 + heads_at_once)
        sc = torch.einsum("qhd,khd->hqk", q[:, hs], k[:, hs]) \
            * (Dn + Dr) ** -0.5
        sc = sc.masked_fill(~causal, -math.inf).softmax(-1)
        out[:, hs] = torch.einsum("hqk,khd->qhd", sc, v[:, hs])
    return out.reshape(S, N * Dv)


def decoder_logits(params: Dict[str, Any], text: Dict[str, Any],
                   embeds: Sequence[torch.Tensor],
                   rows: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each request's embeddings [N_i, H] through the decoder; returns the
    float32 logits [stop - start, V] at positions start .. stop - 1 of each
    request (``rows``). Weights are widened one layer at a time and the
    requests run layer by layer together."""
    eps, Ld = text["rms_norm_eps"], text["first_k_dense_replace"]
    hs = [e.clone() for e in embeds]
    for i in range(text["num_hidden_layers"]):
        p = layer_f32(params["layers"], i)
        xs = []
        for j, h in enumerate(hs):
            x = rms_norm(h, p["input_norm"], eps)
            hs[j] = h + _attention(x, p, text) @ p["o_proj"]
            xs.append(rms_norm(hs[j], p["post_attn_norm"], eps))
        if i < Ld:
            d = layer_f32(params["dense"], i)
            ys = [_swiglu(x, d["gate_proj"], d["up_proj"], d["down_proj"])
                  for x in xs]
        else:
            m = layer_f32(params["moe"], i - Ld)
            flat = _moe(torch.cat(xs), m, text)
            ys = list(flat.split([x.shape[0] for x in xs]))
            del m
        hs = [h + y for h, y in zip(hs, ys)]
        del p
    head = (f32(params["lm_head"]) if "lm_head" in params
            else f32(params["embed"]).T)
    final = f32(params["final_norm"])
    return [rms_norm(h[a:b], final, eps) @ head
            for h, (a, b) in zip(hs, rows)]


def token_flops(text: Dict[str, Any]) -> int:
    """Matrix-product operations of one decoder token through all layers
    of the published forward (attention's scores and the head excluded;
    an MoE layer: the router, its k experts and the shared ones); 2
    operations a multiply-add."""
    s = sizes(text)
    H, N, C = s["H"], s["N"], s["C"]
    proj = (H * N * (s["Dn"] + s["Dr"]) + H * (C + s["Dr"])
            + C * N * (s["Dn"] + s["Dv"]) + N * s["Dv"] * H)
    dense = 3 * H * s["Id"]
    moe = H * s["E"] + s["k"] * 3 * H * s["I"] + 3 * H * s["Is"]
    Ld, L = s["Ld"], s["L"]
    return 2 * (L * proj + Ld * dense + (L - Ld) * moe)


def attention_flops(text: Dict[str, Any], start: int, stop: int) -> int:
    """Attention's operations (q.k at qk_nope + qk_rope, p.v at v_head_dim)
    in all layers for the tokens at positions start .. stop - 1 of one
    sequence, each against the keys at or before it."""
    s = sizes(text)
    keys = stop * (stop + 1) // 2 - start * (start + 1) // 2
    return 2 * s["N"] * (s["Dn"] + s["Dr"] + s["Dv"]) * s["L"] * keys


def prefill_attention_calls(rows_n: List[int], S: int, T: int,
                            text: Dict[str, Any]
                            ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each layer's flash attention prefill call in
    the program: B = len(rows_n) rows of n real tokens left-padded to S,
    q [B, S, N, Dn + Dr] over the S prompt columns' decompressed K [B, S,
    N, Dn + Dr] and V [B, S, N, Dv] (the cache's T columns are not
    decompressed). Operations count the key pairs the causal rule allows;
    bytes are q, k, v, o and the log-sum-exp, each once."""
    s = sizes(text)
    N, Dqk, Dv = s["N"], s["Dn"] + s["Dr"], s["Dv"]
    B = len(rows_n)
    pairs = sum(n * (n + 1) // 2 for n in rows_n)
    flops = 2 * pairs * N * (Dqk + Dv)
    nbytes = 2 * B * S * N * (2 * Dqk + 2 * Dv) + B * N * S * 4
    return [(float(flops), float(nbytes))] * s["L"]
