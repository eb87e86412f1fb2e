"""The Qwen3 decoder (HF ``modeling_qwen3`` and ``modeling_qwen3_moe``),
dense or MoE: everything of the benchmark that depends on the decoder's
equations. A configuration names it (``"decoder": "qwen3"``) and the
harness loads it by that name; another architecture is another file here
with the same names.

- the program's side of the configuration, as data: the port's text
  configuration class and its names for the configuration's keys;
- ``draw``: the decoder's weights in the program's tree layout;
- ``decoder_logits``: its float32 forward (RMSNorm, q/k norms per head,
  rotary, grouped-query causal attention, SwiGLU or a top-k softmax router
  over SwiGLU experts with renormalised weights, the tied or untied head);
- ``token_flops``, ``attention_flops``, ``prefill_attention_calls``: its
  model FLOPs and its prefill's attention calls, for ``mfu`` and the
  attention roofline.

Plain PyTorch: it imports nothing of the program and nothing of JAX."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.model import f32, layer_f32, rms_norm, rope

# the port's text configuration class (in ``molly_tpu_torch.models.
# configs``), its model module (whose ``quantize_for_decode`` is the int8
# control), and its names for configuration keys where they differ: an
# MoE's expert width is the program's ``intermediate_size``
PROGRAM_CONFIG = "Qwen3Config"
PROGRAM_MODULE = "qwen3"
PROGRAM_KEYS = {"moe_intermediate_size": "intermediate_size"}


def sizes(text: Dict[str, Any]) -> Dict[str, int]:
    """H, I (the expert width for an MoE), L, Nq, Nkv, Dh, V, E, k."""
    E = int(text.get("num_experts", 0))
    return {"H": text["hidden_size"],
            "I": text["moe_intermediate_size"] if E else
            text["intermediate_size"],
            "L": text["num_hidden_layers"], "Nq": text["num_attention_heads"],
            "Nkv": text["num_key_value_heads"], "Dh": text["head_dim"],
            "V": text["vocab_size"], "E": E,
            "k": int(text.get("num_experts_per_tok", 0))}


def draw(d, text: Dict[str, Any]) -> Dict[str, Any]:
    """The decoder's weights from the drawer ``d`` (``harness.weights``):
    stacked [L, ...] layer weights, [in, out] linears; the MoE router drawn
    in the model dtype and kept in float32, as the program keeps it."""
    s = sizes(text)
    H, I, L, Dh = s["H"], s["I"], s["L"], s["Dh"]
    Dq, Dkv = s["Nq"] * Dh, s["Nkv"] * Dh
    layers = {"input_norm": d.ones(L, H), "post_attn_norm": d.ones(L, H),
              "q_proj": d.normal(L, H, Dq), "k_proj": d.normal(L, H, Dkv),
              "v_proj": d.normal(L, H, Dkv), "o_proj": d.normal(L, Dq, H),
              "q_norm": d.ones(L, Dh), "k_norm": d.ones(L, Dh)}
    if s["E"]:
        E = s["E"]
        layers["router"] = d.normal(L, H, E).to(torch.float32)
        layers["expert_gate"] = d.normal(L, E, H, I)
        layers["expert_up"] = d.normal(L, E, H, I)
        layers["expert_down"] = d.normal(L, E, I, H)
    else:
        layers["gate_proj"] = d.normal(L, H, I)
        layers["up_proj"] = d.normal(L, H, I)
        layers["down_proj"] = d.normal(L, I, H)
    out = {"embed": d.normal(s["V"], H), "layers": layers,
           "final_norm": d.ones(H)}
    if not text["tie_word_embeddings"]:
        out["lm_head"] = d.normal(H, s["V"])
    return out


def _moe(x: torch.Tensor, p: Dict[str, Any], text: Dict[str, Any]
         ) -> torch.Tensor:
    """Top-k softmax router over SwiGLU experts, weights renormalised."""
    probs = (x @ p["router"]).softmax(-1)
    w, e = probs.topk(text["num_experts_per_tok"], dim=-1)
    if text.get("norm_topk_prob", True):
        w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for ex in torch.unique(e).tolist():
        tok, slot = (e == ex).nonzero(as_tuple=True)
        xe = x[tok]
        y = (F.silu(xe @ p["expert_gate"][ex]) * (xe @ p["expert_up"][ex])
             ) @ p["expert_down"][ex]
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def decoder_logits(params: Dict[str, Any], text: Dict[str, Any],
                   embeds: Sequence[torch.Tensor],
                   rows: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each request's embeddings [N_i, H] through the decoder; returns the
    float32 logits [stop - start, V] at positions start .. stop - 1 of each
    request (``rows``). Weights are widened one layer at a time and the
    requests run layer by layer together."""
    Nq, Nkv, D = (text["num_attention_heads"], text["num_key_value_heads"],
                  text["head_dim"])
    eps = text["rms_norm_eps"]
    hs = [e.clone() for e in embeds]
    for i in range(text["num_hidden_layers"]):
        p = layer_f32(params["layers"], i)
        xs = []
        for j, h in enumerate(hs):
            S = h.shape[0]
            x = rms_norm(h, p["input_norm"], eps)
            q = rms_norm((x @ p["q_proj"]).view(S, Nq, D), p["q_norm"], eps)
            k = rms_norm((x @ p["k_proj"]).view(S, Nkv, D), p["k_norm"],
                         eps)
            v = (x @ p["v_proj"]).view(S, Nkv, D)
            q, k = rope(q, text["rope_theta"]), rope(k, text["rope_theta"])
            q = q.view(S, Nkv, Nq // Nkv, D)
            causal = torch.ones(S, S, dtype=torch.bool,
                                device=h.device).tril()
            out = torch.empty_like(q)
            for g in range(Nkv):  # one kv head at a time bounds the scores
                s = torch.einsum("qrd,kd->rqk", q[:, g], k[:, g]) * D ** -0.5
                s = s.masked_fill(~causal, -math.inf).softmax(-1)
                out[:, g] = torch.einsum("rqk,kd->qrd", s, v[:, g])
            hs[j] = h + out.reshape(S, Nq * D) @ p["o_proj"]
            xs.append(rms_norm(hs[j], p["post_attn_norm"], eps))
        if "router" in p:
            flat = _moe(torch.cat(xs), p, text)
            ys = list(flat.split([x.shape[0] for x in xs]))
        else:
            ys = [(F.silu(x @ p["gate_proj"]) * (x @ p["up_proj"]))
                  @ p["down_proj"] for x in xs]
        hs = [h + y for h, y in zip(hs, ys)]
        del p
    head = (f32(params["lm_head"]) if "lm_head" in params
            else f32(params["embed"]).T)
    final = f32(params["final_norm"])
    return [rms_norm(h[a:b], final, eps) @ head
            for h, (a, b) in zip(hs, rows)]


def token_flops(text: Dict[str, Any]) -> int:
    """Matrix-product operations of one decoder token through all layers,
    the head and attention's scores excluded (an MoE token: the router and
    its k experts); 2 operations a multiply-add."""
    H, D = text["hidden_size"], text["head_dim"]
    Dq, Dkv = text["num_attention_heads"] * D, text["num_key_value_heads"] * D
    proj = H * Dq + 2 * H * Dkv + Dq * H
    if text.get("num_experts"):
        ffn = (H * text["num_experts"]
               + text["num_experts_per_tok"] * 3 * H
               * text["moe_intermediate_size"])
    else:
        ffn = 3 * H * text["intermediate_size"]
    return 2 * text["num_hidden_layers"] * (proj + ffn)


def attention_flops(text: Dict[str, Any], start: int, stop: int) -> int:
    """Attention's operations (q.k and p.v) in all layers for the tokens
    at positions start .. stop - 1 of one sequence, each against the keys
    at or before it: every layer full causal."""
    Dq = text["num_attention_heads"] * text["head_dim"]
    keys = stop * (stop + 1) // 2 - start * (start + 1) // 2
    return 4 * Dq * text["num_hidden_layers"] * keys


def prefill_attention_calls(rows_n: List[int], S: int, T: int,
                            text: Dict[str, Any]
                            ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each layer's flash attention prefill call:
    B = len(rows_n) rows of n real tokens left-padded to S, q over the
    cache of S + T columns. Operations count the key pairs the causal rule
    allows; bytes are q, k, v, o and the log-sum-exp, each once."""
    Nq, Nkv, D = (text["num_attention_heads"], text["num_key_value_heads"],
                  text["head_dim"])
    B = len(rows_n)
    pairs = sum(n * (n + 1) // 2 for n in rows_n)
    flops = 4 * D * Nq * pairs
    nbytes = (2 * (B * S * Nq * D * 2) + 2 * (B * Nkv * (S + T) * D * 2)
              + B * Nq * S * 4)
    return [(float(flops), float(nbytes))] * text["num_hidden_layers"]
