"""The fusion model's forward in float32 plain PyTorch, from a
configuration file's contents and the benchmark's weights: the ESM-family
encoders (HF ``modeling_esm``: token-dropout rescale, pre-LN blocks, q
scaled before rotary, exact GELU or NT-v2's bias-free SwiGLU, final
LayerNorm), the linear projectors, the overwrite of each segment's k
placeholder rows, and the decoder that the configuration names
(``reference/<decoder>.py``, its ``decoder_logits``).

No cache and no padding: every request is one unpadded sequence, its
prompt followed by the tokens it was served. Weights are widened to float32
one layer at a time, and the requests run layer by layer together, so the
check fits beside the model. TF32 is off while it runs."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

MASK_RATIO_TRAIN = 0.15 * 0.8


@contextmanager
def full_float32():
    """float32 products in float32 (not TF32) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def layer_f32(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's weights in float32."""
    return {k: (layer_f32(v, i) if isinstance(v, dict) else f32(v[i]))
            for k, v in stacked.items()}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, N, D], positions 0 .. S-1, GPT-NeoX half split."""
    S, D = x.shape[-3], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]          # [S, 1, D]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * ang.cos() + rot * ang.sin()


def _layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def encoder(params: Dict[str, Any], enc: Dict[str, Any],
            tokens: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """tokens [n, K] (pad 1) -> final hidden states [n, K, H]. Every query
    row is computed, padded ones too (their outputs fill placeholder rows);
    keys are the non-pad tokens, position 0 always among them."""
    outs = []
    for c0 in range(0, tokens.shape[0], chunk):
        ids = tokens[c0:c0 + chunk]
        mask = ids != enc["pad_token_id"]
        mask[:, 0] = True
        emb = f32(params["embed"])[ids]
        if enc["token_dropout"]:
            is_mask = ids == enc["mask_token_id"]
            emb = emb.masked_fill(is_mask[..., None], 0.0)
            observed = is_mask.sum(-1) / mask.sum(-1)
            emb = emb * ((1 - MASK_RATIO_TRAIN) / (1 - observed))[:, None,
                                                                   None]
        if enc.get("position_embedding_type") == "absolute":
            m = mask.to(torch.long)
            pos = torch.cumsum(m, 1) * m + enc["pad_token_id"]
            emb = emb + f32(params["pos_embed"])[pos]
        if enc.get("emb_layer_norm_before"):
            emb = _layer_norm(emb, {k: f32(v) for k, v in
                                    params["emb_ln"].items()},
                              enc["layer_norm_eps"])
        h = emb * mask[..., None]
        n, K, H = h.shape
        N = enc["num_attention_heads"]
        D = H // N
        bias = torch.where(mask, 0.0, -math.inf)[:, None, None, :]
        for i in range(enc["num_hidden_layers"]):
            p = layer_f32(params["layers"], i)
            x = _layer_norm(h, p["attn_ln"], enc["layer_norm_eps"])
            q = (x @ p["q"] + p["q_b"]).view(n, K, N, D) * D ** -0.5
            k = (x @ p["k"] + p["k_b"]).view(n, K, N, D)
            v = (x @ p["v"] + p["v_b"]).view(n, K, N, D)
            if enc.get("position_embedding_type", "rotary") == "rotary":
                q, k = rope(q, 1e4), rope(k, 1e4)
            s = torch.einsum("bqnd,bknd->bnqk", q, k) + bias
            a = torch.einsum("bnqk,bknd->bqnd", s.softmax(-1), v)
            h = h + a.reshape(n, K, H) @ p["attn_out"] + p["attn_out_b"]
            x = _layer_norm(h, p["ffn_ln"], enc["layer_norm_eps"])
            if enc["mlp_type"] == "swiglu":
                x = F.silu(x @ p["ffn_gate"]) * (x @ p["ffn_in"])
            else:
                x = F.gelu(x @ p["ffn_in"] + p["ffn_in_b"])
            x = x @ p["ffn_out"]
            if enc["mlp_bias"]:
                x = x + p["ffn_out_b"]
            h = h + x
        final = {k: f32(v) for k, v in params["final_ln"].items()}
        outs.append(_layer_norm(h, final, enc["layer_norm_eps"]))
    return torch.cat(outs)


def served_logits(params: Dict[str, Any], config: Dict[str, Any],
                  requests: Sequence[Dict[str, Any]], decoder
                  ) -> List[torch.Tensor]:
    """Each request ``{ids, segments, served}`` (prompt ids, the segments
    of ``prompt.build``, the served token ids) -> the reference's float32
    logits [len(served), V]: row j is what predicts served token j.
    ``decoder``: the configuration's ``reference/<decoder>.py``."""
    dev = params["text"]["embed"].device
    H = config["text"]["hidden_size"]
    proj = {}
    for modality in ("dna_rna", "protein"):
        segs = [(r, start, enc) for r, req in enumerate(requests)
                for m, start, enc in req["segments"] if m == modality]
        if not segs:
            continue
        toks = torch.tensor([s[2] for s in segs], device=dev)
        hidden = encoder(params[modality], config[modality], toks)
        pw = params[f"{modality}_projector"]
        out = hidden @ f32(pw["kernel"]) + f32(pw["bias"])
        for (r, start, _), o in zip(segs, out):
            proj.setdefault(r, []).append((start, o))
    embeds, rows = [], []
    table = params["text"]["embed"]
    for r, req in enumerate(requests):
        ids = list(req["ids"]) + list(req["served"][:-1])
        e = f32(table[torch.tensor(ids, device=dev)])
        for start, o in proj.get(r, []):
            n = min(o.shape[0], e.shape[0] - start - 1)
            e[start + 1:start + 1 + n] = o[:n]
        embeds.append(e.reshape(-1, H))
        n_prompt = len(req["ids"])
        rows.append((n_prompt - 1, n_prompt - 1 + len(req["served"])))
    return decoder.decoder_logits(params["text"], config["text"], embeds,
                                  rows)


def greedy_gaps(logits: torch.Tensor, served: Sequence[int],
                penalty: float) -> torch.Tensor:
    """Per served token, the gap by which its logit lies below the
    reference's best, after the repetition penalty over the tokens served
    before it (the greedy rule): 0 where the token is the reference's
    argmax."""
    tok = torch.tensor(list(served), device=logits.device)
    lg = logits[:len(served)]
    if penalty != 1.0:
        # seen[j, v]: token v was served before position j
        seen = torch.zeros_like(lg, dtype=torch.bool)
        for j in range(1, len(served)):
            seen[j] = seen[j - 1]
            seen[j, tok[j - 1]] = True
        lg = torch.where(seen, torch.where(lg > 0, lg / penalty,
                                           lg * penalty), lg)
    return lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]


def gap_numbers(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers a generation check can compare over all checked tokens:
    the widest gap, the mean gap, the mean squared gap, and the share of
    tokens that are not the reference's argmax."""
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "mean_sq_logit_gap": float(gaps.square().mean()),
            "flip_share": float((gaps > 0).to(torch.float32).mean())}
