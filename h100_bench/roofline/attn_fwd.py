"""Flash attention forward (``ops.flash_attention_fwd``) in a generate
batch: every encoder layer over its live segments (all K query rows, which
fill the placeholder rows, against the segment's live keys) and every
decoder layer's prefill (each query row against the live keys at or before
it; q over the cache of S + T columns). Operations count only the key
pairs the mask and the causal rule allow; bytes are q, k, v, o and the
log-sum-exp, each once. The arithmetic of the kernel table in PERF.md."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def decoder_prefill(rows_n: List[int], S: int, T: int, Nq: int, Nkv: int,
                    D: int) -> Tuple[float, float]:
    """(operations, bytes) of one decoder layer's prefill call: B = len(
    rows_n) rows of n real tokens left-padded to S."""
    B = len(rows_n)
    pairs = sum(n * (n + 1) // 2 for n in rows_n)
    flops = 4 * D * Nq * pairs
    nbytes = (2 * (B * S * Nq * D * 2) + 2 * (B * Nkv * (S + T) * D * 2)
              + B * Nq * S * 4)
    return float(flops), float(nbytes)


def encoder_layer(live: List[int], K: int, N: int, D: int
                  ) -> Tuple[float, float]:
    """(operations, bytes) of one encoder layer over the live segments
    (``live``: their live token counts), non-causal."""
    n = len(live)
    flops = 4 * D * N * K * sum(live)
    nbytes = 4 * (n * K * N * D * 2) + n * N * K * 4
    return float(flops), float(nbytes)


def calls(shape: Dict[str, Any], config: Dict[str, Any]
          ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each call in the batch."""
    text = config["text"]
    out = [decoder_prefill([r["n"] for r in shape["rows"]], shape["S"],
                           shape["T"], text["num_attention_heads"],
                           text["num_key_value_heads"], text["head_dim"])
           ] * text["num_hidden_layers"]
    for modality in ("dna_rna", "protein"):
        enc = config[modality]
        live = [n for r in shape["rows"] for m, n in r["segments"]
                if m == modality]
        if live:
            N = enc["num_attention_heads"]
            out += [encoder_layer(live, shape["k"][modality], N,
                                  enc["hidden_size"] // N)
                    ] * enc["num_hidden_layers"]
    return out
