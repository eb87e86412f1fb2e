"""Flash attention forward (``ops.flash_attention_fwd``) in a generate
batch: every encoder layer over its live segments (all K query rows, which
fill the placeholder rows, against the segment's live keys) and every
decoder layer's prefill (each query row against the live keys its layer
lets it read, as the decoder's file counts them). Operations count only
the key pairs the mask and the attention rule allow; bytes are q, k, v, o
and the log-sum-exp, each once. The arithmetic of the kernel table in
PERF.md."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def encoder_layer(live: List[int], K: int, N: int, D: int
                  ) -> Tuple[float, float]:
    """(operations, bytes) of one encoder layer over the live segments
    (``live``: their live token counts), non-causal."""
    n = len(live)
    flops = 4 * D * N * K * sum(live)
    nbytes = 4 * (n * K * N * D * 2) + n * N * K * 4
    return float(flops), float(nbytes)


def calls(shape: Dict[str, Any], config: Dict[str, Any], decoder
          ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each call in the batch: the decoder's prefill
    calls as its ``reference/<decoder>.py`` counts them, one a layer, then
    the encoders'."""
    out = list(decoder.prefill_attention_calls(
        [r["n"] for r in shape["rows"]], shape["S"], shape["T"],
        config["text"]))
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
