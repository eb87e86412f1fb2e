"""Flash attention forward at multi-head latent attention's widths (q.k of
qk_nope + qk_rope, v of v_head_dim) in a generate batch: every decoder
layer's prefill call, as the decoder's file counts them
(``prefill_attention_calls``): operations 2 x the key pairs the mask and
the causal rule allow x heads x (q.k + v width); bytes q, k, v, o and the
log-sum-exp, each once. None of a decoder without a latent. The
arithmetic of the kernel table in PERF.md."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def calls(shape: Dict[str, Any], config: Dict[str, Any], decoder
          ) -> List[Tuple[float, float]]:
    text = config["text"]
    if "kv_lora_rank" not in text:
        return []
    return list(decoder.prefill_attention_calls(
        [r["n"] for r in shape["rows"]], shape["S"], shape["T"], text))
