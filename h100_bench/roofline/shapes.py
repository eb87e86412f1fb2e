"""The shape of one generate batch as the roofline and FLOP counts read it,
built from the reference's own prompt building (not from the program's
encoded arrays): per row the real prompt tokens, the live tokens of each
segment, and the tokens emitted."""

from __future__ import annotations

from typing import Any, Dict, List


def batch_shape(prompts: List[Any], traffic: Dict[str, Any],
                emitted: List[int]) -> Dict[str, Any]:
    """``prompts``: ``reference.prompt.build`` results of the batch's rows,
    in order; ``emitted``: tokens each row emitted, its EOS included."""
    rows = []
    for (ids, segments), e in zip(prompts, emitted):
        rows.append({"n": len(ids), "emitted": int(e),
                     "segments": [(m, sum(1 for t in enc if t != 1))
                                  for m, _, enc in segments]})
    return {"B": traffic["batch_size"], "S": traffic["max_length"],
            "T": traffic["max_new_tokens"],
            "k": {"dna_rna": traffic["dna_rna_k_tokens"],
                  "protein": traffic["protein_k_tokens"]},
            "rows": rows}
