"""The grouped GEMMs of an MoE decoder's prefill (``ops.grouped_gemm``
under ``ops.moe.moe_mlp``): per layer gate and up [R, H] x [E, H, I] and
down [R, I] x [E, I, H], fp32 results, where R counts the routed rows of
the real prompt tokens only (k a token) and E the experts those rows reach.
Operations 2 R K N; bytes the lhs, the reached experts' weights and the
fp32 result, each once. The arithmetic of the kernel table in PERF.md."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def gemm(rows: int, K: int, N: int, experts: int, lhs_bytes: int = 2,
         rhs_bytes: int = 2, out_bytes: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one grouped product."""
    flops = 2 * rows * K * N
    nbytes = rows * K * lhs_bytes + experts * K * N * rhs_bytes \
        + rows * N * out_bytes
    return float(flops), float(nbytes)


def experts_reached(tokens: int, E: int, k: int) -> int:
    """Expected experts with a routed row among ``tokens`` tokens routed
    uniformly to k of E (the router's choices are the program's; with
    thousands of tokens this is E)."""
    return min(E, round(E * (1 - (1 - k / E) ** tokens)))


def calls(shape: Dict[str, Any], config: Dict[str, Any]
          ) -> List[Tuple[float, float]]:
    text = config["text"]
    E = int(text.get("num_experts", 0))
    if not E:
        return []
    H, I, k = (text["hidden_size"], text["moe_intermediate_size"],
               text["num_experts_per_tok"])
    tokens = sum(r["n"] for r in shape["rows"])
    R, reach = tokens * k, experts_reached(tokens, E, k)
    layer = [gemm(R, H, I, reach), gemm(R, H, I, reach),
             gemm(R, I, H, reach)]
    return layer * text["num_hidden_layers"]
