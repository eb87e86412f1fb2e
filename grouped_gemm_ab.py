#!/usr/bin/env python3
"""Times the grouped GEMM's products over int8 experts and fp32 expert
adapters at the MoE shapes of qwen3-30b-a3b width (128 experts, top-8,
hidden 2048, expert width 768, LoRA rank 64) on one NVIDIA card, through
the ``molly_tpu_torch`` package of the tree given by ``--root`` (default:
the tree of this script), so that two trees compare in one call:

    python3 grouped_gemm_ab.py --root PARENT; python3 grouped_gemm_ab.py; ...

Each case is the call the main path makes for that product in that tree,
on the same seeded inputs (group sizes from a real router, one expert
empty, as ``chip_smoke.py`` makes them):
  - int8 forward: ``grouped_gemm(lhs, w_q, scale=...)``, bf16 lhs, fp32 out;
  - int8 lhs gradient (QLoRA): the scale folded into an fp32 ``dout`` by the
    row's group, then the product over w_q transposed into bf16, as the
    tree's autograd backward does it (``_lhs_grad`` where the tree has it);
    and the bare product from an fp32 lhs already scaled, as
    ``chip_smoke.py``'s case times it;
  - adapter forward: ``ops.moe._grouped_dot(bf16 lhs, fp32 adapter)`` (a
    tree that promotes the lhs to fp32 first pays that pass here too);
  - adapter lhs gradient: fp32 ``dout`` against the adapter transposed into
    bf16 (a tree whose kernel writes only fp32 pays the rounding pass).
Times are device milliseconds of a CUDA-graph replay of several calls,
timed by CUDA events (``chip_smoke.time_ms``). Prints the card's name and
power limit, then one JSON object per case: ms, the source that ran, and
the max-abs error against the plain version with the tolerance
``chip_smoke.py`` states. Exits non-zero without a card or on a parity miss.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

E, TOPK, H, I, R = 128, 8, 2048, 768, 64
TOKENS = {"prefill": 12288, "train": 4096}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=here,
                    help="the tree whose molly_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grouped_gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, here)
    import chip_smoke as cs  # the timing and routing helpers
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("molly_tpu_torch")]:
        del sys.modules[name]
    from molly_tpu_torch.ops import _cuda_build, moe
    from molly_tpu_torch.ops import grouped_gemm as gg
    assert os.path.abspath(gg.__file__).startswith(os.path.abspath(args.root))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda_build.build()
    g = torch.Generator("cuda").manual_seed(args.seed)
    dev = "cuda"
    b16, f32 = torch.bfloat16, torch.float32
    routes = ("launches_tma", "launches_int8_tma", "launches_tc",
              "launches_stream")

    def source(fn):
        before = [getattr(gg.grouped_gemm, r, 0) for r in routes]
        out = fn()
        moved = [getattr(gg.grouped_gemm, r, 0) > b
                 for r, b in zip(routes, before)]
        names = ("grouped_gemm_tma.cu", "grouped_gemm_int8_tma.cu",
                 "grouped_gemm_f32_tc.cu", "grouped_gemm_decode.cu")
        return out, (names[moved.index(True)] if any(moved)
                     else "grouped_gemm.cu")

    def int8_dlhs(dout, w_q, gs, scale):
        """The tree's lhs gradient of ``grouped_gemm(x, w_q, scale)``."""
        if hasattr(gg, "_lhs_grad"):
            return gg._lhs_grad(dout, w_q, gs, scale, True, b16)
        eid = gg.row_groups(gs, dout.shape[0]).clamp(max=E - 1)
        return gg._forward(dout * scale[eid], w_q, gs, True, b16, None)

    def adapter_dlhs(dout, w, gs):
        """fp32 dout against the adapter transposed, into bf16."""
        if hasattr(gg, "f32_takes_tc"):
            return gg.grouped_gemm(dout, w, gs, transpose_rhs=True,
                                   out_dtype=b16)
        return gg.grouped_gemm(dout, w, gs, transpose_rhs=True).to(b16)

    def run(name, phase, K, N, kind):
        M = TOKENS[phase] * TOPK
        gs = cs.routed_group_sizes(g, TOKENS[phase], H, E, TOPK,
                                   empty=E // 2)
        bounds = gg._bounds(gs, M)
        trans = kind in ("int8_dlhs", "int8_dlhs_bare", "adapter_dlhs")
        shape = (E, N, K) if trans else (E, K, N)
        scale = None
        if kind.startswith("int8"):
            w = torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8)
            scale = (torch.rand((E, K if trans else N), generator=g,
                                device=dev) * 1e-3 + 1e-4) * K ** -0.5
        else:
            w = torch.randn(shape, generator=g, device=dev) * K ** -0.5
        lhs = torch.randn((M, K), generator=g, device=dev)
        if kind == "int8_fwd":
            lhs16 = lhs.to(b16)
            call = lambda: gg.grouped_gemm(  # noqa: E731
                lhs16, w, gs, scale=scale)
            ref = lambda: gg.grouped_gemm_plain(  # noqa: E731
                lhs16, w, gs, scale=scale, bounds=bounds)
        elif kind == "int8_dlhs":
            call = lambda: int8_dlhs(lhs, w, gs, scale)  # noqa: E731
            eid = gg.row_groups(gs, M).clamp(max=E - 1)
            ref = lambda: gg.grouped_gemm_plain(  # noqa: E731
                lhs * scale[eid], w, gs, transpose_rhs=True, bounds=bounds)
        elif kind == "int8_dlhs_bare":
            call = lambda: gg.grouped_gemm(  # noqa: E731
                lhs, w, gs, transpose_rhs=True, out_dtype=b16)
            ref = lambda: gg.grouped_gemm_plain(  # noqa: E731
                lhs, w, gs, transpose_rhs=True, bounds=bounds)
        elif kind == "adapter_fwd":
            lhs16 = lhs.to(b16)
            call = lambda: moe._grouped_dot(lhs16, w, gs)  # noqa: E731
            ref = lambda: gg.grouped_gemm_plain(  # noqa: E731
                lhs16, w, gs, bounds=bounds)
        else:
            call = lambda: adapter_dlhs(lhs, w, gs)  # noqa: E731
            ref = lambda: gg.grouped_gemm_plain(  # noqa: E731
                lhs, w, gs, transpose_rhs=True, bounds=bounds)
        out, src = source(call)
        want = ref()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        rel = cs.GG_F32_REL if out.dtype == f32 and not kind.startswith(
            "int8") else cs.GG_BF16_REL
        tol = rel * want.abs().max().item()
        del want, out
        ms = cs.time_ms(call, args.iters)
        print(json.dumps({"case": name, "ms": ms, "source": src,
                          "max_abs_err": err, "tol": tol,
                          "root": os.path.abspath(args.root)}), flush=True)
        if not err <= tol:
            raise AssertionError(f"{name}: parity miss, {err} > {tol}")
        torch.cuda.empty_cache()

    run("prefill_gateup_int8", "prefill", H, 2 * I, "int8_fwd")
    run("prefill_down_int8", "prefill", I, H, "int8_fwd")
    run("qlora_gate_int8", "train", H, I, "int8_fwd")
    run("qlora_down_int8", "train", I, H, "int8_fwd")
    run("qlora_dlhs_int8_with_scale_pass", "train", I, H, "int8_dlhs")
    run("qlora_dlhs_down_int8_with_scale_pass", "train", H, I, "int8_dlhs")
    run("qlora_dlhs_f32xint8T", "train", I, H, "int8_dlhs_bare")
    run("qlora_dlhs_down_f32xint8T", "train", H, I, "int8_dlhs_bare")
    run("lora_a", "train", H, R, "adapter_fwd")
    run("lora_a_down", "train", I, R, "adapter_fwd")
    run("lora_b", "train", R, I, "adapter_fwd")
    run("lora_b_down", "train", R, H, "adapter_fwd")
    run("lora_dlhs_b", "train", I, R, "adapter_dlhs")
    run("lora_dlhs_b_down", "train", H, R, "adapter_dlhs")
    run("lora_dlhs_a", "train", R, H, "adapter_dlhs")
    run("lora_dlhs_a_down", "train", R, I, "adapter_dlhs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
