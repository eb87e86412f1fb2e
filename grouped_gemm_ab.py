#!/usr/bin/env python3
"""Times kernels of the port on one NVIDIA card through the
``molly_tpu_torch`` package of the tree given by ``--root`` (default: the
tree of this script), so that two trees compare in one call:

    python3 grouped_gemm_ab.py --root PARENT; python3 grouped_gemm_ab.py; ...

``--sections`` picks what runs (default: all):
  - ``grouped``: the grouped GEMM's products over int8 experts and fp32
    expert adapters at the MoE shapes of qwen3-30b-a3b width (128 experts,
    top-8, hidden 2048, expert width 768, LoRA rank 64);
  - ``tgmm``: the fp32 weight gradients of the four expert adapters, from
    a bf16 lhs and an fp32 ``dout`` through the call the tree's autograd
    backward makes (a tree that widened the lhs to fp32 first pays that
    pass here too); ``tgmm_plans`` adds the tensor-core kernel's time at
    each of its tiles (trees that have it);
  - ``rmsnorm``: the RMSNorm forward at every shape of the main paths (the
    fused branch's stacked qk_norm also as the strided view of the qkv
    product it is handed) and its backward at the training shapes, with
    and without dw, beside ``F.rms_norm``'s autograd backward;
    ``rmsnorm_bwd_plans`` adds the backward's time at each setting of its
    plan's knobs (trees that have ``rmsnorm_bwd_plan``);
  - ``int8``: the int8 weight-only GEMM at every decode shape of the main
    paths (M = 4) and at the prefill and QLoRA shapes;
  - ``gemv_splits``: the int8 weight stream (``csrc/int8_matmul_stream.cu``)
    at each decode shape for every split count of K from 1 to 8, beside
    the one ``quant.gemv_plan`` picks (trees that have the stream only).
A ``rmsnorm`` or ``int8`` case prints the bound (``chip_smoke.bound``) and
the library call (``F.rms_norm``, 1-D weights) or, for int8, cuBLAS's bf16
product over the weights dequantized beforehand as a yardstick.

Each grouped case is the call the main path makes for that product in that
tree, on the same seeded inputs (group sizes from a real router, one expert
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
# (M, K, N) of the int8 GEMM at decode: the lm head, 1.7B down, qkv, o and
# gate-up, the MoE decoder's qkv and o
DECODE_INT8 = ((4, 2048, 151936), (4, 6144, 2048), (4, 2048, 4096),
               (4, 2048, 2048), (4, 2048, 12288), (4, 2048, 5120),
               (4, 4096, 2048))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=here,
                    help="the tree whose molly_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--sections", default="grouped,tgmm,rmsnorm,int8",
                    help="comma-separated: grouped, tgmm, rmsnorm, int8, "
                         "gemv_splits, tgmm_plans, rmsnorm_bwd_plans")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
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
    from molly_tpu_torch.ops import _cuda_build, moe, quant, rmsnorm_triton
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

    def emit(**fields):
        print(json.dumps({**fields, "root": os.path.abspath(args.root)}),
              flush=True)

    def rhs_grad(lhs16, dout, gs):
        """The tree's autograd backward for an fp32 adapter's gradient: a
        tree without ``_rhs_grad`` widened the bf16 lhs to fp32 first."""
        if hasattr(gg, "_rhs_grad"):
            return gg._rhs_grad(lhs16, dout, gs, False, f32)
        return gg.grouped_gemm_tgmm(lhs16.to(f32), dout, gs, f32)

    def tgmm(name, K, N):
        """An fp32 adapter's weight gradient [G, K, N] from a bf16 lhs
        [M, K] and an fp32 dout [M, N] (the QLoRA step's LoRA A and B), as
        the tree's backward computes it. Bound: bytes with the bf16 lhs and
        three split bf16 products; the SIMT bound beside it."""
        M = TOKENS["train"] * TOPK
        gs = cs.routed_group_sizes(g, TOKENS["train"], H, E, TOPK,
                                   empty=E // 2)
        lhs = torch.randn((M, K), generator=g, device=dev).to(b16)
        dout = torch.randn((M, N), generator=g, device=dev)
        call = lambda: rhs_grad(lhs, dout, gs)  # noqa: E731
        c = gg.grouped_gemm_tgmm
        tc0 = getattr(c, "launches_tc", 0)
        out = call()
        src = ("grouped_gemm_f32_tc.cu" if getattr(c, "launches_tc", 0) > tc0
               else "grouped_gemm.cu")
        bit_equal = torch.equal(out, call())
        want = gg.grouped_gemm_tgmm_plain(lhs, dout, gs, f32,
                                          bounds=gg._bounds(gs, M))
        err = (out - want).abs().max().item()
        tol = cs.GG_F32_REL * want.abs().max().item()
        del want, out
        nb = cs.nbytes(lhs, dout, gs) + 4 * E * K * N
        bound_ms, by = cs.bound(nb, 3 * 2 * M * K * N, "bf16")
        emit(case=name, ms=cs.time_ms(call, args.iters), source=src,
             bit_equal=bit_equal, max_abs_err=err, tol=tol,
             bound_ms=bound_ms, bound_by=by,
             simt_bound_ms=cs.bound(nb, 2 * M * K * N, "fp32")[0],
             largest_group=int(gs.max()))
        if not err <= tol or not bit_equal:
            raise AssertionError(f"{name}: parity miss, {err} > {tol}")
        if "tgmm_plans" in sections and hasattr(gg, "tgmm_tc_plan"):
            # the tensor-core kernel at each of its tiles, beside the one
            # ``tgmm_tc_plan`` picks
            lib, res = gg._lib_tc(), torch.empty_like(c(lhs, dout, gs, f32))
            ms = {}
            for plan in range(2):
                ms[plan] = cs.time_ms(
                    lambda: _cuda_build.check(  # noqa: B023
                        lib, lib.molly_grouped_gemm_tgmm_f32_tc(
                            lhs.data_ptr(), dout.data_ptr(), res.data_ptr(),
                            gs.data_ptr(), M, K, N, E, plan,  # noqa: B023
                            torch.cuda.current_stream().cuda_stream),
                        "tgmm tc"), args.iters)
            emit(case=f"{name} by plan", plan=gg.tgmm_tc_plan(K, N),
                 ms_by_plan=ms)

    def norm(name, shape, w_shape, qkv_width=None, iters=20):
        """The RMSNorm forward over bf16 rows (with ``qkv_width``, the view
        ``qkv[..., :N Dh]`` of a [B, S, qkv_width] product)."""
        if qkv_width is None:
            x = torch.randn(shape, generator=g, device=dev).to(b16)
        else:
            qkv = torch.randn((*shape[:2], qkv_width), generator=g,
                              device=dev).to(b16)
            x = qkv[..., :shape[2] * shape[3]].reshape(shape)
        w = (1 + 0.1 * torch.randn(w_shape, generator=g, device=dev)).to(b16)
        call = lambda: rmsnorm_triton.rms_norm(x, w, 1e-6)  # noqa: E731
        y = call()
        ref = rmsnorm_triton.rms_norm_plain(x.float(), w.float(), 1e-6)
        excess = ((y.float() - ref).abs() - cs.RMS_REL * ref.abs()).max()
        bit_equal = torch.equal(y, call())
        del ref
        library_ms = (cs.time_ms(lambda: torch.nn.functional.rms_norm(
            x, (shape[-1],), w, 1e-6), iters) if len(w_shape) == 1 else None)
        bound_ms, by = cs.bound(cs.nbytes(x, w, y), 4 * x.numel(), "fp32")
        emit(case=name, ms=cs.time_ms(call, iters),
             excess_over_2e7_rel=excess.item(), bit_equal=bit_equal,
             bound_ms=bound_ms, bound_by=by, library_ms=library_ms)
        if excess.item() > 0 or not bit_equal:
            raise AssertionError(f"{name}: parity miss")

    def norm_bwd(name, shape, iters=20):
        """The RMSNorm backward of bf16 rows, 1-D weight: with dw, without
        (a frozen norm), and ``F.rms_norm``'s autograd backward."""
        x = torch.randn(shape, generator=g, device=dev).to(b16)
        gr = torch.randn(shape, generator=g, device=dev).to(b16)
        w = (1 + 0.1 * torch.randn((shape[-1],), generator=g,
                                   device=dev)).to(b16)
        call = lambda: rmsnorm_triton.rms_norm_bwd(  # noqa: E731
            x, w, gr, 1e-6, True)
        dx, dw = call()
        dx2, dw2 = call()
        bit_equal = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        library_ms = cs.time_ms(
            lambda yl: torch.autograd.grad(yl, (xl, wl), gr,
                                           retain_graph=True),
            iters, setup=lambda: torch.nn.functional.rms_norm(
                xl, (shape[-1],), wl, 1e-6))
        bound_ms, by = cs.bound(cs.nbytes(x, gr, w, dx, dw), 12 * x.numel(),
                                "fp32")
        emit(case=name, ms=cs.time_ms(call, iters),
             ms_without_dw=cs.time_ms(lambda: rmsnorm_triton.rms_norm_bwd(
                 x, w, gr, 1e-6, False), iters), bit_equal=bit_equal,
             bound_ms=bound_ms, bound_by=by, library_ms=library_ms)
        if "rmsnorm_bwd_plans" in sections and hasattr(
                rmsnorm_triton, "rmsnorm_bwd_plan"):
            # the plan's knobs: programs an SM, stages in flight, tile
            # size; [with dw, without]
            m = rmsnorm_triton
            saved = dict(m._BWD_PLAN)
            ms = {}
            try:
                for per_sm in (1, 2, 4):
                    for stages in (1, 2, 3):
                        for tile in (4096, 8192):
                            m._BWD_PLAN = dict.fromkeys(
                                (True, False), (per_sm, stages, tile))
                            ms[f"{per_sm}/{stages}/{tile}"] = [
                                cs.time_ms(call, iters), cs.time_ms(
                                    lambda: m.rms_norm_bwd(
                                        x, w, gr, 1e-6, False), iters)]
            finally:
                m._BWD_PLAN = saved
            emit(case=f"{name} by programs an SM/stages/tile", ms_by=ms)
            # the two kernels of the dw path apart, at the plan
            H = shape[-1]
            x2, g2 = x.reshape(-1, H), gr.reshape(-1, H)
            rows, tiles, programs, warps, stages = m.rmsnorm_bwd_plan(
                x2.shape[0], H, _cuda_build.sm_count(0))
            dwp = torch.empty((programs, H), dtype=f32, device=dev)
            dx_, dw_ = torch.empty_like(x2), torch.empty_like(w)
            prows = m._next_pow2(programs)
            cols = max(16, m._DW_TILE // prows)
            main_ms = cs.time_ms(lambda: m._BWD_KERNEL[(programs,)](
                x2, w, g2, dx_, dwp, x2.shape[0], H, tiles, x2.stride(0),
                g2.stride(0), dx_.stride(0), 1e-6, BLOCK=m._next_pow2(H),
                ROWS=rows, NEED_DW=True, STAGES=stages,
                num_warps=warps), iters)
            finish_ms = cs.time_ms(lambda: m._DW_KERNEL[(-(-H // cols),)](
                dwp, dw_, programs, H, COLS=cols, ROWS=prows, num_warps=4),
                iters)
            emit(case=f"{name} apart", main_with_partials_ms=main_ms,
                 finish_ms=finish_ms, programs=programs)

    def int8(name, M, K, N, iters=20):
        """The int8 GEMM over bf16 x, as the main path calls it."""
        x = torch.randn((M, K), generator=g, device=dev).to(b16)
        q = {"w_q": torch.randint(-127, 128, (K, N), generator=g,
                                  device=dev, dtype=torch.int8),
             "scale": torch.rand((N,), generator=g, device=dev) * 1e-3
             + 1e-4}
        c = quant.int8_matmul
        before = (c.launches_tma, c.launches_gemv)
        y = quant.int8_matmul(x, q)
        route = ("tma" if c.launches_tma > before[0] else
                 "gemv" if c.launches_gemv > before[1] else "simt")
        bit_equal = torch.equal(y, quant.int8_matmul(x, q))
        ref = quant.int8_matmul_plain(x.float(), q)
        err = (y.float() - ref).abs().max().item()
        tol = cs.INT8_REL * ref.abs().max().item()
        del ref
        w16 = (q["w_q"].float() * q["scale"]).to(b16)
        yard = cs.time_ms(lambda: x @ w16, iters)
        del w16
        bound_ms, by = cs.bound(cs.nbytes(x, q["w_q"], q["scale"], y),
                                2 * M * K * N, "bf16")
        emit(case=name, ms=cs.time_ms(lambda: quant.int8_matmul(x, q),
                                      iters),
             route=route, bit_equal=bit_equal, max_abs_err=err, tol=tol,
             bound_ms=bound_ms, bound_by=by, cublas_bf16_yardstick_ms=yard)
        if not err <= tol:
            raise AssertionError(f"{name}: parity miss, {err} > {tol}")

    if "rmsnorm" in sections:
        for name, shape, w_shape, width in (
                ("hidden[12288,2048]", (12288, 2048), (2048,), None),
                ("qk_norm[4,3072,24,128]", (4, 3072, 24, 128), (24, 128),
                 None),
                ("qk_norm_view[4,3072,24,128] of [4,3072,4096]",
                 (4, 3072, 24, 128), (24, 128), 4096),
                ("decode[4,1,2048]", (4, 1, 2048), (2048,), None),
                ("train_hidden[4096,2048]", (4096, 2048), (2048,), None),
                ("train_q_norm[4,1024,16,128]", (4, 1024, 16, 128), (128,),
                 None),
                ("k_norm[4,3072,8,128]", (4, 3072, 8, 128), (128,), None),
                ("moe_q_norm[4,3072,32,128]", (4, 3072, 32, 128), (128,),
                 None),
                ("moe_qk_norm_view[4,3072,36,128] of [4,3072,5120]",
                 (4, 3072, 36, 128), (36, 128), 5120)):
            norm(name, shape, w_shape, width)
        for name, shape in (("bwd_train_hidden[4096,2048]", (4096, 2048)),
                            ("bwd_train_q_norm[4,1024,16,128]",
                             (4, 1024, 16, 128)),
                            ("bwd_train_k_norm[4,1024,8,128]",
                             (4, 1024, 8, 128)),
                            ("bwd_moe_q_norm[4,1024,32,128]",
                             (4, 1024, 32, 128)),
                            ("bwd_moe_k_norm[4,1024,4,128]",
                             (4, 1024, 4, 128))):
            norm_bwd(name, shape)
        torch.cuda.empty_cache()
    if "int8" in sections:
        for name, M, K, N in (
                *((f"decode[{M},{K}]x[{K},{N}]", M, K, N)
                  for M, K, N in DECODE_INT8),
                ("qkv_prefill[12288,2048]x[2048,4096]", 12288, 2048, 4096),
                ("qlora_gate[4096,2048]x[2048,6144]", 4096, 2048, 6144),
                ("qlora_down[4096,6144]x[6144,2048]", 4096, 6144, 2048)):
            int8(name, M, K, N, 20 if M <= 16 else 5)
        torch.cuda.empty_cache()
    if "gemv_splits" in sections:
        lib = quant._int8_stream_lib()
        for M, K, N in DECODE_INT8:
            x = torch.randn((M, K), generator=g, device=dev).to(b16)
            w_q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                                dtype=torch.int8)
            scale = torch.rand((N,), generator=g, device=dev) + 1e-3
            out = torch.empty((M, N), dtype=b16, device=dev)
            tiles, _, _ = plan = quant.gemv_plan(
                K, N, _cuda_build.sm_count(out.device.index))
            stages, ms = K // 64, {}
            for splits in range(1, 9):
                per = -(-stages // splits)
                if -(-stages // per) != splits:
                    continue  # the same cut as a smaller count
                ms[splits] = cs.time_ms(
                    lambda: _cuda_build.check(  # noqa: B023
                        lib, lib.molly_int8_gemv_stream(
                            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                            out.data_ptr(), M, K, N, tiles, splits, per,
                            torch.cuda.current_stream().cuda_stream),
                        "int8 stream"), 20)
            emit(case=f"gemv_splits[{M},{K}]x[{K},{N}]", plan=plan,
                 ms_by_splits=ms)
        torch.cuda.empty_cache()
    if "tgmm" in sections:
        tgmm("tgmm_lora_a_fp32[2048,32768].[32768,64]", H, R)
        tgmm("tgmm_lora_a_down_fp32[768,32768].[32768,64]", I, R)
        tgmm("tgmm_lora_b_fp32[64,32768].[32768,768]", R, I)
        tgmm("tgmm_lora_b_down_fp32[64,32768].[32768,2048]", R, H)
        torch.cuda.empty_cache()
    if "grouped" not in sections:
        return 0
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
