"""RMSNorm forward and backward: the wrappers of two hand-written Triton
kernels, their plain PyTorch versions, and the autograd function that joins
them.

Replaces ``molly_tpu/ops/rmsnorm_pallas.py:_fwd_kernel`` (launched from
``_fwd``) and ``:_bwd_kernel`` (launched from ``_bwd``). y = w * cast(x * rsqrt(mean(x^2) + eps)): the reduction runs in
fp32, and the weight multiplies *after* the cast back to the input dtype
(HF Qwen3RMSNorm, ``molly_tpu/ops/norms.py``).

What bounds it on this card: one read and one write of each row with a
handful of operations per element — far below the card's ops-per-byte
ridge, so it is bound by device-memory bandwidth, and for the narrow
per-head rows (Dh = 128) by how many rows are in flight. The design: one
program per row, the whole row in registers (one read, one write, no
second pass), the weight row picked as ``weight[row % W]`` so one kernel
serves the 1-D norms (W = 1), the per-head q/k norms and the fused decode
branch's stacked [Nq+Nkv, Dh] ``qk_norm``.

The backward, as the Pallas kernel: inv is recomputed from x,
dx = (w*g - x_hat * mean(w*g*x_hat)) * inv and dw = sum over rows of
g * x_hat, in fp32 (the rounding of x_hat before the weight is not
differentiated). It reads x and g and writes dx once — bound by device-memory
bandwidth again, with no tensor-core work. The Pallas kernel carries its dw
accumulator from grid step to grid step; blocks on the card run in no order,
so each program takes a strip of rows (a [rows, H] tile per iteration, many
rows at once for the narrow per-head norms), keeps its dw partial [H] in
fp32 registers and writes one row of a [programs, H] buffer that the wrapper
sums — no atomics, the same result every run. The strips are sized so that
about 500 programs are in flight whatever the row count; the dw partials are
skipped when the weight needs no gradient. Only 1-D weights have a backward:
the stacked per-head form is the fused decode branch.

``triton`` is imported inside the launching function, so this module
imports on a machine without it.
"""

from __future__ import annotations

import torch

_KERNEL = None
_BWD_KERNEL = None
_BWD_TILE = 4096      # elements of a [rows, H] tile per loop iteration
_BWD_PROGRAMS = 528   # 4 per SM of a 132-SM card
_BWD_WARPS = 4


def _rows_and_weight(x: torch.Tensor, weight: torch.Tensor):
    """x [..., H] and weight of shape x.shape[-weight.ndim:] -> (x as
    [R, H], weight as [W, H]) with row r normalised by weight[r % W]."""
    H = x.shape[-1]
    if tuple(weight.shape) != tuple(x.shape[x.ndim - weight.ndim:]):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match the trailing dims of x {tuple(x.shape)}")
    return x.reshape(-1, H), weight.reshape(-1, H)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The kernel's plain PyTorch version (= molly_tpu.ops.norms.rms_norm)."""
    _rows_and_weight(x, weight)
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return weight * xf.to(dtype)


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                       g: torch.Tensor, eps: float, need_dw: bool = True):
    """The backward kernel's plain PyTorch version: (dx in x's dtype, dw in
    the weight's dtype or None), math in fp32."""
    H = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, H)
    gf = g.to(torch.float32).reshape(-1, H)
    wf = weight.to(torch.float32).reshape(1, H)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    wg = wf * gf
    dot = torch.sum(wg * xhat, dim=-1, keepdim=True) / H
    dx = ((wg - xhat * dot) * inv).to(x.dtype).reshape(x.shape)
    dw = (torch.sum(gf * xhat, dim=0).to(weight.dtype).reshape(weight.shape)
          if need_dw else None)
    return dx, dw


def _build_bwd_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, dwp_ptr, R, H,
                    rows_per_prog, stride_x, stride_g, stride_dx, eps,
                    BLOCK: tl.constexpr, ROWS: tl.constexpr,
                    NEED_DW: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inb = cols < H
        w = tl.load(w_ptr + cols, mask=inb, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK], dtype=tl.float32)
        row0 = pid * rows_per_prog
        for r in range(0, rows_per_prog, ROWS):
            rows = (row0 + r + tl.arange(0, ROWS)).to(tl.int64)
            m = (rows < R)[:, None] & inb[None, :]
            x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + rows[:, None] * stride_g + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1) / H
            inv = 1.0 / tl.sqrt(var + eps)
            xhat = x * inv[:, None]
            wg = w[None, :] * g
            dot = tl.sum(wg * xhat, axis=1) / H
            dx = (wg - xhat * dot[:, None]) * inv[:, None]
            tl.store(dx_ptr + rows[:, None] * stride_dx + cols[None, :],
                     dx.to(dx_ptr.dtype.element_ty), mask=m)
            if NEED_DW:
                dw += tl.sum(g * xhat, axis=0)  # masked rows hold g = 0
        if NEED_DW:
            tl.store(dwp_ptr + pid * H + cols, dw, mask=inb)

    return rmsnorm_bwd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                 eps: float, need_dw: bool = True):
    """(dx, dw or None) of ``rms_norm`` for a 1-D weight. A CPU tensor runs
    the plain version; a CUDA tensor launches the Triton kernel or raises."""
    global _BWD_KERNEL
    if weight.ndim != 1 or weight.shape[0] != x.shape[-1]:
        raise NotImplementedError(
            f"rms_norm backward: weight {tuple(weight.shape)}; only a 1-D "
            f"weight over the last dim has a backward (the stacked per-head "
            f"form is the fused decode branch)")
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, g, eps, need_dw)
    if x.device.type != "cuda" or weight.device != x.device or \
            g.device != x.device:
        raise RuntimeError(f"rms_norm backward: unsupported devices x "
                           f"{x.device}, weight {weight.device}, g {g.device}")
    if g.shape != x.shape:
        raise ValueError(f"rms_norm backward: g {tuple(g.shape)} vs x "
                         f"{tuple(x.shape)}")
    H = x.shape[-1]
    x2, g2 = x.reshape(-1, H), g.reshape(-1, H)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    if g2.stride(-1) != 1:
        g2 = g2.contiguous()
    w1 = weight.contiguous()
    R = x2.shape[0]
    dx = torch.empty((R, H), dtype=x.dtype, device=x.device)
    if R == 0:
        return dx.reshape(x.shape), (torch.zeros_like(weight) if need_dw
                                     else None)
    if _BWD_KERNEL is None:
        _BWD_KERNEL = _build_bwd_kernel()
    import triton
    block = triton.next_power_of_2(H)
    rows = max(1, _BWD_TILE // block)
    programs = min(triton.cdiv(R, rows), _BWD_PROGRAMS)
    rows_per_prog = triton.cdiv(triton.cdiv(R, programs), rows) * rows
    programs = triton.cdiv(R, rows_per_prog)
    dwp = (torch.empty((programs, H), dtype=torch.float32, device=x.device)
           if need_dw else dx)  # never touched when NEED_DW is false
    with torch.cuda.device(x.device):
        _BWD_KERNEL[(programs,)](
            x2, w1, g2, dx, dwp, R, H, rows_per_prog, x2.stride(0),
            g2.stride(0), dx.stride(0), float(eps), BLOCK=block, ROWS=rows,
            NEED_DW=bool(need_dw), num_warps=_BWD_WARPS)
    rms_norm_bwd.launches += 1
    # the partials are summed outside the kernel, as the JAX wrapper sums
    # the Pallas kernel's
    dw = dwp.sum(dim=0).to(weight.dtype) if need_dw else None
    return dx.reshape(x.shape), dw


rms_norm_bwd.launches = 0


class _RmsNorm(torch.autograd.Function):
    """``jax.custom_vjp`` of ``rms_norm_pallas``: forward saves x and the
    weight, backward launches ``rms_norm_bwd``."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.eps,
                              need_dw=ctx.needs_input_grad[1])
        return (dx if ctx.needs_input_grad[0] else None), dw, None


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_fwd(x_ptr, w_ptr, y_ptr, H, W, stride_x, stride_w, stride_y,
                    eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        inb = cols < H
        x = tl.load(x_ptr + row * stride_x + cols, mask=inb,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / H
        inv = 1.0 / tl.sqrt(var + eps)
        # cast to the input dtype first, then scale by the weight (in fp32)
        # and round once more on the store
        xn = (x * inv).to(x_ptr.dtype.element_ty).to(tl.float32)
        w = tl.load(w_ptr + (row % W) * stride_w + cols, mask=inb,
                    other=0.0).to(tl.float32)
        tl.store(y_ptr + row * stride_y + cols,
                 (w * xn).to(y_ptr.dtype.element_ty), mask=inb)

    return rmsnorm_fwd


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim; weight has the shape of x's trailing dims
    ([H], or [Nq+Nkv, Dh] stacked per head). A CPU tensor runs the plain
    version; a CUDA tensor launches the Triton kernel or raises.
    Differentiable in x and a 1-D weight when autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps)


def _rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    global _KERNEL
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise RuntimeError(f"rms_norm: unsupported devices x {x.device}, "
                           f"weight {weight.device}")
    x2, w2 = _rows_and_weight(x, weight)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w2 = w2.contiguous()
    R, H = x2.shape
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    y = torch.empty((R, H), dtype=out_dtype, device=x.device)
    if R == 0:
        return y.reshape(x.shape)
    if _KERNEL is None:
        _KERNEL = _build_kernel()
    import triton
    block = triton.next_power_of_2(H)
    with torch.cuda.device(x.device):
        _KERNEL[(R,)](x2, w2, y, H, w2.shape[0], x2.stride(0), w2.stride(0),
                      y.stride(0), float(eps), BLOCK=block,
                      num_warps=max(1, min(8, block // 256)))
    rms_norm.launches += 1
    return y.reshape(x.shape)


rms_norm.launches = 0
