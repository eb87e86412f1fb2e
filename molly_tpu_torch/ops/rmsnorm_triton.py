"""RMSNorm forward: the wrapper of a hand-written Triton kernel and its plain
PyTorch version.

Replaces ``molly_tpu/ops/rmsnorm_pallas.py:_fwd_kernel`` (launched from
``_fwd``). y = w * cast(x * rsqrt(mean(x^2) + eps)): the reduction runs in
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

``triton`` is imported inside the launching function, so this module
imports on a machine without it.
"""

from __future__ import annotations

import torch

_KERNEL = None


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
    version; a CUDA tensor launches the Triton kernel or raises."""
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
