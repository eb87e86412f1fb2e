"""Int8 weight-only quantization (decode, and the frozen QLoRA base in
training): the wrapper of the hand-written
CUDA GEMM (``csrc/int8_matmul.cu``) and its plain PyTorch version.

Replaces ``molly_tpu/ops/quant.py:_kernel`` (launched from ``int8_matmul``).
Math: y = (x @ w_q) * scale, with w_q = round(w / scale) per output column
and scale = max|w_col| / 127. The plain version follows the Pallas kernel:
it multiplies the activations as given. (The JAX package's non-TPU path
rounds them to bf16 first, so int8 results differ from it by that
rounding; the tests state the tolerance.)

For training the product is an autograd function over the FROZEN int8 base:
forward is the kernel, backward gives dx = (g * scale) @ w_q^T — a plain
``torch.matmul`` on the dequantized weight, the product the JAX package
leaves to XLA — and no gradient for the weight.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., in, out] -> {"w_q": int8 [..., in, out], "scale": fp32
    [..., out]}; leading dims are stacked layers (the JAX side vmaps)."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    # contiguous whatever w's strides (the tied head arrives as embed.T)
    return {"w_q": w_q.to(torch.int8).contiguous(),
            "scale": scale.contiguous()}


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "w_q" in p


def int8_matmul_plain(x: torch.Tensor, q: Dict[str, torch.Tensor],
                      out_dtype=None) -> torch.Tensor:
    """The kernel's plain PyTorch version: fp32 products of x as given and
    the int8 weights, then the per-column scale."""
    w_q, scale = q["w_q"], q["scale"]
    y = (x.to(torch.float32) @ w_q.to(torch.float32)) * scale.to(torch.float32)
    return y.to(out_dtype or x.dtype)


class _Int8Matmul(torch.autograd.Function):
    """Forward: the int8 kernel. Backward: dx only (the base is frozen)."""

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        return _int8_matmul_fwd(x, {"w_q": w_q, "scale": scale})

    @staticmethod
    def backward(ctx, g):
        w_q, scale = ctx.saved_tensors
        dx = (g * scale.to(g.dtype)) @ w_q.to(g.dtype).T
        return dx, None, None


def int8_matmul(x: torch.Tensor, q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., K] @ quantized w [K, N] -> [..., N] in x's dtype. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises. Differentiable in x when autograd records."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q["w_q"], q["scale"])
    return _int8_matmul_fwd(x, q)


def _int8_matmul_fwd(x: torch.Tensor,
                     q: Dict[str, torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: unsupported device {x.device}")
    w_q, scale = q["w_q"], q["scale"]
    K, N = w_q.shape
    if x.shape[-1] != K or scale.shape != (N,):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: dtypes x {x.dtype}, w_q {w_q.dtype}, "
                        f"scale {scale.dtype}")
    if not (w_q.device == scale.device == x.device):
        raise ValueError("int8_matmul: operands on different devices")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: w_q and scale must be contiguous")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)

    from . import _cuda_build
    lib = _int8_lib()
    # decode-sized M takes the split-K path, which sums into an fp32
    # workspace (zeroed by the kernel's launcher)
    ws = (torch.empty((M, N), dtype=torch.float32, device=x.device)
          if M <= lib.molly_int8_matmul_small_m() else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.molly_int8_matmul(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), M, N, K,
            _DTYPES[x.dtype], stream)
    _cuda_build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


int8_matmul.launches = 0


def linear(x: torch.Tensor, p) -> torch.Tensor:
    """Dispatch: quantized dict or plain [in, out] weight matrix."""
    if is_quantized(p):
        return int8_matmul(x, p)
    return x @ p


def _int8_lib():
    from . import _cuda_build
    lib = _cuda_build.library("int8_matmul")
    fn = lib.molly_int8_matmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
        lib.molly_int8_matmul_small_m.restype = I
    return lib
