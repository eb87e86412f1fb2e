"""Int8 weight-only quantization (decode, and the frozen QLoRA base in
training): the wrapper of the hand-written CUDA GEMMs and its plain PyTorch
version. Three routes: ``int8_takes_tma`` sends bf16 x with more than
``SMALL_M`` rows and aligned shapes (prefill, the QLoRA step) to TMA and
wgmma (``csrc/int8_matmul_tma.cu``); ``int8_takes_stream`` sends bf16 x with
at most ``SMALL_M`` rows and aligned shapes (decode) to a weight stream
(``csrc/int8_matmul_stream.cu``: operands swapped on mma.sync, the weights
by TMA, K split where the column tiles are too few for the card, the
splits summed in a fixed order across a cluster, one launch, no atomics;
``gemv_plan`` is its grid); the rest (fp32 x, unaligned views, K or N off
the multiples) runs the SIMT GEMM of ``csrc/int8_matmul.cu``. ``int8_matmul.launches`` counts every launch,
``.launches_tma`` those on the TMA kernel, ``.launches_gemv`` those on the
stream.

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
SMALL_M = 16  # rows up to which the weight stream runs
_GEMV_COLS = 128      # weight columns of a stream block
_GEMV_STAGE = 64      # contraction elements of a TMA stage
_GEMV_MAX_SPLITS = 8  # blocks of a cluster (int8_matmul_stream.cu too)
_GEMV_MIN_STAGES = 4  # stages a split keeps: fewer and prologue dominates


def int8_takes_tma(M: int, K: int, N: int, dtype,
                   aligned: bool = True) -> bool:
    """Does this product go to the TMA and wgmma kernel? bf16 x with more
    than ``SMALL_M`` rows, K a multiple of the 64-element stage, N of 16
    (int8 rows of 16 bytes, four-column stores), 16-byte aligned bases."""
    return (dtype == torch.bfloat16 and M > SMALL_M and K % 64 == 0
            and N % 16 == 0 and aligned)


def int8_takes_stream(M: int, K: int, N: int, dtype,
                      aligned: bool = True) -> bool:
    """Does this product go to the weight stream
    (``csrc/int8_matmul_stream.cu``)? bf16 x with 1 to ``SMALL_M`` rows, K a
    multiple of the 64-element stage, N of 16, 16-byte aligned bases."""
    return (dtype == torch.bfloat16 and 0 < M <= SMALL_M and K % 64 == 0
            and N % 16 == 0 and aligned)


def gemv_plan(K: int, N: int, sm_count: int):
    """(column tiles, splits, stages a split) of the weight stream, from the
    shapes and the SM count only (a captured graph replays with new x).
    Block (split, tile) takes columns [128 tile, +128) and stages [split *
    per, +per) of K's 64-element stages; the splits of a tile form one
    cluster and are summed in order. K is split as far as the blocks stay
    within three quarters of the SMs (a cluster's blocks share a GPC: a grid
    near the SM count leaves some SMs two blocks), at most 8 ways, each
    split keeping ``_GEMV_MIN_STAGES`` stages: the lm head's 1,187 column
    tiles take one split, decode down's 16 take 6."""
    tiles = -(-N // _GEMV_COLS)
    stages = K // _GEMV_STAGE
    splits = max(1, min(_GEMV_MAX_SPLITS, 3 * sm_count // (4 * tiles),
                        stages // _GEMV_MIN_STAGES))
    per = -(-stages // splits)
    return tiles, -(-stages // per), per


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, w_q, scale, out))
    tma = int8_takes_tma(M, K, N, x.dtype, aligned)
    stream = int8_takes_stream(M, K, N, x.dtype, aligned)
    with torch.cuda.device(x.device):
        cuda_stream = torch.cuda.current_stream(x.device).cuda_stream
        if tma:
            lib = _int8_tma_lib()
            err = lib.molly_int8_matmul_tma(
                x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, cuda_stream)
        elif stream:
            lib = _int8_stream_lib()
            err = lib.molly_int8_gemv_stream(
                x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, K, N,
                *gemv_plan(K, N, _cuda_build.sm_count(x.device.index)),
                cuda_stream)
        else:
            lib = _int8_lib()
            err = lib.molly_int8_matmul(
                x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, _DTYPES[x.dtype], cuda_stream)
    _cuda_build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.launches_tma += int(tma)
    int8_matmul.launches_gemv += int(stream)
    return out.reshape(*lead, N)


int8_matmul.launches = 0
int8_matmul.launches_tma = 0    # those on csrc/int8_matmul_tma.cu
int8_matmul.launches_gemv = 0   # those on the weight stream (M <= SMALL_M)


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
        fn.argtypes = [P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return lib


def _int8_stream_lib():
    from . import _cuda_build
    lib = _cuda_build.library("int8_matmul_stream")
    fn = lib.molly_int8_gemv_stream
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
    return lib


def _int8_tma_lib():
    from . import _cuda_build
    lib = _cuda_build.library("int8_matmul_tma")
    fn = lib.molly_int8_matmul_tma
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, P]
        fn.restype = I
    return lib
