"""Grouped matrix products for the mixture-of-experts FFN: the wrappers of
the hand-written CUDA kernels (``csrc/grouped_gemm.cu``;
``csrc/grouped_gemm_tma.cu`` for bf16 experts at prefill and training
shapes; ``csrc/grouped_gemm_int8_tma.cu`` for int8 experts there;
``csrc/grouped_gemm_f32_tc.cu`` for the fp32 expert-LoRA adapters there;
``csrc/grouped_gemm_decode.cu`` for decode and serving shapes) and their
plain PyTorch versions.

Replaces the megablox kernels that ``molly_tpu/ops/moe.py:_grouped_dot``
launches: ``gmm`` (forward, and with ``transpose_rhs`` for the lhs gradient)
and ``tgmm`` (the weight gradient, reached through ``gmm``'s VJP).

  grouped_gemm       out[r] = lhs[r] @ rhs[g(r)]         [M, K] x [G, K, N]
                     (transpose_rhs: rhs is [G, N, K], read through strides)
  grouped_gemm_tgmm  out[g] = lhs[rows_g]^T @ dout[rows_g]     -> [G, K, N]

Row r belongs to the group whose row range holds it; the ranges are the
prefix sums of ``group_sizes`` [G] int32. The sizes are data (the router
decides them on the device): nothing here reads them on the host when the
tensors live on a card. Products accumulate in fp32. Rows past
``sum(group_sizes)`` come out as zeros, and so does the weight gradient of
an empty group.

An int8 rhs (``ops.moe.quantize_experts``) is converted tile by tile inside
the kernel; its per-(group, column) ``scale`` multiplies the fp32
accumulator once at the end (the scale factors out of the contraction).
A bf16 lhs over an fp32 rhs (the expert adapters on a bf16 stream) is an
fp32 product: the lhs is widened exactly, and so is the bf16 lhs of its
weight gradient (inside the kernels, never as an fp32 copy on the main
path).

Five sources hold the kernels. ``takes_tma`` / ``int8_takes_tma`` /
``f32_takes_tc`` / ``takes_stream`` / ``tgmm_takes_tc`` / ``tgmm_takes_tma``
say which one a call goes to: at least 64 rows a group, bf16 experts run
on the TMA and wgmma kernels, int8 experts on the int8 TMA kernel (the
tile converted in registers), the fp32 adapters (forward, lhs and weight
gradients) on the tensor cores at fp32 accuracy (split operands); a bf16
lhs over bf16 or int8 experts with few rows a group
(decode, the serving tick) on the split weight stream (its grid from
``stream_plan``); everything else (transposed products with few rows, fp32
products the rules exclude, unaligned shapes) on the ``mma.sync`` and SIMT
kernels. The bf16 routes multiply bf16 operands, so an fp32 operand of a
bf16 product is rounded to bf16 once: inside the older kernels as they
stage it, before the launch for the TMA ones (the autograd function rounds
``dout`` once for both of its products, and folds an int8 scale into
``dout`` in the same pass). The fp32 products and the CPU route are not
touched by this.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``grouped_gemm.launches`` / ``grouped_gemm_tgmm.launches`` count
kernel launches (``grouped_gemm.launches_int8``: those over an int8 rhs;
``.launches_tma`` on either: those that went to the bf16 TMA and wgmma
kernels; ``grouped_gemm.launches_int8_tma``: those on the int8 TMA kernel;
``grouped_gemm.launches_tc`` / ``grouped_gemm_tgmm.launches_tc``: those
on the fp32 tensor-core kernels; ``grouped_gemm.launches_stream``: those
on the split weight stream).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_GROUPS = 1024  # the kernels stage the group sizes in shared memory


def takes_tma(M: int, K: int, N: int, G: int, rhs_dtype, has_scale: bool,
              aligned: bool = True) -> bool:
    """Does this forward product (transposed or not) go to the TMA and wgmma
    kernel? A bf16 rhs without a scale, at least 64 rows a group on average
    (below that the call is a stream of weights: ``takes_stream``), K
    a multiple of the 64-element stage, rows of 16 bytes, 16-byte aligned
    bases. The lhs may be bf16 or fp32 (rounded once before the launch)."""
    return (rhs_dtype == torch.bfloat16 and not has_scale and M >= 64 * G
            and K % 64 == 0 and N % 8 == 0 and aligned)


def takes_stream(M: int, K: int, N: int, G: int, lhs_dtype, rhs_dtype,
                 has_scale: bool, transpose_rhs: bool = False,
                 aligned: bool = True) -> bool:
    """Does this forward product go to the split weight stream
    (``csrc/grouped_gemm_decode.cu``)? A bf16 lhs over a bf16 rhs without a
    scale or an int8 rhs with its scale, not transposed, fewer than 64 rows
    a group on average, K a multiple of the 64-element stage, rows of 16
    bytes (int8: N a multiple of 16), 16-byte aligned bases."""
    if lhs_dtype != torch.bfloat16 or transpose_rhs or not 0 < M < 64 * G:
        return False
    if rhs_dtype == torch.bfloat16:
        fits = not has_scale and N % 8 == 0
    elif rhs_dtype == torch.int8:
        fits = has_scale and N % 16 == 0
    else:
        return False
    return fits and K % 64 == 0 and aligned


def int8_takes_tma(M: int, K: int, N: int, G: int, lhs_dtype, out_dtype,
                   has_scale: bool, transpose_rhs: bool = False,
                   aligned: bool = True) -> bool:
    """Does this product over an int8 rhs go to the int8 TMA and wgmma
    kernel (``csrc/grouped_gemm_int8_tma.cu``)? The forward with its scale,
    or the transposed product without one (the caller folds the scale into
    the lhs); a bf16 product (a bf16 lhs, or an fp32 lhs rounded once before
    the launch when the result is bf16: an all-fp32 product stays fp32), at
    least 64 rows a group on average, K a multiple of the 64-element stage,
    N of 16 (whole 16-byte rows of int8), 16-byte aligned bases."""
    if lhs_dtype != torch.bfloat16 and out_dtype != torch.bfloat16:
        return False
    return (has_scale != transpose_rhs and M >= 64 * G and K % 64 == 0
            and N % 16 == 0 and aligned)


def f32_takes_tc(M: int, K: int, N: int, G: int, lhs_dtype, rhs_dtype,
                 out_dtype, has_scale: bool, transpose_rhs: bool = False,
                 aligned: bool = True) -> bool:
    """Does this product over an fp32 rhs (the expert adapters) go to the
    tensor-core kernels of ``csrc/grouped_gemm_f32_tc.cu``, held at fp32
    accuracy? At least 64 rows a group on average, no scale, 16-byte
    aligned bases, N a multiple of 8, and: the forward takes a bf16 lhs
    (widened exactly; the adapters' activations) into an fp32 result, K a
    multiple of its 64-element stage; the transposed product (the lhs
    gradient) takes an fp32 lhs into an fp32 or bf16 result, K a multiple of
    its 32-element stage. An fp32 lhs in the forward (the fp32 test models)
    stays on the SIMT kernel."""
    if rhs_dtype != torch.float32 or has_scale or M < 64 * G or not aligned \
            or N % 8:
        return False
    if transpose_rhs:
        return lhs_dtype == torch.float32 and K % 32 == 0
    return (lhs_dtype == torch.bfloat16 and out_dtype == torch.float32
            and K % 64 == 0)


STREAM_COLS = 128    # weight columns of a stream unit
STREAM_STAGE = 64    # contraction elements of a stage
_STREAM_MAX_SPLITS = 8  # K splits of a unit: the blocks of one cluster
# blocks an SM holds at once (csrc/grouped_gemm_decode.cu: 45 KB of shared
# memory a bf16 block, 40 KB an int8 one)
_STREAM_BLOCKS_PER_SM = {False: 4, True: 5}


def stream_plan(M: int, K: int, N: int, G: int, sm_count: int,
                int8: bool = False) -> Tuple[int, int, int, int]:
    """(slots, column tiles, splits, stages a split) of the split weight
    stream, from static shapes and the SM count only: the group sizes live
    on the device and are never read by the host, so the plan holds for any
    sizes and a captured graph replays with new ones. Block (split, slot,
    tile) serves the slot-th group that has rows (min(M, G) slots: no call
    has more), columns [128 tile, +128) and stages [split * per, +per) of
    K's 64-element stages. K is split in powers of two (at most 8) while the
    whole grid still fits the card's resident blocks (one wave: a second
    one would run the tail of the stream on a few SMs), then every split
    gets a stage."""
    slots = min(M, G)
    tiles = -(-N // STREAM_COLS)
    stages = K // STREAM_STAGE
    resident = _STREAM_BLOCKS_PER_SM[int8] * sm_count
    splits = 1
    while (splits < _STREAM_MAX_SPLITS and 2 * splits <= stages
           and slots * tiles * 2 * splits <= resident):
        splits *= 2
    per = -(-stages // splits)
    return slots, tiles, -(-stages // per), per


def tgmm_takes_tc(M: int, K: int, N: int, G: int, dtypes,
                  aligned: bool = True) -> bool:
    """Does this weight gradient go to the tensor-core kernel of
    ``csrc/grouped_gemm_f32_tc.cu``, held at fp32 accuracy? The expert
    adapters' gradient: a bf16 lhs (exact), an fp32 dout and an fp32 result
    (``dtypes``: lhs, dout, out), at least 64 rows a group on average, K and
    N multiples of 8, contiguous operands on 16-byte aligned bases. Asked
    before ``tgmm_takes_tma``."""
    return (tuple(dtypes) == (torch.bfloat16, torch.float32, torch.float32)
            and M >= 64 * G and K % 8 == 0 and N % 8 == 0 and aligned)


def tgmm_tc_plan(K: int, N: int) -> int:
    """The tile of the tensor-core weight gradient (the ``plan`` of
    ``molly_grouped_gemm_tgmm_f32_tc``): a rank-64 dout (the A gradients)
    takes all 64 of its columns against 256 lhs columns (0); a wider dout
    (the B gradients, a rank-64 lhs) 128 of its columns against 64 lhs
    columns (1)."""
    return 0 if N <= 64 else 1


def tgmm_takes_tma(M: int, K: int, N: int, dtypes, aligned: bool = True
                   ) -> bool:
    """Does this weight gradient go to the TMA and wgmma kernel? A bf16
    product (``dtypes``: lhs, dout, out): a bf16 result, or bf16 operands
    into fp32; given rows of 16 bytes on both operands and aligned bases.
    The kernel rounds an fp32 operand to bf16, so an fp32 result of an fp32
    operand (an fp32 product, such as the adapters') never comes here."""
    lhs_dt, dout_dt, out_dt = dtypes
    bf16_product = out_dt == torch.bfloat16 or (
        lhs_dt == dout_dt == torch.bfloat16)
    return (bf16_product and M > 0 and K % 8 == 0 and N % 8 == 0
            and aligned)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def row_groups(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[M] int64: the group of each row (G for rows past the last group),
    from the prefix sums, without a host read."""
    ends = torch.cumsum(group_sizes, dim=0)
    rows = torch.arange(n_rows, device=group_sizes.device, dtype=ends.dtype)
    return torch.searchsorted(ends, rows, right=True)


def _bounds(group_sizes: torch.Tensor, n_rows: int):
    """Python (start, end) row ranges, clipped to n_rows (a host read: the
    plain versions only)."""
    ends = torch.cumsum(group_sizes, dim=0).clamp(max=n_rows).tolist()
    return list(zip([0] + ends[:-1], ends))


def grouped_gemm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor, *,
                       transpose_rhs: bool = False, out_dtype=None,
                       scale: Optional[torch.Tensor] = None,
                       bounds=None) -> torch.Tensor:
    """The forward kernel's plain version: one fp32 product per non-empty
    group over that group's rows, zeros elsewhere. ``bounds`` (the row
    ranges as Python ints) spares the host read of ``group_sizes``."""
    M = lhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((M, N), dtype=torch.float32, device=lhs.device)
    lf = lhs.to(torch.float32)
    for g, (a, b) in enumerate(bounds or _bounds(group_sizes, M)):
        if b <= a:
            continue
        w = rhs[g].to(torch.float32)
        y = lf[a:b] @ (w.T if transpose_rhs else w)
        if scale is not None:
            y = y * scale[g].reshape(1, N).to(torch.float32)
        out[a:b] = y
    return out.to(out_dtype or torch.float32)


def grouped_gemm_tgmm_plain(lhs: torch.Tensor, dout: torch.Tensor,
                            group_sizes: torch.Tensor, out_dtype,
                            bounds=None) -> torch.Tensor:
    """The weight-gradient kernel's plain version: per group, lhs_g^T @
    dout_g in fp32; exact zeros for an empty group."""
    G, M = group_sizes.shape[0], lhs.shape[0]
    out = torch.zeros((G, lhs.shape[1], dout.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    lf, df = lhs.to(torch.float32), dout.to(torch.float32)
    for g, (a, b) in enumerate(bounds or _bounds(group_sizes, M)):
        if b > a:
            out[g] = lf[a:b].T @ df[a:b]
    return out.to(out_dtype)


def _check_sizes(name: str, group_sizes: torch.Tensor, G: int, like):
    if group_sizes.shape != (G,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"{name}: group_sizes must be int32 [{G}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    if group_sizes.device != like.device:
        raise ValueError(f"{name}: group_sizes on {group_sizes.device}, "
                         f"operands on {like.device}")
    if not 0 < G <= MAX_GROUPS:
        raise ValueError(f"{name}: {G} groups (the kernels take 1 to "
                         f"{MAX_GROUPS})")


def _forward(lhs, rhs, group_sizes, transpose_rhs, out_dtype, scale):
    """One forward product, no autograd."""
    out_dtype = out_dtype or torch.float32
    if lhs.ndim != 2 or rhs.ndim != 3:
        raise ValueError(f"grouped_gemm: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}")
    M, K = lhs.shape
    G = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if rhs.shape[2 if transpose_rhs else 1] != K:
        raise ValueError(f"grouped_gemm: lhs {tuple(lhs.shape)} does not "
                         f"contract with rhs {tuple(rhs.shape)} "
                         f"(transpose_rhs={transpose_rhs})")
    if scale is not None:
        if transpose_rhs:
            raise ValueError("grouped_gemm: a column scale lies on the "
                             "contraction axis of a transposed rhs; scale "
                             "the lhs rows instead")
        if scale.numel() != G * N or scale.dtype != torch.float32:
            raise ValueError(f"grouped_gemm: scale {scale.dtype} "
                             f"{tuple(scale.shape)} for [{G}, {N}]")
    elif rhs.dtype == torch.int8 and not transpose_rhs:
        raise ValueError("grouped_gemm: an int8 rhs needs its scale")
    if lhs.device.type == "cpu":
        return grouped_gemm_plain(lhs, rhs, group_sizes,
                                  transpose_rhs=transpose_rhs,
                                  out_dtype=out_dtype, scale=scale)
    if lhs.device.type != "cuda":
        raise RuntimeError(f"grouped_gemm: unsupported device {lhs.device}")
    _check_sizes("grouped_gemm", group_sizes, G, lhs)
    if lhs.dtype not in (torch.float32, torch.bfloat16) or \
            rhs.dtype not in _DTYPES or \
            out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_gemm: dtypes lhs {lhs.dtype}, rhs "
                        f"{rhs.dtype}, out {out_dtype}")
    if rhs.device != lhs.device or (scale is not None
                                    and scale.device != lhs.device):
        raise ValueError("grouped_gemm: operands on different devices")
    if not rhs.is_contiguous() or (scale is not None
                                   and not scale.is_contiguous()):
        raise ValueError("grouped_gemm: rhs and scale must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=lhs.device)
    if M == 0:
        return out
    has_scale = scale is not None
    bases = (rhs, out) + ((scale,) if has_scale else ())
    tma = takes_tma(M, K, N, G, rhs.dtype, has_scale, _aligned(rhs))
    i8 = rhs.dtype == torch.int8 and int8_takes_tma(
        M, K, N, G, lhs.dtype, out_dtype, has_scale, transpose_rhs,
        _aligned(*bases))
    tc = f32_takes_tc(M, K, N, G, lhs.dtype, rhs.dtype, out_dtype, has_scale,
                      transpose_rhs, _aligned(*bases))
    if tma or i8:
        lhs = lhs.to(torch.bfloat16)
    elif rhs.dtype == torch.float32 and not tc:
        lhs = lhs.to(torch.float32)  # the SIMT kernel: fp32 operands
    lhs = lhs.contiguous()
    if not _aligned(lhs):
        tma = i8 = tc = False
    # the SIMT kernel writes fp32; a bf16 result of an fp32 product is that,
    # rounded once
    simt_out = (torch.empty((M, N), dtype=torch.float32, device=lhs.device)
                if rhs.dtype == torch.float32 and not tc
                and out_dtype != torch.float32 else out)
    operands = (lhs, rhs, out) + (() if scale is None else (scale,))
    stream = takes_stream(M, K, N, G, lhs.dtype, rhs.dtype, has_scale,
                          transpose_rhs, _aligned(*operands))

    from . import _cuda_build
    with torch.cuda.device(lhs.device):
        cuda_stream = torch.cuda.current_stream(lhs.device).cuda_stream
        if tma:
            lib = _lib_tma()
            err = lib.molly_grouped_gemm_tma(
                lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[out_dtype],
                int(transpose_rhs), cuda_stream)
        elif i8:
            lib = _lib_int8_tma()
            err = lib.molly_grouped_gemm_int8_tma(
                lhs.data_ptr(), rhs.data_ptr(),
                None if scale is None else scale.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[out_dtype],
                int(transpose_rhs), cuda_stream)
        elif tc:
            lib = _lib_tc()
            err = lib.molly_grouped_gemm_f32_tc(
                lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[out_dtype],
                int(transpose_rhs), cuda_stream)
        elif stream:
            lib = _lib_decode()
            err = lib.molly_grouped_gemm_decode(
                lhs.data_ptr(), rhs.data_ptr(),
                None if scale is None else scale.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[out_dtype],
                *stream_plan(M, K, N, G,
                             _cuda_build.sm_count(lhs.device.index),
                             rhs.dtype == torch.int8),
                cuda_stream)
        else:
            lib = _lib()
            err = lib.molly_grouped_gemm(
                lhs.data_ptr(), rhs.data_ptr(),
                None if scale is None else scale.data_ptr(),
                simt_out.data_ptr(), group_sizes.data_ptr(), M, K, N, G,
                _DTYPES[lhs.dtype], _DTYPES[rhs.dtype],
                _DTYPES[simt_out.dtype], int(transpose_rhs), cuda_stream)
    _cuda_build.check(lib, err, "grouped_gemm")
    grouped_gemm.launches += 1
    grouped_gemm.launches_tma += int(tma)
    grouped_gemm.launches_int8_tma += int(i8)
    grouped_gemm.launches_tc += int(tc)
    grouped_gemm.launches_stream += int(stream)
    if rhs.dtype == torch.int8:
        grouped_gemm.launches_int8 += 1
    if simt_out is not out:
        out.copy_(simt_out)
    return out


def grouped_gemm_tgmm(lhs: torch.Tensor, dout: torch.Tensor,
                      group_sizes: torch.Tensor, out_dtype) -> torch.Tensor:
    """out[g] = lhs[rows_g]^T @ dout[rows_g]: [M, K], [M, N] -> [G, K, N]
    in ``out_dtype``, fp32 accumulation, zeros for an empty group. One block
    a tile walks its group's rows in order, so there are no atomics and the
    bits are the same on every run. A bf16 lhs with an fp32 dout into fp32
    (the expert adapters) runs on the tensor cores at fp32 accuracy; an
    fp32 product that rule leaves out runs on the SIMT kernel over operands
    widened exactly; a bf16 product on the TMA kernel (fp32 operands
    rounded to bf16 once) or the mma.sync kernel."""
    if lhs.ndim != 2 or dout.ndim != 2 or lhs.shape[0] != dout.shape[0]:
        raise ValueError(f"grouped_gemm_tgmm: lhs {tuple(lhs.shape)}, dout "
                         f"{tuple(dout.shape)}")
    if lhs.device.type == "cpu":
        return grouped_gemm_tgmm_plain(lhs, dout, group_sizes, out_dtype)
    if lhs.device.type != "cuda":
        raise RuntimeError(f"grouped_gemm_tgmm: unsupported device "
                           f"{lhs.device}")
    G = group_sizes.shape[0]
    _check_sizes("grouped_gemm_tgmm", group_sizes, G, lhs)
    floats = (torch.float32, torch.bfloat16)
    if lhs.dtype not in floats or dout.dtype not in floats or \
            out_dtype not in floats:
        raise TypeError(f"grouped_gemm_tgmm: dtypes lhs {lhs.dtype}, dout "
                        f"{dout.dtype}, out {out_dtype}")
    if dout.device != lhs.device:
        raise ValueError("grouped_gemm_tgmm: operands on different devices")
    (M, K), N = lhs.shape, dout.shape[1]
    out = torch.empty((G, K, N), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    dtypes = (lhs.dtype, dout.dtype, out_dtype)
    tc = tgmm_takes_tc(M, K, N, G, dtypes, lhs.is_contiguous()
                       and dout.is_contiguous() and _aligned(lhs, dout, out))
    tma = not tc and tgmm_takes_tma(M, K, N, dtypes)
    if tma:
        lhs, dout = lhs.to(torch.bfloat16), dout.to(torch.bfloat16)
    elif not tc and out_dtype == torch.float32 and \
            torch.float32 in dtypes[:2]:
        lhs, dout = lhs.to(torch.float32), dout.to(torch.float32)
    lhs, dout = lhs.contiguous(), dout.contiguous()
    tma = tma and _aligned(lhs, dout, out)

    from . import _cuda_build
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        if tc:
            lib = _lib_tc()
            err = lib.molly_grouped_gemm_tgmm_f32_tc(
                lhs.data_ptr(), dout.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, tgmm_tc_plan(K, N),
                stream)
        elif tma:
            lib = _lib_tma()
            err = lib.molly_grouped_gemm_tgmm_tma(
                lhs.data_ptr(), dout.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[out_dtype],
                stream)
        else:
            lib = _lib()
            err = lib.molly_grouped_gemm_tgmm(
                lhs.data_ptr(), dout.data_ptr(), out.data_ptr(),
                group_sizes.data_ptr(), M, K, N, G, _DTYPES[lhs.dtype],
                _DTYPES[dout.dtype], _DTYPES[out_dtype], stream)
    _cuda_build.check(lib, err, "grouped_gemm_tgmm")
    grouped_gemm_tgmm.launches += 1
    grouped_gemm_tgmm.launches_tma += int(tma)
    grouped_gemm_tgmm.launches_tc += int(tc)
    return out


grouped_gemm_tgmm.launches = 0
grouped_gemm_tgmm.launches_tma = 0
grouped_gemm_tgmm.launches_tc = 0


def _lhs_grad(dout, rhs, group_sizes, scale, transpose_rhs, out_dtype):
    """The lhs gradient: dout against the rhs transposed. An int8 rhs's
    scale lies on that product's contraction axis, so it is folded into
    dout's rows first (the JAX VJP of ``y * scale[eid]``). On a card, a
    bf16 result means a bf16 product: that pass rounds to bf16, once, as
    the kernels would on their way in."""
    if scale is not None:
        G = rhs.shape[0]
        eid = row_groups(group_sizes, dout.shape[0]).clamp(max=G - 1)
        s = scale.reshape(G, -1)[eid]
        if dout.is_cuda and out_dtype == torch.bfloat16:
            dout = torch.mul(dout, s, out=torch.empty(
                dout.shape, dtype=torch.bfloat16, device=dout.device))
        else:
            dout = dout * s.to(dout.dtype)
    return _forward(dout, rhs, group_sizes, transpose_rhs, out_dtype, None)


def _rhs_grad(lhs, dout, group_sizes, transpose_rhs, out_dtype):
    """The rhs gradient, tgmm in the rhs dtype (``dout`` against ``lhs``
    for a transposed rhs). A bf16 lhs goes as it is: over fp32 adapters the
    tgmm wrapper sends it to the tensor cores, or widens it for the SIMT
    kernel, so no fp32 copy is made on the main path."""
    if transpose_rhs:
        return grouped_gemm_tgmm(dout, lhs, group_sizes, out_dtype)
    return grouped_gemm_tgmm(lhs, dout, group_sizes, out_dtype)


class _GroupedGemm(torch.autograd.Function):
    """Forward: the grouped kernel. Backward, as megablox's VJP: the lhs
    gradient is the same kernel over the transposed rhs (in the lhs dtype),
    the rhs gradient is tgmm (in the rhs dtype). Each is skipped when its
    operand needs no gradient: a frozen (LoRA) or int8 (QLoRA) base never
    pays for a weight gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs, out_dtype, scale):
        ctx.save_for_backward(lhs, rhs, group_sizes, scale)
        ctx.transpose_rhs = transpose_rhs
        return _forward(lhs, rhs, group_sizes, transpose_rhs, out_dtype,
                        scale)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes, scale = ctx.saved_tensors
        dlhs = drhs = None
        if dout.is_cuda and dout.dtype == torch.float32 and \
                lhs.dtype == rhs.dtype == torch.bfloat16:
            # both products below run in bf16: round dout once for both
            dout = dout.to(torch.bfloat16)
        if ctx.needs_input_grad[0]:
            dlhs = _lhs_grad(dout, rhs, group_sizes, scale,
                             not ctx.transpose_rhs, lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = _rhs_grad(lhs, dout, group_sizes, ctx.transpose_rhs,
                             rhs.dtype)
        return dlhs, drhs, None, None, None, None


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor, *, transpose_rhs: bool = False,
                 out_dtype=None,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lhs [M, K] x rhs [G, K, N] (or [G, N, K] with ``transpose_rhs``)
    -> [M, N] in ``out_dtype`` (fp32 by default), each row against its
    group's matrix. ``scale`` [G, N] (or [G, 1, N]) fp32 goes with an int8
    rhs. Differentiable in lhs, and in a floating-point rhs, when autograd
    records."""
    if torch.is_grad_enabled() and (lhs.requires_grad or (
            rhs.is_floating_point() and rhs.requires_grad)):
        return _GroupedGemm.apply(lhs, rhs, group_sizes, transpose_rhs,
                                  out_dtype, scale)
    return _forward(lhs, rhs, group_sizes, transpose_rhs, out_dtype, scale)


grouped_gemm.launches = 0
grouped_gemm.launches_int8 = 0
grouped_gemm.launches_tma = 0
grouped_gemm.launches_stream = 0
grouped_gemm.launches_int8_tma = 0
grouped_gemm.launches_tc = 0


def _lib():
    from . import _cuda_build
    lib = _cuda_build.library("grouped_gemm")
    fn = lib.molly_grouped_gemm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        fn.restype = I
        lib.molly_grouped_gemm_tgmm.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                                I, P]
        lib.molly_grouped_gemm_tgmm.restype = I
    return lib


def _lib_tma():
    from . import _cuda_build
    lib = _cuda_build.library("grouped_gemm_tma")
    fn = lib.molly_grouped_gemm_tma
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        lib.molly_grouped_gemm_tgmm_tma.argtypes = [P, P, P, P, I, I, I, I, I,
                                                    P]
        lib.molly_grouped_gemm_tgmm_tma.restype = I
    return lib


def _lib_decode():
    from . import _cuda_build
    lib = _cuda_build.library("grouped_gemm_decode")
    fn = lib.molly_grouped_gemm_decode
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P] + [I] * 9 + [P]
        fn.restype = I
    return lib


def _lib_int8_tma():
    from . import _cuda_build
    lib = _cuda_build.library("grouped_gemm_int8_tma")
    fn = lib.molly_grouped_gemm_int8_tma
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P] + [I] * 6 + [P]
        fn.restype = I
    return lib


def _lib_tc():
    from . import _cuda_build
    lib = _cuda_build.library("grouped_gemm_f32_tc")
    fn = lib.molly_grouped_gemm_f32_tc
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [I] * 6 + [P]
        fn.restype = I
        lib.molly_grouped_gemm_tgmm_f32_tc.argtypes = [P, P, P, P] + \
            [I] * 5 + [P]
        lib.molly_grouped_gemm_tgmm_f32_tc.restype = I
    return lib
