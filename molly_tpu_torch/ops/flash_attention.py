"""Flash attention, forward and backward: the wrappers of the hand-written
CUDA kernels (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``),
their plain PyTorch versions, and the autograd function that joins them.

Replaces ``molly_tpu/ops/flash_attention.py``: ``_fwd_kernel`` (launched from
``_flash_fwd``), ``_dq_kernel`` and ``_dkv_kernel`` (launched from
``_flash_bwd``). The public layout is the model's [B, S, N, D]; the kernels
take element strides, so K/V views of the head-major KV cache
([B, Nkv, Smax, 2*Dh] sliced and transposed to [B, Smax, Nkv, Dh]) and the
gradient dO, with whatever strides autograd left it, are read in place — the
JAX wrapper transposes them instead.

The backward recomputes P = exp(S - LSE) from the forward's saved LSE with
the finite -1e30 for masked scores, as the Pallas kernels do; it does not
differentiate a softmax. On a query row with no valid key the result
therefore depends on which keys a kernel visits; in the model dO is exactly
zero on such rows, so they add nothing.

The headers of the CUDA sources say what bounds the kernels on the card and
what their design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite, like the kernel: fully masked rows stay finite

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, mask=None, causal=True, scale=None,
                          q_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: (O [B, Sq, N, D] in q's dtype,
    LSE [B, N, Sq] fp32), math in fp32. A row with no valid key gets a
    uniform average over all keys (finite), where the kernel averages over
    the keys it visited; callers compare only rows with a valid key."""
    B, Sq, N, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    g = N // Nkv
    qg = q.float().reshape(B, Sq, Nkv, g, D)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * scale
    valid = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = valid & (mask != 0)[:, None, None, None, :]
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        valid = valid & (q_pos >= torch.arange(Skv, device=q.device))
    s = s.masked_fill(~valid, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                       # [B, Nkv, g, Sq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return (o.reshape(B, Sq, N, D).to(q.dtype),
            lse.reshape(B, N, Sq))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, N, D], k/v [B, Skv, Nkv, D] (any strides with a contiguous
    head dim), mask [B, Skv] 1=keep -> (O [B, Sq, N, D], LSE [B, N, Sq]).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, scale, q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    B, Sq, N, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of "
                        f"{list(_DTYPES)} for all three")
    if D not in (64, 128) or N % Nkv or k.shape != v.shape or \
            k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, Sq, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, Sq), dtype=torch.float32, device=q.device)
    if mask is not None:
        if mask.shape != (B, Skv):
            raise ValueError(f"flash_attention: mask {tuple(mask.shape)}, "
                             f"expected {(B, Skv)}")
        mask = mask.to(device=q.device, dtype=torch.int32)
        m_ptr, m_sb, m_ss = mask.data_ptr(), mask.stride(0), mask.stride(1)
    else:
        m_ptr, m_sb, m_ss = None, 0, 0

    from . import _cuda_build
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.molly_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr, o.data_ptr(),
            lse.data_ptr(), B, N, Nkv, Sq, Skv, D, _DTYPES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2), m_sb, m_ss,
            float(scale), int(bool(causal)), int(q_offset), stream)
    _cuda_build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _scores(q, k, mask, causal, scale, q_offset):
    """Masked fp32 scores [B, Nkv, g, Sq, Skv] (NEG_INF where masked)."""
    B, Sq, N, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Nkv, N // Nkv, D)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * scale
    valid = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = valid & (mask != 0)[:, None, None, None, :]
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        valid = valid & (q_pos >= torch.arange(Skv, device=q.device))
    return s.masked_fill(~valid, NEG_INF)


def flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout, causal=True,
                              scale=None, q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' plain PyTorch version, the same recompute:
    P = exp(S - LSE), dS = P * (dO V^T - delta), both rounded to the storage
    dtype before their second product; dQ = scale * dS K,
    dK = scale * dS^T Q, dV = P^T dO, the last two summed over the q heads
    of each kv head. lse, delta [B, N, Sq] fp32."""
    B, Sq, N, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    g = N // Nkv
    s = _scores(q, k, mask, causal, scale, q_offset)
    p = torch.exp(s - lse.reshape(B, Nkv, g, Sq)[..., None])
    dog = dout.float().reshape(B, Sq, Nkv, g, D)
    dp = torch.einsum("bqngd,bknd->bngqk", dog, v.float())
    ds = p * (dp - delta.reshape(B, Nkv, g, Sq)[..., None])
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    qg = q.float().reshape(B, Sq, Nkv, g, D)
    dq = torch.einsum("bngqk,bknd->bqngd", ds, k.float()) * scale
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qg) * scale
    dv = torch.einsum("bngqk,bqngd->bknd", p, dog)
    return (dq.reshape(B, Sq, N, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_launch(which: str, q, k, v, mask, lse, delta, dout, causal, scale,
                q_offset):
    """Check the operands and launch ``molly_flash_attention_<which>``."""
    B, Sq, N, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_{which}: unsupported device "
                           f"{q.device}")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == dout.dtype
                                      == q.dtype):
        raise TypeError(f"flash_attention_{which}: dtypes {q.dtype}/{k.dtype}"
                        f"/{v.dtype}/{dout.dtype}; the kernel takes one of "
                        f"{list(_DTYPES)} for all four")
    if D not in (64, 128) or N % Nkv or k.shape != v.shape or \
            k.shape[0] != B or k.shape[3] != D or dout.shape != q.shape:
        raise ValueError(f"flash_attention_{which}: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} dO "
                         f"{tuple(dout.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, N, Sq) or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"flash_attention_{which}: {name} must be a "
                             f"contiguous fp32 [B, N, Sq]")
    if dout.stride(-1) != 1:
        # the kernels read dO through strides but need its head dim dense
        dout = dout.contiguous()
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_{which}: the head dim must "
                             f"be contiguous")
    if not all(t.device == q.device for t in (k, v, dout, lse, delta)):
        raise ValueError(f"flash_attention_{which}: operands on different "
                         f"devices")
    if scale is None:
        scale = D ** -0.5
    if mask is not None:
        if mask.shape != (B, Skv):
            raise ValueError(f"flash_attention_{which}: mask "
                             f"{tuple(mask.shape)}, expected {(B, Skv)}")
        mask = mask.to(device=q.device, dtype=torch.int32)
        m_ptr, m_st = mask.data_ptr(), (mask.stride(0), mask.stride(1))
    else:
        m_ptr, m_st = None, (0, 0)
    if which == "dq":
        outs = (torch.empty_like(q, memory_format=torch.contiguous_format),)
    else:
        outs = (torch.empty_like(k, memory_format=torch.contiguous_format),
                torch.empty_like(v, memory_format=torch.contiguous_format))
    st = []
    for t in (q, k, v, dout, outs[0], outs[-1]):
        st += [t.stride(0), t.stride(1), t.stride(2)]
    strides = (ctypes.c_longlong * 20)(*st, *m_st)

    from . import _cuda_build
    lib = _flash_bwd_lib()
    fn = getattr(lib, f"molly_flash_attention_{which}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 m_ptr, lse.data_ptr(), delta.data_ptr(),
                 *[o.data_ptr() for o in outs], B, N, Nkv, Sq, Skv, D,
                 _DTYPES[q.dtype], strides, float(scale), int(bool(causal)),
                 int(q_offset), stream)
    _cuda_build.check(lib, err, f"flash_attention_{which}")
    return outs


def flash_attention_dq(q, k, v, mask, lse, delta, dout, causal=True,
                       scale=None, q_offset: int = 0) -> torch.Tensor:
    """dQ [B, Sq, N, D] on a CUDA tensor (the kernel, or raises); a CPU
    tensor runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         causal, scale, q_offset)[0]
    (dq,) = _bwd_launch("dq", q, k, v, mask, lse, delta, dout, causal, scale,
                        q_offset)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal=True,
                        scale=None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, Skv, Nkv, D] on a CUDA tensor (the kernel, or raises); a
    CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         causal, scale, q_offset)[1:]
    dk, dv = _bwd_launch("dkv", q, k, v, mask, lse, delta, dout, causal,
                         scale, q_offset)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, mask, o, lse, dout, causal=True, scale=None,
                        q_offset: int = 0):
    """(dQ, dK, dV) from the forward's saved O and LSE. delta =
    rowsum(dO * O) is tensor ops here, as ``_flash_bwd`` computes it outside
    the Pallas kernels."""
    delta = torch.einsum("bsnd,bsnd->bns", dout.float(), o.float()
                         ).contiguous()
    if q.device.type == "cpu":  # one pass of the plain version gives all
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         causal, scale, q_offset)
    dq = flash_attention_dq(q, k, v, mask, lse, delta, dout, causal, scale,
                            q_offset)
    dk, dv = flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal,
                                 scale, q_offset)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX package: forward saves q, k, v, mask, O
    and LSE; backward launches the dQ and dK/dV kernels (plain versions on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, q_offset):
        o, lse = flash_attention_fwd(q, k, v, mask, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.args = (causal, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, dout,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, causal=True, scale=None,
                    q_offset: int = 0) -> torch.Tensor:
    """O only ([B, Sq, N, D]); see ``flash_attention_fwd``. Differentiable
    in q, k and v when autograd records."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, mask, causal, scale, q_offset)
    return flash_attention_fwd(q, k, v, mask, causal, scale, q_offset)[0]


def _flash_lib():
    from . import _cuda_build
    lib = _cuda_build.library("flash_attention_fwd")
    fn = lib.molly_flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 7 + [L] * 14
                       + [ctypes.c_float, I, I, P])
        fn.restype = I
    return lib


def _flash_bwd_lib():
    from . import _cuda_build
    lib = _cuda_build.library("flash_attention_bwd")
    if lib.molly_flash_attention_dq.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        tail = [I] * 7 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          I, I, P]
        lib.molly_flash_attention_dq.argtypes = [P] * 8 + tail
        lib.molly_flash_attention_dkv.argtypes = [P] * 9 + tail
        lib.molly_flash_attention_dq.restype = I
        lib.molly_flash_attention_dkv.restype = I
    return lib
