"""Flash-attention forward: the wrapper of the hand-written CUDA kernel
(``csrc/flash_attention_fwd.cu``) and its plain PyTorch version.

Replaces ``molly_tpu/ops/flash_attention.py:_fwd_kernel`` (launched from
``_flash_fwd``). The public layout is the model's [B, S, N, D]; the kernel
takes element strides, so K/V views of the head-major KV cache
([B, Nkv, Smax, 2*Dh] sliced and transposed to [B, Smax, Nkv, Dh]) are read
in place — the JAX wrapper transposes them instead.

The header of the CUDA source says what bounds the kernel on the card and
what its design does about it.
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


def flash_attention(q, k, v, mask=None, causal=True, scale=None,
                    q_offset: int = 0) -> torch.Tensor:
    """O only ([B, Sq, N, D]); see ``flash_attention_fwd``."""
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
