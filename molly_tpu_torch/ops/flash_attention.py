"""Flash attention, forward and backward: the wrappers of the hand-written
CUDA kernels (``csrc/flash_attention_fwd_tma.cu`` and
``csrc/flash_attention_fwd.cu`` for the forward,
``csrc/flash_attention_bwd_tma.cu`` and ``csrc/flash_attention_bwd.cu`` for
the backward), their plain PyTorch versions, and the autograd function that
joins them.

Replaces ``molly_tpu/ops/flash_attention.py``: ``_fwd_kernel`` (launched from
``_flash_fwd``), ``_dq_kernel`` and ``_dkv_kernel`` (launched from
``_flash_bwd``). The public layout is the model's [B, S, N, D]; the kernels
take element strides, so K/V views of the head-major KV cache
([B, Nkv, Smax, 2*Dh] sliced and transposed to [B, Smax, Nkv, Dh]) and the
gradient dO, with whatever strides autograd left it, are read in place — the
JAX wrapper transposes them instead.

The forward and each backward kernel exist twice. ``fwd_takes_tma`` and
``bwd_takes_tma`` are the rules: bf16 with 16-byte aligned bases and
strides (every main-path call) runs the TMA and wgmma kernels, which visit
no key tile that the mask and the causal rule leave empty; fp32 and
unaligned bf16 views run the SIMT kernels. The forward's v (and O) head
width may differ from the q.k width: multi-head latent attention's prefill
attends at 192 / 128 (``models.deepseek_v3``), on the TMA kernel and the
plain version only; the backward takes one width.

A query row with no valid key (a left-padded prompt position) comes out of
both card kernels as O = 0 and LSE = 0; the plain version gives it the
uniform mean over all keys, as the JAX package does (``_probs``). Nothing
reads such a row: the loss masks it and no valid row attends to a padded
key. The backward recomputes P = exp(S - LSE) from the forward's saved LSE
with the finite -1e30 for masked scores, as the Pallas kernels do; it does
not differentiate a softmax. On the card LSE = 0 makes P zero on every key
of a row without a valid key; in the model dO is exactly zero there anyway.

The headers of the CUDA sources say what bounds the kernels on the card and
what their design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite, like the kernel: fully masked rows stay finite

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, mask, causal, scale, q_offset):
    """Masked fp32 scores [B, Nkv, g, Sq, Skv] (NEG_INF where masked) and
    ``no_key`` [B, 1, 1, Sq, 1]: the rows with no valid key (left-padded
    positions)."""
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
    return s.masked_fill(~valid, NEG_INF), ~valid.any(dim=-1, keepdim=True)


def _probs(s, lse, no_key):
    """P = exp(S - LSE). A row with no valid key weighs every key 1 / Skv,
    the uniform mean over ALL keys that both attention routes of the JAX
    package give it. (All its scores are NEG_INF, the fp32 LSE absorbs
    log(Skv), and exp(S - LSE) alone would weigh every key 1: the sum.) The
    card's kernels give such a row O = 0 and LSE = 0 instead."""
    p = torch.exp(s - lse[..., None])
    return torch.where(no_key, 1.0 / s.shape[-1], p)


def flash_attention_plain(q, k, v, mask=None, causal=True, scale=None,
                          q_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: (O [B, Sq, N, D] in q's dtype,
    LSE [B, N, Sq] fp32), math in fp32. A row with no valid key gets the
    uniform average over all keys (see ``_probs``), where the kernels give
    O = 0 and LSE = 0; callers that compare the two compare only rows with
    a valid key."""
    B, Sq, N, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s, no_key = _scores(q, k, mask, causal, scale, q_offset)
    lse = torch.logsumexp(s, dim=-1)                       # [B, Nkv, g, Sq]
    o = torch.einsum("bngqk,bknd->bqngd", _probs(s, lse, no_key), v.float())
    return (o.reshape(B, Sq, N, v.shape[-1]).to(q.dtype),
            lse.reshape(B, N, Sq))


def _tma_layout(t: torch.Tensor) -> bool:
    """A contiguous head dim, a 16-byte aligned base and strides of whole
    16-byte rows (multiples of 8 elements) on every axis longer than 1: what
    a TMA tensor map over the [B, S, heads, D] view takes."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(
        st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


# (q.k, v) head widths the TMA forward is built for
TMA_WIDTHS = ((64, 64), (128, 128), (192, 128))


def fwd_takes_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor) -> bool:
    """Does this forward go to the TMA and wgmma kernel? All four bf16,
    (q.k, v) head widths of 64 / 64, 128 / 128 or 192 / 128, and each laid
    out as ``_tma_layout`` says. Everything else runs the SIMT kernel, which
    takes one width, 64 or 128."""
    return (q.dtype == k.dtype == v.dtype == o.dtype == torch.bfloat16
            and (q.shape[-1], v.shape[-1]) in TMA_WIDTHS
            and all(_tma_layout(t) for t in (q, k, v, o)))


def bwd_takes_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor) -> bool:
    """Do this backward's dQ and dK/dV go to the TMA and wgmma kernels? The
    forward's rule over q, k, v and dO (the outputs are allocated
    contiguous, so they always qualify) at one head width, 64 or 128.
    Everything else runs the SIMT kernels."""
    return q.shape[-1] == v.shape[-1] and fwd_takes_tma(q, k, v, dout)


def _strides(t: torch.Tensor, D: int):
    """Element strides of the three outer axes; an axis of length 1 gets D
    (its stride is never stepped, and the TMA maps take only multiples of
    16 bytes)."""
    return [st if n > 1 else D for st, n in zip(t.stride()[:3], t.shape[:3])]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, N, D], k [B, Skv, Nkv, D], v [B, Skv, Nkv, Dv] (any
    strides with a contiguous head dim; Dv = D but on the TMA kernel's
    192 / 128), mask [B, Skv] 1=keep -> (O [B, Sq, N, Dv], LSE [B, N,
    Sq]).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    that ``fwd_takes_tma`` names, or raises. ``.launches`` counts kernel
    launches, ``.launches_tma`` those on the TMA and wgmma kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, scale, q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    B, Sq, N, D = q.shape
    Skv, Nkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of "
                        f"{list(_DTYPES)} for all three")
    widths = (D, Dv) in TMA_WIDTHS if Dv != D else D in (64, 128)
    if not widths or N % Nkv or k.shape[:3] != v.shape[:3] or \
            k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, Sq, N, Dv), dtype=q.dtype, device=q.device)
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
    tma = fwd_takes_tma(q, k, v, o)
    if Dv != D and not tma:
        raise ValueError(f"flash_attention: q.k width {D} and v width {Dv} "
                         f"run on the TMA kernel alone, which takes aligned "
                         f"bf16")
    lib = _flash_lib("flash_attention_fwd_tma" if tma else
                     "flash_attention_fwd")
    if tma:  # the TMA kernel's entry point takes both widths
        fn, widths, st = lib.molly_flash_attention_fwd_tma, (D, Dv), [
            x for t in (q, k, v, o) for x in _strides(t, t.shape[-1])]
    else:  # the SIMT kernel's, one width and a dtype code
        fn, widths, st = lib.molly_flash_attention_fwd, (
            D, _DTYPES[q.dtype]), [x for t in (q, k, v, o)
                                   for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr,
                 o.data_ptr(), lse.data_ptr(), B, N, Nkv, Sq, Skv, *widths,
                 *st, m_sb, m_ss, float(scale), int(bool(causal)),
                 int(q_offset), stream)
    _cuda_build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_tma += tma
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_tma = 0


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
    s, no_key = _scores(q, k, mask, causal, scale, q_offset)
    p = _probs(s, lse.reshape(B, Nkv, g, Sq), no_key)
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
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_{which}: the head dim must "
                             f"be contiguous")
    # the kernels read dO through strides but need its head dim dense; a dO
    # that alone keeps a call off the TMA kernels is copied once instead, so
    # tma is bwd_takes_tma(q, k, v, dout) (dtypes and D are checked above)
    tma = q.dtype == torch.bfloat16 and all(_tma_layout(t) for t in (q, k, v))
    if dout.stride(-1) != 1 or (tma and not _tma_layout(dout)):
        dout = dout.contiguous()
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
        st += _strides(t, D) if tma else t.stride()[:3]
    strides = (ctypes.c_longlong * 20)(*st, *m_st)

    from . import _cuda_build
    lib, fn = _flash_bwd_fn(which, tma)
    dtype = () if tma else (_DTYPES[q.dtype],)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 m_ptr, lse.data_ptr(), delta.data_ptr(),
                 *[o.data_ptr() for o in outs], B, N, Nkv, Sq, Skv, D,
                 *dtype, strides, float(scale), int(bool(causal)),
                 int(q_offset), stream)
    _cuda_build.check(lib, err, f"flash_attention_{which}")
    return outs, tma


def flash_attention_dq(q, k, v, mask, lse, delta, dout, causal=True,
                       scale=None, q_offset: int = 0) -> torch.Tensor:
    """dQ [B, Sq, N, D] on a CUDA tensor (the kernel that ``bwd_takes_tma``
    names, or raises); a CPU tensor runs the plain version. ``.launches``
    counts kernel launches, ``.launches_tma`` those on the TMA kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         causal, scale, q_offset)[0]
    (dq,), tma = _bwd_launch("dq", q, k, v, mask, lse, delta, dout, causal,
                             scale, q_offset)
    flash_attention_dq.launches += 1
    flash_attention_dq.launches_tma += tma
    return dq


def flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal=True,
                        scale=None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, Skv, Nkv, D] on a CUDA tensor, as ``flash_attention_dq``
    launches and counts; a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         causal, scale, q_offset)[1:]
    (dk, dv), tma = _bwd_launch("dkv", q, k, v, mask, lse, delta, dout,
                                causal, scale, q_offset)
    flash_attention_dkv.launches += 1
    flash_attention_dkv.launches_tma += tma
    return dk, dv


flash_attention_dq.launches = flash_attention_dq.launches_tma = 0
flash_attention_dkv.launches = flash_attention_dkv.launches_tma = 0


def flash_attention_delta(dout: torch.Tensor, o: torch.Tensor
                          ) -> torch.Tensor:
    """delta = rowsum(dO * O), fp32 [B, N, S] contiguous: tensor ops, as
    ``_flash_bwd`` computes it outside the Pallas kernels. The products and
    sums are fp32; O is promoted inside the multiply, not copied to fp32
    first."""
    return (dout.float() * o).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, mask, o, lse, dout, causal=True, scale=None,
                        q_offset: int = 0):
    """(dQ, dK, dV) from the forward's saved O and LSE, with
    ``flash_attention_delta`` between them."""
    delta = flash_attention_delta(dout, o)
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


def _flash_lib(name: str):
    """The forward's library ``name``: the SIMT kernel's entry point takes a
    dtype code after D, the TMA kernel's (bf16 only) the v width Dv."""
    from . import _cuda_build
    lib = _cuda_build.library(name)
    fn = getattr(lib, f"molly_{name}")
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 7 + [L] * 14
                       + [ctypes.c_float, I, I, P])
        fn.restype = I
    return lib


def _flash_bwd_fn(which: str, tma: bool):
    """(library, entry point) of the backward's ``which`` ("dq" or "dkv"):
    the SIMT kernels' entry points take a dtype code after D, the TMA
    kernels' (bf16 only) do not."""
    from . import _cuda_build
    lib = _cuda_build.library("flash_attention_bwd_tma" if tma else
                              "flash_attention_bwd")
    fn = getattr(lib, f"molly_flash_attention_{which}{'_tma' if tma else ''}")
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * (8 if which == "dq" else 9)
                       + [I] * (6 if tma else 7)
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          I, I, P])
        fn.restype = I
    return lib, fn
