"""Paged-KV decode attention: the wrapper of the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version, the counterpart
of ``molly_tpu/ops/paged_attention.py`` and ``paged_attention_int8.py``.

One query token per serving slot attends over a KV cache stored as a chain
of fixed-size pages (``inference/paged.py`` owns the pool and the
allocator):

  q            [B, Nq, Dh]        one decode token per slot
  k/v_pages    [Nkv, rows, P, Dh] in the model dtype, or int8
  k/v_scales   [Nkv, rows, P]     fp32, int8 pools only: one scale per page
                                  row, dequant = w * scale / 127.5
  lengths      [B] int32          attention covers positions [0, len)
  page_indices [B, pages_per_seq] int32, position t lives in
               k_pages[:, page_indices[b, t // P], t % P]

The JAX package stores int8 scales as ``[Nkv, rows, 8, P]`` tiles replicated
over 8 sublanes, which its TPU compiler needs; here a scale is stored once.
The softmax scale multiplies the fp32 logits in the kernel and in the plain
version alike. A slot of length 0 gets a zero row from both (the JAX gather
reference averages uniformly there; its engine never passes 0). Entries of
``page_indices`` past a slot's length may name any row: neither version
lets them reach the result.

Two sources hold the kernels. ``paged_takes_tma`` is the rule: bf16 q over
bf16 pages (Dh 64 or 128) or over int8 pages (Dh 128), G = Nq / Nkv in
{1, 2, 4, 8}, a page size that is a multiple of 16 up to 128, 16-byte
aligned bases and q strides of multiples of 8 elements go to
``csrc/paged_attention_tma.cu`` (the sequence split over blocks by
``paged_split_plan``, whole pages loaded ahead by TMA, mma.sync products,
the splits merged in order by a second kernel); the rest (fp32 pages, fp32
q over int8 pages, other shapes) to ``csrc/paged_attention.cu``. The
headers of the CUDA sources say what bounds each kernel on the card and
what its design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

PAGED_QUANT_MAX = 127.5

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_SPLIT_TOKENS = 256      # a split's pages hold about this many tokens ...
_SPLIT_BLOCKS_PER_SM = 4  # ... unless fewer splits than this fill the card
_MAX_SPLIT_PAGES = 32    # table entries the kernel stages for a split


def paged_takes_tma(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> bool:
    """Whether a call goes to ``csrc/paged_attention_tma.cu``: bf16 q over
    bf16 pages (head dim 64 or 128) or int8 pages with fp32 scales (head
    dim 128), G = Nq / Nkv in {1, 2, 4, 8}, page size a multiple of 16 up to
    128, contiguous pools, 16-byte aligned bases and q strides that are
    multiples of 8 elements with a contiguous head dim. Shapes and
    strides only: nothing is read from the device."""
    if q.ndim != 3 or k_pages.ndim != 4 or q.dtype != torch.bfloat16:
        return False
    B, Nq, Dh = q.shape
    Nkv, rows, P, Dh_k = k_pages.shape
    quant = k_pages.dtype == torch.int8
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        return False
    if quant:
        if Dh != 128 or k_scales is None or v_scales is None:
            return False
        if any(sc.dtype != torch.float32 or not sc.is_contiguous()
               or sc.data_ptr() % 16 for sc in (k_scales, v_scales)):
            return False
    elif k_pages.dtype != torch.bfloat16 or Dh not in _HEAD_DIMS:
        return False
    return (Dh_k == Dh and Nq % Nkv == 0 and Nq // Nkv in _GROUPS
            and P % 16 == 0 and 16 <= P <= 128
            and k_pages.is_contiguous() and v_pages.is_contiguous()
            and Nkv * rows * P < 2 ** 31
            and q.stride(2) == 1 and q.stride(0) % 8 == 0
            and q.stride(1) % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)))


def paged_split_plan(B: int, Nkv: int, pages_per_seq: int, page_size: int,
                     sm_count: int) -> Tuple[int, int]:
    """(pages a split, splits a slot) of the TMA kernel, from static shapes
    and the device's SM count only (lengths live on the device and are never
    read by the host, so the plan holds for any lengths and a captured graph
    replays with new ones). A split covers a whole number of pages, about
    256 tokens; it is halved while B * Nkv * splits would give fewer than 4
    blocks an SM."""
    k = max(1, min(_MAX_SPLIT_PAGES, _SPLIT_TOKENS // page_size,
                   pages_per_seq))
    while k > 1 and (B * Nkv * -(-pages_per_seq // k)
                     < _SPLIT_BLOCKS_PER_SM * sm_count):
        k //= 2
    return k, -(-pages_per_seq // k)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, *,
                          scale: Optional[float] = None, k_scales=None,
                          v_scales=None) -> torch.Tensor:
    """The kernel's plain PyTorch version, the gather reference
    (``_xla_paged_attention``): materializes each slot's pages, dequantizes
    int8 rows, and runs a length-masked softmax in fp32."""
    b, nq, dh = q.shape
    nkv, _, p, _ = k_pages.shape
    group = nq // nkv
    if scale is None:
        scale = dh ** -0.5
    idx = page_indices.long()
    # [Nkv, B, pages_per_seq, P, Dh] -> [B, Nkv, S, Dh]
    k = k_pages[:, idx].movedim(1, 0)
    v = v_pages[:, idx].movedim(1, 0)
    if k_scales is not None:  # dequantize int8 pages
        ksc = k_scales[:, idx].movedim(1, 0)[..., None]
        vsc = v_scales[:, idx].movedim(1, 0)[..., None]
        k = k.float() * (ksc / PAGED_QUANT_MAX)
        v = (v.float() * (vsc / PAGED_QUANT_MAX)).to(q.dtype)
    s = k.shape[2] * p
    k = k.reshape(b, nkv, s, dh)
    v = v.reshape(b, nkv, s, dh)
    qg = q.reshape(b, nkv, group, dh)
    logits = torch.einsum("bngd,bnkd->bngk", qg.float(), k.float()) * scale
    live = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])                                # [B, S]
    logits = torch.where(live[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    # dead columns weigh exactly 0 (their rows may hold anything, inf and
    # nan included), and an empty slot gets a zero row
    probs = torch.where(live[:, None, None, :], probs, 0.0)
    v = torch.where(live[:, None, :, None], v, torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
    out = torch.einsum("bngk,bnkd->bngd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, nq, dh).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_indices: torch.Tensor, *,
                    scale: Optional[float] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool; returns [B, Nq, Dh] in q's
    dtype. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel that ``paged_takes_tma`` names, or raises."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_indices, scale=scale,
                                     k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention: unsupported device {q.device}")
    B, Nq, Dh = q.shape
    Nkv, rows, P, Dh_k = k_pages.shape
    quant = k_pages.dtype == torch.int8
    if q.dtype not in _Q_DTYPES or v_pages.dtype != k_pages.dtype or \
            (not quant and k_pages.dtype != q.dtype):
        raise TypeError(f"paged_attention: dtypes q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}; the kernel takes "
                        f"q in {list(_Q_DTYPES)} with pages in q's dtype or "
                        f"int8")
    if Dh not in _HEAD_DIMS or Dh_k != Dh or v_pages.shape != k_pages.shape \
            or Nq % Nkv or Nq // Nkv not in _GROUPS:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}; "
                         f"the kernel takes head dims {_HEAD_DIMS} and "
                         f"Nq / Nkv in {_GROUPS}")
    if quant != (k_scales is not None) or quant != (v_scales is not None):
        raise ValueError("paged_attention: int8 pages need k_scales and "
                         "v_scales, other pages take none")
    if quant:
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if sc.shape != (Nkv, rows, P) or sc.dtype != torch.float32 or \
                    not sc.is_contiguous() or sc.device != q.device:
                raise ValueError(f"paged_attention: {name} must be a "
                                 f"contiguous fp32 {(Nkv, rows, P)} on "
                                 f"{q.device}, got {tuple(sc.shape)} "
                                 f"{sc.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention: the page pools must be contiguous")
    if q.stride(-1) != 1:
        raise ValueError("paged_attention: the head dim of q must be "
                         "contiguous")
    if lengths.shape != (B,) or page_indices.ndim != 2 or \
            page_indices.shape[0] != B:
        raise ValueError(f"paged_attention: lengths {tuple(lengths.shape)}, "
                         f"page_indices {tuple(page_indices.shape)} for "
                         f"{B} slots")
    pps = page_indices.shape[1]
    tma = paged_takes_tma(q, k_pages, v_pages, k_scales, v_scales)
    if not tma and 4 * (pps + 3) + 4 * 8 * (Nq // Nkv) * (Dh + 2) > 48 * 1024:
        raise ValueError(f"paged_attention: a page table of {pps} entries a "
                         f"slot does not fit the kernel's shared memory")
    if not all(t.device == q.device
               for t in (k_pages, v_pages, lengths, page_indices)):
        raise ValueError("paged_attention: operands on different devices")
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    if scale is None:
        scale = Dh ** -0.5
    out = torch.empty((B, Nq, Dh), dtype=q.dtype, device=q.device)

    from . import _cuda_build
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tma:
            lib = _cuda_build.library("paged_attention_tma")
            k_split, n_splits = paged_split_plan(
                B, Nkv, pps, P, _cuda_build.sm_count(q.device.index))
            # the splits' partials; a plan of one split needs none
            part_o = part_ml = None
            if n_splits > 1:
                part_o = torch.empty((B, Nkv, n_splits, Nq // Nkv, Dh),
                                     dtype=torch.float32, device=q.device)
                part_ml = torch.empty((B, Nkv, n_splits, Nq // Nkv, 2),
                                      dtype=torch.float32, device=q.device)
            err = _tma_fn(lib)(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr() if quant else None,
                v_scales.data_ptr() if quant else None,
                lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
                None if part_o is None else part_o.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                B, Nq, Nkv, Dh, P, pps, rows, k_split, q.stride(0),
                q.stride(1), int(quant), float(scale), stream)
        else:
            lib = _paged_lib()
            err = lib.molly_paged_attention(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr() if quant else None,
                v_scales.data_ptr() if quant else None,
                lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
                B, Nq, Nkv, Dh, P, pps, rows, q.stride(0), q.stride(1),
                _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], float(scale),
                stream)
    _cuda_build.check(lib, err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.launches_int8 += int(quant)
    paged_attention.launches_tma += int(tma)
    return out


paged_attention.launches = 0       # every launch (of either source)
paged_attention.launches_int8 = 0  # those over int8 pages
paged_attention.launches_tma = 0   # those on csrc/paged_attention_tma.cu


def _paged_lib():
    from . import _cuda_build
    lib = _cuda_build.library("paged_attention")
    fn = lib.molly_paged_attention
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 8 + [I] * 6 + [L] * 3 + [I, I, ctypes.c_float,
                                                      P])
        fn.restype = I
    return lib


def _tma_fn(lib):
    fn = lib.molly_paged_attention_tma
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 10 + [I] * 8 + [L, L, I, ctypes.c_float, P])
        fn.restype = I
    return fn
