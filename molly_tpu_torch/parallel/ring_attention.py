"""Ring attention: context parallelism over the ``seq`` axis of the mesh, the
counterpart of ``molly_tpu/parallel/ring_attention.py``.

  - the sequence of Q/K/V is split over the ranks of ``seq``; Q stays, the
    K/V shards rotate around the ring (``comm.exchange``: one
    ``batch_isend_irecv`` a step, so no ring can deadlock);
  - partial results merge by the online-softmax rule, so the result is a
    softmax over the whole sequence;
  - one ``torch.autograd.Function`` (``_Ring``) holds both directions: its
    backward runs a ring of its own, recomputing each chunk's
    probabilities from the saved log-sum-exp (the JAX package wraps the
    chunk in ``jax.checkpoint``) and carrying each chunk's dK/dV
    accumulators around the ring with it until they are home. The
    backward never leans on the autograd engine to pair sends and
    receives across ranks.

Causality is tracked through per-token position vectors that rotate with
their K/V, so the zigzag layout (``zigzag=True``: rank i holds chunks i and
2P-1-i of the sequence, balancing causal work) changes only which tokens a
rank holds. ``zigzag_permute`` / ``zigzag_unpermute`` convert between the
natural and zigzag orders.

The per-chunk attention is plain ``torch.matmul`` (the JAX package's is
plain ``einsum``, outside any Pallas kernel): scores and accumulators in
fp32, the probabilities cast to the value dtype for the PV product.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm

SEQ_AXIS = "seq"
_NEG_INF = -1e30


def _scores(q, k, kv_mask, q_pos, kv_pos, causal, scale):
    """fp32 scores [B, Nkv, G, Sq, Sk] of local q against one K/V chunk,
    masked to -1e30 where the key is padding or in the future."""
    B, Sq, Nq, D = q.shape
    Nkv = k.shape[2]
    qg = q.reshape(B, Sq, Nkv, Nq // Nkv, D).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]               # [B, Nkv, 1, D, Sk]
    s = torch.matmul(qg.to(torch.float32), kt.to(torch.float32)) * scale
    keep = (kv_mask[:, None, None, None, :] != 0)
    if causal:
        keep = keep & (q_pos[:, None] >= kv_pos[None, :])
    return torch.where(keep, s, torch.full_like(s, _NEG_INF))


def _chunk_attention(q, k, v, kv_mask, q_pos, kv_pos, causal, scale):
    """Unnormalized partials of one chunk: (o [B, Nkv, G, Sq, D] fp32,
    m [B, Nkv, G, Sq], l [B, Nkv, G, Sq])."""
    s = _scores(q, k, kv_mask, q_pos, kv_pos, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    # a fully masked row has m == -1e30, so exp(s - m) == 1 on its masked
    # entries: zero them, so the partial merges as "no data"
    p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    vv = v.permute(0, 2, 1, 3)[:, :, None]               # [B, Nkv, 1, Sk, D]
    o = torch.matmul(p.to(v.dtype).to(torch.float32), vv.to(torch.float32))
    return o, m, l


def _local_positions(S_loc: int, n: int, idx: int, zigzag: bool, device):
    ar = torch.arange(S_loc // 2 if zigzag else S_loc, device=device)
    if zigzag:
        C = S_loc // 2
        return torch.cat([idx * C + ar, (2 * n - 1 - idx) * C + ar])
    return idx * S_loc + ar


def _rotate(tensors, group, n, idx):
    """Send to the previous rank, receive from the next: after t rotations a
    rank holds the chunk of rank idx + t."""
    return comm.exchange([(t, (idx - 1) % n) for t in tensors],
                         [(t, (idx + 1) % n) for t in tensors], group)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, scale, zigzag):
        n, idx = torch.distributed.get_world_size(group), \
            torch.distributed.get_rank(group)
        B, S_loc, Nq, D = q.shape
        Nkv = k.shape[2]
        pos = _local_positions(S_loc, n, idx, zigzag, q.device)
        o = torch.zeros((B, Nkv, Nq // Nkv, S_loc, D), dtype=torch.float32,
                        device=q.device)
        m = torch.full(o.shape[:-1], _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        k_cur, v_cur, mask_cur, pos_cur = k, v, mask, pos
        for t in range(n):
            o_c, m_c, l_c = _chunk_attention(q, k_cur, v_cur, mask_cur, pos,
                                             pos_cur, causal, scale)
            m_new = torch.maximum(m, m_c)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_c - m_new)
            o = o * alpha[..., None] + o_c * beta[..., None]
            l = l * alpha + l_c * beta
            m = m_new
            if t < n - 1:
                k_cur, v_cur, mask_cur, pos_cur = _rotate(
                    (k_cur, v_cur, mask_cur, pos_cur), group, n, idx)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        # log-sum-exp of each row; +inf for a row without any key, so that
        # the backward's probabilities exp(s - lse) are 0 there
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full_like(m, float("inf")))
        ctx.save_for_backward(q, k, v, mask, pos, out, lse)
        ctx.args = (group, causal, scale, n, idx)
        return out.permute(0, 3, 1, 2, 4).reshape(B, S_loc, Nq, D).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, pos, out, lse = ctx.saved_tensors
        group, causal, scale, n, idx = ctx.args
        B, S_loc, Nq, D = q.shape
        Nkv = k.shape[2]
        G = Nq // Nkv
        do = dout.to(torch.float32).reshape(B, S_loc, Nkv, G, D).permute(
            0, 2, 3, 1, 4)                                # [B, Nkv, G, Sq, D]
        delta = (do * out).sum(dim=-1)                    # [B, Nkv, G, Sq]
        qf = q.to(torch.float32).reshape(B, S_loc, Nkv, G, D).permute(
            0, 2, 3, 1, 4)
        dq = torch.zeros_like(qf)
        k_cur, v_cur, mask_cur, pos_cur = k, v, mask, pos
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros_like(dk_cur)
        for t in range(n):
            s = _scores(q, k_cur, mask_cur, pos, pos_cur, causal, scale)
            p = torch.exp(s - lse[..., None])
            p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
            kf = k_cur.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
            vf = v_cur.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
            dp = torch.matmul(do, vf.transpose(-1, -2))   # [B,Nkv,G,Sq,Sk]
            ds = p * (dp - delta[..., None])
            dq = dq + torch.matmul(ds, kf) * scale
            # [B, Nkv, Sk, D] summed over the G query heads of each kv head
            dk_c = (torch.matmul(ds.transpose(-1, -2), qf) * scale).sum(2)
            dv_c = torch.matmul(p.to(v.dtype).to(torch.float32)
                                .transpose(-1, -2), do).sum(2)
            dk_cur = dk_cur + dk_c.permute(0, 2, 1, 3)
            dv_cur = dv_cur + dv_c.permute(0, 2, 1, 3)
            # the accumulators travel with their chunk: after the n-th
            # rotation every chunk's dK / dV is back on its own rank
            if t < n - 1:
                k_cur, v_cur, mask_cur, pos_cur, dk_cur, dv_cur = _rotate(
                    (k_cur, v_cur, mask_cur, pos_cur, dk_cur, dv_cur), group,
                    n, idx)
            else:
                dk_cur, dv_cur = _rotate((dk_cur, dv_cur), group, n, idx)
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S_loc, Nq, D)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   axis_name: str = SEQ_AXIS, causal: bool = True,
                   scale: Optional[float] = None, zigzag: bool = False
                   ) -> torch.Tensor:
    """Collective ring attention over the current mesh's ``axis_name``:
    q [B, S_loc, Nq, D], k / v [B, S_loc, Nkv, D] and mask [B, S_loc] (1 =
    keep) are this rank's shards of the sequence. With ``zigzag=True`` a
    rank's shard holds global chunks idx and 2P-1-idx (``zigzag_permute``
    the sequence first). Returns this rank's [B, S_loc, Nq, D]; a query row
    without any key comes out zero."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    mesh = comm.current_mesh()
    group = mesh.group(axis_name) if mesh is not None else None
    if group is None:
        o, m, l = _chunk_attention(
            q, k, v, mask, torch.arange(q.shape[1], device=q.device),
            torch.arange(k.shape[1], device=q.device), causal, scale)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        B, S, Nq, D = q.shape
        return out.permute(0, 3, 1, 2, 4).reshape(B, S, Nq, D).to(q.dtype)
    return _Ring.apply(q, k, v, mask.to(torch.int32), group, causal, scale,
                       zigzag)


def zigzag_order(S: int, n_dev: int) -> torch.Tensor:
    """Permutation pi with zigzag[i] = natural[pi[i]]: rank d's shard holds
    global chunks d and 2*n_dev-1-d (chunk size S / (2*n_dev))."""
    assert S % (2 * n_dev) == 0, (S, n_dev)
    C = S // (2 * n_dev)
    order = []
    for d in range(n_dev):
        order.extend(range(d * C, (d + 1) * C))
        order.extend(range((2 * n_dev - 1 - d) * C, (2 * n_dev - d) * C))
    return torch.tensor(order, dtype=torch.long)


def zigzag_permute(x: torch.Tensor, n_dev: int, axis: int = 1):
    order = zigzag_order(x.shape[axis], n_dev).to(x.device)
    return x.index_select(axis, order)


def zigzag_unpermute(x: torch.Tensor, n_dev: int, axis: int = 1):
    order = zigzag_order(x.shape[axis], n_dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel())
    return x.index_select(axis, inv.to(x.device))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           axis_name: str = SEQ_AXIS, causal: bool = True,
                           scale: Optional[float] = None,
                           zigzag: bool = False, pre_permuted: bool = False
                           ) -> torch.Tensor:
    """The whole-array form: q / k / v [B, S, N, D] and mask [B, S] are the
    same on every rank of ``axis_name`` (gradients come back whole on
    every rank); each rank takes its part of the sequence, runs the ring,
    and the parts are gathered back. zigzag=True permutes the sequence into
    the balanced layout first and back after; with pre_permuted=True the
    caller's arrays are already in zigzag order and the output stays so."""
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    mesh = comm.current_mesh()
    group = mesh.group(axis_name) if mesh is not None else None
    if group is None:
        return ring_attention(q, k, v, mask, axis_name=axis_name,
                              causal=causal, scale=scale)
    n, idx = mesh.size(axis_name), mesh.index(axis_name)
    if zigzag and not pre_permuted:
        q, k, v = (zigzag_permute(x, n) for x in (q, k, v))
        mask = zigzag_permute(mask, n)
    S_loc = q.shape[1] // n

    def part(x):
        return comm.reduce_grad(x, group).narrow(1, idx * S_loc, S_loc)

    out = ring_attention(part(q), part(k), part(v),
                         mask.narrow(1, idx * S_loc, S_loc),
                         axis_name=axis_name, causal=causal, scale=scale,
                         zigzag=zigzag)
    out = comm.gather(out, 1, group, "slice")
    if zigzag and not pre_permuted:
        out = zigzag_unpermute(out, n)
    return out
