"""The port's hand-written kernels against their plain PyTorch versions on
the card. Skipped without a CUDA device; run on one with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have; this file imports only torch and the port.)
Tolerances: fp32 inputs 1e-4 (the kernels' fp32 sums run in another order),
bf16 outputs one bf16 rounding of the fp32 result.
"""

import pytest
import torch

from molly_tpu_torch.ops import flash_attention as fa
from molly_tpu_torch.ops import grouped_gemm as gg
from molly_tpu_torch.ops import paged_attention as pa
from molly_tpu_torch.ops import quant, rmsnorm_triton

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal,q_offset,bnsd,aligned", [
    (64, False, 0, False, True), (128, True, 0, False, True),
    (128, True, 37, True, True), (64, True, 5, True, True),
    (128, True, 0, False, False)])
def test_flash_kernel_matches_plain(dev, dtype, D, causal, q_offset, bnsd,
                                    aligned):
    """bf16 with aligned rows runs the TMA and wgmma kernel; fp32 and the
    unaligned bf16 view run the SIMT kernel. Both give a row without a
    valid key O = 0 and LSE = 0, and the same bits on every run."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, Sq, N, Nkv = 2, 100, 4, 2
    Skv = Sq + q_offset + 13
    q = torch.randn((B, Sq, N, D + 1), generator=g, device=dev).to(dtype)
    q = q[..., 1:] if not aligned else q[..., :D].contiguous()
    if bnsd:  # k/v as strided views of a [B, Nkv, Skv, 2D] cache
        kv = torch.randn((B, Nkv, Skv, 2 * D), generator=g,
                         device=dev).to(dtype)
        k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    else:
        k = torch.randn((B, Skv, Nkv, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Skv, Nkv, D), generator=g, device=dev).to(dtype)
    mask = torch.ones((B, Skv), dtype=torch.int32, device=dev)
    mask[1, :40] = 0  # rows of batch 1 below 40 - q_offset see no key
    before = fa.flash_attention_fwd.launches
    tma = fa.flash_attention_fwd.launches_tma
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    assert fa.flash_attention_fwd.launches == before + 1
    assert fa.flash_attention_fwd.launches_tma == tma + (
        dtype == torch.bfloat16 and aligned)
    again = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(), mask,
                                        causal, None, q_offset)
    torch.cuda.synchronize()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    rows = torch.ones((B, Sq), dtype=torch.bool, device=dev)
    if causal:
        rows[1, :max(0, 40 - q_offset)] = False
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert ((o.float() - ro).abs()[rows]).max().item() <= tol
    assert ((lse - rlse).abs().transpose(1, 2)[rows]).max().item() <= 1e-4
    assert (o[~rows] == 0).all()
    assert (lse.transpose(1, 2)[~rows] == 0).all()


_HOLE = 300  # keys masked in the middle of a row


def _flash_mask(kind, B, Skv, dev):
    """[B, Skv] int32: batch row 1 left-padded, right-padded, with a hole of
    300 keys in the middle (clipped to the row, key 0 and the last key
    stay), or with no valid key at all; batch row 0 keeps every key."""
    mask = torch.ones((B, Skv), dtype=torch.int32, device=dev)
    if kind == "left":
        mask[1, :40] = 0
    elif kind == "right":
        mask[1, Skv - Skv // 3:] = 0
    elif kind == "hole":
        a = max(1, Skv // 2 - _HOLE // 2)
        mask[:, a:min(Skv - 1, a + _HOLE)] = 0
    else:
        mask[1] = 0
    return mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("kind", ["left", "right", "hole", "empty"])
@pytest.mark.parametrize("causal,q_offset,bnsd,Sq", [
    (True, 0, False, 300), (True, 37, True, 100), (True, 37, False, 16),
    (False, 0, True, 300), (False, 0, False, 100)])
def test_flash_tma_kernel_matches_plain(dev, D, group, kind, causal,
                                        q_offset, bnsd, Sq):
    """The TMA and wgmma kernel (bf16, aligned) against the plain version on
    every row with a valid key: O within one bf16 rounding (2e-2), LSE 1e-4
    (the same fp32 math). Skv is no multiple of the 128-key tile; tiles the
    mask leaves empty are not visited, which changes nothing but the order
    of sums. A row without a valid key is O = 0 and LSE = 0 exactly, and
    two runs give the same bits."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, Nkv = 2, 2
    N = Nkv * group
    Skv = Sq + q_offset + 13 if causal else 613
    q = torch.randn((B, Sq, N, D), generator=g, device=dev).to(torch.bfloat16)
    if bnsd:
        kv = torch.randn((B, Nkv, Skv, 2 * D), generator=g,
                         device=dev).to(torch.bfloat16)
        k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    else:
        k = torch.randn((B, Skv, Nkv, D), generator=g,
                        device=dev).to(torch.bfloat16)
        v = torch.randn((B, Skv, Nkv, D), generator=g,
                        device=dev).to(torch.bfloat16)
    mask = _flash_mask(kind, B, Skv, dev)
    assert fa.fwd_takes_tma(q, k, v, torch.empty_like(q))
    tma = fa.flash_attention_fwd.launches_tma
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    again = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    assert fa.flash_attention_fwd.launches_tma == tma + 2
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(), mask,
                                        causal, None, q_offset)
    torch.cuda.synchronize()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    allowed = (mask != 0)[:, None, :].expand(B, Sq, Skv)
    if causal:
        pos = torch.arange(Sq, device=dev)[:, None] + q_offset
        allowed = allowed & (pos >= torch.arange(Skv, device=dev))
    rows = allowed.any(-1)                                   # [B, Sq]
    if kind == "empty" or (kind == "left" and causal):
        assert not rows.all()  # the case has rows without a key
    assert ((o.float() - ro).abs()[rows]).max().item() <= 2e-2
    assert ((lse - rlse).abs().transpose(1, 2)[rows]).max().item() <= 1e-4
    assert (o[~rows] == 0).all()
    assert (lse.transpose(1, 2)[~rows] == 0).all()


def test_flash_kernel_rejects_unsupported_head_dim(dev):
    q = torch.zeros((1, 4, 2, 32), device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,w_shape", [
    ((7, 2048), (2048,)), ((2, 5, 6, 128), (6, 128)), ((3, 1000), (1000,))])
def test_rmsnorm_kernel_matches_plain(dev, dtype, x_shape, w_shape):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(x_shape, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(w_shape, generator=g, device=dev)).to(dtype)
    before = rmsnorm_triton.rms_norm.launches
    y = rmsnorm_triton.rms_norm(x, w, 1e-6)
    assert rmsnorm_triton.rms_norm.launches == before + 1
    ref = rmsnorm_triton.rms_norm_plain(x, w, 1e-6)  # same rounding points
    assert y.dtype == ref.dtype and y.shape == ref.shape
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((y.float() - ref.float()).abs()
            <= rel * ref.float().abs() + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [64, 128, 1000, 2048])
@pytest.mark.parametrize("outer", [1, 7, 3001])
@pytest.mark.parametrize("layout", ["contiguous", "fused_view", "copied"])
@pytest.mark.parametrize("stacked", [False, True])
def test_rmsnorm_kernel_tiles_and_views_match_plain(dev, dtype, H, outer,
                                                    layout, stacked):
    """Rows of three heads, [outer, 3, H]: a weight [H] or stacked [3, H];
    H a power of two or not; 3 rows, 21 (one partial tile) or 9,003 (many
    tiles of the plan, the last partial); x contiguous, the fused branch's
    view (the first three heads of a [outer, 5 H] product, read in place)
    or a view the kernel cannot fold (last stride not 1: copied first).
    Parity with the plain version in fp32 (bf16: max(err - 2^-7 |ref|) <=
    0, as chip_smoke.py holds it: the kernel rounds twice, x_hat and then
    w * x_hat), the same bits on a second run."""
    g = torch.Generator(device=dev).manual_seed(5)
    if layout == "fused_view":
        qkv = torch.randn((outer, 5 * H), generator=g, device=dev).to(dtype)
        x = qkv[:, :3 * H].view(outer, 3, H)
        assert rmsnorm_triton._row_strides(x) is not None  # read in place
    elif layout == "copied":
        x = torch.randn((outer, H, 3), generator=g, device=dev).to(
            dtype).transpose(1, 2)
        assert x.stride(-1) != 1
    else:
        x = torch.randn((outer, 3, H), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn((3, H) if stacked else (H,), generator=g,
                               device=dev)).to(dtype)
    before = rmsnorm_triton.rms_norm.launches
    y = rmsnorm_triton.rms_norm(x, w, 1e-6)
    again = rmsnorm_triton.rms_norm(x, w, 1e-6)
    assert rmsnorm_triton.rms_norm.launches == before + 2
    ref = rmsnorm_triton.rms_norm_plain(x.float(), w.float(), 1e-6)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    err = (y.float() - ref).abs()
    if dtype == torch.float32:
        assert (err <= 1e-5 * ref.abs() + 1e-6).all()
    else:
        assert (err - 2.0 ** -7 * ref.abs()).max().item() <= 0
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (1, 64, 40), (4, 2048, 1000), (4, 6144, 2048), (16, 1000, 520),
    (17, 300, 129), (70, 300, 129), (257, 512, 256), (130, 256, 2064)])
def test_int8_kernel_matches_plain(dev, dtype, M, K, N):
    """bf16 x with K % 64 == 0 and N % 16 == 0 takes the weight stream (M <=
    16) or the TMA and wgmma GEMM (larger M); the rest the SIMT GEMM."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = torch.randn((K, N), generator=g, device=dev) * 0.05
    q = quant.quantize_int8(w)
    before = quant.int8_matmul.launches
    y = quant.int8_matmul(x, q)
    assert quant.int8_matmul.launches == before + 1
    ref = quant.int8_matmul_plain(x.float(), q)
    assert y.dtype == dtype and y.shape == (M, N)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (y.float() - ref).abs().max().item() <= tol


def _int8_operands(dev, M, K, N, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q = quant.quantize_int8(torch.randn((K, N), generator=g, device=dev)
                            * 0.05)
    return x, q


@pytest.mark.parametrize("M", [17, 64, 100, 4096])
@pytest.mark.parametrize("K,N", [(64, 16), (192, 272), (1024, 768)])
def test_int8_tma_kernel_matches_plain(dev, M, K, N):
    """bf16 x with more than 16 rows runs on the TMA and wgmma kernel: one
    row tile or many, a partial last row tile, the smallest K and N the
    route takes, a column tile whose second box lies wholly past N; parity
    with the plain version (one bf16 rounding of the output) and the same
    bits on a second run."""
    x, q = _int8_operands(dev, M, K, N)
    assert quant.int8_takes_tma(M, K, N, x.dtype)
    before = (quant.int8_matmul.launches, quant.int8_matmul.launches_tma)
    y = quant.int8_matmul(x, q)
    again = quant.int8_matmul(x, q)
    assert (quant.int8_matmul.launches,
            quant.int8_matmul.launches_tma) == (before[0] + 2, before[1] + 2)
    ref = quant.int8_matmul_plain(x.float(), q)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert torch.isfinite(y).all()
    assert (y.float() - ref).abs().max().item() <= \
        1e-2 * ref.abs().max().item()
    assert torch.equal(y, again)


@pytest.mark.parametrize("case", ["unaligned_view", "k_not_of_64",
                                  "n_not_of_16", "fp32", "sixteen_rows"])
def test_int8_other_routes_match_plain(dev, case):
    """What the TMA kernel does not take: an x whose base is 2 bytes off a
    16-byte boundary, K or N off the route's multiples, fp32 x (the SIMT
    GEMM), 16 rows (the weight stream)."""
    M, K, N = (16 if case == "sixteen_rows" else 70,
               96 if case == "k_not_of_64" else 128,
               40 if case == "n_not_of_16" else 256)
    x, q = _int8_operands(dev, M, K, N, seed=4)
    if case == "unaligned_view":
        flat = torch.empty(M * K + 1, dtype=x.dtype, device=dev)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(M, K)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    elif case == "fp32":
        x = x.float()
    before = (quant.int8_matmul.launches, quant.int8_matmul.launches_tma,
              quant.int8_matmul.launches_gemv)
    y = quant.int8_matmul(x, q)
    stream = quant.int8_takes_stream(M, K, N, x.dtype,
                                     x.data_ptr() % 16 == 0)
    assert stream is (case == "sixteen_rows")
    assert (quant.int8_matmul.launches, quant.int8_matmul.launches_tma,
            quant.int8_matmul.launches_gemv) == (
        before[0] + 1, before[1], before[2] + stream)
    ref = quant.int8_matmul_plain(x.float(), q)
    torch.cuda.synchronize()
    rel = 1e-4 if case == "fp32" else 1e-2
    assert (y.float() - ref).abs().max().item() <= \
        rel * ref.abs().max().item()


@pytest.mark.parametrize("M", [1, 2, 4, 8, 9, 16])
@pytest.mark.parametrize("K,N", [(64, 16), (64, 272), (2048, 272),
                                 (2048, 2048), (2048, 151936), (6144, 272),
                                 (6144, 2048)])
def test_int8_stream_kernel_matches_plain(dev, M, K, N):
    """bf16 x with at most 16 rows runs on the weight stream
    (int8_matmul_stream.cu): one or two n8 chunks of rows, one K stage
    or 96, a partial column tile (272 = 2 x 128 + 16), K split (8 ways at
    N 2048) or not (the lm head's 1,187 tiles); parity with the plain
    version (one bf16 rounding of the output) and the same bits on a
    second run (the splits are summed in a fixed order, no atomics)."""
    x, q = _int8_operands(dev, M, K, N, seed=5)
    assert quant.int8_takes_stream(M, K, N, x.dtype)
    c = quant.int8_matmul
    before = (c.launches, c.launches_tma, c.launches_gemv)
    y = quant.int8_matmul(x, q)
    again = quant.int8_matmul(x, q)
    assert (c.launches, c.launches_tma, c.launches_gemv) == (
        before[0] + 2, before[1], before[2] + 2)
    ref = quant.int8_matmul_plain(x.float(), q)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert torch.isfinite(y).all()
    assert (y.float() - ref).abs().max().item() <= \
        1e-2 * ref.abs().max().item()
    assert torch.equal(y, again)


def test_int8_stream_kernel_replays_in_a_graph_with_new_x(dev):
    """The plan depends on shapes only: one captured launch, replayed after
    x changes in place, equals an eager call on the new x bit for bit."""
    M, K, N = 4, 6144, 2048
    x, q = _int8_operands(dev, M, K, N, seed=6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.int8_matmul(x, q)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = quant.int8_matmul(x, q)
    g = torch.Generator(device=dev).manual_seed(7)
    for _ in range(3):
        x.copy_(torch.randn((M, K), generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, quant.int8_matmul(x, q))
        ref = quant.int8_matmul_plain(x.float(), q)
        assert (out.float() - ref).abs().max().item() <= \
            1e-2 * ref.abs().max().item()


# ------------------------------------------------------------- backward


def _bwd_inputs(dev, dtype, D, causal, q_offset, N=4, Nkv=2, pad="left"):
    g = torch.Generator(device=dev).manual_seed(3)
    B, Sq = 2, 100
    Skv = Sq + q_offset + (0 if causal else 13)
    q = torch.randn((B, Sq, N, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, Nkv, D), generator=g, device=dev).to(dtype)
    dout = torch.randn((B, Sq, N, D), generator=g, device=dev).to(dtype)
    mask = torch.ones((B, Skv), dtype=torch.int32, device=dev)
    if pad == "left":
        mask[1, :40] = 0
    else:
        mask[1, Skv - 30:] = 0
    # rows with a valid key; dO is zeroed on the others, as in the model
    if causal:
        seen = torch.cumsum(mask, 1)[:, q_offset:q_offset + Sq] > 0
    else:
        seen = (mask.sum(1, keepdim=True) > 0).expand(B, Sq)
    return q, k, v, dout * seen[:, :, None, None].to(dtype), dout, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal,q_offset,N,Nkv,pad", [
    (128, True, 0, 4, 2, "left"), (64, True, 0, 4, 4, "right"),
    (64, False, 0, 6, 2, "right"), (128, False, 0, 2, 2, "left"),
    (64, True, 37, 4, 2, "left")])
def test_flash_backward_kernels_match_plain(dev, dtype, D, causal, q_offset,
                                            N, Nkv, pad):
    """dQ and dK/dV against the plain recompute on the same tensors (P and
    dS rounded to the storage dtype on both sides): fp32 1e-4 of max|ref|,
    bf16 one rounding of the output (1e-2 of max|ref|)."""
    q, k, v, dout, noise, mask = _bwd_inputs(dev, dtype, D, causal, q_offset,
                                             N, Nkv, pad)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    delta = torch.einsum("bsnd,bsnd->bns", dout.float(), o.float()
                         ).contiguous()
    args = (q, k, v, mask, lse, delta, dout, causal, None, q_offset)
    n_dq, n_dkv = fa.flash_attention_dq.launches, \
        fa.flash_attention_dkv.launches
    dq = fa.flash_attention_dq(*args)
    dk, dv = fa.flash_attention_dkv(*args)
    assert fa.flash_attention_dq.launches == n_dq + 1
    assert fa.flash_attention_dkv.launches == n_dkv + 1
    ref = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert a.shape == r.shape and a.dtype == dtype
        assert torch.isfinite(a).all(), name
        tol = rel * r.float().abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol, name
    # random dO on every row, rows without a valid key included: finite
    nargs = (q, k, v, mask, lse, delta, noise, causal, None, q_offset)
    for t in (fa.flash_attention_dq(*nargs), *fa.flash_attention_dkv(*nargs)):
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("kind", ["left", "right", "hole", "empty"])
@pytest.mark.parametrize("causal,q_offset,Sq,strided_dout", [
    (True, 0, 300, False), (True, 37, 100, True), (True, 37, 16, False),
    (False, 0, 300, True), (False, 0, 100, False)])
def test_flash_bwd_tma_kernels_match_plain(dev, D, group, kind, causal,
                                           q_offset, Sq, strided_dout):
    """The TMA and wgmma dQ and dK/dV kernels (bf16, aligned) against the
    plain recompute on the same tensors: within 1e-2 of max|ref| (one bf16
    rounding of the output, and P and dS rounded to bf16 on both sides)
    plus 1e-4: where a row sees one key only ("hole" at q_offset 37), P = 1
    and dS = dP - delta is zero but for fp32 rounding, so dQ and dK are
    rounding noise of ~1e-6 on both sides. Sq and Skv are no multiples of
    the tiles; a strided dO is read in place. Keys the mask removes (a
    whole 128-key tile of them under "hole" and "empty") get dK = dV = 0
    exactly, a row without a valid key dQ = 0, and two runs give the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, Nkv = 2, 2
    N = Nkv * group
    Skv = Sq + q_offset + 13 if causal else 613
    q = torch.randn((B, Sq, N, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Skv, Nkv, D), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((B, Skv, Nkv, D), generator=g,
                    device=dev).to(torch.bfloat16)
    mask = _flash_mask(kind, B, Skv, dev)
    allowed = (mask != 0)[:, None, :].expand(B, Sq, Skv)
    if causal:
        pos = torch.arange(Sq, device=dev)[:, None] + q_offset
        allowed = allowed & (pos >= torch.arange(Skv, device=dev))
    rows = allowed.any(-1)                                   # [B, Sq]
    dout = torch.randn((B, Sq, N, D), generator=g, device=dev).to(
        torch.bfloat16)
    dout = dout * rows[:, :, None, None].to(dout.dtype)  # zero as in the model
    if strided_dout:  # the same values in the first half of wider rows
        wide = torch.zeros((B, Sq, N, 2 * D), dtype=dout.dtype, device=dev)
        wide[..., :D] = dout
        dout = wide[..., :D]
        assert not dout.is_contiguous()
    assert fa.bwd_takes_tma(q, k, v, dout)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    delta = torch.einsum("bsnd,bsnd->bns", dout.float(), o.float()
                         ).contiguous()
    args = (q, k, v, mask, lse, delta, dout, causal, None, q_offset)
    n_dq, n_dkv = (fa.flash_attention_dq.launches_tma,
                   fa.flash_attention_dkv.launches_tma)
    dq = fa.flash_attention_dq(*args)
    dk, dv = fa.flash_attention_dkv(*args)
    dq2 = fa.flash_attention_dq(*args)
    dk2, dv2 = fa.flash_attention_dkv(*args)
    assert fa.flash_attention_dq.launches_tma == n_dq + 2
    assert fa.flash_attention_dkv.launches_tma == n_dkv + 2
    ref = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and \
        torch.equal(dv, dv2)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all(), name
        tol = 1e-2 * r.float().abs().max().item() + 1e-4
        assert (a.float() - r.float()).abs().max().item() <= tol, name
    assert (dq[~rows] == 0).all()
    masked = mask == 0                                        # [B, Skv]
    if kind == "empty" or (kind == "hole" and Skv > 300):
        # some 128-key tile holds no valid key: nothing of it is loaded
        tiles = torch.zeros((B, -(-Skv // 128) * 128), dtype=torch.bool,
                            device=dev)
        tiles[:, :Skv] = ~masked
        assert not tiles.view(B, -1, 128).any(-1).all()
    assert (dk[masked] == 0).all() and (dv[masked] == 0).all()
    # random dO on every row, rows without a valid key included: finite
    noise = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    nargs = (q, k, v, mask, lse, delta, noise, causal, None, q_offset)
    for t in (fa.flash_attention_dq(*nargs), *fa.flash_attention_dkv(*nargs)):
        assert torch.isfinite(t).all()


def test_flash_backward_unaligned_bf16_views_match_plain(dev):
    """bf16 views whose rows are not 16-byte aligned take the SIMT kernels
    (aligned ones the TMA kernels): same answers."""
    q, k, v, dout, _, mask = _bwd_inputs(dev, torch.bfloat16, 64, True, 0)

    def shifted(x):  # the same values behind an odd element offset
        wide = torch.zeros((*x.shape[:3], x.shape[3] + 1), dtype=x.dtype,
                           device=dev)
        wide[..., 1:] = x
        return wide[..., 1:]

    o, lse = fa.flash_attention_fwd(q, k, v, mask, True, None, 0)
    delta = torch.einsum("bsnd,bsnd->bns", dout.float(), o.float()
                         ).contiguous()
    ref = fa.flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout, True,
                                       None, 0)
    args = (shifted(q), shifted(k), shifted(v), mask, lse, delta,
            shifted(dout), True, None, 0)
    assert not fa.bwd_takes_tma(*args[:3], args[6])
    n_dq, n_dkv = (fa.flash_attention_dq.launches_tma,
                   fa.flash_attention_dkv.launches_tma)
    got = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
    assert (fa.flash_attention_dq.launches_tma,
            fa.flash_attention_dkv.launches_tma) == (n_dq, n_dkv)
    for a, r in zip(got, ref):
        tol = 1e-2 * r.float().abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol


def test_flash_backward_reads_strided_dout(dev):
    """dO arrives from autograd with the strides the reshape before o_proj
    left; the kernels read it through its strides."""
    q, k, v, dout, _, mask = _bwd_inputs(dev, torch.bfloat16, 64, True, 0)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, True, None, 0)
    delta = torch.einsum("bsnd,bsnd->bns", dout.float(), o.float()
                         ).contiguous()
    wide = torch.zeros((*dout.shape[:3], 2 * dout.shape[3]),
                       dtype=dout.dtype, device=dev)
    wide[..., :64] = dout
    view = wide[..., :64]
    assert not view.is_contiguous()
    tma = fa.flash_attention_dq.launches_tma
    a = fa.flash_attention_dq(q, k, v, mask, lse, delta, view, True, None, 0)
    b = fa.flash_attention_dq(q, k, v, mask, lse, delta, dout, True, None, 0)
    assert torch.equal(a, b)
    assert fa.flash_attention_dq.launches_tma == tma + 2


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_function_matches_plain_backward(dev, causal):
    """The autograd function on the card against the same function on the
    CPU (plain forward, plain backward), fp32: 1e-4 of each gradient's
    max."""
    q, k, v, _, noise, mask = _bwd_inputs(dev, torch.float32, 64, causal, 0,
                                          pad="right")
    grads = []
    for device in ("cuda", "cpu"):
        qs = [t.to(device).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*qs, mask.to(device), causal)
        assert "FlashAttention" in type(out.grad_fn).__name__
        grads.append(torch.autograd.grad(
            (out * noise.to(device)).sum(), qs))
    for a, b in zip(*grads):
        tol = 1e-4 * b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 2048), (2, 37, 16, 128), (5, 1000),
                                   (1, 64)])
def test_rmsnorm_backward_kernel_matches_plain(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    gr = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)).to(dtype)
    before = rmsnorm_triton.rms_norm_bwd.launches
    dx, dw = rmsnorm_triton.rms_norm_bwd(x, w, gr, 1e-6, True)
    dx2, none = rmsnorm_triton.rms_norm_bwd(x, w, gr, 1e-6, False)
    assert rmsnorm_triton.rms_norm_bwd.launches == before + 2
    assert none is None and torch.equal(dx, dx2)
    rx, rw = rmsnorm_triton.rms_norm_bwd_plain(x.float(), w.float(),
                                               gr.float(), 1e-6)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert dx.dtype == dtype and dw.dtype == dtype
    assert ((dx.float() - rx).abs() <= rel * rx.abs() + 1e-5).all()
    dw_rel = 1e-5 if dtype == torch.float32 else 1e-2
    assert (dw.float() - rw).abs().max().item() <= \
        dw_rel * rw.abs().max().item() + 1e-5


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("shape", [(4096, 2048), (4, 1024, 16, 128),
                                   (4, 1024, 8, 128), (4, 1024, 32, 128),
                                   (4, 1024, 4, 128)])
def test_rmsnorm_backward_training_shapes_bit_equal(dev, shape, need_dw):
    """The backward at every training shape of both decoders (hidden rows;
    q and k norms of the 1.7B and the MoE decoder), with dw and without (a
    frozen norm: no partials, no second kernel): one launch counted, bf16
    dx within one rounding of the plain version, dw within 1e-2 of its max
    (a sum over up to 131,072 rows, rounded once to bf16), and a second
    run bit-equal (dw summed in a fixed order, no atomics)."""
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gr = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)).to(
        torch.bfloat16)
    before = rmsnorm_triton.rms_norm_bwd.launches
    dx, dw = rmsnorm_triton.rms_norm_bwd(x, w, gr, 1e-6, need_dw)
    dx2, dw2 = rmsnorm_triton.rms_norm_bwd(x, w, gr, 1e-6, need_dw)
    assert rmsnorm_triton.rms_norm_bwd.launches == before + 2
    rx, rw = rmsnorm_triton.rms_norm_bwd_plain(x.float(), w.float(),
                                               gr.float(), 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2)
    assert ((dx.float() - rx).abs() <= 2.0 ** -7 * rx.abs() + 1e-5).all()
    if not need_dw:
        assert dw is None and dw2 is None
        return
    assert dw.dtype == torch.bfloat16 and torch.equal(dw, dw2)
    assert (dw.float() - rw).abs().max().item() <= \
        1e-2 * rw.abs().max().item()


def test_rmsnorm_autograd_function_matches_plain_backward(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((3, 50, 256), generator=g, device=dev)
    w = 1 + 0.1 * torch.randn((256,), generator=g, device=dev)
    gr = torch.randn((3, 50, 256), generator=g, device=dev)
    grads = []
    for device in ("cuda", "cpu"):
        xs = x.to(device).requires_grad_(True)
        ws = w.to(device).requires_grad_(True)
        y = rmsnorm_triton.rms_norm(xs, ws, 1e-6)
        assert "RmsNorm" in type(y.grad_fn).__name__
        grads.append(torch.autograd.grad((y * gr.to(device)).sum(),
                                         (xs, ws)))
    for a, b in zip(*grads):
        assert (a.cpu() - b).abs().max().item() <= \
            1e-5 * max(1.0, b.abs().max().item())
    stacked = torch.ones((4, 256), device=dev)
    y = rmsnorm_triton.rms_norm(
        torch.randn((2, 4, 256), device=dev, requires_grad=True), stacked,
        1e-6)
    with pytest.raises(NotImplementedError):
        y.sum().backward()


def test_int8_autograd_function_gives_dx_only(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((70, 256), generator=g, device=dev, requires_grad=True)
    q = quant.quantize_int8(torch.randn((256, 128), generator=g,
                                        device=dev) * 0.05)
    gr = torch.randn((70, 128), generator=g, device=dev)
    before = quant.int8_matmul.launches
    y = quant.int8_matmul(x, q)
    assert quant.int8_matmul.launches == before + 1
    (dx,) = torch.autograd.grad((y * gr).sum(), (x,))
    ref = gr @ (q["w_q"].float() * q["scale"]).T
    assert (dx - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# ------------------------------------------------------------- paged decode


def _paged_inputs(dev, dtype, quant, B, Nq, Nkv, Dh, P, lens, seed=7):
    """q, shuffled page table, lengths and pools [Nkv, rows, P, Dh] (int8
    with per-row scales when ``quant``) with more rows than the slots use."""
    from molly_tpu_torch.models.qwen3 import quantize_page_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    pps = -(-max(max(lens), 1) // P)
    rows = B * pps + 7
    q = torch.randn((B, Nq, Dh), generator=g, device=dev).to(dtype)
    k = torch.randn((Nkv, rows, P, Dh), generator=g, device=dev)
    v = torch.randn((Nkv, rows, P, Dh), generator=g, device=dev)
    table = torch.randperm(rows - 1, generator=g, device=dev)[
        :B * pps].reshape(B, pps).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    if quant:
        k, ks = quantize_page_rows(k)
        v, vs = quantize_page_rows(v)
        scales = dict(k_scales=ks[..., 0].contiguous(),
                      v_scales=vs[..., 0].contiguous())
    else:
        k, v, scales = k.to(dtype), v.to(dtype), {}
    return q, k, v, lengths, table, scales


_SERVING_LENS = (1, 3136, 63, 64, 65, 1000, 2047, 0, 129, 2500, 31, 777)


@pytest.mark.parametrize("dtype,quant,B,Nq,Nkv,Dh,P,lens", [
    (torch.bfloat16, False, 12, 16, 8, 128, 64, _SERVING_LENS),
    (torch.bfloat16, True, 12, 16, 8, 128, 128, _SERVING_LENS),
    (torch.float32, False, 5, 4, 4, 64, 16, (1, 17, 100, 0, 333)),
    (torch.float32, True, 5, 4, 2, 64, 16, (1, 17, 100, 0, 333)),
    (torch.float32, False, 4, 8, 2, 128, 16, (5, 170, 401, 16)),
    (torch.bfloat16, True, 3, 8, 1, 64, 128, (5, 170, 400)),
    (torch.float32, False, 3, 4, 2, 128, 4, (5, 170, 401)),
])
def test_paged_kernel_matches_plain(dev, dtype, quant, B, Nq, Nkv, Dh, P,
                                    lens):
    """bf16, fp32 and int8 pages, head dims 64 and 128, groups 1 to 8, page
    sizes 4 to 128, lengths that end inside a page, a length-0 slot (a zero
    row). fp32 1e-4; bf16 one rounding of the output."""
    q, k, v, lengths, table, scales = _paged_inputs(dev, dtype, quant, B, Nq,
                                                    Nkv, Dh, P, lens)
    before = pa.paged_attention.launches
    tma0 = pa.paged_attention.launches_tma
    out = pa.paged_attention(q, k, v, lengths, table, **scales)
    assert pa.paged_attention.launches == before + 1
    # fp32 q or pages and int8 pages at Dh 64 stay on paged_attention.cu;
    # the rest goes to paged_attention_tma.cu
    assert pa.paged_attention.launches_tma == tma0 + int(
        dtype == torch.bfloat16 and (Dh == 128 or not quant))
    ref = pa.paged_attention_plain(
        q.float(), k if quant else k.float(), v if quant else v.float(),
        lengths, table, **scales)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref).abs().max().item() <= tol
    empty = lengths == 0
    assert (out[empty] == 0).all()


def test_paged_kernel_never_reads_past_a_length(dev):
    """Table entries past a slot's pages may name any row, and page rows
    past its length may hold anything: the result does not change."""
    q, k, v, lengths, table, _ = _paged_inputs(
        dev, torch.float32, False, 3, 4, 2, 64, 16, (20, 1, 40))
    base = pa.paged_attention(q, k, v, lengths, table)
    table2 = table.clone()
    table2[0, 2:] = 10 ** 6      # far outside the pool
    table2[1, 1:] = -1
    k2, v2 = k.clone(), v.clone()
    k2[:, table[0, 1].long(), 4:] = float("nan")  # rows 20.. of slot 0
    v2[:, table[0, 1].long(), 4:] = float("inf")
    got = pa.paged_attention(q, k2, v2, lengths, table2)
    torch.cuda.synchronize()
    assert torch.equal(got, base)


def test_paged_kernel_reads_strided_q(dev):
    """q arrives as a slice of the fused q-k projection: rows strided."""
    q, k, v, lengths, table, _ = _paged_inputs(
        dev, torch.bfloat16, False, 4, 4, 2, 128, 16, (20, 1, 40, 64))
    wide = torch.zeros((4, 6, 128), dtype=q.dtype, device=dev)
    wide[:, :4] = q
    view = wide[:, :4]
    assert not view.is_contiguous()
    assert torch.equal(pa.paged_attention(view, k, v, lengths, table),
                       pa.paged_attention(q, k, v, lengths, table))


def _split_lens(B, Nkv, P, lens_max=3136):
    """Lengths at every edge the TMA kernel has: 0, 1, a page -1, +0, +1,
    a split -1, +0, +1 (the plan of this shape), two splits, 3136."""
    pps = -(-lens_max // P)
    k, _ = pa.paged_split_plan(B, Nkv, pps, P,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    kp = k * P
    return (0, 1, P - 1, P, P + 1, kp - 1, kp, kp + 1, lens_max, 777,
            2 * kp + 3, 1500)[:B]


@pytest.mark.parametrize("quant,Dh,P", [
    (False, 128, 64), (False, 128, 128), (False, 64, 64), (False, 128, 16),
    (True, 128, 128), (True, 128, 64), (True, 128, 32)])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paged_tma_kernel_matches_plain(dev, quant, Dh, P, group):
    """The TMA route over bf16 and int8 pages at groups 1 to 8: lengths 0,
    1, a page and a split -1 / +0 / +1, 3136 (13 or more splits), against
    the plain version (one bf16 rounding of the output), a zero row for
    length 0, two runs bit-equal."""
    Nkv = 2
    lens = _split_lens(12, Nkv, P)
    q, k, v, lengths, table, scales = _paged_inputs(
        dev, torch.bfloat16, quant, 12, Nkv * group, Nkv, Dh, P, lens)
    assert pa.paged_takes_tma(q, k, v, **scales)
    tma0 = pa.paged_attention.launches_tma
    out = pa.paged_attention(q, k, v, lengths, table, **scales)
    assert pa.paged_attention.launches_tma == tma0 + 1
    again = pa.paged_attention(q, k, v, lengths, table, **scales)
    ref = pa.paged_attention_plain(q.float(), k if quant else k.float(),
                                   v if quant else v.float(), lengths, table,
                                   **scales)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (out[lengths == 0] == 0).all()


@pytest.mark.parametrize("quant", [False, True])
def test_paged_tma_kernel_one_split_and_moe_shape(dev, quant):
    """A table of one page a slot (the plan has one split: no merge
    kernel), and the MoE serving shape (8 slots, 32 q heads over 4 kv heads,
    Dh 128, the serving lengths)."""
    P = 128 if quant else 64
    for B, Nq, Nkv, lens in ((6, 8, 4, (1, 0, P - 1, P, 7, 33)),
                             (8, 32, 4, (3136, 2900, 2047, 1531, 1000, 640,
                                         65, 1))):
        q, k, v, lengths, table, scales = _paged_inputs(
            dev, torch.bfloat16, quant, B, Nq, Nkv, 128, P, lens)
        tma0 = pa.paged_attention.launches_tma
        out = pa.paged_attention(q, k, v, lengths, table, **scales)
        assert pa.paged_attention.launches_tma == tma0 + 1
        ref = pa.paged_attention_plain(
            q.float(), k if quant else k.float(), v if quant else v.float(),
            lengths, table, **scales)
        torch.cuda.synchronize()
        assert (out.float() - ref).abs().max().item() <= 2e-2
        assert (out[lengths == 0] == 0).all()
        assert torch.equal(out, pa.paged_attention(q, k, v, lengths, table,
                                                   **scales))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_tma_kernel_never_reads_past_a_length(dev, quant):
    """On the TMA route a whole page box is loaded, so rows past a length
    inside the last live page arrive with it: NaN in their K rows (int8:
    their K scales), inf in their V rows (int8: V scales), table entries past
    the live pages naming rows far outside the pool or -1. The result is
    bit-equal to the one over clean data."""
    P = 128 if quant else 64
    q, k, v, lengths, table, sc = _paged_inputs(
        dev, torch.bfloat16, quant, 3, 4, 2, 128, P, (P + 20, 1, 3 * P))
    base = pa.paged_attention(q, k, v, lengths, table, **sc)
    table2 = table.clone()
    table2[0, 2:] = 10 ** 6
    table2[1, 1:] = -1
    k2, v2 = k.clone(), v.clone()
    sc2 = {n: t.clone() for n, t in sc.items()}
    for b, n in ((0, P + 20), (1, 1)):
        row = table[b, n // P].long()
        if quant:
            sc2["k_scales"][:, row, n % P:] = float("nan")
            sc2["v_scales"][:, row, n % P:] = float("inf")
            k2[:, row, n % P:] = 127
            v2[:, row, n % P:] = -127
        else:
            k2[:, row, n % P:] = float("nan")
            v2[:, row, n % P:] = float("inf")
    tma0 = pa.paged_attention.launches_tma
    got = pa.paged_attention(q, k2, v2, lengths, table2, **sc2)
    assert pa.paged_attention.launches_tma == tma0 + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, base)


def test_paged_tma_kernel_reads_strided_q(dev):
    """q as a slice of a wider projection, rows strided, on the TMA route."""
    q, k, v, lengths, table, _ = _paged_inputs(
        dev, torch.bfloat16, False, 4, 8, 2, 128, 64, (200, 1, 640, 64))
    wide = torch.zeros((4, 12, 128), dtype=q.dtype, device=dev)
    wide[:, :8] = q
    view = wide[:, :8]
    assert not view.is_contiguous() and pa.paged_takes_tma(view, k, v)
    assert torch.equal(pa.paged_attention(view, k, v, lengths, table),
                       pa.paged_attention(q, k, v, lengths, table))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_tma_kernel_replays_in_a_graph_with_new_lengths(dev, quant):
    """The split plan depends on shapes only, so a captured launch replays
    after the lengths and the page table change in place on the device, and
    equals an eager call on the new data."""
    P = 128 if quant else 64
    q, k, v, lengths, table, sc = _paged_inputs(
        dev, torch.bfloat16, quant, 8, 16, 8, 128, P,
        (3136, 2900, 2047, 1531, 1000, 640, 65, 1))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(q, k, v, lengths, table, **sc)  # warm-up
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = pa.paged_attention(q, k, v, lengths, table, **sc)
    lengths.copy_(torch.tensor((5, 0, 3000, 129, 128, 2047, 1, 700),
                               dtype=torch.int32, device=dev))
    table.copy_(table.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    eager = pa.paged_attention(q, k, v, lengths, table, **sc)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert (out[1] == 0).all()


def test_paged_kernel_refuses_what_it_does_not_take(dev):
    q, k, v, lengths, table, sc = _paged_inputs(
        dev, torch.float32, True, 2, 4, 2, 64, 16, (5, 9))
    with pytest.raises(ValueError, match="scales"):
        pa.paged_attention(q, k, v, lengths, table)  # int8 without scales
    with pytest.raises(ValueError):  # head dim 32
        pa.paged_attention(q[..., :32].contiguous(),
                           k[..., :32].contiguous(),
                           v[..., :32].contiguous(), lengths, table, **sc)
    with pytest.raises(TypeError):  # bf16 q over fp32 pages
        pa.paged_attention(q.bfloat16(), k.float(), v.float(), lengths,
                           table)
    with pytest.raises(ValueError):  # 3 q heads a kv head
        pa.paged_attention(torch.zeros((2, 6, 64), device=dev), k.float(),
                           v.float(), lengths, table)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, k.float().transpose(1, 2).contiguous()
                           .transpose(1, 2)[:, :, :, :], v.float(), lengths,
                           table)


# ------------------------------------------------------------ grouped GEMMs

_GG_SIZES = {
    # an empty group, a one-row group, a group larger than one tile, and
    # rows past the last group (M = 300 > 271)
    "ragged": (300, [100, 0, 1, 170]),
    "decode": (32, [0, 3, 0, 0, 1, 0, 9, 0, 0, 0, 2, 0, 0, 0, 0, 1,
                    0, 0, 4, 0, 0, 0, 0, 0, 0, 6, 0, 0, 0, 0, 5, 1]),
}


def _gg_tol(ref, *dtypes):
    """fp32 throughout: 1e-4 relative (another summation order); anything in
    bf16: 1e-2 of the reference's max-abs (operands or result rounded to
    bf16)."""
    rel = 1e-4 if all(d == torch.float32 for d in dtypes) else 1e-2
    return rel * max(ref.abs().max().item(), 1e-6)


@pytest.mark.parametrize("sizes", sorted(_GG_SIZES))
@pytest.mark.parametrize("K,N", [(64, 128), (136, 72), (50, 9), (8, 64)])
@pytest.mark.parametrize("lhs_dt,rhs_dt,out_dt", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8, torch.float32),
    (torch.float32, torch.int8, torch.float32),
    (torch.float32, torch.int8, torch.bfloat16)])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_grouped_gemm_kernel_matches_plain(dev, sizes, K, N, lhs_dt, rhs_dt,
                                           out_dt, transpose_rhs):
    M, counts = _GG_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(5)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(lhs_dt)
    shape = (G, N, K) if transpose_rhs else (G, K, N)
    scale = None
    if rhs_dt == torch.int8:
        rhs = torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8)
        if not transpose_rhs:
            scale = torch.rand((G, N), generator=g, device=dev) * 1e-2 + 1e-3
    else:
        rhs = torch.randn(shape, generator=g, device=dev).to(rhs_dt)
    before = (gg.grouped_gemm.launches, gg.grouped_gemm.launches_int8)
    out = gg.grouped_gemm(lhs, rhs, gs, transpose_rhs=transpose_rhs,
                          out_dtype=out_dt, scale=scale)
    assert gg.grouped_gemm.launches == before[0] + 1
    assert gg.grouped_gemm.launches_int8 == before[1] + (rhs_dt == torch.int8)
    ref = gg.grouped_gemm_plain(lhs, rhs, gs, transpose_rhs=transpose_rhs,
                                scale=scale)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (M, N)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= _gg_tol(
        ref, lhs_dt, rhs_dt if rhs_dt != torch.int8 else torch.float32,
        out_dt)
    assert bool((out[sum(counts):] == 0).all())   # rows no group owns


@pytest.mark.parametrize("sizes", sorted(_GG_SIZES))
@pytest.mark.parametrize("K,N", [(64, 128), (136, 72), (50, 9), (8, 200)])
@pytest.mark.parametrize("lhs_dt,dout_dt,out_dt", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16)])
def test_grouped_gemm_tgmm_kernel_matches_plain(dev, sizes, K, N, lhs_dt,
                                                dout_dt, out_dt):
    M, counts = _GG_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(6)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(lhs_dt)
    dout = torch.randn((M, N), generator=g, device=dev).to(dout_dt)
    before = gg.grouped_gemm_tgmm.launches
    out = gg.grouped_gemm_tgmm(lhs, dout, gs, out_dt)
    assert gg.grouped_gemm_tgmm.launches == before + 1
    again = gg.grouped_gemm_tgmm(lhs, dout, gs, out_dt)
    ref = gg.grouped_gemm_tgmm_plain(lhs, dout, gs, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (G, K, N)
    assert (out.float() - ref).abs().max().item() <= _gg_tol(
        ref, lhs_dt, dout_dt, out_dt)
    assert torch.equal(out, again)                 # no atomics: same bits
    for e, n in enumerate(counts):                 # empty group: exact zeros
        if n == 0:
            assert bool((out[e] == 0).all())


# The TMA and wgmma kernels (csrc/grouped_gemm_tma.cu): an empty first and
# last group, a one-row group, a group of several tiles, one row more than a
# tile, rows past the last group, M not a multiple of 128.
_MANY = [(37 * i) % 129 for i in range(300)]   # 300 groups of 0 .. 128 rows
_TMA_SIZES = {
    "ragged": (517, [1, 0, 300, 64, 129, 0]),           # 494 rows owned
    "empty_ends": (700, [0, 128, 5, 0, 200, 256, 111, 0]),   # all owned
    # more groups than blocks: several tiles of different groups a block
    "many_groups": (max(sum(_MANY), 64 * len(_MANY)) + 5, _MANY),
}
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("sizes", sorted(_TMA_SIZES))
@pytest.mark.parametrize("K,N", [(64, 64), (128, 768), (768, 128), (64, 72)])
@pytest.mark.parametrize("lhs_dt,out_dt", [(_BF16, _F32), (_BF16, _BF16),
                                           (_F32, _BF16)])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_grouped_gemm_tma_kernel_matches_plain(dev, sizes, K, N, lhs_dt,
                                               out_dt, transpose_rhs):
    """The forward at many rows a group: the launch goes to the TMA and
    wgmma kernel, agrees with the plain version over the operands as bf16
    (an fp32 lhs is rounded once before the launch), writes zeros past the
    last group and the same bits on a second run."""
    M, counts = _TMA_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(15)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(lhs_dt)
    shape = (G, N, K) if transpose_rhs else (G, K, N)
    rhs = (torch.randn(shape, generator=g, device=dev) * K ** -0.5).to(_BF16)
    assert gg.takes_tma(M, K, N, G, rhs.dtype, False)
    before = (gg.grouped_gemm.launches, gg.grouped_gemm.launches_tma)
    out = gg.grouped_gemm(lhs, rhs, gs, transpose_rhs=transpose_rhs,
                          out_dtype=out_dt)
    again = gg.grouped_gemm(lhs, rhs, gs, transpose_rhs=transpose_rhs,
                            out_dtype=out_dt)
    assert gg.grouped_gemm.launches == before[0] + 2
    assert gg.grouped_gemm.launches_tma == before[1] + 2
    ref = gg.grouped_gemm_plain(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (M, N)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= _gg_tol(ref, _BF16)
    assert bool((out[sum(counts):] == 0).all())
    assert torch.equal(out, again)


@pytest.mark.parametrize("sizes", sorted(_TMA_SIZES))
@pytest.mark.parametrize("K,N", [(64, 64), (128, 768), (768, 128), (72, 8)])
@pytest.mark.parametrize("lhs_dt,dout_dt,out_dt", [
    (_BF16, _BF16, _BF16), (_BF16, _F32, _BF16), (_BF16, _BF16, _F32),
    (_F32, _BF16, _BF16)])
def test_grouped_gemm_tgmm_tma_kernel_matches_plain(dev, sizes, K, N, lhs_dt,
                                                    dout_dt, out_dt):
    """tgmm in bf16: the launch goes to the TMA and wgmma kernel; parity
    with the plain version, exact zeros for every empty group, two runs
    bit-equal (one block a tile, rows in order, no atomics)."""
    M, counts = _TMA_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(16)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(lhs_dt)
    dout = torch.randn((M, N), generator=g, device=dev).to(dout_dt)
    before = (gg.grouped_gemm_tgmm.launches, gg.grouped_gemm_tgmm.launches_tma)
    out = gg.grouped_gemm_tgmm(lhs, dout, gs, out_dt)
    again = gg.grouped_gemm_tgmm(lhs, dout, gs, out_dt)
    assert gg.grouped_gemm_tgmm.launches == before[0] + 2
    assert gg.grouped_gemm_tgmm.launches_tma == before[1] + 2
    ref = gg.grouped_gemm_tgmm_plain(lhs, dout, gs, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (G, K, N)
    assert (out.float() - ref).abs().max().item() <= _gg_tol(ref, _BF16)
    assert torch.equal(out, again)
    for e, n in enumerate(counts):
        if n == 0:
            assert bool((out[e] == 0).all())


def _stream_sizes(kind, M, G):
    """[G] sizes for M rows: ``one``: every row but one in group G // 2;
    ``spread``: rows dealt round-robin over min(M, G) groups, one row past
    the sum (none for M = 1); ``shifted``: the same over other groups, the
    first of them empty."""
    tail = 1 if M > 1 else 0
    sizes = [0] * G
    if kind == "one":
        sizes[G // 2] = M - tail
    else:
        first = 1 if kind == "shifted" else 0
        groups = list(range(first, G))[:max(1, min(M - tail, G - first))]
        for r in range(M - tail):
            sizes[groups[r % len(groups)]] += 1
    return sizes


def _stream_operands(dev, M, K, N, G, int8, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lhs = torch.randn((M, K), generator=g, device=dev).to(_BF16)
    if int8:
        rhs = torch.randint(-127, 128, (G, K, N), generator=g, device=dev,
                            dtype=torch.int8)
        scale = (torch.rand((G, N), generator=g, device=dev) * 1e-2 + 1e-3
                 ) * K ** -0.5
    else:
        rhs = (torch.randn((G, K, N), generator=g, device=dev)
               * K ** -0.5).to(_BF16)
        scale = None
    return lhs, rhs, scale


@pytest.mark.parametrize("M", [1, 4, 32, 63, 64])
@pytest.mark.parametrize("kind", ["one", "spread"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("out_dt", [_F32, _BF16])
@pytest.mark.parametrize("G,K,N", [(16, 256, 272), (128, 2048, 768)])
def test_grouped_gemm_stream_kernel_matches_plain(dev, M, kind, int8, out_dt,
                                                  G, K, N):
    """Decode and serving shapes (M < 64 G, a bf16 lhs over bf16 or int8
    experts) run on the split weight stream: one group holding every row or
    all of them spread, a column tile past N's last 128, NaN in the row past
    the sum without effect on any output (that row comes out 0), parity with
    the plain version and the same bits on a second run."""
    lhs, rhs, scale = _stream_operands(dev, M, K, N, G, int8, seed=18)
    sizes = _stream_sizes(kind, M, G)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    owned = sum(sizes)
    lhs[owned:] = float("nan")
    assert gg.takes_stream(M, K, N, G, lhs.dtype, rhs.dtype, int8)
    before = (gg.grouped_gemm.launches, gg.grouped_gemm.launches_stream)
    out = gg.grouped_gemm(lhs, rhs, gs, out_dtype=out_dt, scale=scale)
    again = gg.grouped_gemm(lhs, rhs, gs, out_dtype=out_dt, scale=scale)
    assert (gg.grouped_gemm.launches,
            gg.grouped_gemm.launches_stream) == (before[0] + 2, before[1] + 2)
    ref = gg.grouped_gemm_plain(lhs, rhs, gs, scale=scale)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (M, N)
    assert torch.isfinite(out).all()
    assert bool((out[owned:] == 0).all())
    assert (out.float() - ref).abs().max().item() <= _gg_tol(ref, _BF16)
    assert torch.equal(out, again)


@pytest.mark.parametrize("int8", [False, True])
def test_grouped_gemm_stream_kernel_replays_with_new_group_sizes(dev, int8):
    """The plan depends on shapes only: one captured launch, replayed after
    the group sizes change in place (other active groups with one empty,
    then every row in one group, then no row in any group), equals an eager
    call on the new sizes bit for bit."""
    M, K, N, G = 32, 512, 384, 128
    lhs, rhs, scale = _stream_operands(dev, M, K, N, G, int8, seed=19)
    gs = torch.tensor(_stream_sizes("spread", M, G), dtype=torch.int32,
                      device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gg.grouped_gemm(lhs, rhs, gs, scale=scale)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = gg.grouped_gemm(lhs, rhs, gs, scale=scale)
    for sizes in (_stream_sizes("shifted", M, G), _stream_sizes("one", M, G),
                  [0] * G):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        eager = gg.grouped_gemm(lhs, rhs, gs, scale=scale)
        assert torch.equal(out, eager)
        ref = gg.grouped_gemm_plain(lhs, rhs, gs, scale=scale)
        assert (out - ref).abs().max().item() <= _gg_tol(ref, _BF16)
    assert bool((out == 0).all())   # the last sizes own no row


def _route_counts():
    c = gg.grouped_gemm
    return (c.launches, c.launches_tma, c.launches_stream,
            c.launches_int8_tma, c.launches_tc)


@pytest.mark.parametrize("case", [
    "k_not_a_multiple_of_64", "int8_k_not_a_multiple_of_64",
    "int8_all_fp32", "int8_n_not_a_multiple_of_16", "few_rows_transposed",
    "few_rows_int8_transposed", "fp32_forward", "fp32_transposed_few_rows",
    "fp32_transposed_k_not_of_32", "tgmm_k_not_of_8", "tgmm_all_fp32"])
def test_grouped_gemm_falls_to_the_mma_sync_kernels(dev, case):
    """What the TMA, int8 TMA, fp32 tensor-core and stream kernels do not
    take still launches (on the mma.sync or SIMT kernels of
    grouped_gemm.cu: no other route's counter moves) and still agrees with
    the plain version."""
    M, counts = _TMA_SIZES["ragged"]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(17)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    fwd0 = _route_counts()
    tg0 = (gg.grouped_gemm_tgmm.launches, gg.grouped_gemm_tgmm.launches_tma)
    if case.startswith("tgmm"):
        K, dt = (68, _BF16) if case == "tgmm_k_not_of_8" else (64, _F32)
        lhs = torch.randn((M, K), generator=g, device=dev).to(dt)
        dout = torch.randn((M, 128), generator=g, device=dev).to(dt)
        out = gg.grouped_gemm_tgmm(lhs, dout, gs, dt)
        ref = gg.grouped_gemm_tgmm_plain(lhs, dout, gs, torch.float32)
        assert gg.grouped_gemm_tgmm.launches == tg0[0] + 1
        assert gg.grouped_gemm_tgmm.launches_tma == tg0[1]
        tol = _gg_tol(ref, dt)
    else:
        K, N = {"k_not_a_multiple_of_64": (96, 128),
                "int8_k_not_a_multiple_of_64": (96, 128),
                "int8_n_not_a_multiple_of_16": (64, 72),
                "fp32_transposed_k_not_of_32": (48, 128)}.get(case, (64, 128))
        trans = "transposed" in case
        int8 = case.startswith(("int8", "few_rows_int8"))
        lhs_dt = _F32 if case.startswith(("int8_all", "fp32")) else _BF16
        rhs_dt = torch.int8 if int8 else (
            _F32 if case.startswith("fp32") else _BF16)
        if case.startswith("few_rows") or case == "fp32_transposed_few_rows":
            M, gs = 40, torch.tensor([3, 0, 20, 9, 7, 0], dtype=torch.int32,
                                     device=dev)
        lhs = torch.randn((M, K), generator=g, device=dev).to(lhs_dt)
        shape = (G, N, K) if trans else (G, K, N)
        scale = None
        if int8:
            rhs = torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8)
            if not trans:
                scale = torch.rand((G, N), generator=g, device=dev) * 1e-2 \
                    + 1e-3
        else:
            rhs = torch.randn(shape, generator=g, device=dev).to(rhs_dt)
        out = gg.grouped_gemm(lhs, rhs, gs, scale=scale, transpose_rhs=trans)
        ref = gg.grouped_gemm_plain(lhs, rhs, gs, scale=scale,
                                    transpose_rhs=trans)
        assert _route_counts() == (fwd0[0] + 1,) + fwd0[1:]
        tol = _gg_tol(ref, lhs_dt, _F32 if int8 else rhs_dt)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() <= tol


def _nan_past_the_sum(lhs, counts):
    """NaN in the rows no group owns: they must not reach any output."""
    owned = sum(counts)
    lhs[owned:] = float("nan")
    return owned


@pytest.mark.parametrize("sizes", sorted(_TMA_SIZES))
@pytest.mark.parametrize("K,N", [(64, 16), (128, 272), (768, 128),
                                 (2048, 768)])
@pytest.mark.parametrize("out_dt", [_F32, _BF16])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_grouped_gemm_int8_tma_kernel_matches_plain(dev, sizes, K, N, out_dt,
                                                    transpose_rhs):
    """int8 experts at many rows a group (csrc/grouped_gemm_int8_tma.cu):
    the forward with its scale, and the transposed product (the lhs
    gradient); N at the route's edge (16) and past a 256-column tile; NaN in
    the rows past the sum reaches no output (those rows come out 0); parity
    with the plain version over the bf16 lhs, the same bits on a second
    run."""
    M, counts = _TMA_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(21)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(_BF16)
    owned = _nan_past_the_sum(lhs, counts)
    shape = (G, N, K) if transpose_rhs else (G, K, N)
    rhs = torch.randint(-127, 128, shape, generator=g, device=dev,
                        dtype=torch.int8)
    scale = None if transpose_rhs else (
        torch.rand((G, N), generator=g, device=dev) * 1e-2 + 1e-3) * K ** -0.5
    kw = dict(transpose_rhs=transpose_rhs, out_dtype=out_dt, scale=scale)
    assert gg.int8_takes_tma(M, K, N, G, _BF16, out_dt, scale is not None,
                             transpose_rhs)
    before = _route_counts()
    out = gg.grouped_gemm(lhs, rhs, gs, **kw)
    again = gg.grouped_gemm(lhs, rhs, gs, **kw)
    after = _route_counts()
    assert (after[0] - before[0], after[3] - before[3]) == (2, 2)
    ref = gg.grouped_gemm_plain(lhs[:owned], rhs, gs,
                                transpose_rhs=transpose_rhs, scale=scale)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and out.shape == (M, N)
    assert torch.isfinite(out).all()
    assert bool((out[owned:] == 0).all())
    assert (out[:owned].float() - ref).abs().max().item() <= _gg_tol(
        ref, _BF16)
    assert torch.equal(out, again)


@pytest.mark.parametrize("sizes", sorted(_TMA_SIZES))
@pytest.mark.parametrize("K,N", [(64, 64), (64, 8), (128, 136), (2048, 64),
                                 (64, 768)])
def test_grouped_gemm_f32_tc_forward_matches_plain(dev, sizes, K, N):
    """The adapters' forward (csrc/grouped_gemm_f32_tc.cu): a bf16 lhs over
    fp32 weights into fp32, held to the fp32 tolerance (the weights split
    into three bf16 parts); one m64 tile (N <= 64) or 128-column tiles, a
    column tile past N; NaN past the sum reaches no output; two runs
    bit-equal."""
    M, counts = _TMA_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(22)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(_BF16)
    owned = _nan_past_the_sum(lhs, counts)
    rhs = torch.randn((G, K, N), generator=g, device=dev) * K ** -0.5
    assert gg.f32_takes_tc(M, K, N, G, _BF16, _F32, _F32, False)
    before = _route_counts()
    out = gg.grouped_gemm(lhs, rhs, gs)
    again = gg.grouped_gemm(lhs, rhs, gs)
    after = _route_counts()
    assert (after[0] - before[0], after[4] - before[4]) == (2, 2)
    ref = gg.grouped_gemm_plain(lhs[:owned], rhs, gs)
    torch.cuda.synchronize()
    assert out.dtype == _F32 and torch.isfinite(out).all()
    assert bool((out[owned:] == 0).all())
    assert (out[:owned] - ref).abs().max().item() <= _gg_tol(ref, _F32)
    assert torch.equal(out, again)


@pytest.mark.parametrize("sizes", sorted(_TMA_SIZES))
@pytest.mark.parametrize("K,N", [(64, 64), (32, 8), (768, 64), (64, 2048),
                                 (96, 200)])
@pytest.mark.parametrize("out_dt", [_F32, _BF16])
def test_grouped_gemm_f32_tc_transposed_matches_plain(dev, sizes, K, N,
                                                      out_dt):
    """The adapters' lhs gradient (csrc/grouped_gemm_f32_tc.cu): fp32 lhs
    against fp32 weights transposed, three TF32 products held to the fp32
    tolerance (bf16 out: one rounding); 64-column tiles (N <= 64) or 128,
    K at the 32-element stage's edge; NaN past the sum reaches no output;
    two runs bit-equal."""
    M, counts = _TMA_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(23)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev)
    owned = _nan_past_the_sum(lhs, counts)
    rhs = torch.randn((G, N, K), generator=g, device=dev) * K ** -0.5
    assert gg.f32_takes_tc(M, K, N, G, _F32, _F32, out_dt, False, True)
    before = _route_counts()
    out = gg.grouped_gemm(lhs, rhs, gs, transpose_rhs=True, out_dtype=out_dt)
    again = gg.grouped_gemm(lhs, rhs, gs, transpose_rhs=True,
                            out_dtype=out_dt)
    after = _route_counts()
    assert (after[0] - before[0], after[4] - before[4]) == (2, 2)
    ref = gg.grouped_gemm_plain(lhs[:owned], rhs, gs, transpose_rhs=True)
    torch.cuda.synchronize()
    assert out.dtype == out_dt and torch.isfinite(out).all()
    assert bool((out[owned:] == 0).all())
    assert (out[:owned].float() - ref).abs().max().item() <= _gg_tol(
        ref, out_dt)
    assert torch.equal(out, again)


# the tensor-core weight gradient's sizes: the TMA kernels' (an empty first
# and last group, a one-row group, rows past the sum, 300 groups) and one
# group more than four times the mean of the others
_TGMM_TC_SIZES = dict(_TMA_SIZES,
                      skewed=(1100, [700, 0, 50, 64, 100, 1, 130, 40]))


def _tgmm_tc_count():
    c = gg.grouped_gemm_tgmm
    return c.launches, c.launches_tc, c.launches_tma


@pytest.mark.parametrize("sizes", sorted(_TGMM_TC_SIZES))
@pytest.mark.parametrize("K,N", [(2048, 64), (768, 64), (64, 768),
                                 (64, 2048), (72, 200), (264, 8)])
def test_grouped_gemm_tgmm_tc_matches_plain(dev, sizes, K, N):
    """The adapters' weight gradient (csrc/grouped_gemm_f32_tc.cu): a bf16
    lhs and an fp32 dout into fp32, held to the fp32 tolerance (dout split
    into three bf16 parts) at both tile plans (256 lhs columns against a
    rank-64 dout, 64 against 128 dout columns), tiles past K and
    N, group ends inside a 64-row stage; NaN in the rows no group owns (of
    both operands) reaches no output; every empty group exact zeros; two
    runs bit-equal."""
    M, counts = _TGMM_TC_SIZES[sizes]
    G = len(counts)
    g = torch.Generator(device=dev).manual_seed(27)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(_BF16)
    dout = torch.randn((M, N), generator=g, device=dev)
    owned = _nan_past_the_sum(lhs, counts)
    _nan_past_the_sum(dout, counts)
    assert gg.tgmm_takes_tc(M, K, N, G, (_BF16, _F32, _F32))
    before = _tgmm_tc_count()
    out = gg.grouped_gemm_tgmm(lhs, dout, gs, _F32)
    again = gg.grouped_gemm_tgmm(lhs, dout, gs, _F32)
    after = _tgmm_tc_count()
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (2, 2, 0)
    ref = gg.grouped_gemm_tgmm_plain(lhs[:owned], dout[:owned], gs, _F32)
    torch.cuda.synchronize()
    assert out.dtype == _F32 and out.shape == (G, K, N)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _gg_tol(ref, _F32)
    assert torch.equal(out, again)
    for e, n in enumerate(counts):
        if n == 0:
            assert bool((out[e] == 0).all())


@pytest.mark.parametrize("K,N", [(128, 64), (64, 256)])
def test_grouped_gemm_tgmm_tc_replays_with_new_group_sizes(dev, K, N):
    """The tensor-core weight gradient reads the group sizes on the device
    only and allocates nothing: one captured launch, replayed after the
    sizes change in place (one group empty, every row in one group, no row
    owned), equals an eager call on the new sizes bit for bit."""
    M, G = 1024, 8
    g = torch.Generator(device=dev).manual_seed(28)
    lhs = torch.randn((M, K), generator=g, device=dev).to(_BF16)
    dout = torch.randn((M, N), generator=g, device=dev)
    gs = torch.full((G,), M // G, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gg.grouped_gemm_tgmm(lhs, dout, gs, _F32)
    side.synchronize()
    before = _tgmm_tc_count()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = gg.grouped_gemm_tgmm(lhs, dout, gs, _F32)
    assert _tgmm_tc_count()[1] == before[1] + 1
    one = [0] * G
    one[G - 1] = M - 7
    for sizes in ([0] + [M // (G - 1)] * (G - 1), one, [0] * G):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gg.grouped_gemm_tgmm(lhs, dout, gs, _F32))
    assert bool((out == 0).all())   # the last sizes own no row


@pytest.mark.parametrize("case", ["int8", "int8_transposed", "f32",
                                  "f32_transposed"])
def test_grouped_gemm_new_kernels_replay_with_new_group_sizes(dev, case):
    """Both kernels read the group sizes on the device only: one captured
    launch, replayed after the sizes change in place (one group empty,
    then every row in one group, then no row owned), equals an eager call
    on the new sizes bit for bit."""
    M, G, K, N = 1024, 8, 128, 128
    g = torch.Generator(device=dev).manual_seed(24)
    trans = case.endswith("transposed")
    lhs = torch.randn((M, K), generator=g, device=dev)
    kw = dict(transpose_rhs=trans)
    shape = (G, N, K) if trans else (G, K, N)
    if case.startswith("int8"):
        lhs = lhs.to(_BF16)
        rhs = torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8)
        if not trans:
            kw["scale"] = torch.rand((G, N), generator=g, device=dev) * 1e-3
    else:
        lhs = lhs if trans else lhs.to(_BF16)
        rhs = torch.randn(shape, generator=g, device=dev) * K ** -0.5
    gs = torch.full((G,), M // G, dtype=torch.int32, device=dev)
    counters = _route_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gg.grouped_gemm(lhs, rhs, gs, **kw)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = gg.grouped_gemm(lhs, rhs, gs, **kw)
    moved = _route_counts()
    assert moved[3 if case.startswith("int8") else 4] == \
        counters[3 if case.startswith("int8") else 4] + 2
    one = [0] * G
    one[G - 1] = M - 7
    for sizes in ([0] + [M // (G - 1)] * (G - 1), one, [0] * G):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gg.grouped_gemm(lhs, rhs, gs, **kw))
    assert bool((out == 0).all())   # the last sizes own no row


def test_grouped_gemm_autograd_runs_the_three_kernels(dev):
    """Gradients of a bf16 product through the transposed kernel and tgmm
    against the plain versions; a frozen rhs launches no tgmm; an int8 rhs
    folds its scale into dout before the transposed kernel."""
    M, counts = _GG_SIZES["ragged"]
    K, N, G = 64, 128, len(counts)
    g = torch.Generator(device=dev).manual_seed(7)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    lhs = torch.randn((M, K), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    rhs = (0.1 * torch.randn((G, K, N), generator=g, device=dev)).to(
        torch.bfloat16).requires_grad_(True)
    dout = torch.randn((M, N), generator=g, device=dev)
    out = gg.grouped_gemm(lhs, rhs, gs)
    assert out.dtype == torch.float32
    t0 = gg.grouped_gemm_tgmm.launches
    dl, dr = torch.autograd.grad(out, (lhs, rhs), dout)
    assert gg.grouped_gemm_tgmm.launches == t0 + 1
    assert dl.dtype == torch.bfloat16 and dr.dtype == torch.bfloat16
    rl = gg.grouped_gemm_plain(dout, rhs.detach(), gs, transpose_rhs=True)
    rr = gg.grouped_gemm_tgmm_plain(lhs.detach(), dout, gs, torch.float32)
    assert (dl.float() - rl).abs().max().item() <= _gg_tol(rl, torch.bfloat16)
    assert (dr.float() - rr).abs().max().item() <= _gg_tol(rr, torch.bfloat16)
    assert bool((dr[1] == 0).all())

    frozen = rhs.detach()
    tma0 = gg.grouped_gemm.launches_tma
    out = gg.grouped_gemm(lhs, frozen, gs)
    (dl2,) = torch.autograd.grad(out, (lhs,), dout)
    assert gg.grouped_gemm_tgmm.launches == t0 + 1
    assert torch.equal(dl2, dl)
    # 300 rows over 4 groups of bf16: the forward and the lhs gradient (its
    # fp32 dout rounded to bf16 once) both ran on the TMA and wgmma kernel
    assert gg.grouped_gemm.launches_tma == tma0 + 2

    w_q = torch.randint(-127, 128, (G, K, N), generator=g, device=dev,
                        dtype=torch.int8)
    scale = torch.rand((G, N), generator=g, device=dev) * 1e-2 + 1e-3
    out = gg.grouped_gemm(lhs, w_q, gs, scale=scale)
    (dl3,) = torch.autograd.grad(out, (lhs,), dout)
    dense = (w_q.float() * scale[:, None, :])
    r3 = gg.grouped_gemm_plain(dout, dense, gs, transpose_rhs=True)
    assert (dl3.float() - r3).abs().max().item() <= _gg_tol(r3, torch.bfloat16)


# The expert-parallel MoE's capacity buffer (ops.moe.moe_mlp_expert_sharded):
# C rows a rank, of which only sum(sizes) are live, over its local experts,
# some of them empty. route -> (lhs dtype, rhs dtype, C, sizes, K, N, the
# forward's counter index in _route_counts or None for the SIMT kernel)
_CAPACITY = {
    "bf16_tma": (_BF16, _BF16, 512, [300, 0, 150, 0], 128, 256, 1),
    "bf16_stream": (_BF16, _BF16, 32, [5, 0, 3, 0, 0, 9, 0, 0], 128, 256, 2),
    "int8_tma": (_BF16, torch.int8, 512, [300, 0, 150, 0], 128, 256, 3),
    "f32_tc": (_BF16, _F32, 512, [300, 0, 150, 0], 128, 64, 4),
    "simt": (_F32, _F32, 40, [10, 0, 7, 0], 50, 9, None),
}


@pytest.mark.parametrize("route", sorted(_CAPACITY))
def test_grouped_gemm_over_a_capacity_buffer_on_every_route(dev, route):
    """The forward, the transposed product (the lhs gradient) and tgmm (the
    weight gradient; not for a frozen int8 rhs) over a buffer whose rows
    past sum(sizes) hold garbage of 1e3: those rows come out exactly zero,
    an empty expert's weight gradient is exactly zero, and every live row
    equals the plain version."""
    lhs_dt, rhs_dt, C, counts, K, N, counter = _CAPACITY[route]
    G, live = len(counts), sum(counts)
    g = torch.Generator(device=dev).manual_seed(41)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)

    def buffer(cols, dt):
        x = torch.randn((C, cols), generator=g, device=dev)
        x[live:] = 1e3 * torch.randn((C - live, cols), generator=g,
                                     device=dev)
        return x.to(dt)

    lhs = buffer(K, lhs_dt)
    scale = None
    if rhs_dt == torch.int8:
        rhs = torch.randint(-127, 128, (G, K, N), generator=g, device=dev,
                            dtype=torch.int8)
        scale = torch.rand((G, N), generator=g, device=dev) * 1e-2 + 1e-3
    else:
        rhs = (torch.randn((G, K, N), generator=g, device=dev)
               * K ** -0.5).to(rhs_dt)
    before = _route_counts()
    out = gg.grouped_gemm(lhs, rhs, gs, scale=scale)
    after = _route_counts()
    assert after[0] == before[0] + 1
    for i in range(1, 5):
        assert after[i] - before[i] == (i == counter), (route, i)
    ref = gg.grouped_gemm_plain(lhs, rhs, gs, scale=scale)
    torch.cuda.synchronize()
    assert bool((out[live:] == 0).all())
    assert (out.float() - ref).abs().max().item() <= _gg_tol(
        ref, lhs_dt, rhs_dt if rhs_dt != torch.int8 else _F32)

    # the lhs gradient: dout over the same buffer, the rhs transposed (an
    # int8 rhs without its scale, folded into dout by the caller)
    dout = buffer(N, _F32 if rhs_dt == _F32 else lhs_dt)
    dl = gg.grouped_gemm(dout, rhs, gs, transpose_rhs=True,
                         out_dtype=_F32)
    rl = gg.grouped_gemm_plain(dout, rhs, gs, transpose_rhs=True)
    torch.cuda.synchronize()
    assert bool((dl[live:] == 0).all())
    assert (dl - rl).abs().max().item() <= _gg_tol(
        rl, dout.dtype, rhs_dt if rhs_dt != torch.int8 else _F32)
    if rhs_dt == torch.int8:
        return
    dw = gg.grouped_gemm_tgmm(lhs, dout, gs, rhs_dt)
    rw = gg.grouped_gemm_tgmm_plain(lhs, dout, gs, _F32)
    torch.cuda.synchronize()
    for e, n in enumerate(counts):
        if n == 0:
            assert bool((dw[e] == 0).all()), e
    assert (dw.float() - rw).abs().max().item() <= _gg_tol(
        rw, lhs_dt, dout.dtype, rhs_dt)


def test_lora_grouped_runs_the_tc_kernels_forward_and_backward(dev):
    """The expert adapters' bypass (ops.moe._lora_grouped: a bf16 stream
    over fp32 adapters, M >= 64 G) on the card against the same call on the
    CPU (the plain versions): its two forward products and two lhs
    gradients run on the fp32 tensor-core kernels, its two weight gradients
    on the tensor-core tgmm (from the bf16 activations, never widened).
    Every result within 1e-2 of its max: the
    bypass rounds its rank-64 intermediate to bf16, and an fp32 product of
    the card and of the CPU may round an element to different neighbours
    (each product alone is held to 1e-4 above)."""
    from molly_tpu_torch.ops import moe
    M, counts = _TMA_SIZES["ragged"]
    G, H, r = len(counts), 128, 64
    g = torch.Generator().manual_seed(25)
    xs = torch.randn((M, H), generator=g).to(_BF16)
    ab = {"a": torch.randn((G, H, r), generator=g) / r,
          "b": torch.randn((G, r, H), generator=g) * 0.05}
    c = torch.randn((M, H), generator=g)
    gs = torch.tensor(counts, dtype=torch.int32)
    got = {}
    for where in ("cpu", dev):
        x = xs.to(where).requires_grad_(True)
        w = {k: v.to(where).requires_grad_(True) for k, v in ab.items()}
        before, tg0 = _route_counts(), _tgmm_tc_count()
        y = moe._lora_grouped(x, w, gs.to(where), 2.0)
        grads = torch.autograd.grad((y * c.to(where)).sum(),
                                    (x, w["a"], w["b"]))
        if where != "cpu":
            after, tg1 = _route_counts(), _tgmm_tc_count()
            assert after[0] - before[0] == after[4] - before[4] == 4
            assert tg1[0] - tg0[0] == tg1[1] - tg0[1] == 2
        got[str(where)] = [t.detach().cpu() for t in (y,) + grads]
    for i, (k, p) in enumerate(zip(got[str(dev)], got["cpu"])):
        assert k.dtype == p.dtype
        tol = _gg_tol(p.float(), _BF16)
        assert (k.float() - p.float()).abs().max().item() <= tol, i


def test_grouped_gemm_refuses_what_the_kernel_does_not_take(dev):
    lhs = torch.zeros((4, 8), device=dev)
    rhs = torch.zeros((2, 8, 8), device=dev)
    with pytest.raises(ValueError):     # int64 sizes
        gg.grouped_gemm(lhs, rhs, torch.tensor([2, 2], device=dev))
    gs = torch.tensor([2, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):     # sizes on the host
        gg.grouped_gemm(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError):     # int8 without its scale
        gg.grouped_gemm(lhs, rhs.to(torch.int8), gs)
    with pytest.raises(TypeError):
        gg.grouped_gemm(lhs.half(), rhs.half(), gs)
    with pytest.raises(ValueError):     # a strided rhs view
        gg.grouped_gemm(lhs, rhs.transpose(1, 2), gs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_checkpoint_and_peft_adapter_load_onto_the_card(dev, tmp_path,
                                                           dtype):
    """A tiny HF checkpoint written by the port's writer imports onto the
    card bit-equal to the CPU import (the rounding to bf16 happens on the
    card), its logits match the CPU's, and a PEFT directory loaded onto the
    card equals the CPU's load; merged, within fp32 rounding."""
    from molly_tpu_torch.inference import cli
    from molly_tpu_torch.models import qwen3
    from molly_tpu_torch.models.configs import tiny_qwen3
    from molly_tpu_torch.models.hf_export import (peft_lora_to_hf_state,
                                                  save_hf_checkpoint,
                                                  write_safetensors)
    from molly_tpu_torch.models.hf_import import load_hf_state, qwen3_from_hf
    from molly_tpu_torch.models.lora import LoraConfig, init_lora, merge_lora
    from molly_tpu_torch.utils.tree import leaves

    # head_dim 64: the flash kernels take 64 or 128
    kw = dict(vocab_size=384, head_dim=64, tie_word_embeddings=False)
    cfg = tiny_qwen3(**kw)
    g = torch.Generator().manual_seed(0)
    save_hf_checkpoint(str(tmp_path / "hf"), qwen3.init_params(cfg, g), cfg)
    state = load_hf_state(str(tmp_path / "hf"))
    run_cfg = tiny_qwen3(dtype=dtype, **kw)
    cpu = qwen3_from_hf(state, run_cfg)
    card = qwen3_from_hf(state, run_cfg, device=dev)
    for a, b in zip(leaves(card), leaves(cpu)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    if dtype == "float32":
        ids = torch.randint(0, 384, (2, 24), generator=g)
        with torch.no_grad():
            ref = qwen3.forward_logits(cpu, run_cfg, input_ids=ids)
            got = qwen3.forward_logits(card, run_cfg, input_ids=ids.to(dev))
        assert (got.cpu() - ref).abs().max().item() <= 1e-4

    adapter = init_lora(cfg, LoraConfig(r=4), g)
    adapter["layers"] = {t: {"a": ab["a"], "b": ab["b"] + 0.01}
                         for t, ab in adapter["layers"].items()}
    (tmp_path / "peft").mkdir()
    write_safetensors(str(tmp_path / "peft" / "adapter_model.safetensors"),
                      peft_lora_to_hf_state(adapter, cfg))
    (tmp_path / "peft" / "adapter_config.json").write_text(
        '{"lora_alpha": 8}')
    lora_cpu, alpha = cli.load_peft_adapter(str(tmp_path / "peft"), cfg)
    lora_card, _ = cli.load_peft_adapter(str(tmp_path / "peft"), cfg,
                                         device=dev)
    assert alpha == 8
    for a, b in zip(leaves(lora_card), leaves(lora_cpu)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    lcfg = LoraConfig(r=4, alpha=8.0)
    ref = merge_lora(cpu, lora_cpu, lcfg)
    got = merge_lora(card, lora_card, lcfg)
    for a, b in zip(leaves(got), leaves(ref)):
        # fp32: the merge's sums in another order; bf16: one rounding more
        tol = 1e-6 if dtype == "float32" else \
            b.float().abs().max().item() * 2 ** -8
        assert (a.cpu().float() - b.float()).abs().max().item() <= tol


# ------------------------------------------------ the rest of serving


def _serving_model(dev, dtype="float32", seed=0):
    """A small fusion model (head_dim 64, which the flash kernels take) with
    unit-scale text weights and an untied head, so greedy tokens vary:
    (cfg, cpu params, card params)."""
    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.configs import (FusionConfig, tiny_esm,
                                                tiny_qwen3)
    from molly_tpu_torch.utils.tree import tree_to
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=128, hidden_size=128,
                        intermediate_size=256, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=64, dtype=dtype,
                        tie_word_embeddings=False),
        dna_rna=tiny_esm(vocab_size=16, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         dtype=dtype),
        protein=tiny_esm(vocab_size=20, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         dtype=dtype),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    g = torch.Generator().manual_seed(seed)
    cpu = fusion.init_params(cfg, g)
    text = cpu["text"]
    text["embed"] = torch.randn(text["embed"].shape, generator=g).to(
        text["embed"].dtype)
    for name, w in text["layers"].items():
        if not isinstance(w, dict) and w.ndim == 3:
            text["layers"][name] = (torch.randn(w.shape, generator=g)
                                    * w.shape[1] ** -0.5).to(w.dtype)
    head = text["lm_head"]  # untied: a tied head repeats the input token
    text["lm_head"] = (torch.randn(head.shape, generator=g)
                       * head.shape[0] ** -0.5).to(head.dtype)
    return cfg, cpu, tree_to(cpu, dev)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_dense_writes_card_equal_cpu(dev, quant, dtype):
    """A [B] and a [B, S] ``cache_index`` write on the dense cache: the card
    matches the CPU (fp32: hidden 1e-4 and the cache 1e-4; int8 KV: values
    within one rounding step, scales 1e-5, hidden 1e-2 of its max), and two
    card runs give the same bits."""
    from molly_tpu_torch.models import qwen3
    cfg, cpu, card = _serving_model(dev, dtype)
    tcfg = cfg.text
    B, P, T, S = 3, 8, 24, 4
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(1, 128, (B, P + S), generator=g)
    valid = torch.zeros((B, T), dtype=torch.int32)
    valid[:, :P] = 1
    start = torch.tensor([P, P + 6, T - 2])
    idx = P + (start[:, None] - P + torch.arange(S)) % (T - P)   # [B, S]
    onehot = idx[:, :, None] == torch.arange(T)[None, None]
    m4 = ((valid[:, None] != 0) | (onehot.cumsum(1) > 0))[:, None]
    col = torch.tensor([P + 1, P + 3, T - 1])                    # [B]

    def run(params, where):
        on = dict(device=where)
        cache = qwen3.init_cache(tcfg, B, T, quant=quant, **on)
        with torch.inference_mode():
            qwen3.forward_hidden(params["text"], tcfg,
                                 input_ids=ids[:, :P].to(where),
                                 attention_mask=valid.to(where),
                                 cache=cache, cache_index=0)
            h1, _ = qwen3.forward_hidden(
                params["text"], tcfg, input_ids=ids[:, P:].to(where),
                attention_mask=m4.to(where),
                positions=(P + torch.arange(S))[None].expand(B, S).to(where),
                cache=cache, cache_index=idx.to(where), causal=False)
            v2 = valid.clone()
            v2[torch.arange(B), col] = 1
            h2, _ = qwen3.forward_hidden(
                params["text"], tcfg, input_ids=ids[:, P:P + 1].to(where),
                attention_mask=v2.to(where),
                positions=torch.full((B, 1), P + S).to(where), cache=cache,
                cache_index=col.to(where), causal=False)
        return h1, h2, cache

    a, b = run(card, dev), run(card, dev)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k])
    if dtype != "float32":
        return
    ref = run(cpu, "cpu")
    for x, y in zip(a[:2], ref[:2]):
        # int8 KV: the card's and the CPU's fp32 sums round a few fresh K/V
        # values to the other int8 neighbour (one step of a row's scale),
        # which moves the attention output at the int8 KV's ~1e-2 level
        tol = 1e-4 if quant is None else 1e-2 * y.abs().max().item()
        assert (x.cpu() - y).abs().max().item() <= tol
    if quant is None:
        assert (a[2]["kv"].cpu() - ref[2]["kv"]).abs().max().item() <= 1e-4
    else:
        d = (a[2]["kv"].cpu().int() - ref[2]["kv"].int()).abs()
        assert d.max().item() <= 1
        assert (a[2]["kv_scale"].cpu() - ref[2]["kv_scale"]).abs().max() \
            .item() <= 1e-5


@pytest.mark.parametrize("mode", ["lookup", "self_draft"])
def test_greedy_speculation_card_equal_cpu(dev, mode):
    """Greedy prompt lookup, and speculation with the int8 self-draft, give
    the CPU's tokens and round counts on the card (fp32)."""
    from molly_tpu_torch.inference import speculative
    from molly_tpu_torch.models import qwen3
    from molly_tpu_torch.models.configs import GenerationConfig
    cfg, cpu, card = _serving_model(dev)
    pat = torch.randint(2, 128, (5,), generator=torch.Generator()
                        .manual_seed(3))
    ids = torch.cat([pat, pat, pat, pat[:2]])[None]
    gen = GenerationConfig(max_new_tokens=16, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    outs = []
    for params, where in ((cpu, "cpu"), (card, dev)):
        t = params["text"]
        if mode == "lookup":
            outs.append(speculative.generate_lookup(
                t, cfg.text, ids.to(where), gen, k=4, n=2,
                return_stats=True))
        else:
            with torch.no_grad():
                d = qwen3.quantize_for_decode(t, cfg.text)
            outs.append(speculative.generate_speculative(
                t, cfg.text, d, cfg.text, ids.to(where), gen, k=3,
                return_stats=True))
    (rt, rr, ra), (gt, gr, ga) = outs
    assert torch.equal(gt.cpu(), rt) and (gr, ga) == (rr, ra)
    assert len(set(rt[0].tolist())) > 1


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("spec", [0, 3])
def test_offline_ring_card_equal_cpu(dev, kv_quant, spec):
    """A tiny offline ring (10 requests, 4 slots, groups of 2) on the card
    gives the CPU's tokens (int8 KV: first tokens equal, at most 3
    flips)."""
    from molly_tpu_torch.inference import offline
    from molly_tpu_torch.models.configs import GenerationConfig
    cfg, cpu, card = _serving_model(dev)
    g = torch.Generator().manual_seed(5)
    n, bucket = 10, 32
    ids = torch.randint(1, 128, (n, bucket), generator=g).int().numpy()
    mask = (torch.arange(bucket)[None] >= torch.randint(
        0, 20, (n, 1), generator=g)).int().numpy()
    gen = GenerationConfig(max_new_tokens=12, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    kw = dict(n_slots=4, max_len=bucket + 12 + spec, admit_group=2,
              kv_quant=kv_quant, spec_lookup=spec)
    ref = offline.run_offline(cpu, cfg, gen, ids, mask, **kw)
    got = offline.run_offline(card, cfg, gen, ids, mask, **kw)
    again = offline.run_offline(card, cfg, gen, ids, mask, **kw)
    assert (got["tokens"] == again["tokens"]).all()
    assert (got["lengths"] == ref["lengths"]).all()
    flips = int((got["tokens"] != ref["tokens"]).sum())
    if kv_quant is None:
        assert flips == 0
    else:
        assert (got["tokens"][:, 0] == ref["tokens"][:, 0]).all()
        assert flips <= 3


def test_http_round_trip_on_the_card(dev):
    """One greedy completion and one embedding through the HTTP API over
    the card's engine (fp32): the CPU server's answer."""
    import json
    import threading
    import urllib.request

    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.inference import api_server
    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.configs import (FusionConfig,
                                                GenerationConfig, tiny_esm,
                                                tiny_qwen3)
    from molly_tpu_torch.utils.tree import tree_to
    text_tok, dna_tok, prot_tok = (load_text_tokenizer(None),
                                   *default_modality_tokenizers())
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=-(-text_tok.vocab_size // 128) * 128,
                        head_dim=64),
        dna_rna=tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                         hidden_size=128, num_attention_heads=2),
        protein=tiny_esm(vocab_size=prot_tok.vocab_size,
                         mask_token_id=prot_tok.mask_id, hidden_size=128,
                         num_attention_heads=2),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    cpu = fusion.init_params(cfg, torch.Generator().manual_seed(0))
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=192, dna_rna_k_tokens=4, protein_k_tokens=4))
    gen = GenerationConfig(max_new_tokens=6, do_sample=False,
                           eos_token_id=text_tok.eos_token_id,
                           pad_token_id=text_tok.pad_token_id)
    answers = []
    for params in (cpu, tree_to(cpu, dev)):
        online = api_server.OnlineServer(params, cfg, gen, enc, text_tok,
                                         n_slots=2, decode_chunk=2)
        httpd = api_server.make_http_server(online, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        got = []
        for path, body in (("/v1/completions",
                            {"prompt": "Is <dna>ACGTACGT</dna> a promoter?",
                             "temperature": 0, "logprobs": 1}),
                           ("/v1/embeddings", {"input": ["hi <dna>ACGT</dna>"]})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                got.append(json.loads(r.read()))
        httpd.shutdown()
        httpd.server_close()
        online.close()
        answers.append(got)
    (c_cpu, e_cpu), (c_card, e_card) = answers
    assert c_card["choices"][0]["text"] == c_cpu["choices"][0]["text"]
    assert c_card["usage"] == c_cpu["usage"]
    lp = [c["choices"][0]["logprobs"]["token_logprobs"]
          for c in (c_card, c_cpu)]
    assert max(abs(a - b) for a, b in zip(*lp)) <= 1e-3
    va = torch.tensor(e_card["data"][0]["embedding"])
    vb = torch.tensor(e_cpu["data"][0]["embedding"])
    assert (va - vb).abs().max().item() <= 1e-3


def test_int8_encoders_card_close_to_cpu(dev):
    """``esm.quantize_for_decode`` of a bf16 encoder: every product runs
    the int8 TMA kernel on the card, within one bf16 rounding (2e-2 of the
    output's max) of the same int8 encoder on the CPU."""
    from molly_tpu_torch.models import esm
    from molly_tpu_torch.models.configs import tiny_esm
    from molly_tpu_torch.utils.tree import tree_to
    cfg = tiny_esm(vocab_size=33, hidden_size=128, intermediate_size=256,
                   num_attention_heads=2, dtype="bfloat16")
    cpu = esm.quantize_for_decode(
        esm.init_params(cfg, torch.Generator().manual_seed(0)))
    card = tree_to(cpu, dev)
    ids = torch.randint(4, 30, (4, 40), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones_like(ids, dtype=torch.int32)
    before = (quant.int8_matmul.launches, quant.int8_matmul.launches_tma)
    with torch.inference_mode():
        got = esm.forward_hidden(card, cfg, ids.to(dev), mask.to(dev))
        ref = esm.forward_hidden(cpu, cfg, ids, mask)
    n = quant.int8_matmul.launches - before[0]
    assert n == 6 * cfg.num_hidden_layers
    assert quant.int8_matmul.launches_tma - before[1] == n
    err = (got.float().cpu() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


def _train_model(dev, moe=False, seed=0):
    """A small bf16 fusion model whose flash calls take the TMA kernels
    (head_dim 64), on the card, and a right-padded tri-modal batch."""
    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.configs import (FusionConfig, tiny_esm,
                                                tiny_moe, tiny_qwen3)
    cfg = FusionConfig(
        text=(tiny_moe if moe else tiny_qwen3)(
            vocab_size=384, hidden_size=256, intermediate_size=512,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            dtype="bfloat16"),
        dna_rna=tiny_esm(vocab_size=4107, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         mask_token_id=2, mlp_type="swiglu", mlp_bias=False,
                         dtype="bfloat16"),
        protein=tiny_esm(vocab_size=33, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         dtype="bfloat16"),
        dna_rna_k_tokens=16, protein_k_tokens=16)
    g = torch.Generator().manual_seed(seed)
    B, S = 4, 128
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, 100:] = 0
    mask[3, 70:] = 0
    ids = torch.randint(0, 384, (B, S), generator=g)
    labels = torch.where(mask.bool(), ids, -100)
    labels[:, :30] = -100
    batch = {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1], [5, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75], [25]]),
        "task_label": torch.tensor([0, 3, 100, 7]),
    }

    def params():
        return fusion.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return cfg, params, {k: t.to(dev) for k, t in batch.items()}


def test_offloaded_step_is_pinned_and_bit_equal_on_the_card(dev, tmp_path,
                                                            monkeypatch):
    """Three full fine-tune steps with the moments offloaded (streamed in
    chunks of 4,096 elements through the ring) against the on-device step:
    params and moments bit-equal after every step; the moments stay pinned
    on the host, also through a checkpoint save and restore."""
    from molly_tpu_torch.training import checkpoint as ckpt
    from molly_tpu_torch.training import trainer
    cfg, make, batch = _train_model(dev)
    monkeypatch.setattr(trainer, "_OFFLOAD_CHUNK", 4096)
    runs = []
    for off in (False, True):
        tc = trainer.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0,
                                 weight_decay=0.1, offload_opt_state=off)
        params = make()
        state = trainer.init_train_state(params, tc)
        step = trainer.make_train_step(cfg, tc)
        stats = {}
        if off:
            state = trainer.offload_opt_state(state)
            step = trainer.make_offloaded_step(step, state, stats)
        snaps = []
        for _ in range(3):
            state, m = step(state, batch, None)
            assert not m["skipped"]
            snaps.append([t.detach().cpu().clone() for t in
                          trainer._trainable_leaves(params, tc)]
                         + [t.cpu().clone() for t in
                            state.opt_state["mu"] + state.opt_state["nu"]])
        runs.append((snaps, state, tc, stats))
    (ref, _, _, _), (got, state, tc, stats) = runs
    for a, b in zip(ref, got):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    moments = state.opt_state["mu"] + state.opt_state["nu"]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in moments)
    assert stats["offload_h2d_s"] > 0 and stats["offload_d2h_s"] > 0
    path = str(tmp_path / "ckpt")
    ckpt.save_train_state(path, state)
    fresh = trainer.offload_opt_state(trainer.init_train_state(make(), tc))
    restored = ckpt.restore_train_state(path, fresh)
    for name in ("mu", "nu"):
        for a, b in zip(restored.opt_state[name], state.opt_state[name]):
            assert a.is_pinned() and torch.equal(a, b)


def test_offloaded_step_refuses_moments_not_pinned(dev):
    from molly_tpu_torch.training import trainer
    cfg, make, batch = _train_model(dev)
    tc = trainer.TrainConfig(offload_opt_state=True)
    state = trainer.init_train_state(make(), tc)
    step = trainer.make_offloaded_step(trainer.make_train_step(cfg, tc),
                                       state)
    state.opt_state["mu"][0] = state.opt_state["mu"][0].clone()  # pageable
    with pytest.raises(RuntimeError, match="not pinned"):
        step(state, batch, None)


@pytest.mark.parametrize("moe", [False, True])
def test_dots_gradients_equal_full_on_the_card(dev, moe):
    """Loss and every trainable gradient of one bf16 step under ``dots``
    against ``full`` and no remat on the card: within 1e-2 of each leaf's
    max (in practice bit-equal: the kernels rerun deterministically), with
    every flash launch on the TMA kernels."""
    import dataclasses

    from molly_tpu_torch.training import trainer
    cfg, make, batch = _train_model(dev, moe=moe)
    params = make()
    tc = trainer.TrainConfig()
    trainer.init_train_state(params, tc)
    out = {}
    for policy in (None, "full", "dots"):
        run_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, remat=policy is not None,
            remat_policy=policy or "full"))
        before = (fa.flash_attention_fwd.launches,
                  fa.flash_attention_fwd.launches_tma,
                  fa.flash_attention_dq.launches,
                  fa.flash_attention_dq.launches_tma)
        out[policy] = trainer.make_grad_fn(run_cfg, tc)(params, batch)
        n_fwd = fa.flash_attention_fwd.launches - before[0]
        assert n_fwd == fa.flash_attention_fwd.launches_tma - before[1] > 0
        assert fa.flash_attention_dq.launches - before[2] == \
            fa.flash_attention_dq.launches_tma - before[3] > 0
    base_g, base_m = out[None]
    for policy in ("full", "dots"):
        g, m = out[policy]
        assert abs(float(m["loss"]) - float(base_m["loss"])) <= 1e-2 * abs(
            float(base_m["loss"]))
        for a, b in zip(g, base_g):
            ref = b.float().abs().max().item()
            assert (a.float() - b.float()).abs().max().item() <= \
                1e-2 * max(ref, 1e-12)


def test_baseline_forward_runs_the_flash_tma_kernel(dev):
    """The NT+ESM baseline's bf16 forward on the card: one flash launch a
    layer of each encoder, all on the TMA kernel, and logits within 2e-2
    of their max of the same weights through the plain attention."""
    from molly_tpu_torch.baselines import model as bmodel
    from molly_tpu_torch.models import esm
    from molly_tpu_torch.models.configs import tiny_esm
    from molly_tpu_torch.ops import attention
    nt = tiny_esm(vocab_size=4107, hidden_size=128, intermediate_size=256,
                  num_attention_heads=2, mask_token_id=2, mlp_type="swiglu",
                  mlp_bias=False, dtype="bfloat16")
    prot = tiny_esm(vocab_size=33, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=3, num_attention_heads=2,
                    dtype="bfloat16")
    cfg = bmodel.BaselineConfig(model_type="NT+ESM", nt=nt, protein=prot)
    params = bmodel.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    B, S = 4, 96
    batch = {"x1": torch.randint(6, 4102, (B, S), generator=g, device=dev),
             "x2": torch.randint(4, 24, (B, S), generator=g, device=dev)}
    batch["x1"][1, 60:] = 1
    batch["x2"][2, 40:] = 1
    batch["mask1"] = (batch["x1"] != 1).int()
    batch["mask2"] = (batch["x2"] != 1).int()
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.launches_tma)
    with torch.no_grad():
        got = bmodel.forward_logits(params, cfg, batch)
    n = fa.flash_attention_fwd.launches - before[0]
    assert n == fa.flash_attention_fwd.launches_tma - before[1] == 2 + 3
    plain = attention.plain_attention
    orig = esm.dot_product_attention
    esm.dot_product_attention = lambda q, k, v, **kw: plain(
        q, k, v, mask=kw["mask"], causal=kw["causal"], scale=kw["scale"])
    try:
        with torch.no_grad():
            ref = bmodel.forward_logits(params, cfg, batch)
    finally:
        esm.dot_product_attention = orig
    assert (got - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()
