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
    """bf16 with aligned rows runs the tensor-core kernel; fp32 and the
    unaligned bf16 view run the SIMT kernel."""
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
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, None, q_offset)
    assert fa.flash_attention_fwd.launches == before + 1
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(), mask,
                                        causal, None, q_offset)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    rows = torch.ones((B, Sq), dtype=torch.bool, device=dev)
    if causal:
        rows[1, :max(0, 40 - q_offset)] = False
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert ((o.float() - ro).abs()[rows]).max().item() <= tol
    assert ((lse - rlse).abs().transpose(1, 2)[rows]).max().item() <= 1e-4


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
@pytest.mark.parametrize("M,K,N", [
    (1, 64, 40), (4, 2048, 1000), (4, 6144, 2048), (16, 1000, 520),
    (17, 300, 129), (70, 300, 129), (257, 512, 256), (130, 256, 2064)])
def test_int8_kernel_matches_plain(dev, dtype, M, K, N):
    """M <= 16 takes the split-K weight stream; larger M the tensor-core
    GEMM (bf16, K % 32 == 0, N % 16 == 0) or else the SIMT GEMM."""
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


def test_flash_backward_unaligned_bf16_views_match_plain(dev):
    """bf16 views whose rows are not 16-byte aligned take the SIMT kernels
    (aligned ones the tensor-core kernels): same answers."""
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
    got = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
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
    a = fa.flash_attention_dq(q, k, v, mask, lse, delta, view, True, None, 0)
    b = fa.flash_attention_dq(q, k, v, mask, lse, delta, dout, True, None, 0)
    assert torch.equal(a, b)


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
