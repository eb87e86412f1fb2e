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
