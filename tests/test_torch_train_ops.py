"""The training ops of molly_tpu_torch held against molly_tpu on the CPU, in
fp32: flash-attention backward, RMSNorm backward, the chunked linear +
cross-entropy. Inputs come from numpy seeds and go through both sides.

The Pallas kernels run as the JAX package's own tests run them (interpret
mode, small blocks); the port's wrappers run their plain versions because
the tensors lie on the CPU, through the same autograd functions that launch
the kernels on a card.

Tolerances: flash dQ/dK/dV 1e-4 (two fp32 recomputes of P in different
tile orders), RMSNorm and LCE 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from molly_tpu.ops import flash_attention as jfa
from molly_tpu.ops import lce as jlce
from molly_tpu.ops import norms as jnorms
from molly_tpu.ops.rmsnorm_pallas import rms_norm_pallas
from molly_tpu_torch.ops import flash_attention as tfa
from molly_tpu_torch.ops import lce, rmsnorm_triton

FLASH_ATOL = 1e-4
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- flash


def _flash_case(D, causal, N, Nkv, pad, q_offset, seed=0):
    rng = np.random.default_rng(seed)
    B, Sq = 2, 24
    Skv = Sq + q_offset
    q = _rand(rng, B, Sq, N, D)
    k = _rand(rng, B, Skv, Nkv, D)
    v = _rand(rng, B, Skv, Nkv, D)
    mask = np.ones((B, Skv), np.int32)
    if pad == "left":
        mask[0, :5] = 0
        mask[1, :11] = 0
    elif pad == "right":
        mask[0, Skv - 4:] = 0
        mask[1, Skv - 9:] = 0
    # a query row has a valid key iff some unmasked key lies at or before
    # its diagonal (causal) / anywhere (bidirectional)
    if causal:
        seen = np.cumsum(mask, axis=1)[:, q_offset:q_offset + Sq] > 0
    else:
        seen = np.broadcast_to(mask.sum(1, keepdims=True) > 0, (B, Sq))
    # the loss weights stand in for dO; zero on rows without a valid key,
    # as in the model (nothing the loss sees depends on such rows)
    w = _rand(rng, B, Sq, N, D) * seen[:, :, None, None]
    return q, k, v, mask, w.astype(np.float32), seen


@pytest.mark.parametrize("D,causal,N,Nkv,pad,q_offset", [
    (64, True, 4, 2, "left", 0),
    (64, True, 4, 2, "right", 0),
    (128, True, 2, 1, "left", 0),
    (64, False, 4, 4, "right", 0),
    (128, False, 2, 2, "none", 0),
    (64, True, 4, 2, "left", 8),
    (64, True, 2, 2, "none", 0),
])
def test_flash_backward_matches_jax_grad(D, causal, N, Nkv, pad, q_offset):
    q, k, v, mask, w, _ = _flash_case(D, causal, N, Nkv, pad, q_offset)
    scale = D ** -0.5

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), causal, scale,
                                q_offset, block_sizes=(8, 8))
        return jnp.sum(o * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = tfa.flash_attention(tq, tk, tv, _t(mask), causal, scale, q_offset)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    got = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=FLASH_ATOL, err_msg=f"d{name}")


def test_flash_backward_agrees_with_autograd_through_the_plain_forward():
    """Where every row has a valid key, the recompute backward equals
    differentiating the plain forward's softmax."""
    q, k, v, mask, w, _ = _flash_case(64, True, 4, 2, "right", 0, seed=1)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = tfa.flash_attention(tq, tk, tv, _t(mask), True, None, 0)
    got = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    o2, _ = tfa.flash_attention_plain(tq, tk, tv, _t(mask), True, None, 0)
    ref = torch.autograd.grad((o2 * _t(w)).sum(), (tq, tk, tv))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=FLASH_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_finite_with_random_dout_on_every_row(causal):
    q, k, v, mask, _, seen = _flash_case(64, causal, 4, 2, "left", 0, seed=2)
    if not causal:
        mask[1] = 0  # a sample with no valid key at all
    else:
        assert not seen.all()  # left padding leaves rows without a key
    rng = np.random.default_rng(5)
    dout = _rand(rng, *q.shape)
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, tm, causal, None, 0)
    for g in tfa.flash_attention_bwd(tq, tk, tv, tm, o, lse, _t(dout),
                                     causal, None, 0):
        assert bool(torch.isfinite(g).all())


def test_flash_inference_path_is_unchanged():
    q, k, v, mask, _, _ = _flash_case(64, True, 4, 2, "left", 0)
    with torch.inference_mode():
        o = tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), True)
    o2, _ = tfa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), True)
    assert o.grad_fn is None
    np.testing.assert_array_equal(o.numpy(), o2.numpy())


# ---------------------------------------------------------------- rmsnorm


@pytest.mark.parametrize("shape", [(3, 8, 32), (2, 5, 4, 16), (19, 128)])
@pytest.mark.parametrize("ref_fn", ["pallas", "norms"])
def test_rmsnorm_backward_matches_jax_grad(shape, ref_fn):
    rng = np.random.default_rng(0)
    x = _rand(rng, *shape)
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    g = _rand(rng, *shape)
    jf = rms_norm_pallas if ref_fn == "pallas" else jnorms.rms_norm
    rdx, rdw = jax.grad(lambda x_, w_: jnp.sum(jf(x_, w_, 1e-6) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    y = rmsnorm_triton.rms_norm(tx, tw, 1e-6)
    assert "RmsNorm" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad((y * _t(g)).sum(), (tx, tw))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), atol=ATOL)


def test_rmsnorm_backward_skips_dw_for_a_frozen_weight():
    rng = np.random.default_rng(1)
    x, w, g = _rand(rng, 6, 32), _rand(rng, 32), _rand(rng, 6, 32)
    dx, dw = rmsnorm_triton.rms_norm_bwd(_t(x), _t(w), _t(g), 1e-6,
                                         need_dw=False)
    assert dw is None
    ref, _ = rmsnorm_triton.rms_norm_bwd_plain(_t(x), _t(w), _t(g), 1e-6)
    np.testing.assert_array_equal(dx.numpy(), ref.numpy())
    tx = _t(x, True)
    y = rmsnorm_triton.rms_norm(tx, _t(w), 1e-6)  # weight needs no grad
    (dx2,) = torch.autograd.grad((y * _t(g)).sum(), (tx,))
    np.testing.assert_array_equal(dx2.numpy(), ref.numpy())


def test_rmsnorm_stacked_weight_has_no_backward():
    rng = np.random.default_rng(2)
    x, w = _t(_rand(rng, 2, 3, 6, 16), True), _t(_rand(rng, 6, 16))
    y = rmsnorm_triton.rms_norm(x, w, 1e-6)
    with pytest.raises(NotImplementedError, match="1-D weight"):
        y.sum().backward()


# ---------------------------------------------------------------- lce


def _lce_case(seed=0, T=37, H=16, V=50):
    rng = np.random.default_rng(seed)
    h = _rand(rng, T, H)
    w = _rand(rng, H, V, scale=0.3)
    labels = rng.integers(0, V, T).astype(np.int32)
    labels[rng.random(T) < 0.3] = -100
    g = _rand(rng, T)
    return h, w, labels, g


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
@pytest.mark.parametrize("chunk", [8, 64])
def test_lce_nll_dh_dw_match_jax(z_loss, chunk):
    h, w, labels, g = _lce_case()

    def jf(h_, w_):
        return jlce.fused_linear_cross_entropy(
            h_, w_, jnp.asarray(labels), chunk, z_loss, -100, True)

    ref = np.asarray(jf(jnp.asarray(h), jnp.asarray(w)))
    rdh, rdw = jax.grad(lambda a, b: jnp.sum(jf(a, b) * g), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, True), _t(w, True)
    nll = lce.fused_linear_cross_entropy(th, tw, _t(labels), chunk, z_loss)
    np.testing.assert_allclose(nll.detach().numpy(), ref, atol=ATOL)
    assert nll.dtype == torch.float32
    dh, dw = torch.autograd.grad((nll * _t(g)).sum(), (th, tw))
    np.testing.assert_allclose(dh.numpy(), np.asarray(rdh), atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), atol=ATOL)


def test_lce_need_dw_false_skips_the_weight_gradient():
    h, w, labels, g = _lce_case(seed=1)
    th, tw = _t(h, True), _t(w, True)
    nll = lce.fused_linear_cross_entropy(th, tw, _t(labels), 8, 0.0, -100,
                                         need_dw=False)
    dh, dw = torch.autograd.grad((nll * _t(g)).sum(), (th, tw),
                                 allow_unused=True)
    assert dw is None
    rdh = jax.grad(lambda a: jnp.sum(jlce.fused_linear_cross_entropy(
        a, jnp.asarray(w), jnp.asarray(labels), 8, 0.0, -100, False) * g))(
        jnp.asarray(h))
    np.testing.assert_allclose(dh.numpy(), np.asarray(rdh), atol=ATOL)


def test_lce_tied_head_gradient_reaches_the_embedding():
    h, w, labels, g = _lce_case(seed=2)
    embed = _t(np.ascontiguousarray(w.T), True)          # [V, H]
    nll = lce.fused_linear_cross_entropy(_t(h), embed.T, _t(labels), 16)
    (de,) = torch.autograd.grad((nll * _t(g)).sum(), (embed,))
    rdw = jax.grad(lambda b: jnp.sum(jlce.fused_linear_cross_entropy(
        jnp.asarray(h), b, jnp.asarray(labels), 16) * g))(jnp.asarray(w))
    np.testing.assert_allclose(de.numpy(), np.asarray(rdw).T, atol=ATOL)


@pytest.mark.parametrize("pre_shifted", [False, True])
def test_causal_lm_loss_matches_jax(pre_shifted):
    rng = np.random.default_rng(3)
    B, S, H, V = 3, 9, 16, 40
    hidden, w = _rand(rng, B, S, H), _rand(rng, H, V, scale=0.3)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, :3] = -100
    labels[2] = -100
    ref = jlce.causal_lm_loss(jnp.asarray(hidden), jnp.asarray(w),
                              jnp.asarray(labels), chunk_size=8,
                              z_loss=1e-3, pre_shifted=pre_shifted)
    got = lce.causal_lm_loss(_t(hidden), _t(w), _t(labels), chunk_size=8,
                             z_loss=1e-3, pre_shifted=pre_shifted)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_lce_bf16_logits_are_not_rounded():
    """bf16 operands, fp32 logits: the nll equals the one computed from the
    same bf16 values in fp32, far inside a bf16 rounding of the logits."""
    h, w, labels, _ = _lce_case(seed=4, T=64, H=32, V=300)
    hb, wb = _t(h).bfloat16(), _t(w * 4).bfloat16()
    nll = lce.fused_linear_cross_entropy(hb, wb, _t(labels), 16)
    ref = lce.fused_linear_cross_entropy(hb.float(), wb.float(), _t(labels),
                                         16)
    assert nll.dtype == torch.float32
    np.testing.assert_allclose(nll.numpy(), ref.numpy(), atol=1e-5)
