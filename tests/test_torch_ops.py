"""molly_tpu_torch.ops held against molly_tpu.ops on the CPU, in fp32.

Inputs come from numpy seeds and go through both sides. The Pallas kernels
run as the JAX package's own tests run them (interpret mode, small blocks);
the port's kernel wrappers run their plain versions because the tensors lie
on the CPU. Tolerances: 1e-5 for ops in fp32 unless stated otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from molly_tpu.ops import flash_attention as jfa
from molly_tpu.ops import norms as jnorms
from molly_tpu.ops import quant as jquant
from molly_tpu.ops import rope as jrope
from molly_tpu.ops.attention import _xla_attention
from molly_tpu.ops.rmsnorm_pallas import rms_norm_pallas
from molly_tpu_torch.ops import attention, norms, quant, rope
from molly_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- rope


@pytest.mark.parametrize("theta,per_row", [(1e6, True), (1e4, False)])
def test_rope_matches_jax(theta, per_row):
    rng = np.random.default_rng(0)
    B, S, N, Dh = 2, 7, 3, 16
    pos = (rng.integers(0, 3000, (B, S)) if per_row
           else np.arange(S)).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), Dh, theta)
    tc, ts = rope.rope_cos_sin(_t(pos), Dh, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    x = _rand(rng, B, S, N, Dh)
    np.testing.assert_allclose(
        rope.apply_rope(_t(x), tc, ts).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)), atol=ATOL)
    np.testing.assert_array_equal(rope.rotate_half(_t(x)).numpy(),
                                  np.asarray(jrope.rotate_half(x)))


# ---------------------------------------------------------------- norms


@pytest.mark.parametrize("x_shape,w_shape", [
    ((3, 5, 32), (32,)),          # hidden-state norm
    ((2, 3, 4, 16), (16,)),       # unfused per-head q_norm
    ((2, 3, 6, 16), (6, 16)),     # fused decode branch: stacked qk_norm
])
def test_rms_norm_matches_jax(x_shape, w_shape):
    rng = np.random.default_rng(1)
    x = _rand(rng, *x_shape)
    w = 1.0 + _rand(rng, *w_shape, scale=0.1)
    got = norms.rms_norm(_t(x), _t(w), 1e-6)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_rms_norm_matches_pallas_kernel():
    """The plain version against the Pallas kernel it replaces (1-D
    weight, the only form that kernel takes)."""
    rng = np.random.default_rng(2)
    x = _rand(rng, 4, 9, 128)
    w = 1.0 + _rand(rng, 128, scale=0.1)
    got = norms.rms_norm(_t(x), _t(w), 1e-6)
    ref = rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_rms_norm_rejects_mismatched_weight():
    with pytest.raises(ValueError):
        norms.rms_norm(torch.ones(2, 3, 8), torch.ones(4, 8), 1e-6)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, 3, 5, 32, scale=2.0) + 0.5
    w, b = 1.0 + _rand(rng, 32, scale=0.1), _rand(rng, 32, scale=0.1)
    got = norms.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------- flash


FLASH_CASES = [
    # the parity cases of tests/test_flash_attention.py
    # (B, Sq, Skv, N, Nkv, D, causal, use_mask, q_offset)
    (1, 32, 32, 2, 2, 16, True, False, 0),     # plain causal MHA
    (2, 32, 32, 4, 2, 16, True, True, 0),      # GQA + padding mask
    (1, 32, 32, 2, 1, 16, False, True, 0),     # bidirectional (encoder)
    (1, 24, 40, 2, 2, 16, True, True, 16),     # prefill into longer cache
    (2, 20, 20, 2, 2, 16, True, True, 0),      # non-divisible seq lens
    (2, 16, 24, 4, 2, 16, True, True, 0),      # left padding: empty rows
]


def _valid_rows(B, Sq, Skv, mask, causal, q_offset):
    """[B, Sq] True where the query row has at least one valid key."""
    m = np.ones((B, Skv), bool) if mask is None else mask != 0
    if not causal:
        return np.repeat(m.any(1, keepdims=True), Sq, 1)
    qpos = np.arange(Sq)[:, None] + q_offset
    allowed = qpos >= np.arange(Skv)[None, :]              # [Sq, Skv]
    return (allowed[None] & m[:, None, :]).any(-1)


@pytest.mark.parametrize("B,Sq,Skv,N,Nkv,D,causal,use_mask,q_offset",
                         FLASH_CASES)
def test_flash_forward_matches_pallas(B, Sq, Skv, N, Nkv, D, causal,
                                      use_mask, q_offset):
    rng = np.random.default_rng(4)
    q = _rand(rng, B, Sq, N, D, scale=0.3)
    k = _rand(rng, B, Skv, Nkv, D, scale=0.3)
    v = _rand(rng, B, Skv, Nkv, D, scale=0.3)
    mask = None
    if use_mask:
        mask = np.ones((B, Skv), np.int32)
        mask[:, -4:] = 0
        if Sq == 16:  # left-padded prompt rows have no valid key
            mask[1, :6] = 0
    jmask = None if mask is None else jnp.asarray(mask)

    # JAX side as its own tests run it: interpret mode, 16-row blocks
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jmask, causal, None, q_offset, (16, 16))
    BQ, BK = min(16, -(-Sq // 8) * 8), min(16, -(-Skv // 8) * 8)
    qt = jfa._pad_axis(jnp.asarray(q).transpose(0, 2, 1, 3), 2, BQ)
    kt = jfa._pad_axis(jnp.asarray(k).transpose(0, 2, 1, 3), 2, BK)
    vt = jfa._pad_axis(jnp.asarray(v).transpose(0, 2, 1, 3), 2, BK)
    maskp = None if mask is None else jfa._pad_axis(jmask, 1, BK)[:, None]
    _, res = jfa._flash_fwd(qt, kt, vt, maskp, causal, None, q_offset,
                            (BQ, BK), Skv)
    ref_lse = np.asarray(res[5])[:, :, 0, :Sq]

    o, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v),
                                     None if mask is None else _t(mask),
                                     causal, None, q_offset)
    assert o.shape == (B, Sq, N, D) and lse.shape == (B, N, Sq)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    rows = _valid_rows(B, Sq, Skv, mask, causal, q_offset)
    np.testing.assert_allclose(o.numpy()[rows], np.asarray(ref)[rows],
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[rows],
                               ref_lse.transpose(0, 2, 1)[rows], atol=ATOL)


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("kind", [
    "flash_2d_mask", "bool_4d_mask", "decode_per_row_offset",
    "bnsd_prefill", "bnsd_decode", "no_mask_causal"])
def test_dot_product_attention_matches_xla(kind):
    rng = np.random.default_rng(5)
    B, N, Nkv, D = 2, 4, 2, 16
    Sq, Skv = (1, 24) if "decode" in kind else (12, 12)
    if kind == "bnsd_prefill":
        Skv = 20
    q = _rand(rng, B, Sq, N, D, scale=0.5)
    k = _rand(rng, B, Skv, Nkv, D, scale=0.5)
    v = _rand(rng, B, Skv, Nkv, D, scale=0.5)
    mask = np.ones((B, Skv), np.int32)
    mask[0, :3] = 0
    mask[1, -2:] = 0
    kw = dict(causal=True, scale=None)
    if kind == "bool_4d_mask":
        m4 = rng.random((B, 1, Sq, Skv)) > 0.3
        m4[..., 0] = True
        kw.update(causal=False)
        jm, tm = jnp.asarray(m4), _t(m4)
    elif kind == "no_mask_causal":
        jm = tm = None
    else:
        jm, tm = jnp.asarray(mask), _t(mask)
    jq_off = tq_off = 0
    if kind == "decode_per_row_offset":
        off = np.asarray([20, 13], np.int32)
        jq_off, tq_off = jnp.asarray(off), _t(off)
    elif kind == "bnsd_decode":
        jq_off = tq_off = 17
    elif kind == "bnsd_prefill":
        jq_off = tq_off = 8
    layout = "bnsd" if kind.startswith("bnsd") else "bsnd"
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    if layout == "bnsd":
        jk, jv = jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3)
        tk, tv = tk.transpose(1, 2).contiguous(), tv.transpose(1, 2).contiguous()
    ref = _xla_attention(jnp.asarray(q), jk, jv, mask=jm, q_offset=jq_off,
                         kv_layout=layout, **kw)
    got = attention.dot_product_attention(_t(q), tk, tv, mask=tm,
                                          q_offset=tq_off, kv_layout=layout,
                                          **kw)
    if kind in ("bool_4d_mask", "decode_per_row_offset", "bnsd_decode"):
        rows = np.ones((B, Sq), bool)
    else:
        rows = _valid_rows(B, Sq, Skv, None if tm is None else mask,
                           True, int(tq_off))
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------- int8


def test_quantize_int8_exact():
    rng = np.random.default_rng(6)
    w = _rand(rng, 40, 24, scale=0.05)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    ref = jquant.quantize_int8(jnp.asarray(w))
    got = quant.quantize_int8(_t(w))
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    # stacked [L, in, out] weights: the JAX side vmaps
    ws = _rand(rng, 3, 40, 24, scale=0.05)
    ref = jax.vmap(jquant.quantize_int8)(jnp.asarray(ws))
    got = quant.quantize_int8(_t(ws))
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    assert quant.is_quantized(got) and not quant.is_quantized(_t(w))


def test_int8_matmul_plain_follows_kernel_and_jax():
    rng = np.random.default_rng(7)
    x = _rand(rng, 3, 5, 64)
    qd = jquant.quantize_int8(jnp.asarray(_rand(rng, 64, 48, scale=0.05)))
    tq = {k: _t(v) for k, v in qd.items()}
    got = quant.int8_matmul(_t(x), tq).numpy()
    assert got.shape == (3, 5, 48) and got.dtype == np.float32
    # the Pallas kernel's math in float64: x as given, f32 accumulation
    exact = (x.astype(np.float64) @ np.asarray(qd["w_q"], np.float64)
             ) * np.asarray(qd["scale"], np.float64)
    np.testing.assert_allclose(got, exact, atol=ATOL, rtol=1e-5)
    # the JAX package's CPU path rounds x to bf16 first (quant.py:81): the
    # two agree to bf16 precision of the activations, 1e-2 of the max
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), qd))
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())
    np.testing.assert_allclose(quant.linear(_t(x), tq).numpy(), got)
    w = _rand(rng, 64, 8)
    np.testing.assert_allclose(quant.linear(_t(x), _t(w)).numpy(), x @ w,
                               atol=ATOL)
