"""The RMSNorm forward's row view and launch plan, and the int8 GEMM's
decode route (the weight stream) and its plan, held against molly_tpu on the
CPU.

The card kernels cannot run here; what surrounds them can: the view of x
that the RMSNorm kernel reads (no copy for the fused branch's strided qk
view), the plans that cut the work (every row, every (K chunk, column tile)
exactly once), the route rule, and the stream's arithmetic, split over K as
the plan splits it and summed in the kernel's fixed order, against the
Pallas kernel in interpret mode. Tolerances: 1e-5 in fp32; one bf16
rounding (2^-7 of the value) where the result is bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from molly_tpu.ops import norms as jnorms
from molly_tpu.ops import quant as jquant
from molly_tpu.ops.rmsnorm_pallas import rms_norm_pallas
from molly_tpu_torch.ops import quant, rmsnorm_triton
from molly_tpu_torch.ops.norms import rms_norm

ATOL = 1e-5
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _fused_qk_view(x_qkv, Nq, Nkv, Dh):
    """The fused decode branch's view (``models/qwen3.py:_attn_inputs``):
    q and k heads of qkv [B, S, (Nq + 2 Nkv) Dh], as [B, S, Nq+Nkv, Dh]."""
    B, S, _ = x_qkv.shape
    return x_qkv[..., :(Nq + Nkv) * Dh].reshape(B, S, Nq + Nkv, Dh)


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL)
    else:
        assert (np.abs(got - ref) - BF16_REL * np.abs(ref)).max() <= 0


# ---------------------------------------------------------------- RMSNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False])
def test_rms_norm_over_the_fused_strided_view_matches_jax(dtype, stacked):
    """The stacked qk_norm (weight [Nq+Nkv, Dh]) against
    ``molly_tpu.ops.norms.rms_norm``, and a per-head 1-D weight against the
    Pallas kernel in interpret mode, both over the strided view; the
    kernel reads the view in place (no copy)."""
    rng = np.random.default_rng(11)
    B, S, Nq, Nkv, Dh = 2, 5, 4, 2, 16
    qkv = torch.from_numpy(_rand(rng, B, S, (Nq + 2 * Nkv) * Dh)).to(
        getattr(torch, dtype))
    qk = _fused_qk_view(qkv, Nq, Nkv, Dh)
    assert not qk.is_contiguous()
    assert rmsnorm_triton._row_strides(qk) == (B * S, Nq + Nkv,
                                               (Nq + 2 * Nkv) * Dh, Dh)
    w_shape = (Nq + Nkv, Dh) if stacked else (Dh,)
    w = torch.from_numpy(1.0 + _rand(rng, *w_shape, scale=0.1)).to(
        getattr(torch, dtype))
    got = rms_norm(qk, w, 1e-6)
    assert got.shape == qk.shape and got.dtype == qk.dtype
    jx = jnp.asarray(qk.float().numpy()).astype(dtype)
    jw = jnp.asarray(w.float().numpy()).astype(dtype)
    ref = (jnorms.rms_norm(jx, jw, 1e-6) if stacked
           else rms_norm_pallas(jx, jw, 1e-6))
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("case,copies", [
    ("contiguous_hidden", False),
    ("contiguous_heads", False),
    ("fused_qk_view", False),
    ("leading_rows_sliced", False),
    ("every_other_position", False),
    ("one_row", False),
    ("heads_transposed", True),
    ("last_dim_strided", True),
])
def test_row_strides_pin_which_views_copy(case, copies):
    """x is read as [outer, heads, H] through two strides: every view whose
    last stride is 1 and whose leading dims fold so is read where it lies
    (the strides address x's rows in C order); the rest are copied once,
    contiguous (no strides)."""
    base = torch.arange(2 * 6 * 3 * 32, dtype=torch.float32)
    x = {
        "contiguous_hidden": lambda: base.view(12, 96),
        "contiguous_heads": lambda: base.view(2, 6, 3, 32),
        "fused_qk_view": lambda: _fused_qk_view(base.view(2, 6, 96), 1, 1,
                                                32),
        "leading_rows_sliced": lambda: base.view(2, 6, 96)[:, 1:5],
        "every_other_position": lambda: base.view(2, 6, 3, 32)[:, ::2],
        "one_row": lambda: base[:32],
        "heads_transposed": lambda: base.view(2, 6, 3, 32).transpose(1, 2),
        "last_dim_strided": lambda: base.view(12, 3, 32)[..., ::2],
    }[case]()
    fold = rmsnorm_triton._row_strides(x)
    assert (fold is None) is copies
    if fold is not None:
        outer, heads, stride_o, stride_h = fold
        H = x.shape[-1]
        rows = torch.as_strided(x, (outer, heads, H), (stride_o, stride_h, 1))
        torch.testing.assert_close(rows.reshape(-1, H), x.reshape(-1, H),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("R", [1, 7, 128, 12288, 294912])
@pytest.mark.parametrize("H", [64, 128, 2048, 2560])
def test_rmsnorm_plan_covers_every_row_once(R, H):
    """Program p takes rows [p rows, (p + 1) rows): together the programs
    cover [0, R) once, the last one partly; a tile holds at most 8,192
    elements of the padded row (16 KB of bf16), a row of 1024 or more
    alone, 1 to 8 warps, and a call with rows to spare has at least two
    programs on each of 132 SMs."""
    rows, programs, warps = rmsnorm_triton.rmsnorm_plan(R, H, 132)
    assert rows >= 1 and rows & (rows - 1) == 0
    assert (programs - 1) * rows < R <= programs * rows
    starts = np.arange(programs) * rows
    ends = np.minimum(starts + rows, R)
    assert starts[0] == 0 and ends[-1] == R
    assert (starts[1:] == ends[:-1]).all() and (ends > starts).all()
    block = 1 << (H - 1).bit_length()
    assert rows * block <= max(8192, block)
    assert rows == 1 or block < 1024
    assert 1 <= warps <= 8
    assert programs >= min(R, 2 * 132)


# ---------------------------------------------------------------- int8 GEMV


@pytest.mark.parametrize("case,args,expected", [
    ("decode_lm_head", (4, 2048, 151936, torch.bfloat16, True), True),
    ("decode_down", (4, 6144, 2048, torch.bfloat16, True), True),
    ("one_row", (1, 2048, 4096, torch.bfloat16, True), True),
    ("sixteen_rows", (16, 2048, 2048, torch.bfloat16, True), True),
    ("smallest_k_and_n", (4, 64, 16, torch.bfloat16, True), True),
    ("seventeen_rows", (17, 2048, 2048, torch.bfloat16, True), False),
    ("no_rows", (0, 2048, 2048, torch.bfloat16, True), False),
    ("fp32_x", (4, 2048, 2048, torch.float32, True), False),
    ("k_not_a_multiple_of_64", (4, 2000, 2048, torch.bfloat16, True), False),
    ("n_not_a_multiple_of_16", (4, 2048, 2056, torch.bfloat16, True), False),
    ("unaligned_base", (4, 2048, 2048, torch.bfloat16, False), False),
])
def test_int8_takes_stream_rule(case, args, expected):
    """The decode route: bf16 x with 1 to 16 rows, K a multiple of 64, N of
    16, aligned bases (``csrc/int8_matmul_stream.cu``); everything else goes
    to the TMA kernel (more rows)
    or the SIMT GEMM. No shape takes both routes."""
    assert quant.int8_takes_stream(*args) is expected
    assert not (expected and quant.int8_takes_tma(*args))


# (K, N) of every M <= 16 int8 product on the main paths: 1.7B qkv, o,
# gate-up, down and the lm head; the MoE decoder's qkv and o
MAIN_PATH = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048),
             (2048, 151936), (2048, 5120), (4096, 2048)]


@pytest.mark.parametrize("K,N", MAIN_PATH + [(64, 16), (128, 272),
                                             (1024, 2064)])
def test_gemv_plan_covers_each_chunk_and_tile_once(K, N):
    """Block (split, tile) takes columns [128 tile, +128) and stages [split
    per, +per): every (64-deep K chunk, column tile) exactly once, no split
    left empty, at most 8 splits (one cluster), each split at least 4
    stages unless K has fewer; K is split only while the blocks stay within
    three quarters of the 132 SMs, and as far as that allows: one more
    split would pass that line, the cap of 8 or 4 stages a split; at the
    main path's shapes the blocks cover at least half the SMs."""
    tiles, splits, per = quant.gemv_plan(K, N, 132)
    stages = K // 64
    assert tiles == -(-N // 128) and 1 <= splits <= 8
    seen = np.zeros((stages, tiles), np.int64)
    for s in range(splits):
        lo, hi = s * per, min((s + 1) * per, stages)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert per >= min(4, stages)
    assert splits == 1 or tiles * splits <= 99
    assert (tiles * (splits + 1) > 99 or splits == 8
            or (splits + 1) * 4 > stages)
    if (K, N) in MAIN_PATH:  # the blocks cover at least half the SMs
        assert tiles * splits >= 66
    if (K, N) == (2048, 151936):
        assert splits == 1
    if (K, N) == (6144, 2048):
        assert (splits, per) == (6, 16)


def _stream_arithmetic(x, q, K, N, sm_count):
    """The weight stream's arithmetic in plain torch: each split's partial
    [M, N] in fp32 over its K chunk, the partials summed in split order 0 ..
    S-1, the per-column scale once, the cast to x's dtype."""
    _, splits, per = quant.gemv_plan(K, N, sm_count)
    xf, wf = x.float(), q["w_q"].float()
    acc = None
    for s in range(splits):
        k0, k1 = s * per * 64, min((s + 1) * per * 64, K)
        part = xf[:, k0:k1] @ wf[k0:k1]
        acc = part if acc is None else acc + part
    return (acc * q["scale"]).to(x.dtype), splits


@pytest.mark.parametrize("M", [1, 4, 8, 16])
def test_stream_split_arithmetic_matches_pallas_kernel(M, monkeypatch):
    """At a card of 16 SMs the plan splits K = 1024 four ways over 3 column
    tiles (the last partial); the split-and-sum arithmetic equals
    ``molly_tpu.ops.quant.int8_matmul``'s Pallas kernel (interpret mode,
    reached as on a TPU) in fp32, and in bf16 to one rounding."""
    monkeypatch.setenv("MOLLY_INT8_PALLAS", "1")
    monkeypatch.setattr(jquant.jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(60 + M)
    K, N = 1024, 272
    x = _rand(rng, M, K)
    qd = jquant.quantize_int8(jnp.asarray(_rand(rng, K, N, scale=0.05)))
    tq = {k: torch.from_numpy(np.array(v)) for k, v in qd.items()}
    got, splits = _stream_arithmetic(torch.from_numpy(x), tq, K, N, 16)
    assert splits == 4
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), qd))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got16, _ = _stream_arithmetic(xb, tq, K, N, 16)
    ref16 = np.asarray(jquant.int8_matmul(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), qd
    ).astype(jnp.float32))
    _close(got16.float().numpy(), ref16, "bfloat16")
    # the wrapper on the CPU runs the plain version: the same product
    np.testing.assert_allclose(quant.int8_matmul(torch.from_numpy(x),
                                                 tq).numpy(), ref,
                               atol=ATOL, rtol=1e-5)
