"""The expert adapters' weight gradient on the tensor cores and the RMSNorm
backward's plan, held against molly_tpu on the CPU.

The card kernels cannot run here; what surrounds them can: the route rules
that send a weight gradient with a bf16 lhs, an fp32 dout and an fp32
result (the expert adapters') to the tensor-core kernel and never to the
bf16 TMA kernel, the tile plan, the autograd backward that hands that bf16
lhs on without an fp32 copy, the MoE QLoRA gradients over fp32 expert
adapters against JAX's, and the RMSNorm backward's plan (every row once, a
bounded number of dw partials) with its arithmetic, summed in the kernel's
order, against the Pallas kernel in interpret mode. Tolerances are stated
at each assert.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from molly_tpu.ops import moe as jmoe
from molly_tpu.ops.rmsnorm_pallas import rms_norm_pallas
from molly_tpu_torch.ops import grouped_gemm as gg
from molly_tpu_torch.ops import moe, rmsnorm_triton

B16, F32 = torch.bfloat16, torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ the adapters' weight gradient

# (M, K, N, G, (lhs, dout, out dtypes), aligned?) -> the weight gradient
# goes to the tensor-core kernel. The first four are the MoE QLoRA step's
# at qwen3-30b-a3b width (LoRA A and B of the gate / up and of the down).
TGMM_TC_ROUTES = {
    "lora_a": ((32768, 2048, 64, 128, (B16, F32, F32), True), True),
    "lora_a_down": ((32768, 768, 64, 128, (B16, F32, F32), True), True),
    "lora_b": ((32768, 64, 768, 128, (B16, F32, F32), True), True),
    "lora_b_down": ((32768, 64, 2048, 128, (B16, F32, F32), True), True),
    "exactly_64_a_group": ((64 * 128, 2048, 64, 128, (B16, F32, F32), True),
                           True),
    "smallest_k_and_n": ((256, 8, 8, 4, (B16, F32, F32), True), True),
    "one_row_short_of_64_a_group": ((64 * 128 - 1, 2048, 64, 128,
                                     (B16, F32, F32), True), False),
    "true_fp32_lhs": ((32768, 2048, 64, 128, (F32, F32, F32), True), False),
    "transposed_product": ((32768, 64, 2048, 128, (F32, B16, F32), True),
                           False),
    "bf16_dout": ((32768, 2048, 64, 128, (B16, B16, F32), True), False),
    "bf16_out": ((32768, 2048, 768, 128, (B16, F32, B16), True), False),
    "k_not_a_multiple_of_8": ((32768, 2052, 64, 128, (B16, F32, F32), True),
                              False),
    "n_not_a_multiple_of_8": ((32768, 2048, 68, 128, (B16, F32, F32), True),
                              False),
    "unaligned_base": ((32768, 2048, 64, 128, (B16, F32, F32), False),
                       False),
}


@pytest.mark.parametrize("case", TGMM_TC_ROUTES)
def test_tgmm_tc_route_rule(case):
    """The tensor-core weight gradient's rule; the bf16 TMA kernel never
    takes what it takes."""
    args, takes = TGMM_TC_ROUTES[case]
    assert gg.tgmm_takes_tc(*args) is takes
    M, K, N, _, dtypes, aligned = args
    assert not (takes and gg.tgmm_takes_tma(M, K, N, dtypes, aligned))


@pytest.mark.parametrize("dtypes", [(B16, F32, F32), (F32, B16, F32),
                                    (F32, F32, F32)])
@pytest.mark.parametrize("M,K,N,G", [(32768, 2048, 64, 128),
                                     (32768, 64, 2048, 128),
                                     (300, 64, 128, 4), (494, 72, 200, 6)])
def test_fp32_weight_gradient_never_reaches_the_bf16_tma_kernel(dtypes, M, K,
                                                                N, G):
    """An fp32 result with an fp32 operand is an fp32 product: the bf16 TMA
    kernel would round that operand to bf16, so it never takes one, at any
    row count; a bf16 lhs with an fp32 dout goes to the tensor cores where
    the rows allow, else to the SIMT kernel over operands widened
    exactly."""
    assert not gg.tgmm_takes_tma(M, K, N, dtypes)
    assert gg.tgmm_takes_tc(M, K, N, G, dtypes) is (
        dtypes == (B16, F32, F32) and M >= 64 * G)


@pytest.mark.parametrize("K,N,plan", [(2048, 64, 0), (768, 64, 0),
                                      (64, 768, 1), (64, 2048, 1),
                                      (4096, 32, 0), (264, 8, 0),
                                      (72, 200, 1)])
def test_tgmm_tc_plan(K, N, plan):
    """A rank-64 dout (the A gradients) keeps all its columns in one tile
    against 256 lhs columns; a wider dout (the B gradients) 128 of its
    columns a tile against 64 lhs columns."""
    assert gg.tgmm_tc_plan(K, N) == plan


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_backward_hands_a_bf16_lhs_to_tgmm_unwidened(monkeypatch,
                                                     transpose_rhs):
    """The autograd backward of a bf16 lhs over an fp32 rhs passes the bf16
    lhs to tgmm as it is (no fp32 copy); on the CPU the plain version
    widens it exactly, so the gradient is the plain version over the lhs
    widened beforehand, bit for bit."""
    rng = np.random.default_rng(31)
    sizes = np.asarray([300, 0, 64, 140], np.int32)
    M, K, N = 512, 128, 96
    lhs = _t(rng.normal(size=(M, K)).astype(np.float32)).to(B16)
    shape = (4, N, K) if transpose_rhs else (4, K, N)
    rhs = _t((rng.normal(size=shape) * K ** -0.5).astype(np.float32))
    dout = _t(rng.normal(size=(M, N)).astype(np.float32))
    seen = []
    real = gg.grouped_gemm_tgmm

    def spy(a, b, group_sizes, out_dtype):
        seen.append((a.dtype, b.dtype, out_dtype))
        return real(a, b, group_sizes, out_dtype)

    monkeypatch.setattr(gg, "grouped_gemm_tgmm", spy)
    tl = lhs.clone().requires_grad_(True)
    tr = rhs.clone().requires_grad_(True)
    out = gg.grouped_gemm(tl, tr, _t(sizes), transpose_rhs=transpose_rhs)
    gl, gr = torch.autograd.grad(out, (tl, tr), dout)
    assert seen == [(F32, B16, F32) if transpose_rhs else (B16, F32, F32)]
    want = (gg.grouped_gemm_tgmm_plain(dout, lhs.float(), _t(sizes), F32)
            if transpose_rhs else
            gg.grouped_gemm_tgmm_plain(lhs.float(), dout, _t(sizes), F32))
    assert gr.dtype == F32 and torch.equal(gr, want)
    assert gl.dtype == B16


def test_moe_qlora_adapter_gradients_match_jax_without_widening(monkeypatch):
    """``moe_mlp`` over a bf16 stream, int8 expert stacks (frozen) and fp32
    expert adapters, as the MoE QLoRA step runs it: every weight gradient
    is an adapter's, takes its bf16 lhs unwidened and an fp32 dout into
    fp32 (the tensor-core route's dtypes), and the adapters' gradients
    agree with JAX's through the same bf16 stream within 1e-2 of each
    one's max (the stream rounds h and the output to bf16 on both sides,
    and an fp32 sum in another order can round an element of them to the
    other bf16 neighbour)."""
    rng = np.random.default_rng(32)
    T, H, I, E, r = 64, 32, 64, 4, 8

    def w(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    x, router = rng.normal(size=(T, H)).astype(np.float32), w(H, E)
    stacks = [w(E, H, I), w(E, H, I), w(E, I, H)]
    dims = {"expert_gate": (H, I), "expert_up": (H, I),
            "expert_down": (I, H)}
    lora = {t: {"a": (rng.normal(size=(E, di, r)) / r).astype(np.float32),
                "b": (rng.normal(size=(E, r, do)) * 0.05).astype(np.float32)}
            for t, (di, do) in dims.items()}
    c = rng.normal(size=(T, H)).astype(np.float32)
    names = sorted(lora)
    kw = dict(num_experts_per_tok=2, lora_scale=2.0)

    def jloss(*ab):
        lo = {t: {"a": ab[2 * i], "b": ab[2 * i + 1]}
              for i, t in enumerate(names)}
        out, _ = jmoe.moe_mlp(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(router),
            *[jmoe.quantize_experts(jnp.asarray(s)) for s in stacks],
            lora=lo, **kw)
        return jnp.sum(out.astype(jnp.float32) * c)

    flat = [lora[t][k] for t in names for k in "ab"]
    ref = jax.grad(jloss, argnums=tuple(range(len(flat))))(
        *[jnp.asarray(v) for v in flat])

    seen = []
    real = gg.grouped_gemm_tgmm

    def spy(a, b, group_sizes, out_dtype):
        seen.append((a.dtype, b.dtype, out_dtype))
        return real(a, b, group_sizes, out_dtype)

    monkeypatch.setattr(gg, "grouped_gemm_tgmm", spy)
    tv = [_t(v).requires_grad_(True) for v in flat]
    lo = {t: {"a": tv[2 * i], "b": tv[2 * i + 1]}
          for i, t in enumerate(names)}
    out, _ = moe.moe_mlp(_t(x).to(B16), _t(router),
                         *[moe.quantize_experts(_t(s)) for s in stacks],
                         lora=lo, **kw)
    got = torch.autograd.grad((out.float() * _t(c)).sum(), tv)
    assert seen == [(B16, F32, F32)] * 6
    for i, (g, rg) in enumerate(zip(got, ref)):
        rg = np.asarray(rg)
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), rg,
                                   atol=1e-2 * np.abs(rg).max(),
                                   err_msg=names[i // 2] + "ab"[i % 2])


# ------------------------------------------------ the RMSNorm backward's plan


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("R", [1, 7, 300, 4096, 16384, 131072])
@pytest.mark.parametrize("H", [64, 128, 2048, 2560])
def test_rmsnorm_bwd_plan_covers_every_row_once(R, H, need_dw):
    """Tile t holds rows [t rows, (t + 1) rows) and program p takes tiles
    p, p + programs, ...: every row of [0, R) once, every program at least
    one tile; a tile at most 8,192 elements of the padded row (one row if
    wider), 1 to 8 warps, 1 to 4 tiles' loads in flight; with dw at most
    one program (dw partial row) an SM of a 132-SM card whatever R,
    without at most four."""
    rows, tiles, programs, warps, stages = rmsnorm_triton.rmsnorm_bwd_plan(
        R, H, 132, need_dw)
    assert rows >= 1 and rows & (rows - 1) == 0
    assert (tiles - 1) * rows < R <= tiles * rows
    assert 1 <= programs <= min(tiles, (1 if need_dw else 4) * 132)
    assert 1 <= stages <= 4
    taken = np.zeros(R, np.int64)
    for p in range(programs):
        mine = range(p, tiles, programs)
        assert len(mine) >= 1
        for t in mine:
            taken[t * rows:min((t + 1) * rows, R)] += 1
    assert (taken == 1).all()
    block = 1 << (H - 1).bit_length()
    assert rows * block <= max(8192, block)
    assert 1 <= warps <= 8
    assert tiles >= min(R, 2 * 132)


@pytest.fixture
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("shape,sms", [((300, 128), 4), ((4, 50, 3, 128), 2),
                                       ((37, 256), 132), ((12, 2048), 1)])
def test_rmsnorm_bwd_in_the_kernels_order_matches_pallas(_interpret_mode,
                                                         shape, sms):
    """The backward as the kernels compute it, from the plan: each
    program's dw partial a [rows, H] tile summed over its tiles in order and
    over its rows at the end, the partials summed by the second kernel;
    dx row by row. Against the Pallas kernel's gradient (interpret mode) in
    fp32: 1e-5 of each result's max (another summation order)."""
    rng = np.random.default_rng(33)
    H = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(H,))).astype(np.float32)
    rdx, rdw = jax.vjp(lambda a, b: rms_norm_pallas(a, b, 1e-6),
                       jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g))

    rows, tiles, programs, _, _ = rmsnorm_triton.rmsnorm_bwd_plan(
        x.size // H, H, sms)
    x2, g2 = _t(x.reshape(-1, H)), _t(g.reshape(-1, H))
    inv = torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + 1e-6)
    xhat = x2 * inv
    wg = _t(w) * g2
    dx = (wg - xhat * (wg * xhat).sum(-1, keepdim=True) / H) * inv
    partials = torch.zeros((programs, H))
    for p in range(programs):
        acc = torch.zeros((rows, H))
        for t in range(p, tiles, programs):
            part = (g2 * xhat)[t * rows:(t + 1) * rows]
            acc[:part.shape[0]] += part
        partials[p] = acc.sum(0)
    dw = partials.sum(0)
    for got, ref in ((dx.reshape(shape), rdx), (dw, rdw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())
    got_dx, got_dw = rmsnorm_triton.rms_norm_bwd(_t(x), _t(w), _t(g), 1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(rdx),
                               atol=1e-5 * np.abs(np.asarray(rdx)).max())
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(rdw),
                               atol=1e-5 * np.abs(np.asarray(rdw)).max())
