"""The MoE slice of molly_tpu_torch held against molly_tpu on the CPU, in
fp32, at a tiny size (4 experts, top-2, 2 layers), from the same numpy
inputs: the grouped GEMMs' plain versions (forward, transposed, tgmm)
against ``jax.lax.ragged_dot`` and against ``megablox.gmm`` run through the
Pallas interpreter; the router, ``moe_mlp`` (unfused, fused, int8 experts,
expert LoRA) with its aux losses and gradients; the MoE decoder (logits,
cached decode, greedy tokens, int8 experts, both serving engines); one train
step in three regimes; ``merge_lora`` over expert adapters; and both CLIs
with ``--moe-experts 4 --moe-topk 2``. Each tolerance is stated at its
assert. On the CPU every wrapper runs its kernel's plain version, so the
arithmetic that the CUDA kernels are held to on a card is what is checked
here.

``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk`` does
not promise to; with real-valued random weights no two router probabilities
tie, so the chosen experts agree.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.inference import engine as jengine
from molly_tpu.inference.paged import PagedServingEngine as JPagedEngine
from molly_tpu.inference.server import ServingEngine as JServingEngine
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import lora as jlora
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm as jtiny_esm
from molly_tpu.models import tiny_moe as jtiny_moe
from molly_tpu.models.fusion import FusionConfig as JFusionConfig
from molly_tpu.ops import moe as jmoe
from molly_tpu.training import trainer as jtrainer
from molly_tpu_torch.inference import cli, engine
from molly_tpu_torch.inference.paged import PagedServingEngine
from molly_tpu_torch.inference.server import ServingEngine
from molly_tpu_torch.models import configs as tcfg
from molly_tpu_torch.models import fusion, lora, qwen3
from molly_tpu_torch.models.convert import params_from_jax
from molly_tpu_torch.ops import grouped_gemm as gg
from molly_tpu_torch.ops import moe
from molly_tpu_torch.training import trainer
from test_torch_models import _fusion_batch, _fusion_setup, _np_tree, _tcfg_of
from test_torch_serving import (assert_same_run, fusion_batch, greedy_gen,
                                text_batch)
from test_torch_training import (GRAD_RTOL, LOSS_ATOL, _both_tc, _jax_grads,
                                 _jbatch, _tbatch)

ATOL = 1e-5   # fp32 products of unit-scale operands, other summation order


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ grouped GEMMs

# an empty group, a one-row group and a group longer than a 128-row tile
SIZES = [100, 0, 1, 155]


def _gg_inputs(M=256, K=128, N=256, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = (rng.normal(size=(len(SIZES), K, N)) * K ** -0.5).astype(np.float32)
    dout = rng.normal(size=(M, N)).astype(np.float32)
    return lhs, rhs, dout, np.asarray(SIZES, np.int32)


@pytest.fixture
def backend(request):
    """The JAX package's grouped-GEMM backend: ragged_dot (its default), or
    megablox.gmm, which ``_grouped_dot`` runs in interpret mode off the
    TPU."""
    jmoe.set_moe_gemm_impl(request.param)
    try:
        yield request.param
    finally:
        jmoe.set_moe_gemm_impl("ragged")


@pytest.mark.parametrize("backend", ["ragged", "gmm"], indirect=True)
def test_grouped_gemm_forward_matches_jax(backend):
    lhs, rhs, _, gs = _gg_inputs()
    ref = np.asarray(jmoe._grouped_dot(jnp.asarray(lhs), jnp.asarray(rhs),
                                       jnp.asarray(gs)))
    got = gg.grouped_gemm(_t(lhs), _t(rhs), _t(gs))
    assert got.dtype == torch.float32 and gg.grouped_gemm.launches == 0
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    plain = gg.grouped_gemm_plain(_t(lhs), _t(rhs), _t(gs))
    assert torch.equal(plain, got)   # the CPU wrapper IS the plain version


def _decode_sizes(M, G, seed):
    """Decode-shaped group sizes: M rows over at most half of G groups (the
    rest empty), and for M > 1 one row past the sum."""
    rng = np.random.default_rng(seed)
    owned = M - 1 if M > 1 else M
    groups = rng.choice(G, size=min(G // 2, owned), replace=False)
    sizes = np.zeros(G, np.int32)
    for r in range(owned):
        sizes[groups[r % len(groups)]] += 1
    return sizes


@pytest.mark.parametrize("backend", ["ragged", "gmm"], indirect=True)
@pytest.mark.parametrize("M", [1, 4, 32, 64])
@pytest.mark.parametrize("int8", [False, True])
def test_grouped_gemm_decode_shapes_match_jax(backend, M, int8):
    """The decode and serving route's shapes (M <= 64 rows over 8 groups,
    empty groups, a row past the sum), bf16-free so the plain versions are
    compared in fp32: bf16 experts as fp32, int8 experts with their scale,
    against ``_grouped_dot`` (ragged_dot, or megablox gmm in interpret mode,
    which pads its last group, so only the owned rows compare there). Rows
    past the sum are exact zeros."""
    G, K, N = 8, 128, 96
    rng = np.random.default_rng(M)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = (rng.normal(size=(G, K, N)) * K ** -0.5).astype(np.float32)
    gs = _decode_sizes(M, G, seed=M)
    owned = int(gs.sum())
    if int8:
        jrhs = jmoe.quantize_experts(jnp.asarray(rhs))
        q = moe.quantize_experts(_t(rhs))
        np.testing.assert_array_equal(q["w_q"].numpy(),
                                      np.asarray(jrhs["w_q"]))
        got = gg.grouped_gemm(_t(lhs), q["w_q"], _t(gs), scale=q["scale"])
    else:
        jrhs = jnp.asarray(rhs)
        got = gg.grouped_gemm(_t(lhs), _t(rhs), _t(gs))
    ref = np.asarray(jmoe._grouped_dot(jnp.asarray(lhs), jrhs,
                                       jnp.asarray(gs)))
    rows = M if backend == "ragged" else owned
    np.testing.assert_allclose(got.numpy()[:rows], ref[:rows], atol=ATOL)
    assert not got[owned:].any()
    assert gg.grouped_gemm.launches == gg.grouped_gemm.launches_stream == 0


@pytest.mark.parametrize("backend", ["ragged", "gmm"], indirect=True)
def test_grouped_gemm_gradients_match_jax(backend):
    """The autograd function's backward (the transposed product for lhs,
    tgmm for rhs) against JAX's gradients of the same product; megablox's
    VJP launches ``gmm`` with transpose_rhs and ``tgmm``."""
    lhs, rhs, dout, gs = _gg_inputs()

    def f(l, r):
        return jnp.sum(jmoe._grouped_dot(l, r, jnp.asarray(gs)) * dout)

    rl, rr = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = _t(lhs).requires_grad_(True), _t(rhs).requires_grad_(True)
    out = gg.grouped_gemm(tl, tr, _t(gs))
    gl, gr = torch.autograd.grad(out, (tl, tr), _t(dout))
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    # a group's weight gradient sums up to 155 rows: 1e-4
    np.testing.assert_allclose(gr.numpy(), np.asarray(rr), atol=1e-4)
    assert not gr[1].any()                      # the empty group: exact 0
    assert not np.asarray(rr)[1].any()          # ... in JAX too
    # a frozen rhs gets no gradient (and no tgmm call)
    (gl2,) = torch.autograd.grad(gg.grouped_gemm(tl, _t(rhs), _t(gs)), (tl,),
                                 _t(dout))
    assert torch.equal(gl2, gl)


def test_grouped_gemm_transposed_and_tgmm_plain():
    """The transposed product reads rhs [G, N, K] as the JAX lhs gradient
    does; tgmm against a per-group einsum; rows past the last group and an
    empty group give exact zeros; bf16 operands accumulate in fp32."""
    lhs, rhs, dout, gs = _gg_inputs(M=270)   # 14 rows that no group owns
    ref = np.asarray(jax.lax.ragged_dot(
        jnp.asarray(dout[:256]), jnp.swapaxes(jnp.asarray(rhs), 1, 2),
        jnp.asarray(gs)))
    got = gg.grouped_gemm(_t(dout), _t(rhs), _t(gs), transpose_rhs=True)
    np.testing.assert_allclose(got[:256].numpy(), ref, atol=ATOL)
    assert not got[256:].any()
    assert not gg.grouped_gemm(_t(lhs), _t(rhs), _t(gs))[256:].any()

    tg = gg.grouped_gemm_tgmm(_t(lhs), _t(dout), _t(gs), torch.float32)
    ends = np.cumsum(gs)
    for g, (a, b) in enumerate(zip(ends - gs, ends)):
        np.testing.assert_allclose(tg[g].numpy(), lhs[a:b].T @ dout[a:b],
                                   atol=1e-4)
    assert not tg[1].any()

    rows = gg.row_groups(_t(gs), 270).numpy()
    assert rows.tolist() == sum(([g] * n for g, n in enumerate(SIZES)),
                                []) + [4] * 14

    b16 = gg.grouped_gemm(_t(lhs).bfloat16(), _t(rhs).bfloat16(), _t(gs),
                          out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    exact = gg.grouped_gemm(_t(lhs).bfloat16().float(),
                            _t(rhs).bfloat16().float(), _t(gs))
    assert torch.equal(b16, exact.bfloat16())   # one rounding, at the end


B16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# (M, K, N, G, rhs dtype, scale?, aligned?) -> the forward goes to the TMA
# and wgmma kernel. The first five are what MoE prefill and training launch
# at qwen3-30b-a3b width (gate/up, down, their lhs gradients).
FORWARD_ROUTES = {
    "prefill_gate": ((98304, 2048, 768, 128, B16, False, True), True),
    "prefill_down": ((98304, 768, 2048, 128, B16, False, True), True),
    "train_forward": ((32768, 2048, 768, 128, B16, False, True), True),
    "train_dlhs_gate": ((32768, 768, 2048, 128, B16, False, True), True),
    "train_dlhs_down": ((32768, 2048, 768, 128, B16, False, True), True),
    "ragged_small": ((494, 64, 128, 6, B16, False, True), True),
    "decode": ((32, 2048, 768, 128, B16, False, True), False),
    "serving_tick": ((64, 2048, 768, 128, B16, False, True), False),
    "one_row_short_of_64_a_group": ((64 * 128 - 1, 2048, 768, 128, B16,
                                    False, True), False),
    "int8_experts": ((98304, 2048, 1536, 128, I8, True, True), False),
    "int8_transposed": ((32768, 768, 2048, 128, I8, False, True), False),
    "fp32_rhs": ((32768, 2048, 64, 128, F32, False, True), False),
    "k_not_a_multiple_of_64": ((32768, 2048 + 32, 768, 128, B16, False,
                               True), False),
    "n_not_a_multiple_of_8": ((32768, 2048, 772, 128, B16, False, True),
                              False),
    "unaligned_base": ((32768, 2048, 768, 128, B16, False, False), False),
}
# (M, K, N, (lhs, dout, out dtypes), aligned?) -> tgmm goes there
TGMM_ROUTES = {
    "train_gate": ((32768, 2048, 768, (B16, F32, B16), True), True),
    "train_down": ((32768, 768, 2048, (B16, F32, B16), True), True),
    "bf16_dout": ((32768, 2048, 768, (B16, B16, B16), True), True),
    "transposed_product": ((32768, 2048, 768, (F32, B16, B16), True), True),
    "ragged_small_fp32_out": ((494, 64, 128, (B16, B16, F32), True), True),
    "all_fp32": ((32768, 2048, 64, (F32, F32, F32), True), False),
    "k_not_a_multiple_of_8": ((494, 68, 128, (B16, B16, B16), True), False),
    "n_not_a_multiple_of_8": ((494, 64, 132, (B16, B16, B16), True), False),
    "unaligned_base": ((494, 64, 128, (B16, B16, B16), False), False),
}


@pytest.mark.parametrize("case", FORWARD_ROUTES)
def test_forward_route_rule(case):
    args, takes = FORWARD_ROUTES[case]
    assert gg.takes_tma(*args) is takes


@pytest.mark.parametrize("case", TGMM_ROUTES)
def test_tgmm_route_rule(case):
    args, takes = TGMM_ROUTES[case]
    assert gg.tgmm_takes_tma(*args) is takes


# (M, K, N, G, lhs dtype, rhs dtype, scale?, transposed?, aligned?) -> the
# forward goes to the split weight stream. The first five are what MoE
# decode and the serving tick launch at qwen3-30b-a3b width (gate, down,
# fused int8 gate-and-up, a serving prefill chunk of 4 x 16 tokens).
STREAM_ROUTES = {
    "decode_gate": ((32, 2048, 768, 128, B16, B16, False, False, True), True),
    "serving_gate": ((64, 2048, 768, 128, B16, B16, False, False, True),
                     True),
    "decode_down": ((32, 768, 2048, 128, B16, B16, False, False, True), True),
    "decode_gateup_int8": ((32, 2048, 1536, 128, B16, I8, True, False, True),
                           True),
    "serving_chunk": ((512, 2048, 768, 128, B16, B16, False, False, True),
                      True),
    "one_row": ((1, 2048, 768, 128, B16, B16, False, False, True), True),
    "one_row_short_of_64_a_group": ((64 * 128 - 1, 2048, 768, 128, B16, B16,
                                     False, False, True), True),
    "64_rows_a_group": ((64 * 128, 2048, 768, 128, B16, B16, False, False,
                         True), False),
    "int8_at_prefill": ((98304, 2048, 1536, 128, B16, I8, True, False, True),
                        False),
    "fp32_lhs": ((32, 2048, 768, 128, F32, B16, False, False, True), False),
    "fp32_rhs": ((32, 2048, 64, 128, B16, F32, False, False, True), False),
    "transposed": ((32, 768, 2048, 128, B16, B16, False, True, True), False),
    "int8_without_scale": ((32, 2048, 1536, 128, B16, I8, False, False,
                            True), False),
    "bf16_with_scale": ((32, 2048, 768, 128, B16, B16, True, False, True),
                        False),
    "k_not_a_multiple_of_64": ((32, 2048 + 32, 768, 128, B16, B16, False,
                                False, True), False),
    "n_not_a_multiple_of_8": ((32, 2048, 772, 128, B16, B16, False, False,
                               True), False),
    "int8_n_not_a_multiple_of_16": ((32, 2048, 1544, 128, B16, I8, True,
                                     False, True), False),
    "unaligned_base": ((32, 2048, 768, 128, B16, B16, False, False, False),
                       False),
    "no_rows": ((0, 2048, 768, 128, B16, B16, False, False, True), False),
}


@pytest.mark.parametrize("case", STREAM_ROUTES)
def test_stream_route_rule(case):
    """The split stream's rule, and that no call fits it and the TMA and
    wgmma kernel's rule both."""
    args, takes = STREAM_ROUTES[case]
    assert gg.takes_stream(*args) is takes
    M, K, N, G, _, rhs_dt, scale, _, aligned = args
    assert not (takes and gg.takes_tma(M, K, N, G, rhs_dt, scale, aligned))


# (M, K, N, G, lhs dtype, out dtype, scale?, transposed?, aligned?) -> the
# product over int8 experts goes to the int8 TMA kernel. The first five are
# what MoE prefill over int8 experts and a QLoRA step launch at
# qwen3-30b-a3b width (fused gate-and-up, down, their lhs gradients).
INT8_TMA_ROUTES = {
    "prefill_gateup": ((98304, 2048, 1536, 128, B16, F32, True, False, True),
                       True),
    "prefill_down": ((98304, 768, 2048, 128, B16, F32, True, False, True),
                     True),
    "qlora_gate": ((32768, 2048, 768, 128, B16, F32, True, False, True), True),
    "qlora_dlhs_gate": ((32768, 768, 2048, 128, B16, B16, False, True, True),
                        True),
    "qlora_dlhs_down": ((32768, 2048, 768, 128, B16, B16, False, True, True),
                        True),
    "fp32_lhs_into_bf16": ((32768, 768, 2048, 128, F32, B16, False, True,
                            True), True),
    "exactly_64_a_group": ((64 * 128, 2048, 768, 128, B16, F32, True, False,
                            True), True),
    "smallest_k_and_n": ((256, 64, 16, 4, B16, F32, True, False, True), True),
    "one_row_short_of_64_a_group": ((64 * 128 - 1, 2048, 768, 128, B16, F32,
                                     True, False, True), False),
    "transposed_one_row_short": ((64 * 128 - 1, 768, 2048, 128, B16, B16,
                                  False, True, True), False),
    "all_fp32": ((32768, 2048, 768, 128, F32, F32, True, False, True), False),
    "forward_without_scale": ((32768, 2048, 768, 128, B16, F32, False, False,
                               True), False),
    "transposed_with_scale": ((32768, 768, 2048, 128, B16, B16, True, True,
                               True), False),
    "k_not_a_multiple_of_64": ((32768, 2048 + 32, 768, 128, B16, F32, True,
                                False, True), False),
    "n_not_a_multiple_of_16": ((32768, 2048, 776, 128, B16, F32, True, False,
                                True), False),
    "transposed_k_not_of_64": ((32768, 768 + 32, 2048, 128, B16, B16, False,
                                True, True), False),
    "transposed_n_not_of_16": ((32768, 768, 2056, 128, B16, B16, False, True,
                                True), False),
    "unaligned_base": ((32768, 2048, 768, 128, B16, F32, True, False, False),
                       False),
}
# (M, K, N, G, lhs, rhs, out dtypes, scale?, transposed?, aligned?) -> the
# fp32 tensor-core kernels. The first six are the MoE QLoRA step's adapter
# products (rank 64: A and B forward, the lhs gradients of B and A).
F32_TC_ROUTES = {
    "lora_a": ((32768, 2048, 64, 128, B16, F32, F32, False, False, True),
               True),
    "lora_a_down": ((32768, 768, 64, 128, B16, F32, F32, False, False, True),
                    True),
    "lora_b": ((32768, 64, 768, 128, B16, F32, F32, False, False, True), True),
    "lora_b_down": ((32768, 64, 2048, 128, B16, F32, F32, False, False, True),
                    True),
    "lora_dlhs_b": ((32768, 768, 64, 128, F32, F32, B16, False, True, True),
                    True),
    "lora_dlhs_a": ((32768, 64, 2048, 128, F32, F32, B16, False, True, True),
                    True),
    "transposed_into_fp32": ((32768, 64, 2048, 128, F32, F32, F32, False,
                              True, True), True),
    "transposed_k_of_32": ((256, 32, 8, 4, F32, F32, F32, False, True, True),
                           True),
    "fp32_lhs_forward": ((300, 64, 128, 4, F32, F32, F32, False, False, True),
                         False),
    "bf16_out_forward": ((32768, 2048, 64, 128, B16, F32, B16, False, False,
                          True), False),
    "bf16_lhs_transposed": ((32768, 768, 64, 128, B16, F32, B16, False, True,
                             True), False),
    "one_row_short_of_64_a_group": ((64 * 128 - 1, 2048, 64, 128, B16, F32,
                                     F32, False, False, True), False),
    "forward_k_not_of_64": ((32768, 2048 + 32, 64, 128, B16, F32, F32, False,
                             False, True), False),
    "transposed_k_not_of_32": ((32768, 80, 64, 128, F32, F32, B16, False,
                                True, True), False),
    "n_not_a_multiple_of_8": ((32768, 2048, 68, 128, B16, F32, F32, False,
                               False, True), False),
    "bf16_rhs": ((32768, 2048, 64, 128, B16, B16, F32, False, False, True),
                 False),
    "with_scale": ((32768, 2048, 64, 128, B16, F32, F32, True, False, True),
                   False),
    "unaligned_base": ((32768, 2048, 64, 128, B16, F32, F32, False, False,
                        False), False),
}


@pytest.mark.parametrize("case", INT8_TMA_ROUTES)
def test_int8_tma_route_rule(case):
    """The int8 TMA kernel's rule; the bf16 TMA kernel and the split stream
    never take what it takes."""
    args, takes = INT8_TMA_ROUTES[case]
    assert gg.int8_takes_tma(*args) is takes
    M, K, N, G, lhs_dt, _, scale, trans, aligned = args
    assert not (takes and (
        gg.takes_tma(M, K, N, G, I8, scale, aligned) or gg.takes_stream(
            M, K, N, G, lhs_dt, I8, scale, trans, aligned)))


@pytest.mark.parametrize("case", F32_TC_ROUTES)
def test_f32_tc_route_rule(case):
    """The fp32 tensor-core kernels' rule; neither the bf16 TMA kernel nor
    the split stream takes what it takes (the int8 rule is asked only for
    an int8 rhs)."""
    args, takes = F32_TC_ROUTES[case]
    assert gg.f32_takes_tc(*args) is takes
    M, K, N, G, lhs_dt, rhs_dt, out_dt, scale, trans, aligned = args
    assert not (takes and (
        gg.takes_tma(M, K, N, G, rhs_dt, scale, aligned)
        or gg.takes_stream(M, K, N, G, lhs_dt, rhs_dt, scale, trans,
                           aligned)))


# at least 64 rows a group (the int8 TMA and fp32 tensor-core routes'
# shapes): uneven sizes, an empty group, 8 rows past the sum
WIDE_SIZES = np.asarray([300, 0, 64, 140], np.int32)


@pytest.mark.parametrize("backend", ["ragged", "gmm"], indirect=True)
def test_int8_experts_and_scale_gradient_match_jax_at_64_rows_a_group(
        backend):
    """A ``quantize_experts`` stack at the int8 TMA kernel's shapes
    (M 512 over 4 groups, K 128, N 96) against ``_grouped_dot`` over JAX's
    quantized dict: the forward, and the lhs gradient through the scale
    (the scale folded into dout, then the product over w_q transposed).
    megablox pads its last group, so only the owned rows compare there;
    rows past the sum are exact zeros here. ATOL forward; the gradient
    within the existing 1e-3 of its max."""
    M, K, N = 512, 128, 96
    G = len(WIDE_SIZES)
    rng = np.random.default_rng(12)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = (rng.normal(size=(G, K, N)) * K ** -0.5).astype(np.float32)
    dout = rng.normal(size=(M, N)).astype(np.float32)
    owned = int(WIDE_SIZES.sum())
    jq = jmoe.quantize_experts(jnp.asarray(rhs))
    q = moe.quantize_experts(_t(rhs))

    def f(x):
        y = jmoe._grouped_dot(x, jq, jnp.asarray(WIDE_SIZES))
        return jnp.sum(y[:owned] * dout[:owned]), y

    (_, ref), rg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(lhs))
    tl = _t(lhs).requires_grad_(True)
    got = moe._grouped_dot(tl, q, _t(WIDE_SIZES))
    (gl,) = torch.autograd.grad((got[:owned] * _t(dout[:owned])).sum(), tl)
    rows = M if backend == "ragged" else owned
    np.testing.assert_allclose(got.detach().numpy()[:rows],
                               np.asarray(ref)[:rows], atol=ATOL)
    assert not got[owned:].any() and not gl[owned:].any()
    rg = np.asarray(rg)[:rows]
    np.testing.assert_allclose(gl.numpy()[:rows], rg,
                               atol=1e-3 * np.abs(rg).max())
    assert gg.grouped_gemm.launches == gg.grouped_gemm.launches_int8_tma == 0


@pytest.mark.parametrize("backend", ["ragged", "gmm"], indirect=True)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_grouped_matches_jax_at_64_rows_a_group(backend, dtype):
    """The expert adapters' bypass, ``_lora_grouped`` (A then B, rank 16,
    scale 2), at the fp32 tensor-core route's shapes against JAX's: an fp32
    or a bf16 activation stream (bf16: handed to the grouped GEMM as it is,
    where JAX promotes it; the same fp32 product), M 512 over 4 groups with
    one empty and 8 rows past the sum. The output within ATOL, the
    gradients of the activations and of both adapters within the existing
    1e-3 of each one's max; only owned rows compare under megablox, which
    pads its last group."""
    M, K, N, r = 512, 128, 96, 16
    G = len(WIDE_SIZES)
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(M, K)).astype(np.float32)
    a = (rng.normal(size=(G, K, r)) / r).astype(np.float32)
    b = (rng.normal(size=(G, r, N)) * 0.05).astype(np.float32)
    c = rng.normal(size=(M, N)).astype(np.float32)
    owned = int(WIDE_SIZES.sum())
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x, wa, wb):
        y = jmoe._lora_grouped(x, {"a": wa, "b": wb},
                               jnp.asarray(WIDE_SIZES), 2.0)
        return jnp.sum(y[:owned] * c[:owned]), y

    (_, ref), rgs = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xs).astype(jdt), jnp.asarray(a), jnp.asarray(b))
    tx = _t(xs).to(tdt).requires_grad_(True)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    got = moe._lora_grouped(tx, {"a": ta, "b": tb}, _t(WIDE_SIZES), 2.0)
    tgs = torch.autograd.grad((got[:owned] * _t(c[:owned])).sum(),
                              (tx, ta, tb))
    rows = M if backend == "ragged" else owned
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy()[:rows],
                               np.asarray(ref)[:rows], atol=ATOL)
    for i, (g, rg) in enumerate(zip(tgs, rgs)):
        rg = np.asarray(rg.astype(jnp.float32))
        if i == 0:
            assert g.dtype == tdt
            g, rg = g[:rows], rg[:rows]
        np.testing.assert_allclose(g.float().numpy(), rg,
                                   atol=1e-3 * np.abs(rg).max(),
                                   err_msg=str(i))
    assert gg.grouped_gemm.launches == gg.grouped_gemm.launches_tc == 0


def _active_groups(sizes, M):
    """(group, first row, end row) of every group that owns rows, with the
    sizes clipped to M rows as every kernel clips them."""
    out, row = [], 0
    for g, s in enumerate(sizes):
        end = min(row + s, M)
        if end > row:
            out.append((g, row, end))
        row = end
    return out


def _plan_sizes(rng, M, G):
    """Group sizes a plan must hold for: none active, every row in one
    group, rows spread over as many groups as can have them (rows past the
    sum), and three random draws (some summing past M)."""
    yield [0] * G
    one = [0] * G
    one[G - 1] = M
    yield one
    spread = [0] * G
    for r in range(M - 1 if M > 1 else M):
        spread[r % G] += 1
    yield spread
    for _ in range(3):
        yield rng.multinomial(max(0, M + int(rng.integers(-2, 3))),
                              rng.dirichlet(np.ones(G) * 0.3)).tolist()


@pytest.mark.parametrize("M", [1, 4, 32, 64])
@pytest.mark.parametrize("G", [8, 128])
@pytest.mark.parametrize("N", [768, 1536, 2048])
def test_stream_plan_covers_every_active_group(M, G, N):
    """``stream_plan`` is a pure function of shapes and the SM count. Walk
    its grid the way the kernel does (block (split, slot, tile) serves the
    slot-th group that has rows) for group sizes it never saw: every
    (active group, column tile) gets its splits' stages covering K's stages
    once each, in order, every split at least one stage, and the grid fits
    the card's resident blocks in one wave."""
    rng = np.random.default_rng(M * 1000 + G + N)
    for K in (768, 2048):
        for int8 in (False, True):
            plan = gg.stream_plan(M, K, N, G, 132, int8)
            slots, tiles, splits, per = plan
            assert plan == gg.stream_plan(M, K, N, G, 132, int8)
            stages = K // gg.STREAM_STAGE
            assert (tiles - 1) * gg.STREAM_COLS < N <= tiles * gg.STREAM_COLS
            assert 1 <= splits <= 8 and (splits - 1) * per < stages
            assert splits * per >= stages
            assert slots * tiles * splits <= max(
                slots * tiles, gg._STREAM_BLOCKS_PER_SM[int8] * 132)
            for sizes in _plan_sizes(rng, M, G):
                active = _active_groups(sizes, M)
                assert len(active) <= slots
                covered = {}
                for split in range(splits):
                    first = split * per
                    n_st = min(per, stages - first)
                    assert n_st >= 1
                    for slot in range(slots):
                        if slot >= len(active):
                            continue      # the block leaves at once
                        for tile in range(tiles):
                            covered.setdefault((active[slot][0], tile),
                                               []).append(
                                list(range(first, first + n_st)))
                assert set(covered) == {(g, t) for g, _, _ in active
                                        for t in range(tiles)}
                for ranges in covered.values():
                    assert sum(ranges, []) == list(range(stages))


def test_stream_plan_keeps_every_sm_busy_at_decode():
    """At the decode and serving shapes (qwen3-30b-a3b, 132 SMs) the plan
    gives at least one block to every SM, and splits K only while the whole
    grid still fits one wave of resident blocks."""
    for M, K, N, int8 in ((32, 2048, 768, False), (64, 2048, 768, False),
                          (32, 768, 2048, False), (32, 2048, 1536, True),
                          (32, 768, 2048, True), (64, 2048, 1536, True)):
        slots, tiles, splits, _ = gg.stream_plan(M, K, N, 128, 132, int8)
        blocks = slots * tiles * splits
        assert blocks >= 132
        assert splits == 1 or blocks <= gg._STREAM_BLOCKS_PER_SM[int8] * 132
    assert gg.stream_plan(32, 2048, 768, 128, 132) == (32, 6, 2, 16)


def test_cpu_backward_does_not_round_dout():
    """The card's bf16 route rounds an fp32 ``dout`` to bf16 once for both
    backward products. The CPU route must not: bf16 operands with an fp32
    ``dout`` give exactly the plain versions over the unrounded ``dout``,
    and an all-fp32 product is the plain version bit for bit."""
    lhs, rhs, dout, gs = _gg_inputs()
    assert not np.array_equal(_t(dout).bfloat16().float().numpy(), dout)
    for dt in (torch.bfloat16, torch.float32):
        tl = _t(lhs).to(dt).requires_grad_(True)
        tr = _t(rhs).to(dt).requires_grad_(True)
        out = gg.grouped_gemm(tl, tr, _t(gs))      # fp32 out: fp32 dout
        gl, gr = torch.autograd.grad(out, (tl, tr), _t(dout))
        assert gl.dtype == gr.dtype == dt
        assert torch.equal(gl, gg.grouped_gemm_plain(
            _t(dout), tr.detach(), _t(gs), transpose_rhs=True, out_dtype=dt))
        assert torch.equal(gr, gg.grouped_gemm_tgmm_plain(
            tl.detach(), _t(dout), _t(gs), dt))
    assert gg.grouped_gemm.launches == gg.grouped_gemm_tgmm.launches == 0
    assert gg.grouped_gemm.launches_tma == 0
    assert gg.grouped_gemm_tgmm.launches_tma == 0


def test_grouped_gemm_int8_scale_and_its_gradient():
    """An int8 rhs with per-(group, column) scales equals the dequantized
    product; the lhs gradient folds the scale into dout before the
    transposed product over w_q. 1e-5 of unit-scale values."""
    lhs, rhs, dout, gs = _gg_inputs()
    q = moe.quantize_experts(_t(rhs))
    jq = jmoe.quantize_experts(jnp.asarray(rhs))
    np.testing.assert_array_equal(q["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_allclose(q["scale"].numpy(), np.asarray(jq["scale"]),
                               rtol=1e-7)
    dense = q["w_q"].float() * q["scale"][:, None, :]
    tl = _t(lhs).requires_grad_(True)
    out = gg.grouped_gemm(tl, q["w_q"], _t(gs), scale=q["scale"])
    ref = gg.grouped_gemm(tl, dense, _t(gs))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL)
    (g1,) = torch.autograd.grad(out, (tl,), _t(dout))
    (g2,) = torch.autograd.grad(ref, (tl,), _t(dout))
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="scale"):
        gg.grouped_gemm(_t(lhs), q["w_q"], _t(gs))
    # [G, 1, N] scales (the shape quantize_int8 gives one expert) work too
    out3 = gg.grouped_gemm(_t(lhs), q["w_q"], _t(gs),
                           scale=q["scale"][:, None, :])
    assert torch.equal(out3, out.detach())


# ----------------------------------------------------------------- moe_mlp


def _mlp_inputs(T=48, H=32, I=64, E=4, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    return {"x": rng.normal(size=(T, H)).astype(np.float32),
            "router": w(H, E), "gate": w(E, H, I), "up": w(E, H, I),
            "down": w(E, I, H)}


def test_router_topk_matches_jax():
    d = _mlp_inputs()
    for norm in (True, False):
        ref = jmoe.router_topk(jnp.asarray(d["x"]), jnp.asarray(d["router"]),
                               2, norm)
        got = moe.router_topk(_t(d["x"]), _t(d["router"]), 2, norm)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # bf16 activations: the logits stay fp32 (never rounded to bf16)
    xb = _t(d["x"]).bfloat16()
    logits = moe.router_topk(xb, _t(d["router"]), 2)[3]
    exact = xb.float() @ _t(d["router"]).bfloat16().float()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), exact.numpy(), atol=1e-5)
    # ... and that product has a backward of its own (the card's mm with an
    # fp32 result has none): gradients in the operands' dtypes, within one
    # bf16 rounding (2^-8) of the fp32 product's
    xg, wg = xb.clone().requires_grad_(True), _t(d["router"]).requires_grad_(
        True)
    c = _t(np.random.default_rng(1).normal(size=logits.shape).astype(
        np.float32))
    gx, gw = torch.autograd.grad(
        (moe.router_topk(xg, wg, 2)[3] * c).sum(), (xg, wg))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    rx = c @ _t(d["router"]).bfloat16().float().T
    rw = xb.float().T @ c
    assert (gx.float() - rx).abs().max() <= 2 ** -8 * rx.abs().max()
    assert (gw - rw).abs().max() <= 2 ** -8 * rw.abs().max()


def _lora_np(d, r=4, seed=1):
    rng = np.random.default_rng(seed)
    E, H, I = d["gate"].shape
    dims = {"expert_gate": (H, I), "expert_up": (H, I), "expert_down": (I, H)}
    return {t: {"a": (rng.normal(size=(E, di, r)) / r).astype(np.float32),
                "b": (rng.normal(size=(E, r, do)) * 0.05).astype(np.float32)}
            for t, (di, do) in dims.items()}


def _variant(name, d, to):
    """(w_gate, w_up, w_down, lora) of a moe_mlp variant, built by ``to``
    (jnp.asarray or _t) from the same numpy arrays."""
    g, u, dn = d["gate"], d["up"], d["down"]
    ad = None
    if name == "fused":
        return to(np.concatenate([g, u], axis=-1)), None, to(dn), None
    if name == "lora":
        ad = {t: {k: to(v) for k, v in ab.items()}
              for t, ab in _lora_np(d).items()}
    return to(g), to(u), to(dn), ad


@pytest.mark.parametrize("variant", ["unfused", "fused", "int8", "lora"])
def test_moe_mlp_matches_jax(variant):
    """Output and both aux losses against molly_tpu.ops.moe.moe_mlp: 1e-5."""
    d = _mlp_inputs()
    jw = _variant(variant, d, jnp.asarray)
    tw = _variant(variant, d, _t)
    if variant == "int8":
        jw = tuple(jmoe.quantize_experts(w) for w in jw[:3]) + (None,)
        tw = tuple(moe.quantize_experts(w) for w in tw[:3]) + (None,)
    kw = dict(num_experts_per_tok=2, lora_scale=2.0)
    ref, raux = jmoe.moe_mlp(jnp.asarray(d["x"]), jnp.asarray(d["router"]),
                             *jw[:3], lora=jw[3], **kw)
    got, taux = moe.moe_mlp(_t(d["x"]), _t(d["router"]), *tw[:3], lora=tw[3],
                            **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert set(taux) == set(raux) == {"load_balance", "router_z"}
    for k in raux:
        np.testing.assert_allclose(float(taux[k]), float(raux[k]), rtol=1e-5)
    # the decode path asks for no aux losses and gets the same output
    again, none = moe.moe_mlp(_t(d["x"]), _t(d["router"]), *tw[:3],
                              lora=tw[3], with_aux=False, **kw)
    assert none is None and torch.equal(again, got)
    if variant in ("unfused", "fused"):   # the port's own dense oracle
        oracle = moe.moe_mlp_reference(
            _t(d["x"]), _t(d["router"]), _t(d["gate"]), _t(d["up"]),
            _t(d["down"]), num_experts_per_tok=2)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("variant", ["unfused", "lora"])
def test_moe_mlp_gradients_match_jax(variant):
    """Gradients of sum(out * c) + load_balance + router_z w.r.t. x, the
    router, the three stacks and (lora) every adapter: 1e-3 of each
    gradient's max-abs."""
    d = _mlp_inputs()
    rng = np.random.default_rng(5)
    c = rng.normal(size=d["x"].shape).astype(np.float32)
    names = ["x", "router", "gate", "up", "down"]
    ad = _lora_np(d) if variant == "lora" else {}
    flat = [d[n] for n in names] + [ad[t][k] for t in sorted(ad)
                                    for k in "ab"]

    def unflat(vals):
        base = dict(zip(names, vals[:5]))
        it = iter(vals[5:])
        lo = {t: {k: next(it) for k in "ab"} for t in sorted(ad)} or None
        return base, lo

    def jloss(*vals):
        b, lo = unflat(vals)
        out, aux = jmoe.moe_mlp(b["x"], b["router"], b["gate"], b["up"],
                                b["down"], num_experts_per_tok=2, lora=lo,
                                lora_scale=2.0)
        return jnp.sum(out * c) + aux["load_balance"] + aux["router_z"]

    ref = jax.grad(jloss, argnums=tuple(range(len(flat))))(
        *[jnp.asarray(v) for v in flat])
    tv = [_t(v).requires_grad_(True) for v in flat]
    b, lo = unflat(tv)
    out, aux = moe.moe_mlp(b["x"], b["router"], b["gate"], b["up"], b["down"],
                           num_experts_per_tok=2, lora=lo, lora_scale=2.0)
    loss = (out * _t(c)).sum() + aux["load_balance"] + aux["router_z"]
    got = torch.autograd.grad(loss, tv)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-3 * np.abs(r).max(),
                                   err_msg=str(i))


def test_moe_single_expert_top1_equals_dense_swiglu():
    d = _mlp_inputs(E=1)
    x = _t(d["x"])
    out, aux = moe.moe_mlp(x, _t(d["router"]), _t(d["gate"]), _t(d["up"]),
                           _t(d["down"]), num_experts_per_tok=1)
    dense = (torch.nn.functional.silu(x @ _t(d["gate"][0]))
             * (x @ _t(d["up"][0]))) @ _t(d["down"][0])
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL)
    assert abs(float(aux["load_balance"]) - 1.0) < 1e-6


# -------------------------------------------------------------- the decoder


def moe_setup():
    """The JAX MoE serving test's tiny fusion config (tiny_moe: 4 experts,
    top-2, 2 layers, hidden 32) with numpy-seeded weights wide enough that
    greedy tokens vary: (JAX config, JAX params, port config, port
    params)."""
    cfg = JFusionConfig(
        text=jtiny_moe(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=8),
        dna_rna=jtiny_esm(vocab_size=16), protein=jtiny_esm(vocab_size=20),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    tree = _np_tree(jfusion.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    text = tree["text"]
    text["embed"] = rng.normal(size=text["embed"].shape).astype(np.float32)
    for name, w in text["layers"].items():
        if w.ndim >= 3:  # the stacked linears and expert stacks
            text["layers"][name] = (rng.normal(size=w.shape) *
                                    w.shape[-2] ** -0.5).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return cfg, jparams, _tcfg_of(cfg), params_from_jax(tree)


@pytest.fixture(scope="module")
def setup():
    return moe_setup()


def test_tiny_moe_config_and_init_params_match_jax():
    assert dataclasses.asdict(tcfg.tiny_moe(vocab_size=99)) == \
        dataclasses.asdict(jtiny_moe(vocab_size=99))
    cfg = tcfg.tiny_moe()
    p = qwen3.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jqwen3.init_params(jtiny_moe(), jax.random.key(0))
    assert list(p["layers"]) == list(ref["layers"])   # names, in order
    for name, w in p["layers"].items():
        r = ref["layers"][name]
        assert tuple(w.shape) == r.shape and str(w.dtype).endswith(
            str(r.dtype)), name
    assert p["layers"]["router"].dtype == torch.float32
    assert abs(float(p["layers"]["expert_up"].std()) - 0.02) < 2e-3


def test_moe_decoder_logits_aux_and_cached_decode(setup):
    cfg, jp, tc, tp = setup
    rng = np.random.default_rng(2)
    B, S = 2, 10
    ids = rng.integers(1, 64, (B, S)).astype(np.int32)
    jh, jaux = jqwen3.forward_hidden(jp["text"], cfg.text,
                                     input_ids=jnp.asarray(ids))
    th, taux = qwen3.forward_hidden(tp["text"], tc.text, input_ids=_t(ids))
    ref = np.asarray(jqwen3.logits_from_hidden(jp["text"], cfg.text, jh))
    full = qwen3.logits_from_hidden(tp["text"], tc.text, th).numpy()
    np.testing.assert_allclose(full, ref, atol=1e-4)
    assert set(taux) == {"moe_aux"}
    for k in ("load_balance", "router_z"):   # the mean over the layers
        np.testing.assert_allclose(float(taux["moe_aux"][k]),
                                   float(jaux["moe_aux"][k]), rtol=1e-5)
    # prefill S-1 tokens then decode the last one through the cache: the
    # same logits, and no aux losses are computed on that path
    cache = qwen3.init_cache(tc.text, B, 16)
    _, cache = qwen3.forward_hidden(tp["text"], tc.text,
                                    input_ids=_t(ids[:, :-1]), cache=cache,
                                    cache_index=0)
    mask = torch.zeros((B, 16), dtype=torch.int32)
    mask[:, :S] = 1
    h1, c1 = qwen3.forward_hidden(tp["text"], tc.text,
                                  input_ids=_t(ids[:, -1:]), cache=cache,
                                  cache_index=S - 1, attention_mask=mask)
    assert "moe_aux" not in c1 and "kv" in c1
    last = qwen3.logits_from_hidden(tp["text"], tc.text, h1).numpy()[:, 0]
    np.testing.assert_allclose(last, ref[:, -1], atol=1e-4)


def test_moe_greedy_generate_token_exact(setup):
    cfg, jp, tc, tp = setup
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in {
        **fusion_batch(S=14, seed=3)}.items()}
    batch["input_ids"][1] = text_batch(14, 9)["input_ids"][0]
    gen = greedy_gen(8)
    ref = np.asarray(jengine.generate(jp, cfg, _jbatch(batch), gen,
                                      jax.random.key(0)))
    got = engine.generate(tp, tc, batch, _tcfg_of(gen))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(ref.reshape(-1).tolist())) > 2   # the rows differ


def _assert_same_tree(got, ref):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, a), (_, t) in zip(flat_ref, flat_got):
        assert tuple(t.shape) == a.shape, path
        np.testing.assert_allclose(t.numpy(), a, rtol=1e-7, atol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("how", ["plain", "decode_int8", "decode_fused",
                                 "training_int8"])
def test_moe_trees_cross_and_quantize_like_jax(setup, how):
    """An MoE tree crosses ``params_from_jax`` unchanged (4-D stacks,
    {w_q, scale} dicts), and the port's own quantizers build the same tree
    from the plain one: same names, shapes, int8 values and scales."""
    cfg, jp, tc, tp = setup
    jtext = {"plain": lambda p: p,
             "decode_int8": lambda p: jqwen3.quantize_for_decode(
                 p, cfg.text, moe_experts=True),
             "decode_fused": lambda p: jqwen3.quantize_for_decode(p, cfg.text),
             "training_int8": lambda p: jqwen3.quantize_for_training(
                 p, cfg.text)}[how](jp["text"])
    ref = _np_tree(jtext)
    _assert_same_tree(params_from_jax(ref), ref)
    text = dict(tp["text"], layers=dict(tp["text"]["layers"]))
    got = {"plain": lambda p: p,
           "decode_int8": lambda p: qwen3.quantize_for_decode(
               p, tc.text, moe_experts=True),
           "decode_fused": lambda p: qwen3.quantize_for_decode(p, tc.text),
           "training_int8": lambda p: qwen3.quantize_for_training(
               p, tc.text)}[how](text)
    _assert_same_tree(got, ref)
    if how == "decode_int8":
        lay = got["layers"]
        assert lay["expert_gateup"]["w_q"].shape == (2, 4, 32, 128)
        assert lay["expert_gateup"]["scale"].shape == (2, 4, 128)
        assert lay["router"].dtype == torch.float32
        assert "expert_gate" not in lay and "expert_gate" in text["layers"]
        # donate=True releases the source leaves of the caller's tree
        qwen3.quantize_for_decode(text, tc.text, moe_experts=True,
                                  donate=True)
        assert not any(n in text["layers"] for n in qwen3.EXPERT_STACKS)


def test_moe_int8_experts_logits_and_generate(setup):
    """``quantize_for_decode(moe_experts=True)``: logits within 2e-2 of
    their max of the JAX package's int8 path (its non-TPU int8_matmul rounds
    the activations to bf16 first, the port multiplies them as given), and
    within 1e-4 of the port's own dequantized experts; greedy generation
    runs on the fused int8 stacks."""
    cfg, jp, tc, tp = setup
    ids = np.random.default_rng(4).integers(1, 64, (2, 12)).astype(np.int32)
    jq = jqwen3.quantize_for_decode(jp["text"], cfg.text, moe_experts=True)
    ref = np.asarray(jqwen3.forward_logits(jq, cfg.text,
                                           input_ids=jnp.asarray(ids)))
    tq = qwen3.quantize_for_decode(tp["text"], tc.text, moe_experts=True)
    got = qwen3.forward_logits(tq, tc.text, input_ids=_t(ids)).numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    deq = dict(tq, layers={
        k: (v["w_q"].float() * v["scale"][..., None, :]
            if k.startswith("expert_") else v)
        for k, v in tq["layers"].items()})
    same = qwen3.forward_logits(deq, tc.text, input_ids=_t(ids)).numpy()
    np.testing.assert_allclose(got, same, atol=1e-4)
    toks = engine.generate({**tp, "text": tq}, tc,
                           {"input_ids": ids,
                            "attention_mask": np.ones_like(ids)},
                           _tcfg_of(greedy_gen(4)))
    assert toks.shape == (2, 4)


def _serve_specs():
    specs = [(i, text_batch(s, 20 + i), {}) for i, s in
             enumerate([5, 12, 9, 15])]
    return specs + [(4, fusion_batch(S=14, seed=3), {})]


def test_moe_serving_engine_token_exact(setup):
    """The dense ring serves the MoE decoder: results token-exact against
    the JAX engine, equal scheduler stats, slots reused (5 requests, 2
    slots)."""
    cfg, jp, tc, tp = setup
    gen = greedy_gen(6)
    kw = dict(n_slots=2, max_len=48, prefill_buckets=(16,), decode_chunk=4)
    assert_same_run(JServingEngine(jp, cfg, gen, **kw),
                    ServingEngine(tp, tc, _tcfg_of(gen), **kw),
                    _serve_specs())


def test_moe_paged_serving_engine_token_exact(setup):
    cfg, jp, tc, tp = setup
    gen = greedy_gen(6)
    kw = dict(n_slots=2, page_size=4, n_pages=16, prefill_buckets=(16,),
              decode_chunk=4)
    jeng = JPagedEngine(jp, cfg, gen, **kw)
    teng = PagedServingEngine(tp, tc, _tcfg_of(gen), **kw)
    assert_same_run(jeng, teng, _serve_specs())
    assert teng._free_pages == jeng._free_pages
    assert len(teng._free_pages) == teng.n_pages - teng._n_shared


# ---------------------------------------------------------------- training


def _moe_fusion_setup():
    cfg = _fusion_setup()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, num_experts_per_tok=2))


def _moe_batch(cfg, left_padded=False, **kw):
    """The fusion test batch, right-padded as training batches are, or
    ``left_padded`` as ``_fusion_batch`` makes it: then row 3's first six
    positions have no key to attend to. An MoE layer routes every row, so
    the load-balance term sees what attention gives such a position (both
    packages: the uniform mean over all keys)."""
    batch = _fusion_batch(cfg, **kw)
    if not left_padded:
        batch["attention_mask"][3, :6] = 1
        batch["attention_mask"][3, -6:] = 0
    return batch


def _moe_adapter(cfg, r, seed):
    """An adapter over the attention and expert targets with a non-zero B,
    so that A has a gradient."""
    rng = np.random.default_rng(seed)
    ad = jlora.init_lora(cfg.text, jlora.LoraConfig(r=r),
                         jax.random.key(seed))
    assert set(jlora.EXPERT_TARGETS) <= set(ad["layers"])
    return jax.tree.map(
        lambda x: jnp.asarray(x + 0.02 * rng.normal(size=x.shape).astype(
            np.float32)), ad)


def _moe_regime(name):
    cfg = _moe_fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(11))
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
              grad_clip=0.0)
    if name in ("lora", "qlora"):
        kw["lora"] = dict(r=4, alpha=8.0, dropout=0.0)
        jp = {**jp, "lora": _moe_adapter(cfg, 4, 5)}
    tp = params_from_jax(_np_tree(jp))
    if name == "qlora":
        # the exact reference is the JAX LoRA step over the DEQUANTIZED
        # base (its own CPU int8 path rounds the activations to bf16)
        q = jqwen3.quantize_for_training(jp["text"], cfg.text)
        dense = {k: (v["w_q"].astype(jnp.float32) * v["scale"][..., None, :]
                     if isinstance(v, dict) else v)
                 for k, v in q["layers"].items()}
        jp = {**jp, "text": {**jp["text"], "layers": dense}}
        tp["text"] = qwen3.quantize_for_training(tp["text"],
                                                 _tcfg_of(cfg.text))
        assert tp["text"]["layers"]["expert_down"]["w_q"].dtype == torch.int8
    jtc, ttc = _both_tc(**kw)
    return cfg, jp, jtc, tp, ttc


def test_left_padded_moe_batch_agrees_tensor_by_tensor(monkeypatch):
    """The same left-padded MoE batch through both packages on the CPU in
    fp32, stage by stage, each within 1e-5 of the reference (fp32 sums in
    another order; the first stage beyond it is reported): the embeddings,
    what each layer's attention hands its MoE block (positions without a
    key included), the block's output, each layer's load balance, and the
    decoder's output and aux losses."""
    cfg = _moe_fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(11))
    tp = params_from_jax(_np_tree(jp))
    batch = _moe_batch(cfg, left_padded=True, B=4, S=48, seed=4)
    assert not batch["attention_mask"][3, :6].any()
    jrec, trec = [], []
    jorig, torig = jmoe.moe_mlp, moe.moe_mlp

    def jpatched(x, *a, **kw):
        out, aux = jorig(x, *a, **kw)
        jax.debug.callback(
            lambda *v: jrec.append([np.asarray(t) for t in v]), x, out,
            aux["load_balance"])
        return out, aux

    def tpatched(x, *a, **kw):
        out, aux = torig(x, *a, **kw)
        trec.append([x.detach().numpy(), out.detach().numpy(),
                     aux["load_balance"].detach().numpy()])
        return out, aux

    monkeypatch.setattr(jmoe, "moe_mlp", jpatched)
    monkeypatch.setattr(moe, "moe_mlp", tpatched)
    jb, tb = _jbatch(batch), _tbatch(batch)
    je = jfusion.build_inputs_embeds(jp, cfg, jb)
    te = fusion.build_inputs_embeds(tp, _tcfg_of(cfg), tb)
    jh, jaux = jqwen3.forward_hidden(jp["text"], cfg.text, inputs_embeds=je,
                                     attention_mask=jb["attention_mask"])
    with torch.no_grad():
        th, taux = qwen3.forward_hidden(
            tp["text"], _tcfg_of(cfg).text, inputs_embeds=te,
            attention_mask=tb["attention_mask"])
    jax.effects_barrier()
    L = cfg.text.num_hidden_layers
    assert len(jrec) == len(trec) == L
    stages = [("embeddings", np.asarray(je), te.numpy())]
    for li in range(L):
        for name, j, t in zip(("MoE input", "MoE output", "load balance"),
                              jrec[li], trec[li]):
            stages.append((f"layer {li} {name}", j, t))
    stages += [("hidden", np.asarray(jh), th.numpy())] + [
        (k, np.asarray(jaux["moe_aux"][k]), taux["moe_aux"][k].numpy())
        for k in ("load_balance", "router_z")]
    for name, j, t in stages:
        err = np.abs(j.reshape(t.shape) - t).max()
        assert err <= 1e-5, f"first stage that differs: {name} ({err:.3e})"


@pytest.mark.parametrize("name", ["full", "lora", "qlora", "full-left-padded"])
def test_moe_one_step_loss_and_gradients_match_make_train_step(name):
    """Loss (1e-5), moe_load_balance (1e-5 relative) and every trainable
    gradient (1e-3 of its max-abs) of one step: full fine-tune (router and
    expert stacks train), expert LoRA, QLoRA over int8 experts; and the full
    fine-tune over a left-padded batch (positions without a key)."""
    name, _, padding = name.partition("-")
    cfg, jp, jtc, tp, ttc = _moe_regime(name)
    batch = _moe_batch(cfg, left_padded=bool(padding), B=4, S=48, seed=4)
    jstate = jtrainer.init_train_state(jp, jtc)
    jstate, jm = jtrainer.make_train_step(cfg, jtc)(
        jstate, _jbatch(batch), jax.random.key(0))
    ref = _jax_grads(jstate)

    trainer.init_train_state(tp, ttc)
    grads, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    paths = trainer.trainable_paths(tp, ttc)
    assert sorted(paths) == sorted(ref), (paths, sorted(ref))
    expert = [p for p in paths if "expert_" in p or p.endswith("router")]
    assert expert, paths
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(tm["moe_load_balance"]),
                               float(jm["moe_load_balance"]), rtol=1e-5)
    assert set(tm) == set(jm) - {"grad_norm", "skipped", "learning_rate"}
    for path, g in zip(paths, grads):
        r = ref[path]
        tol = GRAD_RTOL * max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(g.numpy(), r, atol=tol, err_msg=path)
        if path in expert:
            assert bool(g.any()), path
    np.testing.assert_allclose(float(trainer.global_norm(grads)),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_moe_grad_accumulation_averages_the_load_balance():
    cfg = _moe_fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(13))
    tp = params_from_jax(_np_tree(jp))
    jtc, ttc = _both_tc(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
                        grad_clip=0.0, accum_steps=2)
    batch = _moe_batch(cfg, B=4, S=48, seed=6)
    _, jm = jtrainer.make_train_step(cfg, jtc)(
        jtrainer.init_train_state(jp, jtc), _jbatch(batch),
        jax.random.key(0))
    trainer.init_train_state(tp, ttc)
    _, tm = trainer.make_grad_fn(_tcfg_of(cfg), ttc)(tp, _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(tm["moe_load_balance"]),
                               float(jm["moe_load_balance"]), rtol=1e-5)


@pytest.mark.parametrize("regime", ["full", "lora"])
def test_moe_remat_full_bit_equal_to_no_remat(regime):
    """The aux losses pass through ``checkpoint(_layer, ...)``: loss,
    moe_load_balance and every gradient equal bit for bit."""
    cfg, _, _, tp, ttc = _moe_regime(regime)
    tc = _tcfg_of(cfg)
    trainer.init_train_state(tp, ttc)
    batch = _tbatch(_moe_batch(cfg, B=4, S=32, seed=7))

    def grads(c):
        g, m = trainer.make_grad_fn(c, ttc)(tp, batch)
        return g, float(m["loss"]), float(m["moe_load_balance"])

    base = grads(tc)
    for kw in (dict(remat=True), dict(remat=True, remat_policy="attn")):
        got = grads(dataclasses.replace(
            tc, text=dataclasses.replace(tc.text, **kw)))
        assert got[1:] == base[1:]
        assert all(torch.equal(a, b) for a, b in zip(got[0], base[0]))
    assert any(bool(g.any()) for g in base[0])


@pytest.mark.parametrize("int8_base", [False, True])
def test_moe_merge_lora_matches_jax(int8_base):
    cfg = _moe_fusion_setup()
    jtext = jqwen3.init_params(cfg.text, jax.random.key(3))
    ad = _moe_adapter(cfg, 4, 6)
    if int8_base:
        jtext = jqwen3.quantize_for_training(jtext, cfg.text)
    ttext = params_from_jax(_np_tree(jtext))
    ref = jlora.merge_lora(jtext, ad, jlora.LoraConfig(r=4, alpha=8.0))
    got = lora.merge_lora(ttext, params_from_jax(_np_tree(ad)),
                          lora.LoraConfig(r=4, alpha=8.0))
    assert got["layers"]["expert_gate"].shape == (2, 4, 128, 256)
    for name in ad["layers"]:
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(ref["layers"][name]),
                                   atol=1e-6, err_msg=name)
    # and the merged experts compute what the bypass computes: 1e-4
    if not int8_base:
        ids = _t(np.random.default_rng(1).integers(1, 500, (2, 9)))
        tc = _tcfg_of(cfg.text)
        by = qwen3.forward_logits(ttext, tc, input_ids=ids,
                                  lora=params_from_jax(_np_tree(ad)),
                                  lora_scale=2.0)
        merged = qwen3.forward_logits(got, tc, input_ids=ids)
        np.testing.assert_allclose(merged.numpy(), by.numpy(), atol=1e-4)
    with pytest.raises(AssertionError, match="dense targets only"):
        lora.stack_adapters([params_from_jax(_np_tree(ad))])


# ---------------------------------------------------------------- the CLIs

MOE_FLAGS = ["--moe-experts", "4", "--moe-topk", "2"]


@pytest.mark.parametrize("flags", [
    [], ["--serve", "--serve-paged", "--page-size", "32", "--serve-chunk",
         "2"]], ids=["batch", "serve-paged"])
def test_moe_inference_cli_jsonl_matches_jax_cli(tmp_path, monkeypatch, flags):
    """Both inference CLIs with --tiny --moe-experts 4 --moe-topk 2 on the
    same toy parquet and the same weights: the same records."""
    from test_torch_serving import _jax_weights
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 4)
    common = ["--input-file", data, "--tiny", "--greedy", "--max-length",
              "256", "--max-new-tokens", "4", "--dna-rna-k-tokens", "4",
              "--protein-k-tokens", "4", "--batch-size", "2"] + MOE_FLAGS \
        + flags
    jax_out, torch_out = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jax_main(common + ["--output-file", jax_out])
    seen = {}

    def weights(args, cfg, device):
        seen["experts"] = cfg.text.num_experts
        return _jax_weights(args, cfg, device)

    monkeypatch.setattr(cli, "_load_params", weights)
    cli.main(common + ["--output-file", torch_out, "--device", "cpu"])
    ref = [json.loads(line) for line in open(jax_out)]
    got = [json.loads(line) for line in open(torch_out)]
    assert seen == {"experts": 4} and len(got) == len(ref) == 4
    assert got == ref


def test_moe_inference_cli_int8_quantizes_the_experts(tmp_path, monkeypatch):
    """--int8 on an MoE config passes moe_experts=True: the decode tree
    holds fused int8 expert stacks and the run writes its records."""
    from test_train_cli import _toy_parquet

    data, out = str(tmp_path / "d.parquet"), str(tmp_path / "t.jsonl")
    _toy_parquet(data, 2)
    seen = {}
    real = qwen3.quantize_for_decode

    def spy(params, cfg, **kw):
        seen.update(kw)
        q = real(params, cfg, **kw)
        seen["dtype"] = q["layers"]["expert_gateup"]["w_q"].dtype
        return q

    monkeypatch.setattr(qwen3, "quantize_for_decode", spy)
    cli.main(["--input-file", data, "--output-file", out, "--tiny",
              "--greedy", "--max-length", "256", "--max-new-tokens", "3",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "2", "--int8", "--device", "cpu"] + MOE_FLAGS)
    assert seen["moe_experts"] is True and seen["dtype"] == torch.int8
    assert len(open(out).readlines()) == 2


def test_moe_presets_build_configs():
    args = cli.build_argparser().parse_args(
        ["--input-file", "x", "--output-file", "y", "--preset",
         "qwen3-30b-a3b", "--text-model-path", "unused"])

    class Tok:
        vocab_size = 151669

    c = cli.build_config(args, Tok(), Tok(), Tok())
    assert (c.text.num_experts, c.text.num_experts_per_tok,
            c.text.intermediate_size, c.text.num_hidden_layers,
            c.text.vocab_size) == (128, 8, 768, 48, 151936)
    assert tcfg.QWEN3_PRESETS["qwen3-moe-mini"].num_experts == 32


def test_moe_train_cli_jsonl_matches_jax_cli(tmp_path):
    """Both train CLIs with --tiny --moe-experts 4 --moe-topk 2: the same
    JSONL keys record for record (moe_load_balance among them), finite
    values, and a full fine-tune state with the expert stacks in it."""
    from test_train_cli import _toy_parquet

    from molly_tpu.training.cli import build_argparser as jparser
    from molly_tpu.training.cli import run_training as jrun
    from molly_tpu_torch.training.cli import build_argparser, run_training

    data = str(tmp_path / "train.parquet")
    _toy_parquet(data, 16)   # the JAX CLI shards a batch over all 8 devices
    common = ["--train-dataset-path", data, "--tiny", "--dtype", "float32",
              "--max-len", "192", "--dna-rna-k-tokens", "4",
              "--protein-k-tokens", "4", "--batch-size-per-gpu", "8",
              "--train-iters", "2", "--log-interval", "1",
              "--save-interval", "2", "--lr", "1e-3"] + MOE_FLAGS
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jres = jrun(jparser().parse_args(common + ["--output-dir", jout]))
    tres = run_training(build_argparser().parse_args(
        common + ["--output-dir", tout, "--device", "cpu"]))
    assert tres["steps"] == jres["steps"] == 2
    jrec = [json.loads(l) for l in open(os.path.join(jout, "molly_tpu.jsonl"))]
    trec = [json.loads(l) for l in open(os.path.join(tout, "molly_tpu.jsonl"))]
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert all("moe_load_balance" in r and np.isfinite(r["moe_load_balance"])
               and 0.9 < r["moe_load_balance"] < 2.0 for r in trec)
    assert all(h["moe_load_balance"] > 0 for h in tres["history"])
    layers = tres["state"].params["text"]["layers"]
    assert layers["expert_gate"].shape[:2] == (2, 4)
    assert layers["expert_gate"].requires_grad and "gate_proj" not in layers
