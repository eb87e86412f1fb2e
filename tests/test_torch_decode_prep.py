"""The port's decode preparation and per-row dense-cache writes held against
molly_tpu on the CPU, in fp32 (and bf16 where trees are compared bit for
bit): ``forward_hidden`` with a per-row [B] and a [B, S] ``cache_index`` on
the dense cache (fp32 and int8 KV), ``fuse_for_decode``,
``quantize_for_decode(fuse=False)``, ``esm.quantize_for_decode`` and a
stacked multi-LoRA bank, each converted leaf for leaf by
``params_from_jax`` and rebuilt by the port's own function bit for bit.
Tolerances: hidden states 1e-5; int8 KV values within one rounding step,
their scales 1e-6 (as ``test_torch_serving``); the fused model's logits
1e-5 of the unfused model's; the int8 encoder as JAX's own test bounds it
(max 0.15, mean 0.02 of the full-precision encoder).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.models import esm as jesm
from molly_tpu.models import lora as jlora
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_moe, tiny_qwen3
from molly_tpu_torch.models import esm, lora, qwen3
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _np_tree, _tcfg_of
from test_torch_serving import serving_setup

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side (a pool of threads a worker made each
    small op wait on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    return serving_setup()


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]


def assert_tree_bit_equal(got, ref):
    """Same paths, shapes, dtypes and bits (bf16 compared as raw words)."""
    fr, fg = _flat(_np_tree(ref)), _flat(got)
    assert [p for p, _ in fg] == [p for p, _ in fr]
    for (path, a), (_, t) in zip(fr, fg):
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=str(path))
        else:
            assert str(t.dtype).split(".")[-1] == a.dtype.name, path
            np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))


# ------------------------------------------------ per-row dense-cache writes


def _assert_caches(tc, jc, quant):
    if quant is None:
        np.testing.assert_allclose(tc["kv"].numpy(), np.asarray(jc["kv"]),
                                   atol=ATOL)
        return
    diff = np.abs(tc["kv"].numpy().astype(np.int32)
                  - np.asarray(jc["kv"]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3  # rounding ties
    np.testing.assert_allclose(tc["kv_scale"].numpy(),
                               np.asarray(jc["kv_scale"]), atol=1e-6)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("form", ["rows", "rows_cols"])
def test_per_row_dense_writes_match_jax(setup, quant, form):
    """A prefill at the scalar index, then a step whose rows write at their
    own columns: ``[B]`` (one token a row, the adaptive ring's plain tick)
    or ``[B, S]`` (S tokens a row at per-row columns that wrap, under a
    4-D mask: the speculative verify). Hidden states and the caches
    against JAX after both writes."""
    cfg, jp, tcfg, tp = setup
    rng = np.random.default_rng(7)
    B, P, T = 3, 6, 16
    ids = rng.integers(1, 64, (B, P + 4)).astype(np.int32)
    jc = jqwen3.init_cache(cfg.text, B, T, quant=quant)
    tc = qwen3.init_cache(tcfg.text, B, T, quant=quant)
    valid = np.zeros((B, T), np.int32)
    valid[:, :P] = 1
    valid[1, :2] = 0  # a left-padded row
    jh, jc = jqwen3.forward_hidden(
        jp["text"], cfg.text, input_ids=jnp.asarray(ids[:, :P]),
        attention_mask=jnp.asarray(valid), cache=jc, cache_index=0)
    th, tc = qwen3.forward_hidden(
        tp["text"], tcfg.text, input_ids=_t(ids[:, :P]).long(),
        attention_mask=_t(valid), cache=tc, cache_index=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    n_real = valid.sum(axis=1)
    if form == "rows":
        col = np.array([P + 3, P, T - 1], np.int32)          # [B]
        valid[np.arange(B), col] = 1
        S, idx = 1, col
        mask = valid
        pos = n_real[:, None]
    else:
        S = 4
        start = np.array([P, P + 5, T - 2])  # the last row wraps its ring
        idx = (P + (start[:, None] - P + np.arange(S)) % (T - P)).astype(
            np.int32)                                        # [B, S]
        onehot = idx[:, :, None] == np.arange(T)[None, None]
        tent = np.cumsum(onehot, axis=1) > 0                 # j sees <= j
        mask = ((valid[:, None, :] != 0) | tent)[:, None]    # [B,1,S,T]
        pos = n_real[:, None] + np.arange(S)
    feed = ids[:, P:P + S]
    jh, jc = jqwen3.forward_hidden(
        jp["text"], cfg.text, input_ids=jnp.asarray(feed),
        attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos),
        cache=jc, cache_index=jnp.asarray(idx), causal=False)
    th, tc = qwen3.forward_hidden(
        tp["text"], tcfg.text, input_ids=_t(feed).long(),
        attention_mask=_t(mask), positions=_t(pos), cache=tc,
        cache_index=_t(idx), causal=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    _assert_caches(tc, jc, quant)
    with pytest.raises(AssertionError, match="explicit positions"):
        qwen3.forward_hidden(tp["text"], tcfg.text,
                             input_ids=_t(feed).long(), cache=tc,
                             cache_index=_t(idx), causal=False)
    if form == "rows_cols":
        with pytest.raises(AssertionError, match="S == 1"):
            qwen3.forward_hidden(
                tp["text"], tcfg.text, input_ids=_t(feed).long(),
                attention_mask=_t(valid), positions=_t(pos), cache=tc,
                cache_index=_t(idx[:, 0]), causal=False)


# ------------------------------------------------ decode-prep trees


def _text_params(moe: bool, dtype: str):
    make = tiny_moe if moe else tiny_qwen3
    cfg = make(vocab_size=96, hidden_size=32, intermediate_size=48,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, dtype=dtype)
    jp = jqwen3.init_params(cfg, jax.random.key(3))
    return cfg, jp, _tcfg_of(cfg), params_from_jax(_np_tree(jp))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_for_decode_bit_equal(moe, dtype):
    """JAX's ``fuse_for_decode`` converts leaf for leaf, and the port's own
    function on the converted tree gives the same bits."""
    cfg, jp, tcfg, tp = _text_params(moe, dtype)
    ref = jqwen3.fuse_for_decode(jp, cfg)
    assert_tree_bit_equal(params_from_jax(_np_tree(ref)), ref)
    got = qwen3.fuse_for_decode(tp, tcfg)
    assert_tree_bit_equal(got, ref)
    assert "lm_head" in got and got["lm_head"].is_contiguous()


@pytest.mark.parametrize("moe,experts", [(False, False), (True, False),
                                         (True, True)],
                         ids=["dense", "moe", "moe_int8_experts"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_for_decode_unfused_bit_equal(moe, experts, dtype):
    """``quantize_for_decode(fuse=False)``: one int8 leaf a target, the q/k
    norms kept (multi-LoRA serving), against JAX's leaves."""
    cfg, jp, tcfg, tp = _text_params(moe, dtype)
    ref = jqwen3.quantize_for_decode(jp, cfg, fuse=False,
                                     moe_experts=experts)
    assert_tree_bit_equal(params_from_jax(_np_tree(ref)), ref)
    got = qwen3.quantize_for_decode(tp, tcfg, fuse=False,
                                    moe_experts=experts)
    assert_tree_bit_equal(got, ref)
    assert "q_norm" in got["layers"] and "qkv_proj" not in got["layers"]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_fused_logits_equal_unfused(moe):
    """The fused tree computes the unfused model's logits (and matches
    JAX's fused forward)."""
    cfg, jp, tcfg, tp = _text_params(moe, "float32")
    ids = np.random.default_rng(1).integers(0, 96, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0
    base = qwen3.forward_logits(tp, tcfg, input_ids=_t(ids).long(),
                                attention_mask=_t(mask))
    fused = qwen3.forward_logits(qwen3.fuse_for_decode(tp, tcfg), tcfg,
                                 input_ids=_t(ids).long(),
                                 attention_mask=_t(mask))
    ref = jqwen3.forward_logits(jqwen3.fuse_for_decode(jp, cfg), cfg,
                                input_ids=jnp.asarray(ids),
                                attention_mask=jnp.asarray(mask))
    rows = mask.astype(bool)
    np.testing.assert_allclose(fused.numpy()[rows], base.numpy()[rows],
                               atol=ATOL)
    np.testing.assert_allclose(fused.numpy()[rows], np.asarray(ref)[rows],
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esm_quantize_for_decode(dtype):
    """``esm.quantize_for_decode``: the {w_q, scale} leaves bit-equal to
    JAX's, and the int8 encoder within JAX's bounds of the full-precision
    one (fp32)."""
    cfg = tiny_esm(vocab_size=32, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4, dtype=dtype,
                   mlp_type="swiglu", mlp_bias=False)
    jp = jesm.init_params(cfg, jax.random.key(0))
    ref = jesm.quantize_for_decode(jp)
    assert_tree_bit_equal(params_from_jax(_np_tree(ref)), ref)
    tp = params_from_jax(_np_tree(jp))
    got = esm.quantize_for_decode(tp)
    assert_tree_bit_equal(got, ref)
    if dtype != "float32":
        return
    tcfg = _tcfg_of(cfg)
    ids = np.random.default_rng(0).integers(4, 30, (2, 12))
    mask = np.ones((2, 12), np.int32)
    h = esm.forward_hidden(tp, tcfg, _t(ids), _t(mask)).numpy()
    hq = esm.forward_hidden(got, tcfg, _t(ids), _t(mask)).numpy()
    jhq = np.asarray(jesm.forward_hidden(ref, cfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    assert np.abs(h - hq).max() < 0.15 and np.abs(h - hq).mean() < 0.02
    assert np.abs(jhq - hq).max() < 0.15 and np.abs(jhq - hq).mean() < 0.02


def test_stacked_lora_bank_converts_bit_equal():
    """A two-adapter bank from ``stack_adapters`` (scales folded into B)
    converts leaf for leaf, and the port's ``stack_adapters`` of the
    converted adapters gives the same bits."""
    cfg = tiny_qwen3(vocab_size=96, hidden_size=32, intermediate_size=48,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=8)
    lcfg = jlora.LoraConfig(r=4, alpha=8.0)
    adapters = []
    for seed in (1, 2):
        ad = jlora.init_lora(cfg, lcfg, jax.random.key(seed))
        ad = {"layers": {t: {"a": ab["a"], "b": ab["a"].mean() + 0.1 *
                             jax.random.normal(jax.random.key(seed + 10),
                                               ab["b"].shape)}
                         for t, ab in ad["layers"].items()}}
        adapters.append(ad)
    ref = jlora.stack_adapters(adapters, scales=[2.0, 0.5])
    assert_tree_bit_equal(params_from_jax(_np_tree(ref)), ref)
    got = lora.stack_adapters([params_from_jax(_np_tree(a))
                               for a in adapters], scales=[2.0, 0.5])
    assert_tree_bit_equal(got, ref)
