"""molly_tpu_torch.models.lora held against molly_tpu.models.lora on the CPU,
in fp32, from the same numpy adapters. Tolerance 1e-5. Dropout cannot match
draw for draw (``torch.Generator`` and ``jax.random`` give different
streams), so it is checked for its keep rate and its scaling.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.models import lora as jlora
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_qwen3 as jtiny_qwen3
from molly_tpu_torch.models import lora, qwen3
from molly_tpu_torch.models.configs import tiny_qwen3
from molly_tpu_torch.models.convert import params_from_jax

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adapter(rng, cfg, r=4, targets=lora.LORA_TARGETS):
    dims = lora.target_dims(cfg)
    L = cfg.num_hidden_layers
    return {"layers": {t: {
        "a": (rng.normal(size=(L, dims[t][0], r)) / r).astype(np.float32),
        "b": (rng.normal(size=(L, r, dims[t][1])) * 0.05).astype(np.float32),
    } for t in targets}}


def test_config_and_target_dims_match():
    assert lora.LORA_TARGETS == jlora.LORA_TARGETS
    jc, tc = jlora.LoraConfig(), lora.LoraConfig()
    assert (jc.r, jc.alpha, jc.dropout, jc.targets, jc.scale) == \
        (tc.r, tc.alpha, tc.dropout, tc.targets, tc.scale)
    jd = jlora.target_dims(jtiny_qwen3())
    td = lora.target_dims(tiny_qwen3())
    assert all(td[k] == jd[k] for k in td)


def test_init_lora_shapes_and_statistics():
    cfg = tiny_qwen3()
    lc = lora.LoraConfig(r=8)
    ad = lora.init_lora(cfg, lc, torch.Generator().manual_seed(0))
    ref = jlora.init_lora(jtiny_qwen3(), jlora.LoraConfig(r=8),
                          jax.random.key(0))
    assert set(ad["layers"]) == set(ref["layers"])
    for t, ab in ad["layers"].items():
        assert tuple(ab["a"].shape) == ref["layers"][t]["a"].shape
        assert tuple(ab["b"].shape) == ref["layers"][t]["b"].shape
        assert not ab["b"].any()
        assert abs(float(ab["a"].std()) - 1 / 8) < 0.02   # std 1/r


def test_apply_lora_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    base = rng.normal(size=(2, 5, 7)).astype(np.float32)
    ab = {"a": rng.normal(size=(12, 3)).astype(np.float32),
          "b": rng.normal(size=(3, 7)).astype(np.float32)}
    ref = jlora.apply_lora(jnp.asarray(x), jnp.asarray(base),
                           jax.tree.map(jnp.asarray, ab), 1.5)
    got = lora.apply_lora(_t(x), _t(base), {k: _t(v) for k, v in ab.items()},
                          1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert lora.apply_lora(_t(x), _t(base), None, 1.5) is not None
    np.testing.assert_array_equal(
        lora.apply_lora(_t(x), _t(base), None, 1.5).numpy(), base)


def test_apply_lora_dropout_keep_rate_and_scaling():
    rate = 0.25
    x = torch.ones((64, 32, 16))
    ab = {"a": torch.eye(16), "b": torch.eye(16)}
    base = torch.zeros_like(x)
    g = torch.Generator().manual_seed(3)
    out = lora.apply_lora(x, base, ab, 1.0, rate, g)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.02
    np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - rate), atol=1e-6)
    # the same seed gives the same mask; no generator means no dropout
    out2 = lora.apply_lora(x, base, ab, 1.0, rate,
                           torch.Generator().manual_seed(3))
    assert torch.equal(out, out2)
    assert torch.equal(lora.apply_lora(x, base, ab, 1.0, rate, None), x)


def test_apply_lora_fused_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 10)).astype(np.float32)
    fused = rng.normal(size=(2, 4, 6 + 3 + 3)).astype(np.float32)
    layer = {"q_proj": {"a": rng.normal(size=(10, 2)).astype(np.float32),
                        "b": rng.normal(size=(2, 6)).astype(np.float32)},
             "v_proj": {"a": rng.normal(size=(10, 2)).astype(np.float32),
                        "b": rng.normal(size=(2, 3)).astype(np.float32)}}
    parts = (("q_proj", 6), ("k_proj", 3), ("v_proj", 3))
    ref = jlora.apply_lora_fused(jnp.asarray(x), jnp.asarray(fused),
                                 jax.tree.map(jnp.asarray, layer), parts, 0.5)
    tl = {t: {k: _t(v) for k, v in ab.items()} for t, ab in layer.items()}
    got = lora.apply_lora_fused(_t(x), _t(fused), tl, parts, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    same = lora.apply_lora_fused(_t(x), _t(fused), {}, parts, 0.5)
    np.testing.assert_array_equal(same.numpy(), fused)


def test_stack_adapters_matches_jax():
    rng = np.random.default_rng(2)
    cfg = tiny_qwen3()
    ads = [_adapter(rng, cfg), _adapter(rng, cfg)]
    ref = jlora.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads],
                               scales=[2.0, 0.5])
    got = lora.stack_adapters([params_from_jax(a) for a in ads],
                              scales=[2.0, 0.5])
    for t in ref["layers"]:
        for k in "ab":
            np.testing.assert_allclose(got["layers"][t][k].numpy(),
                                       np.asarray(ref["layers"][t][k]),
                                       atol=ATOL)


@pytest.mark.parametrize("int8_base", [False, True])
def test_merge_lora_matches_jax(int8_base):
    rng = np.random.default_rng(3)
    jcfg, cfg = jtiny_qwen3(), tiny_qwen3()
    jp = jqwen3.init_params(jcfg, jax.random.key(0))
    if int8_base:
        jp = jqwen3.quantize_for_training(jp, jcfg)
    ad = _adapter(rng, cfg)
    ref = jlora.merge_lora(jp, jax.tree.map(jnp.asarray, ad),
                           jlora.LoraConfig(r=4, alpha=8.0))
    got = lora.merge_lora(params_from_jax(_np_tree(jp)), params_from_jax(ad),
                          lora.LoraConfig(r=4, alpha=8.0))
    for name in lora.LORA_TARGETS:
        assert isinstance(got["layers"][name], torch.Tensor)
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(ref["layers"][name]),
                                   atol=ATOL)
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(ref["embed"]))


def test_quantize_for_training_matches_jax():
    jcfg, cfg = jtiny_qwen3(), tiny_qwen3()
    jp = jqwen3.init_params(jcfg, jax.random.key(1))
    ref = jqwen3.quantize_for_training(jp, jcfg)
    got = qwen3.quantize_for_training(params_from_jax(_np_tree(jp)), cfg)
    for name in qwen3.QUANT_TARGETS:
        np.testing.assert_array_equal(got["layers"][name]["w_q"].numpy(),
                                      np.asarray(ref["layers"][name]["w_q"]))
        np.testing.assert_allclose(got["layers"][name]["scale"].numpy(),
                                   np.asarray(ref["layers"][name]["scale"]),
                                   rtol=1e-6)
    assert got["layers"]["input_norm"] is not None
    assert isinstance(got["embed"], torch.Tensor)


def test_forward_hidden_with_lora_matches_jax():
    rng = np.random.default_rng(4)
    jcfg, cfg = jtiny_qwen3(), tiny_qwen3()
    jp = jqwen3.init_params(jcfg, jax.random.key(2))
    ad = _adapter(rng, cfg)
    ids = rng.integers(0, 512, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ref, _ = jqwen3.forward_hidden(
        jp, jcfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask),
        lora=jax.tree.map(jnp.asarray, ad), lora_scale=2.0)
    got, _ = qwen3.forward_hidden(
        params_from_jax(_np_tree(jp)), cfg, input_ids=_t(ids),
        attention_mask=_t(mask), lora=params_from_jax(ad), lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_unported_lora_options_are_refused():
    # lora_slots is ported (multi-LoRA serving): each row of a stacked bank
    # [N, d, r] / [N, r, o] gets its own adapter's delta
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 2, 4), generator=g)
    bank = {"a": torch.randn((2, 4, 2), generator=g),
            "b": torch.randn((2, 2, 4), generator=g)}
    slots = torch.tensor([1, 0, 1])
    got = lora.apply_lora(x, x, bank, 0.5, lora_slots=slots)
    for row, n in enumerate(slots.tolist()):
        one = {"a": bank["a"][n], "b": bank["b"][n]}
        ref = lora.apply_lora(x[row:row + 1], x[row:row + 1], one, 0.5)
        torch.testing.assert_close(got[row:row + 1], ref)
    # expert-stacked targets are ported, and so is expert parallelism:
    # expert_parallel=True without a mesh runs moe_mlp plus a zero
    # ep_dropped_frac, equal to the JAX package without a mesh
    cfg = tiny_qwen3(num_experts=4, num_experts_per_tok=2,
                     expert_parallel=True)
    jcfg = jtiny_qwen3(num_experts=4, num_experts_per_tok=2,
                       expert_parallel=True)
    jparams = jqwen3.init_params(jcfg, jax.random.key(0))
    jad = jlora.init_lora(jcfg, jlora.LoraConfig(r=2), jax.random.key(1))
    jad = jax.tree.map(np.asarray, jad)
    for t in jad["layers"].values():   # a non-zero b, so the bypass acts
        t["b"] = np.full(t["b"].shape, 0.05, np.float32)
    assert jad["layers"]["expert_down"]["a"].shape == (2, 4, 128, 2)
    ids = np.random.default_rng(0).integers(0, 512, (2, 6))
    jh, jaux = jqwen3.forward_hidden(jparams, jcfg, input_ids=ids, lora=jad)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    th, taux = qwen3.forward_hidden(params, cfg,
                                    input_ids=torch.from_numpy(ids),
                                    lora=params_from_jax(jad))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    assert sorted(taux["moe_aux"]) == sorted(jaux["moe_aux"])
    for k, v in jaux["moe_aux"].items():
        np.testing.assert_allclose(float(taux["moe_aux"][k]), float(v),
                                   rtol=1e-5, atol=1e-7)
    assert float(taux["moe_aux"]["ep_dropped_frac"]) == 0.0
