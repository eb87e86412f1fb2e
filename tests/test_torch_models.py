"""molly_tpu_torch.models held against molly_tpu.models on the CPU, in fp32.

The JAX params are made with ``jax.random`` and carried across with
``models.convert.params_from_jax``, so both sides run the same weights on
the same numpy inputs. Tolerance: 1e-4 on logits and hidden states in fp32
unless stated otherwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.models import configs as jcfg
from molly_tpu.models import esm as jesm
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.inference import engine as jengine
from molly_tpu_torch.models import configs as tcfg
from molly_tpu_torch.models import esm, fusion, qwen3
from molly_tpu_torch.models.convert import params_from_jax

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_params(jparams):
    return params_from_jax(_np_tree(jparams))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tcfg_of(cfg):
    """The port's copy of a JAX config dataclass (same field values)."""
    cls = getattr(tcfg, type(cfg).__name__)
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k, v in vals.items():
        if dataclasses.is_dataclass(v):
            vals[k] = _tcfg_of(v)
    return cls(**vals)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("jcls,tcls", [
    (jcfg.Qwen3Config, tcfg.Qwen3Config),
    (jcfg.EsmConfig, tcfg.EsmConfig),
    (jfusion.FusionConfig, tcfg.FusionConfig),
    (jengine.GenerationConfig, tcfg.GenerationConfig),
])
def test_config_copies_match_field_for_field(jcls, tcls):
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert tcls.__dataclass_params__.frozen == jcls.__dataclass_params__.frozen


def test_config_presets_match():
    for name in ("QWEN3_PRESETS", "ESM_PRESETS"):
        jp, tp = getattr(jcfg, name), getattr(tcfg, name)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert dataclasses.asdict(tp[k]) == dataclasses.asdict(jp[k]), k
    assert dataclasses.asdict(tcfg.tiny_qwen3(vocab_size=99)) == \
        dataclasses.asdict(jcfg.tiny_qwen3(vocab_size=99))
    assert dataclasses.asdict(tcfg.tiny_esm(hidden_size=48)) == \
        dataclasses.asdict(jcfg.tiny_esm(hidden_size=48))
    c = tcfg.QWEN3_PRESETS["qwen3-1.7b"]
    assert (c.q_dim, c.kv_dim) == (2048, 1024)
    assert tcfg.ESM_PRESETS["nt-500m"].head_dim == 64


# ---------------------------------------------------------------- convert


def test_params_from_jax_round_trip():
    """bf16 fusion tree (stacked leaves, {kernel, bias} projectors) and the
    int8 fused decode tree ({w_q, scale}, qkv_proj/gateup_proj/qk_norm/
    lm_head_q) cross bit-exactly with their names and shapes."""
    import __graft_entry__ as ge
    cfg = ge._tiny_setup(layers=2)
    jp = jfusion.init_params(cfg, jax.random.key(0))
    jp["text"] = jqwen3.quantize_for_decode(jp["text"], cfg.text)
    npt = _np_tree(jp)
    tp = params_from_jax(npt)

    flat_np = jax.tree_util.tree_flatten_with_path(npt)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in flat_np] == [p for p, _ in flat_t]
    for (path, a), (_, t) in zip(flat_np, flat_t):
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    lay = tp["text"]["layers"]
    assert lay["qkv_proj"]["w_q"].dtype == torch.int8
    assert lay["qk_norm"].shape == (2, 8 + 4, 16)
    assert tp["dna_rna_projector"]["kernel"].shape == (64, 128)


def test_quantize_for_decode_matches_jax():
    cfg = jcfg.tiny_qwen3()
    jp = jqwen3.init_params(cfg, jax.random.key(1))
    tp = _torch_params(jp)
    ref = _np_tree(jqwen3.quantize_for_decode(jp, cfg, fuse=True))
    got = qwen3.quantize_for_decode(tp, _tcfg_of(cfg))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, a), (_, t) in zip(flat_ref, flat_got):
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))


# ---------------------------------------------------------------- qwen3


def _qwen_inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, cfg.vocab_size + 3, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0  # left padding
    return ids, mask


@pytest.mark.parametrize("variant", ["unfused", "fused", "int8", "untied"])
def test_qwen3_forward_no_cache(variant):
    cfg = jcfg.tiny_qwen3(tie_word_embeddings=variant != "untied")
    jp = jqwen3.init_params(cfg, jax.random.key(2))
    if variant == "fused":
        jp = jqwen3.fuse_for_decode(jp, cfg)
    elif variant == "int8":
        jp = jqwen3.quantize_for_decode(jp, cfg, fuse=True)
    ids, mask = _qwen_inputs(cfg)  # includes out-of-vocab ids (clipped)
    ref = np.asarray(jqwen3.forward_logits(
        jp, cfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask)))
    got = qwen3.forward_logits(_torch_params(jp), _tcfg_of(cfg),
                               input_ids=_t(ids), attention_mask=_t(mask))
    rows = mask.astype(bool)  # pad query rows have no valid key
    # int8: the JAX CPU path rounds activations to bf16 before each int8
    # product (ops/quant.py:81), the port (like the Pallas kernel) does not
    atol = 2e-2 * np.abs(ref).max() if variant == "int8" else ATOL
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], atol=atol)


@pytest.mark.parametrize("fused", [False, True])
def test_qwen3_forward_with_dense_cache(fused):
    cfg = jcfg.tiny_qwen3()
    jp = jqwen3.init_params(cfg, jax.random.key(3))
    if fused:
        jp = jqwen3.fuse_for_decode(jp, cfg)
    tp, tc = _torch_params(jp), _tcfg_of(cfg)
    B, S, T = 2, 10, 3
    ids, mask = _qwen_inputs(cfg, B, S, seed=1)
    full = np.zeros((B, S + T), np.int32)
    full[:, :S] = mask
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)

    jcache = jqwen3.init_cache(cfg, B, S + T)
    jh, jcache = jqwen3.forward_hidden(
        jp, cfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(full),
        positions=jnp.asarray(pos), cache=jcache, cache_index=0)
    tcache = qwen3.init_cache(tc, B, S + T)
    th, tcache = qwen3.forward_hidden(
        tp, tc, input_ids=_t(ids), attention_mask=_t(full),
        positions=_t(pos), cache=tcache, cache_index=0)
    rows = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[rows], np.asarray(jh)[rows],
                               atol=ATOL)
    # cache rows of real tokens match (pad rows hold pad-token k/v)
    kv_rows = np.broadcast_to(rows[None, :, None, :],
                              (cfg.num_hidden_layers, B,
                               cfg.num_key_value_heads, S))
    np.testing.assert_allclose(tcache["kv"].numpy()[:, :, :, :S][kv_rows],
                               np.asarray(jcache["kv"])[:, :, :, :S][kv_rows],
                               atol=ATOL)

    # one decode step at column S (plain attention path, Sq == 1)
    step_ids = np.asarray([[5], [7]], np.int32)
    step_mask = full.copy()
    step_mask[:, S] = 1
    step_pos = (mask.sum(1) - 0)[:, None].astype(np.int32)
    jh1, _ = jqwen3.forward_hidden(
        jp, cfg, input_ids=jnp.asarray(step_ids),
        attention_mask=jnp.asarray(step_mask), positions=jnp.asarray(step_pos),
        cache=jcache, cache_index=S)
    th1, _ = qwen3.forward_hidden(
        tp, tc, input_ids=_t(step_ids), attention_mask=_t(step_mask),
        positions=_t(step_pos), cache=tcache, cache_index=S)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=ATOL)
    jl = jqwen3.logits_from_hidden(jp, cfg, jh1[:, 0])
    tl = qwen3.logits_from_hidden(tp, tc, th1[:, 0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_qwen3_embed_tokens_clips():
    cfg = jcfg.tiny_qwen3(vocab_size=32)
    jp = jqwen3.init_params(cfg, jax.random.key(4))
    ids = np.asarray([[-5, 0, 31, 32, 1000]], np.int32)
    np.testing.assert_array_equal(
        qwen3.embed_tokens(_torch_params(jp), _t(ids)).numpy(),
        np.asarray(jqwen3.embed_tokens(jp, jnp.asarray(ids))))


# ---------------------------------------------------------------- esm


@pytest.mark.parametrize("pos_type,mlp,ln_before", [
    ("rotary", "gelu", False),
    ("rotary", "swiglu", False),
    ("absolute", "gelu", True),
    ("absolute", "swiglu", False),
])
def test_esm_forward_hidden(pos_type, mlp, ln_before):
    cfg = jcfg.tiny_esm(position_embedding_type=pos_type, mlp_type=mlp,
                        mlp_bias=mlp == "gelu",
                        emb_layer_norm_before=ln_before, mask_token_id=32)
    jp = jesm.init_params(cfg, jax.random.key(5))
    # nonzero biases and LN params so every term is exercised
    jp = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(6), a.shape),
        jp)
    rng = np.random.default_rng(2)
    B, S = 3, 14
    ids = rng.integers(4, 30, (B, S)).astype(np.int32)
    ids[0, 3] = ids[2, 5] = 32   # mask tokens: token-dropout rescale
    ids[1, 9:] = 1               # padding
    mask = (ids != 1).astype(np.int32)
    ref = np.asarray(jesm.forward_hidden(jp, cfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = esm.forward_hidden(_torch_params(jp), _tcfg_of(cfg), _t(ids),
                             _t(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    # default mask (tokens != pad)
    got2 = esm.forward_hidden(_torch_params(jp), _tcfg_of(cfg), _t(ids))
    np.testing.assert_allclose(got2.numpy(), ref, atol=ATOL)


# ---------------------------------------------------------------- fusion


def _fusion_setup(layers=2):
    import __graft_entry__ as ge
    cfg = ge._tiny_setup(layers=layers)
    cfg = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype="float32"),
        dna_rna=dataclasses.replace(cfg.dna_rna, dtype="float32",
                                    mlp_type="swiglu", mlp_bias=False),
        protein=dataclasses.replace(cfg.protein, dtype="float32"))
    return cfg


def _fusion_batch(cfg, B=4, S=64, seed=0):
    import __graft_entry__ as ge
    batch = {k: np.array(v) for k, v in
             ge._make_batch(cfg, B=B, S=S, seed=seed).items()}
    batch["attention_mask"][3, :6] = 0     # left padding
    batch["protein_tokens"][2, 0, 10:] = 1  # padded protein segment
    batch["protein_pos"][3, 0] = S - 8     # runs past S: rows dropped
    return batch


def test_fusion_forward_logits_matches_jax():
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(7))
    batch = _fusion_batch(cfg)
    ref = np.asarray(jfusion.forward_logits(
        jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = fusion.forward_logits(_torch_params(jp), _tcfg_of(cfg),
                                {k: _t(v) for k, v in batch.items()})
    rows = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], atol=ATOL)


def test_fusion_inject_drops_inactive_and_out_of_range_rows():
    rng = np.random.default_rng(3)
    B, S, G, K, H = 2, 10, 3, 4, 5
    hidden = rng.normal(size=(B, S, H)).astype(np.float32)
    emb = rng.normal(size=(B, G, K, H)).astype(np.float32)
    start = np.asarray([[0, -1, 7], [-1, 3, -1]], np.int32)
    ref = np.asarray(jfusion.inject(jnp.asarray(hidden), jnp.asarray(emb),
                                    jnp.asarray(start)))
    got = fusion.inject(_t(hidden), _t(emb), _t(start))
    np.testing.assert_array_equal(got.numpy(), ref)
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(8))
    batch = _fusion_batch(cfg, seed=1)
    keys = ("input_ids", "dna_rna_tokens", "dna_rna_pos", "protein_tokens",
            "protein_pos")
    ref = np.asarray(jfusion.build_inputs_embeds(
        jp, cfg, {k: jnp.asarray(batch[k]) for k in keys}))
    got = fusion.build_inputs_embeds(_torch_params(jp), _tcfg_of(cfg),
                                     {k: _t(batch[k]) for k in keys})
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
