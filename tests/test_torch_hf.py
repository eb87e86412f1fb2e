"""molly_tpu_torch.models.hf_import / hf_export held against molly_tpu's on
the CPU, and the CLIs' checkpoint and adapter paths against the JAX CLIs.

The HF models are tiny and random, built from config objects as
``tests/test_model_parity.py`` builds them; no checkpoint file comes from
outside the test. Imports must equal ``params_from_jax`` of the JAX import
bit for bit (same keys, same dtype, ``torch.equal``); exports key for key
and bit for bit; logits and hidden states against HF in fp32 at 5e-3, the
JAX test's envelope (``F32_ATOL``).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from molly_tpu.models import hf_export as jexport
from molly_tpu.models import hf_import as jimport
from molly_tpu_torch.models import (esm, fusion, hf_export, hf_import,
                                    qwen3)
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _np_tree, _tcfg_of

F32_ATOL = 5e-3  # fp32 accumulation order on the CPU (test_model_parity.py)


def _assert_same(got, ref, path=""):
    """Same keys, dtypes, shapes and bits, leaf for leaf."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (
            path, sorted(got), sorted(ref))
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}/{k}")
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        path, got.dtype, ref.dtype, got.shape, ref.shape)
    assert torch.equal(got, ref), path


def _from_jax(jtree):
    return params_from_jax(_np_tree(jtree))


# ---------------------------------------------------------------- HF models


def _hf_qwen(seed=0, tie=True, vocab=256, moe=False, layers=3):
    from transformers import (Qwen3Config, Qwen3ForCausalLM,
                              Qwen3MoeConfig, Qwen3MoeForCausalLM)
    torch.manual_seed(seed)
    kw = dict(vocab_size=vocab, hidden_size=64, intermediate_size=128,
              num_hidden_layers=layers, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16,
              max_position_embeddings=512, rope_theta=1e6,
              tie_word_embeddings=tie, attn_implementation="eager")
    if moe:
        cfg = Qwen3MoeConfig(moe_intermediate_size=48, num_experts=4,
                             num_experts_per_tok=2, norm_topk_prob=True,
                             decoder_sparse_step=1, mlp_only_layers=[],
                             output_router_logits=False, **kw)
        return Qwen3MoeForCausalLM(cfg).eval(), cfg
    cfg = Qwen3Config(**kw)
    return Qwen3ForCausalLM(cfg).eval(), cfg


def _hf_esm(pos_type, token_dropout, emb_ln_before, seed=2):
    from transformers import EsmConfig, EsmForMaskedLM
    torch.manual_seed(seed)
    cfg = EsmConfig(
        vocab_size=40, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        position_embedding_type=pos_type, token_dropout=token_dropout,
        emb_layer_norm_before=emb_ln_before, mask_token_id=32,
        pad_token_id=1, max_position_embeddings=128, layer_norm_eps=1e-5,
        attn_implementation="eager", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    return EsmForMaskedLM(cfg).eval(), cfg


def _perturb_norms(model, seed):
    """HF initialises every norm weight to 1; random ones make a swapped
    or misplaced norm visible."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name.lower() and p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))


def _configs(hf_cfg, kind, **kw):
    """(port config, JAX config) from one HF config object."""
    if kind == "qwen3":
        t = hf_import.qwen3_cfg_from_hf_config(hf_cfg, **kw)
        j = jimport.qwen3_cfg_from_hf_config(hf_cfg, **kw)
    else:
        t = hf_import.esm_cfg_from_hf_config(hf_cfg, **kw)
        j = jimport.esm_cfg_from_hf_config(hf_cfg, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


# ---------------------------------------------------------------- import


@pytest.mark.parametrize("case", ["tied", "untied", "bare", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen3_import_equals_the_jax_import(case, dtype):
    model, hf_cfg = _hf_qwen(seed=1, tie=case != "untied",
                             moe=case == "moe")
    _perturb_norms(model, 5)
    state = (model.model if case == "bare" else model).state_dict()
    tcfg, jcfg = _configs(hf_cfg, "qwen3", dtype=dtype)
    got = hf_import.qwen3_from_hf(state, tcfg)
    _assert_same(got, _from_jax(jimport.qwen3_from_hf(state, jcfg)))
    assert got["embed"].dtype == qwen3.torch_dtype(dtype)
    if case == "moe":
        assert got["layers"]["router"].dtype == torch.float32
        assert got["layers"]["expert_gate"].shape == (3, 4, 64, 48)
    assert ("lm_head" in got) == (case == "untied")


@pytest.mark.parametrize("pos_type,token_dropout,emb_ln_before", [
    ("rotary", True, False), ("absolute", False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esm_import_equals_the_jax_import(pos_type, token_dropout,
                                          emb_ln_before, dtype):
    model, hf_cfg = _hf_esm(pos_type, token_dropout, emb_ln_before)
    state = model.state_dict()
    tcfg, jcfg = _configs(hf_cfg, "esm", dtype=dtype)
    got = hf_import.esm_from_hf(state, tcfg)
    _assert_same(got, _from_jax(jimport.esm_from_hf(state, jcfg)))
    assert ("pos_embed" in got) == (pos_type == "absolute")
    assert ("emb_ln" in got) == emb_ln_before


def _nt_v2_state(gate_key):
    """An NT-v2-style state dict: the bias-free SwiGLU FFN with its gate
    under one of the names the releases use (None: no gate at all)."""
    model, hf_cfg = _hf_esm("rotary", True, False, seed=4)
    state = {k: v for k, v in model.state_dict().items()
             if not re.search(r"layer\.\d+\.(intermediate|output)\.dense"
                              r"\.bias$", k)}
    g = torch.Generator().manual_seed(7)
    if gate_key is not None:
        for i in range(hf_cfg.num_hidden_layers):
            state[f"esm.encoder.layer.{i}.{gate_key}"] = torch.randn(
                (hf_cfg.intermediate_size, hf_cfg.hidden_size), generator=g)
    return state, hf_cfg


@pytest.mark.parametrize("gate_key", list(hf_import._GATE_KEYS) + [None])
def test_nt_v2_gate_variants_import_like_jax(gate_key):
    state, hf_cfg = _nt_v2_state(gate_key)
    tcfg, jcfg = _configs(hf_cfg, "esm", dtype="float32",
                          mlp_type="swiglu", mlp_bias=False)
    if gate_key is None:
        with pytest.raises(KeyError) as jerr:
            jimport.esm_from_hf(state, jcfg)
        with pytest.raises(KeyError) as terr:
            hf_import.esm_from_hf(state, tcfg)
        assert str(terr.value) == str(jerr.value)
        return
    got = hf_import.esm_from_hf(state, tcfg)
    _assert_same(got, _from_jax(jimport.esm_from_hf(state, jcfg)))
    assert not got["layers"]["ffn_in_b"].any()
    # the bias-free SwiGLU encoder runs on the imported weights
    ids = torch.randint(4, 30, (2, 9), generator=torch.Generator()
                        .manual_seed(0))
    assert torch.isfinite(esm.forward_hidden(got, tcfg, ids)).all()


def _lora_tree(cfg, r=4, seed=0):
    """A JAX LoRA tree with nonzero b (init_lora zeroes it)."""
    from molly_tpu.models import lora as jlora
    tree = jlora.init_lora(cfg, jlora.LoraConfig(r=r, dropout=0.0),
                           jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tree["layers"] = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(
            size=v.shape).astype(np.float32) * 0.01, tree["layers"])
    return tree


@pytest.mark.parametrize("case", ["dense", "subset", "moe"])
def test_peft_import_equals_the_jax_import(case):
    from molly_tpu.models import tiny_moe, tiny_qwen3
    jcfg = tiny_moe() if case == "moe" else tiny_qwen3()
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             jexport.peft_lora_to_hf_state(_lora_tree(jcfg), jcfg).items()}
    if case == "subset":
        state = {k: v for k, v in state.items()
                 if "q_proj" in k or "v_proj" in k}
    got = hf_import.peft_lora_from_hf(state, _tcfg_of(jcfg), 4)
    ref = _from_jax(jimport.peft_lora_from_hf(state, jcfg, 4))
    _assert_same(got, ref)
    if case == "subset":
        assert set(got["layers"]) == {"q_proj", "v_proj"}
    if case == "moe":
        assert got["layers"]["expert_down"]["a"].shape == (2, 4, 128, 4)
    with pytest.raises(KeyError, match="no lora_A"):
        hf_import.peft_lora_from_hf({}, _tcfg_of(jcfg), 4)


def test_projector_bins_with_prefixed_keys_import_like_jax(tmp_path):
    g = torch.Generator().manual_seed(3)
    for prefix in ("", "dna_rna_projector."):
        path = str(tmp_path / f"p{len(prefix)}.bin")
        torch.save({prefix + "weight": torch.randn((64, 48), generator=g),
                    prefix + "bias": torch.randn((64,), generator=g)}, path)
        state = torch.load(path, map_location="cpu", weights_only=True)
        got = hf_import.projector_from_hf(state)
        _assert_same(got, _from_jax(jimport.projector_from_hf(state)))
        assert got["kernel"].shape == (48, 64)


def test_a_missing_key_or_a_wrong_shape_stops_with_its_name():
    model, hf_cfg = _hf_qwen()
    tcfg, _ = _configs(hf_cfg, "qwen3", dtype="float32")
    state = dict(model.state_dict())
    del state["model.layers.2.self_attn.k_proj.weight"]
    with pytest.raises(KeyError, match="layers.2.self_attn.k_proj"):
        hf_import.qwen3_from_hf(state, tcfg)
    wrong = dataclasses.replace(tcfg, vocab_size=384)
    with pytest.raises(ValueError, match="embed_tokens.*384"):
        hf_import.qwen3_from_hf(model.state_dict(), wrong)


# ---------------------------------------------------------------- logits


@pytest.mark.parametrize("case", ["tied", "untied", "moe"])
def test_imported_decoder_matches_hf_logits_and_hidden_states(case):
    model, hf_cfg = _hf_qwen(seed=3, tie=case != "untied",
                             moe=case == "moe")
    _perturb_norms(model, 6)
    tcfg, _ = _configs(hf_cfg, "qwen3", dtype="float32")
    params = hf_import.qwen3_from_hf(model.state_dict(), tcfg)
    rng = np.random.default_rng(0)
    B, S = 2, 17
    ids = rng.integers(0, hf_cfg.vocab_size, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, -5:] = 0  # right padding
    with torch.no_grad():
        out = model(torch.tensor(ids), attention_mask=torch.tensor(mask),
                    output_hidden_states=True)
        hidden, _, per_layer = qwen3.forward_hidden(
            params, tcfg, input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(mask), output_hidden_states=True)
        logits = qwen3.logits_from_hidden(params, tcfg, hidden)
    m = torch.tensor(mask, dtype=torch.bool)
    assert (logits[m] - out.logits[m]).abs().max() < F32_ATOL
    assert per_layer.shape == (3, B, S, 64)
    for i in range(2):  # HF's last entry is after the final norm
        assert (per_layer[i][m] - out.hidden_states[i + 1][m]).abs().max() \
            < F32_ATOL


@pytest.mark.parametrize("pos_type,token_dropout,emb_ln_before", [
    ("rotary", True, False), ("absolute", False, True)])
def test_imported_encoder_matches_hf_hidden_states(pos_type, token_dropout,
                                                   emb_ln_before):
    model, hf_cfg = _hf_esm(pos_type, token_dropout, emb_ln_before)
    tcfg, _ = _configs(hf_cfg, "esm", dtype="float32")
    params = hf_import.esm_from_hf(model.state_dict(), tcfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 30, (3, 12))
    ids[:, 0] = 0
    ids[0, 3] = 32  # a <mask>: token dropout rescales
    mask = np.ones_like(ids)
    # padding in another row: transformers' EsmModel does not hand the
    # mask to its embeddings, so in a row with both a <mask> and padding its
    # token-dropout ratio counts the pads; both packages count real tokens
    mask[2, -3:] = 0
    ids[2, -3:] = 1
    with torch.no_grad():
        out = model.esm(torch.tensor(ids), attention_mask=torch.tensor(mask),
                        output_hidden_states=True)
        got, per_layer = esm.forward_hidden(
            params, tcfg, torch.tensor(ids), torch.tensor(mask),
            output_hidden_states=True)
    m = torch.tensor(mask, dtype=torch.bool)
    assert (got[m] - out.last_hidden_state[m]).abs().max() < F32_ATOL
    assert (per_layer[0][m] - out.hidden_states[1][m]).abs().max() < F32_ATOL


def test_fp32_projectors_on_a_bf16_model_promote_like_jax():
    """A PEFT directory's projectors import in fp32 (``projector_from_hf``,
    as in JAX) while the encoders stay bf16. JAX promotes the product to
    fp32; the port did ``bf16 @ fp32`` and raised. Both now project in fp32
    and agree to bf16 accuracy (the encoders run in bf16 on both sides)."""
    from molly_tpu.models import fusion as jfusion
    from molly_tpu.models import tiny_esm, tiny_qwen3
    jcfg = jfusion.FusionConfig(text=tiny_qwen3(dtype="bfloat16"),
                                dna_rna=tiny_esm(dtype="bfloat16"),
                                protein=tiny_esm(dtype="bfloat16"),
                                dna_rna_k_tokens=4, protein_k_tokens=4)
    jparams = jfusion.init_params(jcfg, jax.random.key(0))
    g = torch.Generator().manual_seed(1)
    proj = hf_import.projector_from_hf(
        {"dna_rna_projector.weight": torch.randn((64, 32), generator=g),
         "dna_rna_projector.bias": torch.randn((64,), generator=g)})
    jparams["dna_rna_projector"] = {k: jax.numpy.asarray(v.numpy())
                                    for k, v in proj.items()}
    params = _from_jax(jparams)
    assert params["dna_rna_projector"]["kernel"].dtype == torch.float32
    tokens = np.random.default_rng(0).integers(4, 30, (2, 1, 4))
    ref = np.asarray(jfusion.encode_and_project(
        jparams, jcfg.dna_rna, "dna_rna_projector", "dna_rna",
        jax.numpy.asarray(tokens)))
    with torch.no_grad():
        got = fusion.encode_and_project(
            params, _tcfg_of(jcfg).dna_rna, "dna_rna_projector", "dna_rna",
            torch.tensor(tokens))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(got.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


# ---------------------------------------------------------------- export


def _jax_qwen_params(cfg, seed):
    from molly_tpu.models import qwen3 as jqwen3
    return jqwen3.init_params(cfg, jax.random.key(seed))


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen3_export_equals_the_jax_export(moe, dtype):
    from molly_tpu.models import tiny_moe, tiny_qwen3
    jcfg = (tiny_moe if moe else tiny_qwen3)(
        tie_word_embeddings=False, dtype=dtype)
    jparams = _jax_qwen_params(jcfg, 2)
    ref = jexport.qwen3_to_hf_state(jparams, jcfg)
    got = hf_export.qwen3_to_hf_state(_from_jax(jparams), _tcfg_of(jcfg))
    assert list(got) == list(ref)
    _assert_same(got, params_from_jax({k: np.asarray(v)
                                       for k, v in ref.items()}))


@pytest.mark.parametrize("moe", [False, True])
def test_peft_export_equals_the_jax_export(moe):
    from molly_tpu.models import tiny_moe, tiny_qwen3
    jcfg = tiny_moe() if moe else tiny_qwen3()
    tree = _lora_tree(jcfg)
    ref = jexport.peft_lora_to_hf_state(tree, jcfg)
    got = hf_export.peft_lora_to_hf_state(_from_jax(tree), _tcfg_of(jcfg))
    assert list(got) == list(ref)
    _assert_same(got, params_from_jax(ref))
    # and back: the port's import inverts the port's export
    _assert_same(hf_import.peft_lora_from_hf(got, _tcfg_of(jcfg), 4),
                 _from_jax(tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_checkpoint_equals_the_jax_one_and_loads_in_transformers(
        tmp_path, dtype):
    from safetensors import safe_open
    from transformers import AutoModelForCausalLM

    from molly_tpu.models import tiny_qwen3
    jcfg = tiny_qwen3(num_hidden_layers=2, tie_word_embeddings=False,
                      dtype=dtype)
    jparams = _jax_qwen_params(jcfg, 1)
    tcfg, params = _tcfg_of(jcfg), _from_jax(jparams)
    jexport.save_hf_checkpoint(str(tmp_path / "jax"), jparams, jcfg)
    hf_export.save_hf_checkpoint(str(tmp_path / "port"), params, tcfg)

    def read(d):
        with safe_open(str(tmp_path / d / "model.safetensors"),
                       framework="pt") as f:
            return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()

    (ref, _), (got, meta) = read("jax"), read("port")
    assert meta == {"format": "pt"}
    assert set(got) == set(ref)
    _assert_same(got, ref)
    assert all(v.dtype == torch.float32 for v in got.values())
    for d in ("jax", "port"):
        with open(tmp_path / d / "config.json") as f:
            if d == "jax":
                jconf = json.load(f)
            else:
                assert json.load(f) == jconf
    # the port reads its own file back bit for bit
    _assert_same(hf_import.qwen3_from_hf(
        hf_import.load_hf_state(str(tmp_path / "port")), tcfg), params)

    model = AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "port"), attn_implementation="eager").eval()
    ids = np.arange(10)[None] % tcfg.vocab_size
    f32 = dataclasses.replace(tcfg, dtype="float32")
    with torch.no_grad():
        ref_logits = model(torch.tensor(ids)).logits
        got_logits = qwen3.forward_logits(
            hf_import.qwen3_from_hf(
                hf_import.load_hf_state(str(tmp_path / "port")), f32),
            f32, input_ids=torch.tensor(ids))
    assert (ref_logits - got_logits).abs().max() < F32_ATOL


def test_writer_refuses_a_short_disk(tmp_path, monkeypatch):
    import shutil

    from molly_tpu_torch.models.configs import tiny_qwen3
    cfg = tiny_qwen3()
    params = qwen3.init_params(cfg, torch.Generator().manual_seed(0))
    usage = shutil.disk_usage(str(tmp_path))
    monkeypatch.setattr(hf_export.shutil, "disk_usage",
                        lambda p: usage._replace(free=1000))
    with pytest.raises(OSError, match="needs .* GB and the disk has"):
        hf_export.save_hf_checkpoint(str(tmp_path / "x"), params, cfg)
    assert not os.path.exists(tmp_path / "x" / "model.safetensors")


# ---------------------------------------------------------------- reader


def test_load_hf_state_reads_a_file_shards_and_a_bin(tmp_path):
    model, hf_cfg = _hf_qwen(seed=2)
    ref = model.state_dict()
    model.save_pretrained(tmp_path / "one")
    model.save_pretrained(tmp_path / "shards", max_shard_size="40KB")
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    shards = [f for f in os.listdir(tmp_path / "shards")
              if f.endswith(".safetensors")]
    assert len(shards) > 1
    assert os.path.exists(tmp_path / "shards" /
                          "model.safetensors.index.json")
    assert os.path.exists(tmp_path / "bin" / "pytorch_model.bin")
    tcfg, jcfg = _configs(hf_cfg, "qwen3", dtype="float32")
    for d in ("one", "shards", "bin"):
        state = hf_import.load_hf_state(str(tmp_path / d))
        for k, v in state.items():
            assert torch.equal(v, ref[k]), (d, k)
        # tied embeddings: the lm head may or may not be written
        assert set(ref) - {"lm_head.weight"} <= set(state) <= set(ref)
        _assert_same(hf_import.qwen3_from_hf(state, tcfg), _from_jax(
            jimport.qwen3_from_hf(jimport.load_hf_state(str(tmp_path / d)),
                                  jcfg)))
    # a shard named by the index but gone stops the load
    os.remove(tmp_path / "shards" / sorted(shards)[0])
    with pytest.raises(KeyError, match="in no shard"):
        hf_import.load_hf_state(str(tmp_path / "shards"))
    os.makedirs(tmp_path / "empty")
    for load in (hf_import.load_hf_state, jimport.load_hf_state):
        with pytest.raises(FileNotFoundError,
                           match="no safetensors or pytorch_model.bin"):
            load(str(tmp_path / "empty"))


def test_reader_reads_f16_bf16_i8_files_bit_equal(tmp_path):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    state = {"f16": torch.randn((3, 5), generator=g).half(),
             "bf16": torch.randn((4, 2), generator=g).bfloat16(),
             "i8": torch.randint(-128, 128, (7,), generator=g,
                                 dtype=torch.int8),
             "i32": torch.arange(5, dtype=torch.int32),
             "i64": torch.arange(3), "bool": torch.tensor([True, False]),
             "f32": torch.randn((2, 3), generator=g),
             "empty": torch.zeros((0, 4))}
    save_file(state, str(tmp_path / "x.safetensors"))
    got = hf_import.read_safetensors(str(tmp_path / "x.safetensors"))
    assert list(got) == sorted(state, key=list(got).index)
    _assert_same(got, state)
    # the port's writer gives a file the library reads bit for bit
    from safetensors.torch import load_file
    hf_export.write_safetensors(str(tmp_path / "y.safetensors"),
                                {**state, "t": state["f32"].T})
    _assert_same(load_file(str(tmp_path / "y.safetensors")),
                 {**state, "t": state["f32"].T.contiguous()})
    # a dtype the reader does not know, or a file cut short, stops the read
    save_file({"f8": torch.zeros(4).to(torch.float8_e4m3fn)},
              str(tmp_path / "f8.safetensors"))
    with pytest.raises(ValueError, match="F8_E4M3"):
        hf_import.read_safetensors(str(tmp_path / "f8.safetensors"))
    data = open(tmp_path / "x.safetensors", "rb").read()
    with open(tmp_path / "cut.safetensors", "wb") as f:
        f.write(data[:-4])
    with pytest.raises(ValueError, match="do not hold"):
        hf_import.read_safetensors(str(tmp_path / "cut.safetensors"))


_NUMPY_BF16 = r"""
import sys
from safetensors import safe_open
try:
    with safe_open(sys.argv[1], framework="np") as f:
        f.get_tensor(f.keys()[0])
except TypeError as e:
    print("TypeError:", e)
"""


def test_bf16_checkpoint_reads_bit_equal_to_the_jax_import(tmp_path):
    """The published Qwen3 files are BF16. safetensors' numpy reader, which
    the JAX package uses, reads them only once ml_dtypes has registered
    bfloat16 with numpy (importing jax does that; without it the read
    raises TypeError). The port's reader needs neither: its import of the
    file equals the JAX import of the same file and of the same state dict
    handed over in memory (which ``_np`` widens to fp32)."""
    model, hf_cfg = _hf_qwen(seed=4, tie=False)
    model = model.to(torch.bfloat16)
    model.save_pretrained(tmp_path / "bf16")
    out = subprocess.run(
        [sys.executable, "-c", _NUMPY_BF16,
         str(tmp_path / "bf16" / "model.safetensors")],
        capture_output=True, text=True, timeout=120)
    assert "TypeError: data type 'bfloat16' not understood" in out.stdout
    state = hf_import.load_hf_state(str(tmp_path / "bf16"))
    assert state["lm_head.weight"].dtype == torch.bfloat16
    for dtype in ("bfloat16", "float32"):
        tcfg, jcfg = _configs(hf_cfg, "qwen3", dtype=dtype)
        got = hf_import.qwen3_from_hf(state, tcfg)
        _assert_same(got, _from_jax(jimport.qwen3_from_hf(
            model.state_dict(), jcfg)))
        _assert_same(got, _from_jax(jimport.qwen3_from_hf(
            jimport.load_hf_state(str(tmp_path / "bf16")), jcfg)))


@pytest.mark.parametrize("kind", ["qwen3", "qwen3_moe", "esm"])
def test_configs_from_config_json_equal_jax(tmp_path, kind):
    if kind == "esm":
        model, _ = _hf_esm("absolute", False, True)
    else:
        model, _ = _hf_qwen(moe=kind == "qwen3_moe", tie=False)
    model.config.save_pretrained(tmp_path)
    with open(tmp_path / "config.json") as f:
        conf = json.load(f)
    which = "esm" if kind == "esm" else "qwen3"
    t, _ = _configs(conf, which)
    t2, _ = _configs(model.config, which)
    assert t == t2
    if kind == "qwen3_moe":
        assert (t.num_experts, t.intermediate_size) == (4, 48)


# ---------------------------------------------------------------- CLIs


def test_build_config_keeps_the_preset_vocabulary_under_a_checkpoint(
        tmp_path, monkeypatch):
    """The repair: the batch CLI sizes the vocabulary to the tokenizer only
    without --text-model-path AND without --checkpoint, as the JAX CLI
    does; its config equals the JAX CLI's field for field."""
    from test_train_cli import _toy_parquet

    from molly_tpu.inference import cli as jcli
    from molly_tpu_torch.data import (default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.inference import cli

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 2)

    class Captured(Exception):
        pass

    def capture(args, cfg):
        raise Captured(cfg)

    monkeypatch.setattr(jcli, "_load_params", capture)
    base = ["--input-file", data, "--output-file", str(tmp_path / "o")]
    for extra, vocab in (
            (["--preset", "qwen3-1.7b", "--checkpoint", "x"], 151936),
            (["--preset", "qwen3-1.7b", "--checkpoint", "x",
              "--text-model-path", str(tmp_path / "no-tokenizer")], 151936),
            (["--preset", "qwen3-1.7b"], 384),
            (["--tiny", "--checkpoint", "x"], 384)):
        with pytest.raises(Captured) as exc:
            jcli.main(base + extra)
        jconf = exc.value.args[0]
        args = cli.build_argparser().parse_args(base + extra)
        text_tok = load_text_tokenizer(args.text_model_path)
        got = cli.build_config(args, text_tok, *default_modality_tokenizers())
        assert dataclasses.asdict(got) == dataclasses.asdict(jconf), extra
        assert got.text.vocab_size == vocab, extra


def _tiny_hf_dir(path, text_tok_vocab=384):
    """An HF checkpoint at the batch CLI's --tiny text widths."""
    from transformers import Qwen3Config, Qwen3ForCausalLM
    torch.manual_seed(11)
    model = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=text_tok_vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=40960, rope_theta=1e6,
        tie_word_embeddings=True)).eval()
    _perturb_norms(model, 12)
    model.save_pretrained(path)


def _peft_dir(path, variant):
    """A PEFT adapter directory for the --tiny decoder: the adapter file
    (safetensors or .bin), adapter_config.json, both projector .bins."""
    from safetensors.numpy import save_file

    from molly_tpu.models import tiny_qwen3
    os.makedirs(path)
    jcfg = tiny_qwen3(vocab_size=384)
    state = jexport.peft_lora_to_hf_state(_lora_tree(jcfg, seed=3), jcfg)
    if variant == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   os.path.join(path, "adapter_model.bin"))
    else:
        save_file(state, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": 4, "lora_alpha": 16}, f)
    g = torch.Generator().manual_seed(5)
    for name, h_in in (("dna_rna_projector", 32), ("protein_projector", 32)):
        torch.save({f"{name}.weight": torch.randn((64, h_in), generator=g),
                    f"{name}.bias": torch.randn((64,), generator=g)},
                   os.path.join(path, f"{name}.bin"))


@pytest.mark.parametrize("variant", ["checkpoint", "peft", "peft_bin",
                                     "peft_alpha_flag"])
def test_batch_cli_loads_hf_checkpoints_and_peft_adapters_like_jax(
        tmp_path, monkeypatch, variant):
    """Both CLIs with --tiny --greedy --checkpoint <HF dir> (and a PEFT
    adapter: safetensors or .bin, alpha from adapter_config.json or
    --lora-alpha) write the same JSONL. The weights the import does not
    touch (encoders, projectors without an adapter) are the JAX CLI's
    random init on both sides."""
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main
    from molly_tpu.models import fusion as jfusion
    from molly_tpu_torch.inference import cli
    from test_torch_generate import _jax_cfg

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 3)
    _tiny_hf_dir(tmp_path / "hf")
    common = ["--input-file", data, "--tiny", "--greedy",
              "--max-length", "256", "--max-new-tokens", "4",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "3", "--checkpoint", str(tmp_path / "hf")]
    if variant != "checkpoint":
        _peft_dir(str(tmp_path / "peft"),
                  "bin" if variant == "peft_bin" else "st")
        common += ["--peft-adapter", str(tmp_path / "peft")]
    if variant == "peft_alpha_flag":
        common += ["--lora-alpha", "8"]
    jax_out = str(tmp_path / "jax.jsonl")
    jax_main(common + ["--output-file", jax_out])

    def jax_init(cfg, generator, device="cpu", given=None):
        jcfg = jfusion.FusionConfig(
            dna_rna_k_tokens=cfg.dna_rna_k_tokens,
            protein_k_tokens=cfg.protein_k_tokens,
            **{f: _jax_cfg(getattr(cfg, f))
               for f in ("text", "dna_rna", "protein")})
        jp = params_from_jax(_np_tree(jfusion.init_params(
            jcfg, jax.random.key(0))), device)
        return {k: (given or {}).get(k, v) for k, v in jp.items()}

    monkeypatch.setattr(fusion, "init_params", jax_init)
    merged = {}
    real_load = cli._load_params
    monkeypatch.setattr(cli, "_load_params", lambda *a: merged.setdefault(
        "params", real_load(*a)))
    torch_out = str(tmp_path / "torch.jsonl")
    cli.main(common + ["--output-file", torch_out, "--device", "cpu"])
    ref = [json.loads(line) for line in open(jax_out)]
    got = [json.loads(line) for line in open(torch_out)]
    assert len(got) == len(ref) == 3
    assert got == ref
    # the imported decoder is the HF file's, bit for bit, merged or not
    from molly_tpu_torch.models.configs import tiny_qwen3
    imported = hf_import.qwen3_from_hf(
        hf_import.load_hf_state(str(tmp_path / "hf")),
        tiny_qwen3(vocab_size=384))
    if variant == "checkpoint":
        _assert_same(merged["params"]["text"], imported)
        return
    from molly_tpu_torch.models.lora import LoraConfig, merge_lora
    lora, alpha = cli.load_peft_adapter(str(tmp_path / "peft"),
                                        tiny_qwen3(vocab_size=384))
    assert alpha == 16
    scale_alpha = 8.0 if variant == "peft_alpha_flag" else 16.0
    _assert_same(merged["params"]["text"],
                 merge_lora(imported, lora, LoraConfig(r=4,
                                                       alpha=scale_alpha)))
    assert merged["params"]["dna_rna_projector"]["kernel"].shape == (32, 64)


def test_peft_directory_without_an_adapter_file_stops(tmp_path):
    from molly_tpu_torch.inference import cli
    from molly_tpu_torch.models.configs import tiny_qwen3
    os.makedirs(tmp_path / "peft")
    with pytest.raises(FileNotFoundError, match="adapter_model"):
        cli.load_peft_adapter(str(tmp_path / "peft"), tiny_qwen3())


def test_train_cli_build_params_imports_like_the_jax_cli(tmp_path):
    """``training.cli.build_params`` imports --text-model-path,
    --dna-rna-model-path and --protein-model-path as the JAX CLI does
    (``qwen3_from_hf`` / ``esm_from_hf`` of ``load_hf_state`` in the model
    dtype), and imports nothing under --no-load-pretrained or --tiny."""
    from molly_tpu_torch.models.configs import FusionConfig
    from molly_tpu_torch.training import cli as tcli

    model, hf_cfg = _hf_qwen(seed=8, tie=False)
    _perturb_norms(model, 9)
    model.save_pretrained(tmp_path / "text")
    dna, dna_cfg = _hf_esm("absolute", False, True, seed=3)
    dna.save_pretrained(tmp_path / "dna")
    prot, prot_cfg = _hf_esm("rotary", True, False, seed=4)
    prot.save_pretrained(tmp_path / "prot")
    for dtype in ("bfloat16", "float32"):
        tq, jq = _configs(hf_cfg, "qwen3", dtype=dtype)
        td, jd = _configs(dna_cfg, "esm", dtype=dtype)
        tp, jp = _configs(prot_cfg, "esm", dtype=dtype)
        cfg = FusionConfig(text=tq, dna_rna=td, protein=tp)
        argv = ["--train-dataset-path", "x",
                "--text-model-path", str(tmp_path / "text"),
                "--dna-rna-model-path", str(tmp_path / "dna"),
                "--protein-model-path", str(tmp_path / "prot")]
        args = tcli.build_argparser().parse_args(argv)
        tcli._refuse_unported(args)  # the model paths are not refused
        params = tcli.build_params(args, cfg, "cpu")
        assert list(params) == ["text", "dna_rna", "protein",
                                "dna_rna_projector", "protein_projector"]
        _assert_same(params["text"], _from_jax(jimport.qwen3_from_hf(
            jimport.load_hf_state(str(tmp_path / "text")), jq)))
        _assert_same(params["dna_rna"], _from_jax(jimport.esm_from_hf(
            jimport.load_hf_state(str(tmp_path / "dna")), jd)))
        _assert_same(params["protein"], _from_jax(jimport.esm_from_hf(
            jimport.load_hf_state(str(tmp_path / "prot")), jp)))
    for flag in ("--no-load-pretrained", "--tiny"):
        args = tcli.build_argparser().parse_args(argv + [flag])
        params = tcli.build_params(args, cfg, "cpu")
        assert not torch.equal(params["text"]["embed"],
                               model.model.embed_tokens.weight)


# ---------------------------------------------------------------- no jax


_BLOCKED_IO = r"""
import sys
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "molly_tpu", "safetensors",
           "transformers", "pandas", "sklearn")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocked())
import json, os, tempfile
import torch
from molly_tpu_torch.data import (default_modality_tokenizers,
                                  load_text_tokenizer)
from molly_tpu_torch.inference import cli as icli
from molly_tpu_torch.models import fusion, qwen3
from molly_tpu_torch.models.configs import tiny_qwen3
from molly_tpu_torch.models.hf_export import (peft_lora_to_hf_state,
                                              save_hf_checkpoint,
                                              write_safetensors)
from molly_tpu_torch.models.hf_import import load_hf_state, qwen3_from_hf
from molly_tpu_torch.models.lora import LoraConfig, init_lora
from molly_tpu_torch.training import cli as tcli

cfg = tiny_qwen3(vocab_size=384)
g = torch.Generator().manual_seed(0)
params = qwen3.init_params(cfg, g)
tmp = tempfile.mkdtemp()
save_hf_checkpoint(os.path.join(tmp, "hf"), params, cfg)
back = qwen3_from_hf(load_hf_state(os.path.join(tmp, "hf")), cfg)
assert all(torch.equal(back["layers"][k], v)
           for k, v in params["layers"].items())
lora = init_lora(cfg, LoraConfig(r=4), g)
os.makedirs(os.path.join(tmp, "peft"))
write_safetensors(os.path.join(tmp, "peft", "adapter_model.safetensors"),
                  peft_lora_to_hf_state(lora, cfg))
with open(os.path.join(tmp, "peft", "adapter_config.json"), "w") as f:
    json.dump({"lora_alpha": 8}, f)
# the batch CLI's load path, with the HF checkpoint and the PEFT adapter
args = icli.build_argparser().parse_args(
    ["--input-file", "x", "--output-file", "y", "--tiny",
     "--checkpoint", os.path.join(tmp, "hf"),
     "--peft-adapter", os.path.join(tmp, "peft")])
fcfg = icli.build_config(args, load_text_tokenizer(None),
                         *default_modality_tokenizers())
loaded = icli._load_params(args, fcfg, "cpu")
assert loaded["text"]["embed"].shape == (384, 64)
# the train CLI's load path
targs = tcli.build_argparser().parse_args(
    ["--train-dataset-path", "x", "--text-model-path",
     os.path.join(tmp, "hf")])
tparams = tcli.build_params(targs, fcfg, "cpu")
assert torch.equal(tparams["text"]["embed"], params["embed"])
bad = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_hf_io_and_load_paths_run_without_hf_packages():
    """``hf_import``, ``hf_export`` and both CLIs' load paths run with jax,
    molly_tpu, safetensors, transformers, pandas and sklearn blocked (the
    card's machine has none of them)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IO], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
