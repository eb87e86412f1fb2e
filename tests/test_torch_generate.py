"""The port's generation slice held against molly_tpu on the CPU, in fp32:
sampling processors, greedy generate (token-exact), the batch CLI's JSONL,
and that nothing in molly_tpu_torch imports jax or the JAX package.

Sampled outputs cannot match token for token (``torch.Generator`` and
``jax.random`` draw different streams), so the sampled path is compared
through its filtered candidates. Tolerance for logit processors: 1e-6.
"""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.inference import engine as jengine
from molly_tpu.inference import sampling as jsampling
from molly_tpu.models import fusion as jfusion
from molly_tpu_torch.inference import cli, engine, sampling
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _fusion_batch, _fusion_setup, _tcfg_of

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _logits(seed=0, B=3, V=50):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    presence = rng.random((B, V)) < 0.2
    return logits, presence


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_logit_processors_match_jax(penalty):
    logits, presence = _logits(0)
    np.testing.assert_allclose(
        sampling.apply_repetition_penalty(_t(logits), _t(presence),
                                          penalty).numpy(),
        np.asarray(jsampling.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(presence), penalty)), atol=ATOL)
    for k in (0, 1, 7):
        np.testing.assert_array_equal(
            sampling.top_k_filter(_t(logits), k).numpy(),
            np.asarray(jsampling.top_k_filter(jnp.asarray(logits), k)))
    for p in (0.3, 0.9, 1.0):
        np.testing.assert_array_equal(
            sampling.top_p_filter(_t(logits), p).numpy(),
            np.asarray(jsampling.top_p_filter(jnp.asarray(logits), p)))


@pytest.mark.parametrize("top_k,top_p", [(20, 0.95), (5, 0.5), (0, 0.8)])
def test_sampled_path_filters_like_jax(top_k, top_p):
    """penalty -> temperature -> top-k -> top-p: the port's candidate set
    and logits equal the JAX processors', and draws stay inside it."""
    logits, presence = _logits(1, V=64)
    kw = dict(temperature=0.8, top_k=top_k, top_p=top_p,
              repetition_penalty=1.1)
    j = jsampling.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(presence), 1.1) / 0.8
    ref = np.asarray(jsampling.top_p_filter(
        jsampling.top_k_filter(j, top_k), top_p))
    vals, idx = sampling.filter_logits(_t(logits), presence=_t(presence), **kw)
    got = np.full_like(ref, float(sampling.NEG_INF))
    if idx is None:
        got = vals.numpy()
    else:
        np.put_along_axis(got, idx.numpy(), vals.numpy(), axis=1)
    kept = ref > sampling.NEG_INF
    np.testing.assert_array_equal(got > sampling.NEG_INF, kept)
    np.testing.assert_allclose(got[kept], ref[kept], atol=ATOL)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sampling.sample_tokens(_t(logits), g, presence=_t(presence),
                                     **kw)
        assert kept[np.arange(len(tok)), tok.numpy()].all()


def test_greedy_sample_matches_jax():
    logits, presence = _logits(2)
    ref = jsampling.sample_tokens(
        jnp.asarray(logits), jax.random.key(0), do_sample=False,
        repetition_penalty=1.2, presence=jnp.asarray(presence))
    got = sampling.sample_tokens(_t(logits), None, do_sample=False,
                                 repetition_penalty=1.2,
                                 presence=_t(presence))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_greedy_generate_token_exact(penalty):
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(9))
    batch = _fusion_batch(cfg, B=4, S=48, seed=2)
    batch["attention_mask"][1, :10] = 0
    gen = jengine.GenerationConfig(max_new_tokens=6, do_sample=False,
                                   repetition_penalty=penalty,
                                   eos_token_id=3, pad_token_id=0)
    ref = np.asarray(jengine.generate(
        jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, gen,
        jax.random.key(0)))
    got = engine.generate(params_from_jax(jax.tree.map(np.asarray, jp)),
                          _tcfg_of(cfg), batch, _tcfg_of(gen))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_eos_pads_and_sampled_runs():
    cfg = _fusion_setup()
    jp = jfusion.init_params(cfg, jax.random.key(10))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    # an all-zero head ties every logit, so argmax picks id 0 = eos
    greedy = {**tp, "text": {**tp["text"], "lm_head": torch.zeros(
        cfg.text.hidden_size, cfg.text.vocab_size)}}
    batch = _fusion_batch(cfg, B=4, S=32, seed=3)
    gen = _tcfg_of(jengine.GenerationConfig(
        max_new_tokens=5, do_sample=False, eos_token_id=0,
        pad_token_id=7, repetition_penalty=1.0))
    toks = engine.generate(greedy, _tcfg_of(cfg), batch, gen).numpy()
    assert (toks[:, 0] == 0).all() and (toks[:, 1:] == 7).all()
    # sampled: same generator seed, same tokens
    gen = _tcfg_of(jengine.GenerationConfig(max_new_tokens=4,
                                            eos_token_id=-1))
    a = engine.generate(tp, _tcfg_of(cfg), batch, gen,
                        torch.Generator().manual_seed(5))
    b = engine.generate(tp, _tcfg_of(cfg), batch, gen,
                        torch.Generator().manual_seed(5))
    assert a.shape == (4, 4) and torch.equal(a, b)
    # an unmerged adapter over a base already quantized for decode cannot
    # be merged: refused
    from molly_tpu_torch.models import qwen3 as tqwen3
    quantized = {**tp, "text": tqwen3.quantize_for_decode(
        tp["text"], _tcfg_of(cfg).text), "lora": {"layers": {}}}
    with pytest.raises(AssertionError):
        engine.generate(quantized, _tcfg_of(cfg), batch, gen)


# ---------------------------------------------------------------- CLI


def test_cli_jsonl_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs on the same toy parquet (--tiny, greedy) with the same
    weights write the same JSONL records."""
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 5)
    common = ["--input-file", data, "--tiny", "--greedy",
              "--max-length", "256", "--max-new-tokens", "5",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "2"]
    jax_out = str(tmp_path / "jax.jsonl")
    jax_main(common + ["--output-file", jax_out])

    def jax_weights(args, cfg, device):
        # the JAX CLI's tiny weights: fusion.init_params(cfg, key(0))
        jcfg = jfusion.FusionConfig(**{
            f: getattr(cfg, f) for f in ("dna_rna_k_tokens",
                                         "protein_k_tokens")},
            **{f: _jax_cfg(getattr(cfg, f))
               for f in ("text", "dna_rna", "protein")})
        jp = jfusion.init_params(jcfg, jax.random.key(0))
        return params_from_jax(jax.tree.map(np.asarray, jp), device)

    monkeypatch.setattr(cli, "_load_params", jax_weights)
    torch_out = str(tmp_path / "torch.jsonl")
    cli.main(common + ["--output-file", torch_out, "--device", "cpu"])
    ref = [json.loads(line) for line in open(jax_out)]
    got = [json.loads(line) for line in open(torch_out)]
    assert len(got) == len(ref) == 5
    assert got == ref


def _jax_cfg(tcfg_obj):
    from molly_tpu.models import configs as jcfg
    import dataclasses
    cls = getattr(jcfg, type(tcfg_obj).__name__)
    return cls(**dataclasses.asdict(tcfg_obj))


# ---------------------------------------------------------------- no jax


_BLOCK_JAX = r"""
import importlib, io, os, pkgutil, sys, tempfile
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "molly_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in the port: " + name)
        return None

sys.meta_path.insert(0, _Blocked())
import molly_tpu_torch
names = [m.name for m in pkgutil.walk_packages(molly_tpu_torch.__path__,
                                                "molly_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)

# drive the entry points: the --tiny batch CLI's loop and one --tiny train
# step, on in-memory samples (no parquet reader is needed for that)
import torch
from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                  default_modality_tokenizers,
                                  load_text_tokenizer)
from molly_tpu_torch.inference import cli as icli
from molly_tpu_torch.models import GenerationConfig, fusion
from molly_tpu_torch.training import cli as tcli
from molly_tpu_torch.training.trainer import TrainConfig, init_train_state

text_tok = load_text_tokenizer(None)
dna_tok, prot_tok = default_modality_tokenizers()
enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
    max_len=192, dna_rna_k_tokens=4, protein_k_tokens=4))
rows = [{"task": "pd-prom_300", "kind": "dna", "label": "1",
         "input": "Is <dna>ACGTACGTACGT</dna> a promoter?", "output": "Yes"},
        {"task": "Solubility-Solubility", "kind": "protein", "label": "0",
         "input": "Soluble? <protein>MKTAYIAKQR</protein>", "output": "No"}]
args = icli.build_argparser().parse_args(
    ["--input-file", "unused", "--output-file", "unused", "--tiny",
     "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4"])
cfg = icli.build_config(args, text_tok, dna_tok, prot_tok)
params = fusion.init_params(cfg, torch.Generator().manual_seed(0))
recs = icli.run_batches(
    [enc.encode_test(r) for r in rows], params, cfg,
    GenerationConfig(max_new_tokens=2, do_sample=False,
                     eos_token_id=text_tok.eos_token_id,
                     pad_token_id=text_tok.pad_token_id or 0),
    text_tok, io.StringIO(), batch_size=2)
assert len(recs) == 2
tc = TrainConfig(total_steps=1)
out = tcli.train_loop(init_train_state(params, tc), cfg, tc,
                      [enc.encode_train(r) for r in rows], batch_size=2,
                      total_steps=1, device="cpu", output_dir=None)
assert out["steps"] == 1 and out["final_loss"] > 0

bad = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("imported", len(names) + 1, "modules")
"""


def test_port_imports_no_jax():
    """Every molly_tpu_torch module and chip_smoke.py import, and the
    --tiny batch loop and one --tiny train step run, with jax, optax, orbax
    and the whole molly_tpu package blocked; none of them ends up in
    sys.modules. chip_smoke.py names no molly_tpu import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import molly_tpu_torch
    n = len(list(pkgutil.walk_packages(molly_tpu_torch.__path__,
                                         "molly_tpu_torch.")))
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {n + 1} modules" in out.stdout
    import re
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|optax|orbax|molly_tpu)(\.|\s|$)", re.M)
    sources = [os.path.join(root, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(root, "molly_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 20
    for path in sources:
        assert not pat.search(open(path).read()), path


@pytest.mark.parametrize("which", ["inference", "training"])
def test_clis_do_not_carry_on_without_a_card(which):
    """The entry points run on the card unless the caller asks for the CPU:
    with no CUDA device and no --device they stop instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    if which == "inference":
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["--input-file", "none.parquet", "--output-file",
                      "none.jsonl", "--tiny"])
    else:
        from molly_tpu_torch.training import cli as tcli
        with pytest.raises(SystemExit, match="--device cpu"):
            tcli.main(["--train-dataset-path", "none.parquet", "--tiny"])
