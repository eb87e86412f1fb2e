"""The encoder + head baselines of molly_tpu_torch held against molly_tpu on
the CPU, in fp32, at a tiny size: the classification dataset array for
array (every model type, both tag styles, the three label kinds, the
shuffle order of a seed), ``collate``, logits and loss (CE and BCE),
the bundled label sets, the eval metrics, and the training CLI run by both
packages on one parquet file. Tolerances are stated beside each
comparison."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu import baselines as jb
from molly_tpu.baselines import train as jtrain
from molly_tpu.data import NucleotideTokenizer as JNuc
from molly_tpu.data import ProteinTokenizer as JProt
from molly_tpu.models import tiny_esm as jtiny_esm
from molly_tpu_torch import baselines as tb
from molly_tpu_torch.baselines import dataset as tdataset
from molly_tpu_torch.baselines import model as tmodel
from molly_tpu_torch.baselines import train as ttrain
from molly_tpu_torch.data import NucleotideTokenizer, ProteinTokenizer
from molly_tpu_torch.models import tiny_esm
from molly_tpu_torch.models.convert import params_from_jax

ATOL = 1e-5  # fp32 logits and losses, two sum orders

MODEL_TYPES = ("NT", "ESM", "NT+ESM", "NT+NT", "ESM+ESM")
LABEL2ID = {"1.1.1.1": 0, "2.7.11.12": 1, "3.4.21.4": 2}


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _seqs(rng, n, alphabet, lo=6, hi=30):
    return ["".join(rng.choice(list(alphabet), rng.integers(lo, hi)))
            for _ in range(n)]


def _rows(model_type, labels, seed=0, n=11):
    """n rows for ``model_type``, alternating the two tag styles
    (``</dna>`` and the baseline data's ``<dna>``), lower-case bases in a
    few, and the given label strings in turn."""
    rng = np.random.default_rng(seed)
    dna, prot = _seqs(rng, 2 * n, "ACGTN"), _seqs(rng, 2 * n,
                                                   "ACDEFGHIKLMNPQRSTVWY")
    rows = []
    for i in range(n):
        close = "/" if i % 2 else ""
        d = [f"<dna>{s.lower() if i % 3 == 0 else s}<{close}dna>"
             for s in dna[2 * i:2 * i + 2]]
        r = f"<rna>{dna[2 * i]}<{close}rna>"
        p = [f"<protein>{s}<{close}protein>" for s in prot[2 * i:2 * i + 2]]
        nt = d[0] if i % 4 else r   # an RNA sequence counts as NT too
        body = {"NT": f"x {nt} y", "ESM": f"q {p[0]}",
                "NT+ESM": f"{nt} binds {p[0]}?",
                "NT+NT": f"{d[0]} vs {d[1]}", "ESM+ESM": f"{p[0]} {p[1]}"}
        rows.append({"input": body[model_type],
                     "label": labels[i % len(labels)]})
    return rows


LABEL_KINDS = {
    "binary": (["positive", "negative", "negative"], {}),
    "regression": (["0.25", "3", "-1.5", "2.0"], {}),
    "multihot": (["EC1.1.1.1, 2.7.11.12", "EC3.4.21.4", "2.7.11.12, 9.9"],
                 dict(label2id=LABEL2ID, multi_label=True)),
}


@pytest.mark.parametrize("kind", sorted(LABEL_KINDS))
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_dataset_equal_to_jax_array_for_array(model_type, kind):
    labels, kw = LABEL_KINDS[kind]
    rows = _rows(model_type, labels, seed=len(model_type))
    df = pd.DataFrame(rows)
    ref = jb.ClassificationDataset(df, model_type, JNuc(), JProt(), 12, 10,
                                   shuffle=True, seed=5, **kw)
    for source in (df, rows):  # a DataFrame and the rows in memory
        got = tb.ClassificationDataset(source, model_type,
                                       NucleotideTokenizer(),
                                       ProteinTokenizer(), 12, 10,
                                       shuffle=True, seed=5, **kw)
        assert len(got) == len(ref)
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_shuffle_order_is_dataframe_sample(n, seed):
    df = pd.DataFrame({"i": np.arange(n)})
    want = df.sample(frac=1, random_state=np.random.default_rng(seed))
    np.testing.assert_array_equal(tdataset.shuffle_order(n, seed),
                                  want["i"].to_numpy())


def test_dataset_errors_like_jax():
    rows = _rows("NT+NT", ["positive"])
    for cls, toks in ((jb.ClassificationDataset, (JNuc(), JProt())),
                      (tb.ClassificationDataset,
                       (NucleotideTokenizer(), ProteinTokenizer()))):
        with pytest.raises(AssertionError):
            cls(pd.DataFrame(rows), "NT", *toks, 8, 8)[0]
        with pytest.raises(ValueError, match="unparseable"):
            cls(pd.DataFrame([{"input": "<dna>ACGT</dna>", "label": "x"}]),
                "NT", *toks, 8, 8)[0]
        with pytest.raises(ValueError, match="no label"):
            cls(pd.DataFrame([{"input": "<protein>MK</protein>",
                               "label": "EC7.7"}]), "ESM", *toks, 8, 8,
                label2id=LABEL2ID, multi_label=True)[0]


def test_collate_equal():
    rows = _rows("NT+ESM", ["negative", "positive"])
    ref = jb.ClassificationDataset(pd.DataFrame(rows), "NT+ESM", JNuc(),
                                   JProt(), 12, 10)
    got = tb.ClassificationDataset(rows, "NT+ESM", NucleotideTokenizer(),
                                   ProteinTokenizer(), 12, 10)
    a = jb.collate([ref[i] for i in range(5)])
    b = tb.collate([got[i] for i in range(5)])
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == a[k].dtype
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _configs(num_labels, multi_answer=False, model_type="NT"):
    nt = dict(vocab_size=NucleotideTokenizer().vocab_size, mask_token_id=2,
              dtype="float32")
    prot = dict(vocab_size=ProteinTokenizer().vocab_size, dtype="float32")
    jcfg = jb.BaselineConfig(model_type=model_type, nt=jtiny_esm(**nt),
                             protein=jtiny_esm(**prot),
                             num_labels=num_labels,
                             multi_answer=multi_answer)
    tcfg = tb.BaselineConfig(model_type=model_type, nt=tiny_esm(**nt),
                             protein=tiny_esm(**prot), num_labels=num_labels,
                             multi_answer=multi_answer)
    return jcfg, tcfg


@pytest.mark.parametrize("model_type,multi_answer", [
    (mt, False) for mt in MODEL_TYPES] + [("NT+ESM", True), ("ESM", True)])
def test_logits_and_loss_match_jax(model_type, multi_answer):
    labels, kw = LABEL_KINDS["multihot" if multi_answer else "binary"]
    rows = _rows(model_type, labels, seed=3)
    rows[2]["input"] = rows[2]["input"].replace("A", "", 4)  # more padding
    ds = tb.ClassificationDataset(rows, model_type, NucleotideTokenizer(),
                                  ProteinTokenizer(), 16, 12, **kw)
    batch = tb.collate([ds[i] for i in range(6)])
    jcfg, tcfg = _configs(3 if multi_answer else 2, multi_answer, model_type)
    jp = jb.init_params(jcfg, jax.random.key(11))
    # a head of unit scale, so the logits are not all near zero
    rng = np.random.default_rng(2)
    jp["head"]["bias"] = jnp.asarray(
        rng.normal(size=jp["head"]["bias"].shape).astype(np.float32))
    jloss, jlogits = jb.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    tp = params_from_jax(_np_tree(jp))
    tloss, tlogits = tb.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    assert abs(float(tloss) - float(jloss)) <= ATOL
    if model_type != "NT+ESM":
        return
    # the head's gradient agrees too, and the frozen backbones get none
    for k in tp:
        for t in jax.tree.leaves(tp[k]):
            t.requires_grad_(k == "head")
    jg = jax.grad(lambda p: jb.loss_fn(p, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    loss, _ = tb.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    gk, = torch.autograd.grad(loss, [tp["head"]["kernel"]])
    np.testing.assert_allclose(gk.numpy(), np.asarray(jg["head"]["kernel"]),
                               atol=ATOL)


def test_init_params_shapes_match_jax_and_pairs_are_independent():
    jcfg, tcfg = _configs(4, model_type="NT+NT")
    jp = _np_tree(jb.init_params(jcfg, jax.random.key(0)))
    tp = tb.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(np.shape, jp)) == \
        jax.tree.structure(jax.tree.map(lambda t: tuple(t.shape), tp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert tuple(b.shape) == a.shape and str(b.dtype).endswith(
            str(a.dtype))
    assert not torch.equal(tp["enc1"]["embed"], tp["enc2"]["embed"])
    bound = tp["head"]["kernel"].shape[0] ** -0.5
    assert float(tp["head"]["kernel"].abs().max()) <= bound
    assert not tp["head"]["bias"].any()


@pytest.mark.parametrize("name", ["ec", "ncrna", "modification"])
def test_load_label_set_equal(name):
    assert ttrain.load_label_set(name) == jtrain.load_label_set(name)


@pytest.mark.parametrize("name,multi_label", [
    ("acc", False), ("acc", True), ("mcc", False), ("fmax", True),
    ("auc", True), ("auc", False)])
def test_compute_metric_equal(name, multi_label):
    rng = np.random.default_rng(len(name) + multi_label)
    if multi_label:
        logits = rng.normal(size=(20, 5)).astype(np.float32)
        labels = (rng.random((20, 5)) < 0.4).astype(np.float32)
        labels[0] = 1.0
    else:
        logits = rng.normal(size=(20, 2)).astype(np.float32)
        labels = rng.integers(0, 2, 20)
    assert ttrain.compute_metric(name, logits, labels, multi_label) == \
        jtrain.compute_metric(name, logits, labels, multi_label)


def test_cli_flags_match_the_jax_cli():
    def flags(p):
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    jf, tf = flags(jtrain.build_argparser()), flags(ttrain.build_argparser())
    assert {k: tf[k] for k in jf} == jf
    assert set(tf) - set(jf) == {"device"}


def test_train_cli_matches_jax(tmp_path, monkeypatch):
    """``main(["--tiny", ...])`` of both packages on one parquet file, the
    port given the JAX run's initial params: equal steps, the final loss
    within 1e-5, the head after training within 1e-5, the same JSONL
    records (loss and head_delta within 1e-5) and eval metric."""
    rows = _rows("NT+ESM", ["positive", "negative", "negative"], n=14)
    path = str(tmp_path / "train.parquet")
    pd.DataFrame(rows).to_parquet(path)
    argv = ["--model-type", "NT+ESM", "--train-file", path, "--eval-file",
            path, "--tiny", "--dna-rna-k-tokens", "12",
            "--protein-k-tokens", "10", "--batch-size", "4", "--epochs", "2",
            "--log-interval", "2", "--eval-interval", "3", "--metric",
            "acc", "--seed", "3"]

    seen = {}
    real_init, real_jit = jb.model.init_params, jax.jit

    def jinit(cfg, key):
        seen["init"] = _np_tree(real_init(cfg, key))
        return jax.tree.map(jnp.asarray, seen["init"])

    def jit(fn, *a, **kw):  # records the params the step returns
        f = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "step":
            return f

        def run(*args):
            out = f(*args)
            seen["params"] = out[0]
            return out
        return run

    monkeypatch.setattr(jb.model, "init_params", jinit)
    monkeypatch.setattr(jax, "jit", jit)
    jres = jtrain.main(argv + ["--output-dir", str(tmp_path / "j")])
    monkeypatch.setattr(jax, "jit", real_jit)
    monkeypatch.setattr(tmodel, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            seen["init"], device))
    tres = ttrain.main(argv + ["--output-dir", str(tmp_path / "t"),
                               "--device", "cpu"])

    assert tres["steps"] == jres["steps"] == 6
    assert abs(tres["final_loss"] - jres["final_loss"]) <= ATOL
    assert tres["eval_acc"] == jres["eval_acc"]
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(
            tres["params"]["head"][k].detach().numpy(),
            np.asarray(seen["params"]["head"][k]), atol=ATOL)
    # the frozen backbones did not move and never required grad
    for k in ("enc1", "enc2"):
        for a, b in zip(jax.tree.leaves(seen["init"][k]),
                        jax.tree.leaves(tres["params"][k])):
            assert not b.requires_grad
            np.testing.assert_array_equal(b.numpy(), a)
    jrec = [json.loads(l) for l in open(tmp_path / "j" / "baseline.jsonl")]
    trec = [json.loads(l) for l in open(tmp_path / "t" / "baseline.jsonl")]
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for a, b in zip(jrec, trec):
        for k in a:
            assert abs(a[k] - b[k]) <= ATOL, (k, a, b)
    assert trec[-2]["head_delta"] > 0


def test_train_cli_takes_rows_in_memory(tmp_path):
    rows = _rows("ESM", ["EC1.1.1.1", "EC3.4.21.4, 2.7.11.12"], n=8)
    stats = {}
    res = ttrain.main(["--model-type", "ESM", "--train-file", "unused",
                       "--tiny", "--protein-k-tokens", "10", "--batch-size",
                       "4", "--multi-label", "--label-set", "ec",
                       "--metric", "fmax", "--eval-interval", "2",
                       "--output-dir", str(tmp_path), "--device", "cpu"],
                      train_rows=rows, eval_rows=rows, stats=stats)
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval_fmax"] <= 1.0
    assert len(stats["step_s"]) == 2
    assert res["params"]["head"]["kernel"].shape[1] == len(
        ttrain.load_label_set("ec"))
    assert os.path.exists(tmp_path / "baseline.jsonl")
