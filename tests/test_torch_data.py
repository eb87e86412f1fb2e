"""molly_tpu_torch.data (the port's own copy of the data layer) held against
molly_tpu.data: the same rows give identical arrays through both tokenizers,
``encode_train`` / ``encode_test`` and the collators; the host pipeline's
``put`` makes tensors on the device asked for; the native tokenizer library
builds into the port's ``_build`` directory.
"""

import numpy as np
import pytest
import torch

from molly_tpu import data as jdata
from molly_tpu_torch import data as tdata
from molly_tpu_torch.data import pipeline

ROWS = [
    {"task": "pd-prom_300", "kind": "DNA",
     "input": "Is <dna>ACGTACGTTAGCTAGCTAGGATCGATCGANNACGT</dna> a promoter?",
     "think": "look at the TATA box", "output": "yes", "label": "1"},
    {"task": "Solubility-Solubility", "kind": "Protein",
     "input": "Solubility of <protein>MKTAYIAKQRQISFVKSHFSRQ</protein>?",
     "output": "soluble", "label": "1"},
    {"task": "rna_protein_interaction", "kind": "Multi",
     "input": "Does <rna>ACGUACGUUAGC</rna> bind <protein>MKV</protein> or "
              "<protein>GGSGG</protein>?", "output": "no", "label": "0"},
    {"task": "no such task", "kind": "Text", "input": "plain text only",
     "output": "fine", "label": ""},
]
CFG = dict(max_len=384, dna_rna_k_tokens=12, protein_k_tokens=10,
           max_dna_rna_segments=2, max_protein_segments=2)


def _encoders(**kw):
    out = []
    for mod in (jdata, tdata):
        out.append(mod.OmicsSampleEncoder(
            mod.ByteTextTokenizer(), mod.NucleotideTokenizer(),
            mod.ProteinTokenizer(), mod.DataConfig(**{**CFG, **kw})))
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name,seq", [
    ("NucleotideTokenizer", "ACGTACGTTAGCTAGCTAGGATCGATCGANNACGTA"),
    ("ProteinTokenizer", "MKTAYIAKQRQISFVKSHFSRQXBZ"),
])
def test_modality_tokenizers_identical(name, seq):
    jt, tt = getattr(jdata, name)(), getattr(tdata, name)()
    assert jt.vocab_size == tt.vocab_size
    for k in (4, 9, 64):
        np.testing.assert_array_equal(jt.encode(seq, max_length=k),
                                      tt.encode(seq, max_length=k))


def test_text_tokenizer_identical():
    jt, tt = jdata.load_text_tokenizer(None), tdata.load_text_tokenizer(None)
    text = "Is <|dna_start|> this ünïcode? <think>yes</think>"
    assert jt.vocab_size == tt.vocab_size
    assert jt.eos_token_id == tt.eos_token_id
    assert jt.pad_token_id == tt.pad_token_id
    ids = jt.encode(text, add_special_tokens=False)
    assert ids == tt.encode(text, add_special_tokens=False)
    assert jt.decode(ids) == tt.decode(ids)


@pytest.mark.parametrize("row", range(len(ROWS)))
@pytest.mark.parametrize("mode", ["train", "test"])
def test_encode_identical(row, mode):
    je, te = _encoders()
    fn = "encode_train" if mode == "train" else "encode_test"
    _assert_same(getattr(je, fn)(ROWS[row]), getattr(te, fn)(ROWS[row]))


def test_encode_train_truncation_identical():
    je, te = _encoders(max_len=140)
    for row in ROWS:
        _assert_same(je.encode_train(row), te.encode_train(row))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_collate_identical(mode):
    je, te = _encoders()
    fn = "encode_train" if mode == "train" else "encode_test"
    jb = getattr(jdata, f"collate_{mode}")([getattr(je, fn)(r) for r in ROWS])
    tb = getattr(tdata, f"collate_{mode}")([getattr(te, fn)(r) for r in ROWS])
    _assert_same(jb, tb)


def test_constants_and_task_ids_identical():
    for name in ("LABEL_IGNORE", "ENCODER_PAD_ID", "NUM_DOMAIN_TASKS",
                 "UNKNOWN_TASK_ID", "OMICS_SPECIAL_TOKENS"):
        assert getattr(jdata, name) == getattr(tdata, name), name
    for row in ROWS:
        assert jdata.task_name_to_id(row["task"]) == \
            tdata.task_name_to_id(row["task"])


def test_iterate_batches_identical_order():
    je, te = _encoders()
    js = [je.encode_train(r) for r in ROWS]
    ts = [te.encode_train(r) for r in ROWS]
    for jb, tb in zip(
            jdata.iterate_batches(js, 2, shuffle=True, seed=3, epoch=1),
            tdata.iterate_batches(ts, 2, shuffle=True, seed=3, epoch=1)):
        _assert_same(jb, tb)


def test_input_pipeline_puts_tensors_on_the_device():
    _, te = _encoders()
    samples = [te.encode_train(r) for r in ROWS]
    batches = list(pipeline.input_pipeline(
        samples, 2, shuffle=False, put=pipeline.to_device("cpu"), depth=2))
    assert len(batches) == 2
    ref = tdata.collate_train(samples[:2])
    for k, v in batches[0].items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_native_tokenizers_build_into_the_ports_build_dir():
    from molly_tpu_torch import native
    from molly_tpu_torch.data import native_tokenizers as nt
    if not native.available():
        pytest.skip(f"no C++ compiler here: {native.build_error()}")
    assert "molly_tpu_torch/_build/" in native._LIB.replace("\\", "/")
    seqs = ["ACGTACGTTAGCTAGCTAGGATCGATCGANNACGTA", "ACG", ""]
    np.testing.assert_array_equal(
        nt.NativeNucleotideTokenizer().encode_batch(seqs, 9),
        np.stack([jdata.NucleotideTokenizer().encode(s, max_length=9)
                  for s in seqs]))
    prots = ["MKTAYIAKQRQ", "GG"]
    np.testing.assert_array_equal(
        nt.NativeProteinTokenizer().encode_batch(prots, 8),
        np.stack([jdata.ProteinTokenizer().encode(s, max_length=8)
                  for s in prots]))
