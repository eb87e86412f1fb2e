"""molly_tpu_torch.evalsuite and molly_tpu_torch.tools (data tools, their
CLI) held against the JAX package's originals they were copied from.

The inputs are those of ``tests/test_evalsuite.py``,
``tests/test_eval_protocol.py``, ``tests/test_tools.py`` and
``tests/test_sentiment_model.py``. Scores must be EQUAL (not close): the
copies run the same numpy / scipy / sklearn code on the same rows. The last
test drives the port's whole scoring path (batch CLI -> convert ->
harness) with jax and molly_tpu blocked.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from molly_tpu import evalsuite as jeval
from molly_tpu.evalsuite import harness as jharness
from molly_tpu.evalsuite import metrics as JM
from molly_tpu.evalsuite import registry as jreg
from molly_tpu.tools import cli as jtools_cli
from molly_tpu.tools import data_tools as jdt
from molly_tpu_torch import evalsuite as teval
from molly_tpu_torch.evalsuite import harness as tharness
from molly_tpu_torch.evalsuite import metrics as TM
from molly_tpu_torch.evalsuite import registry as treg
from molly_tpu_torch.tools import cli as ttools_cli
from molly_tpu_torch.tools import data_tools as tdt
from test_eval_protocol import build_protocol_jsonl
from test_sentiment_model import sentiment_dir  # noqa: F401 (fixture)


def _same(a, b):
    """Equal, with nan equal to nan (a task whose metric is nan)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return a == b


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("name", ["TASK_REGISTRY", "TASK_RENAMES",
                                  "TASK_NAME_SUBSTITUTIONS",
                                  "SUBTASK_GROUPS", "AUTO_GROUP_PREFIXES"])
def test_registry_tables_equal_the_originals(name):
    assert getattr(treg, name) == getattr(jreg, name)


def test_metric_tables_and_ec_labels_equal_the_originals():
    for name in ("POSITIVE_KEYWORDS", "NEGATIVE_KEYWORDS",
                 "DONT_KNOW_KEYWORDS", "RNA_CLASSES",
                 "MODIFICATION_CLASSES", "_POS_WORDS", "_NEG_WORDS"):
        assert getattr(TM, name) == getattr(JM, name), name
    # the data file travels with the copy and is found from the repo root
    assert tharness._EC_LABELS_PATH != jharness._EC_LABELS_PATH
    assert os.path.exists(tharness._EC_LABELS_PATH)
    assert tharness.load_ec_labels() == jharness.load_ec_labels()
    assert len(tharness.load_ec_labels()) > 100
    for t in treg.TASK_REGISTRY:
        assert treg.get_base_task_name(t) == jreg.get_base_task_name(t)


# ---------------------------------------------------------------- metrics


_ENTRIES_R2 = [
    {"label": json.dumps({"ON": 1.0, "OFF": 2.0, "ON_OFF": 0.5}),
     "model_output": "1.1, 2.1, 0.6", "input": ""},
    {"label": json.dumps({"ON": 2.0, "OFF": 1.0, "ON_OFF": 2.0}),
     "model_output": "2.2, 1.2, 2.2", "input": ""},
    {"label": json.dumps({"ON": 3.0, "OFF": 4.0, "ON_OFF": 0.7}),
     "model_output": "2.9, 3.9, 0.8", "input": ""},
]
_ENTRIES_PCC = [
    {"label": json.dumps({"hk": 1.0, "dev": 5.0}),
     "model_output": "1.2 4.9", "input": ""},
    {"label": json.dumps({"hk": 2.0, "dev": 4.0}),
     "model_output": "2.1 4.1", "input": ""},
    {"label": json.dumps({"hk": 3.0, "dev": 3.0}),
     "model_output": "2.9 3.1", "input": ""},
]
_ENTRIES_BINARY = [
    {"label": "positive", "model_output": "Yes."},
    {"label": "negative", "model_output": "not detected"},
    {"label": "positive", "model_output": "I am unsure"},
    {"label": "positive", "model_output": None},
    {"label": "negative", "model_output": "weak inactive"},
]

_METRIC_CASES = [
    ("extract_numeric_values", ("value is 3.14 and -2",)),
    ("extract_numeric_values", ("no numbers",)),
    ("classify_by_keywords", ("Yes, it binds",)),
    ("classify_by_keywords", ("There is no evidence",)),
    ("classify_by_keywords", ("I am unsure about this",)),
    ("classify_by_keywords", ("banana",)),
    ("lexicon_sentiment", ("strong binding, likely active",)),
    ("compute_spearman", ([1, 2, 3, 4], [1, 2, float("inf"),
                                         float("inf")])),
    ("compute_r2", ([1.0, 2.0, 3.0, 4.0], [2.0, 4.0, 6.0, 8.5])),
    ("compute_mixed_score", ([10.0, 50.0, 90.0, 20.0],
                             [12.0, 45.0, 4000.0, 35.0])),
    ("compute_acc", ([1, 0, 1, 0], [1, 0, 1, 1])),
    ("compute_mcc", ([1, 0, 1, 0], [1, 0, 1, 1])),
    ("binary_outcomes", (_ENTRIES_BINARY,)),
    ("extract_rna_family", ("contains 5_8S_rRNA",)),
    ("extract_modifications", ("m6A and Psi sites, m6Am",)),
    ("compute_r2_programmable_rna_switches", (_ENTRIES_R2,)),
    ("compute_pcc_enhancer_activity", (_ENTRIES_PCC,)),
    ("fmax", (np.array([[1, 1, 0], [0, 1, 0]], float),
              np.array([[1, 0, 1], [0, 1, 0]], float))),
]


@pytest.mark.parametrize("fn,args", _METRIC_CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(_METRIC_CASES)])
def test_metric_functions_equal_the_originals(fn, args):
    assert _same(getattr(TM, fn)(*args), getattr(JM, fn)(*args))


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _evalsuite_rows():
    """The rows of test_evalsuite.py's end-to-end and grouping tests."""
    rows = []
    for i in range(6):
        rows.append({"task": "pd-prom_300_tata",
                     "label": "positive" if i % 2 else "negative",
                     "result": "Yes" if i % 2 else "No", "input": f"i{i}",
                     "kind": "dna"})
    for i in range(5):
        rows.append({"task": "Stability-Stability", "label": str(i * 1.0),
                     "result": f"The value is {i}.0", "input": f"s{i}",
                     "kind": "protein"})
    rows.append({"task": "NoncodingRNAFamily-NoncodingRNAFamily",
                 "label": "tRNA", "result": "This is tRNA", "input": "r",
                 "kind": "rna"})
    for i, sub in enumerate(["tf-m-0", "tf-m-1"]):
        for j in range(2):
            rows.append({"task": sub, "label": "positive",
                         "result": "yes", "input": f"x{i}{j}"})
    rows.append({"task": "rna_protein_interaction", "label": "negative",
                 "model_output": "no", "input": "y"})
    rows.append({"task": "emp-H3K4me3", "label": "positive",
                 "model_output": "yes", "input": "z"})
    return rows


@pytest.mark.parametrize("which", ["evalsuite", "protocol"])
def test_both_harnesses_give_the_same_scores(tmp_path, which):
    path = str(tmp_path / "inf.jsonl")
    if which == "protocol":
        build_protocol_jsonl(path)
    else:
        _write(path, _evalsuite_rows())
    entries = tharness.load_entries(path)
    assert _same(entries, jharness.load_entries(path))
    assert _same(teval.group_entries(entries),
                 jeval.group_entries(entries))
    got = teval.evaluate_file(path, processed_dir=str(tmp_path / "t"))
    ref = jeval.evaluate_file(path, processed_dir=str(tmp_path / "j"))
    assert _same(got, ref)
    n_tasks = sum(len(v) for v in got.values())
    assert n_tasks >= (40 if which == "protocol" else 8)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for f in os.listdir(tmp_path / "t"):
        assert open(tmp_path / "t" / f).read() == \
            open(tmp_path / "j" / f).read(), f


def test_harness_main_writes_the_same_file(tmp_path, capsys):
    path = str(tmp_path / "inf.jsonl")
    build_protocol_jsonl(path)
    for mod, name in ((tharness, "t.json"), (jharness, "j.json")):
        mod.main(["--input_file_path", path, "--output",
                  str(tmp_path / name)])
    assert open(tmp_path / "t.json").read() == \
        open(tmp_path / "j.json").read()


def test_hf_sentiment_fn_gives_the_same_class_and_score(sentiment_dir):  # noqa: F811
    tfn = TM.hf_sentiment_fn(sentiment_dir)
    jfn = JM.hf_sentiment_fn(sentiment_dir)
    for text in ("signal good maybe", "strong binding likely",
                 "weak inactive", "maybe"):
        assert tfn(text) == jfn(text)
    entries = [{"label": "positive", "model_output": "strong binding"},
               {"label": "negative", "model_output": "weak inactive"}]
    assert tharness.evaluate_task("pd-prom_300", entries,
                                  sentiment_fn=tfn) == \
        jharness.evaluate_task("pd-prom_300", entries, sentiment_fn=jfn)


# ---------------------------------------------------------------- tools


def _tagged_frame():
    return pd.DataFrame([
        {"task": "a", "input": "x <dna>ACGT</dna>", "think": "",
         "output": "y", "label": "positive", "kind": "dna"},
        {"task": "b", "input": "x <rna>ACGU</rna>", "think": "",
         "output": "n", "label": "negative", "kind": "rna"},
        {"task": "c", "input": "x <protein>MKT</protein>", "think": "",
         "output": "yes", "label": "positive", "kind": "protein"},
        {"task": "a", "input": "<dna>ACGT</dna> <protein>MKT</protein>",
         "think": "", "output": "abcdef", "label": "negative",
         "kind": "multi"},
        {"task": "e", "input": "no tags at all", "think": "", "output": "",
         "label": "positive", "kind": ""},
    ])


def test_data_tools_equal_the_originals():
    t = ("seq <|reserved_special_token_1|>ACGT</|reserved_special_token_1|>"
         " and <|reserved_special_token_3|>MKT</|reserved_special_token_3|>")
    assert tdt.replace_reserved_tokens(t) == jdt.replace_reserved_tokens(t)
    for s in ("<dna>ACGTN</dna>", "<dna>ACGTX</dna>",
              "<protein>MKTX</protein>"):
        assert tdt.validate_tagged_sequences(s) == \
            jdt.validate_tagged_sequences(s)
    df = _tagged_frame()
    assert tdt.dataset_stats(df) == jdt.dataset_stats(df)
    pd.testing.assert_frame_equal(tdt.balanced_subsample(df, 1),
                                  jdt.balanced_subsample(df, 1))
    pd.testing.assert_frame_equal(
        tdt.filter_by_markers(df, required=["dna"], forbidden=["protein"]),
        jdt.filter_by_markers(df, required=["dna"], forbidden=["protein"]))
    for mods in (["dna"], ["dna", "protein"], ["rna", "protein"]):
        pd.testing.assert_frame_equal(tdt.ablation_subset(df, mods),
                                      jdt.ablation_subset(df, mods))
    for a, b in zip(tdt.split_by_task(df, 0.5, seed=0),
                    jdt.split_by_task(df, 0.5, seed=0)):
        pd.testing.assert_frame_equal(a, b)
    for s in ("blah\nAnswer: Glycolysis\nmore", "Answer：膜转运", "none"):
        assert tdt.extract_answer(s) == jdt.extract_answer(s)
    from molly_tpu.data.tokenizers import ByteTextTokenizer as JByte
    from molly_tpu_torch.data.tokenizers import ByteTextTokenizer as TByte
    assert tdt.count_tokens_with_tokenizer(df, TByte()) == \
        jdt.count_tokens_with_tokenizer(df, JByte())


def _cli_inputs(tmp_path):
    src = tmp_path / "in"
    os.makedirs(src)
    _tagged_frame().to_parquet(src / "all.parquet")
    _tagged_frame().iloc[:2].to_parquet(src / "half.parquet")
    _write(src / "inf.jsonl", [
        {"task": "t", "input": "i", "decoded_output": "Yes",
         "gt_label": "positive", "kind": "dna"},
        {"task": "u", "input": "j", "decoded_output": "Answer: glycolysis",
         "gt_label": "Glycolysis", "kind": "rna"}])
    _write(src / "data.jsonl", [
        {"task": "t", "input": "<dna>ACGT</dna>", "output": "Yes",
         "label": "positive", "kind": "dna"},
        {"task": "t", "input": "<dna>ACGQ</dna>", "output": "No",
         "label": "negative", "kind": "dna"}])
    return src


_CLI_RUNS = [
    ["convert", "--src", "{in}/inf.jsonl", "--dst", "{out}/eval.jsonl"],
    ["to-parquet", "--src", "{in}/data.jsonl", "--dst", "{out}/d.parquet"],
    ["split", "--src", "{out}/all.parquet", "--ratio", "0.5"],
    ["merge", "--out", "{out}/m.parquet", "{in}/all.parquet",
     "{in}/half.parquet"],
    ["subsample", "--src", "{in}/all.parquet", "--dst", "{out}/s.parquet",
     "--n", "1"],
    ["ablation", "--src", "{in}/all.parquet", "--dst", "{out}/a.parquet",
     "--modalities", "dna,rna"],
    ["stats", "--src", "{in}/all.parquet"],
    ["leak-check", "--file1", "{in}/all.parquet", "--file2",
     "{in}/half.parquet"],
    ["kegg", "--src", "{in}/inf.jsonl"],
    ["count-tokens", "--src", "{in}/all.parquet"],
    ["inspect", "--src", "{in}/inf.jsonl", "--preview", "1"],
]


@pytest.mark.parametrize("argv", _CLI_RUNS, ids=[a[0] for a in _CLI_RUNS])
def test_tools_cli_subcommands_write_the_same_files(tmp_path, capsys, argv):
    src = _cli_inputs(tmp_path)
    outputs = {}
    for name, main in (("port", ttools_cli.main), ("jax", jtools_cli.main)):
        out = tmp_path / name
        os.makedirs(out)
        _tagged_frame().to_parquet(out / "all.parquet")  # split writes here
        args = [a.replace("{in}", str(src)).replace("{out}", str(out))
                for a in argv]
        code = 0
        try:
            main(args)
        except SystemExit as e:  # leak-check exits 1 on an overlap
            code = e.code
        printed = capsys.readouterr().out.replace(str(out), "<out>")
        outputs[name] = (code, printed, sorted(os.listdir(out)))
    assert outputs["port"] == outputs["jax"]
    for f in outputs["port"][2]:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(a),
                                          pd.read_parquet(b))
        else:
            assert open(a).read() == open(b).read(), f


# ---------------------------------------------------------------- no jax


_SCORE_PORT_OUTPUT = r"""
import json, os, sys
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "molly_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocked())
import pandas as pd
from molly_tpu_torch.evalsuite import harness
from molly_tpu_torch.inference import cli
from molly_tpu_torch.tools import cli as tools_cli

d = sys.argv[1]
rows = [{"task": "pd-prom_300_tata" if i % 2 else "Solubility",
         "input": (f"Is <dna>ACGTACGTACGT</dna> a promoter (v{i})?"
                   if i % 2 else f"Soluble? <protein>MKTAYIAKQR</protein>"),
         "output": "Yes", "think": "",
         "label": "positive" if i % 3 else "negative",
         "kind": "dna" if i % 2 else "protein"} for i in range(4)]
pd.DataFrame(rows).to_parquet(os.path.join(d, "x.parquet"))
cli.main(["--input-file", os.path.join(d, "x.parquet"),
          "--output-file", os.path.join(d, "out.jsonl"), "--tiny",
          "--greedy", "--max-length", "256", "--max-new-tokens", "3",
          "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
          "--batch-size", "4", "--device", "cpu"])
tools_cli.main(["convert", "--src", os.path.join(d, "out.jsonl"),
                "--dst", os.path.join(d, "eval.jsonl")])
harness.main(["--input_file_path", os.path.join(d, "eval.jsonl"),
              "--output", os.path.join(d, "metrics.json")])
bad = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("scored", json.load(open(os.path.join(d, "metrics.json"))))
"""


def test_port_batch_output_converts_and_scores_without_jax(tmp_path):
    """Main-path step 5 on the port alone: the --tiny batch CLI's JSONL,
    converted by the port's tools CLI and scored by the port's harness,
    with jax, optax, orbax and molly_tpu blocked."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SCORE_PORT_OUTPUT,
                          str(tmp_path)], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    scores = json.load(open(tmp_path / "metrics.json"))
    assert set(scores) == {"DNA", "Protein"}
    assert "pd-prom_300_tata" in scores["DNA"]
    assert "Solubility" in scores["Protein"]
    with open(tmp_path / "eval.jsonl") as f:
        rec = json.loads(f.readline())
    assert {"task", "label", "model_output"} <= set(rec)
