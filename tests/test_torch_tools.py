"""The port's embedding, judge and CoT tools held against molly_tpu's on the
CPU, in fp32: ``embed_batch`` within 1e-5 of JAX's on the same weights and
batch, ``pca_2d`` equal up to each component's sign (1e-4),
``run_embedding`` writing the same files, the judge helpers on the JAX
tests' strings, ``make_engine_judge`` with a small random judge giving
JAX's responses and verdicts, and ``cot_gen`` (a copy) writing the same rows
as JAX's against a local mock endpoint on 127.0.0.1.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.data import (ByteTextTokenizer, DataConfig,
                            NucleotideTokenizer, OmicsDataset,
                            ProteinTokenizer)
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import tiny_esm, tiny_qwen3
from molly_tpu.models.fusion import FusionConfig
from molly_tpu.tools import cot_gen as jcot
from molly_tpu.tools import embed as jembed
from molly_tpu.tools import llm_judge as jjudge
from molly_tpu_torch import tools as ttools
from molly_tpu_torch.data import ByteTextTokenizer as TByteTok
from molly_tpu_torch.data import DataConfig as TDataConfig
from molly_tpu_torch.data import NucleotideTokenizer as TNucTok
from molly_tpu_torch.data import OmicsDataset as TOmicsDataset
from molly_tpu_torch.data import ProteinTokenizer as TProtTok
from molly_tpu_torch.tools import cot_gen, embed, llm_judge
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_api_server import _weights
from test_torch_models import _np_tree, _tcfg_of

EMBED_ATOL = 1e-5
PCA_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side (a pool of threads a worker made each
    small op wait on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = [
    {"task": "a", "input": "x <dna>ACGTACGGTA</dna> and more", "output": "y",
     "think": "", "label": "", "kind": "dna"},
    {"task": "b", "input": "<protein>MKTAYIAK</protein> z", "output": "n",
     "think": "", "label": "", "kind": "protein"},
    {"task": "c", "input": "both <dna>ACGT</dna> <protein>MKQR</protein>",
     "output": "y", "think": "", "label": "", "kind": "multi"},
    {"task": "a", "input": "plain text only", "output": "n", "think": "",
     "label": "", "kind": "text"},
]


@pytest.fixture(scope="module")
def embed_setup():
    text = ByteTextTokenizer()
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=512),
        dna_rna=tiny_esm(vocab_size=NucleotideTokenizer().vocab_size,
                         mask_token_id=2),
        protein=tiny_esm(vocab_size=ProteinTokenizer().vocab_size),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    tree = _np_tree(jfusion.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(2)
    for name in ("dna_rna_projector", "protein_projector"):
        tree[name]["bias"] = rng.normal(
            size=tree[name]["bias"].shape).astype(np.float32)
    df = pd.DataFrame(ROWS)
    dcfg = dict(max_len=160, dna_rna_k_tokens=4, protein_k_tokens=4,
                max_dna_rna_segments=1, max_protein_segments=1)
    jds = OmicsDataset(df, text, NucleotideTokenizer(), ProteinTokenizer(),
                       DataConfig(**dcfg))
    tds = TOmicsDataset(df, TByteTok(), TNucTok(), TProtTok(),
                        TDataConfig(**dcfg))
    return (cfg, jax.tree.map(jnp.asarray, tree), _tcfg_of(cfg),
            params_from_jax(tree), jds, tds)


def test_embed_batch_matches_jax(embed_setup):
    from molly_tpu.data.collate import collate_train
    cfg, jp, tcfg, tp, jds, tds = embed_setup
    batch = collate_train([jds[i] for i in range(len(ROWS))])
    ref = jembed.embed_batch(jp, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got = embed.embed_batch(tp, tcfg, batch)
    assert got.shape == ref.shape == (4, 64 + 32 + 32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=EMBED_ATOL)
    assert not np.allclose(got[0], got[1])


def _same_up_to_sign(got, ref):
    for c in range(ref.shape[1]):
        s = np.sign(np.dot(got[:, c], ref[:, c])) or 1.0
        np.testing.assert_allclose(s * got[:, c], ref[:, c], atol=PCA_ATOL)


def test_pca_2d_matches_jax():
    x = np.random.default_rng(0).normal(size=(20, 7)).astype(np.float32)
    x[:, 2] *= 5
    _same_up_to_sign(embed.pca_2d(x), jembed.pca_2d(x))


def test_run_embedding_writes_the_same_files(embed_setup, tmp_path):
    cfg, jp, tcfg, tp, jds, tds = embed_setup
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jres = jembed.run_embedding(jds, jp, cfg, jdir, batch_size=3)
    tres = embed.run_embedding(tds, tp, tcfg, tdir, batch_size=3)
    assert {k: v for k, v in tres.items() if k != "out_dir"} == \
        {k: v for k, v in jres.items() if k != "out_dir"}
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    np.testing.assert_allclose(np.load(f"{tdir}/embeddings.npy"),
                               np.load(f"{jdir}/embeddings.npy"),
                               atol=EMBED_ATOL)
    jproj = pd.read_parquet(f"{jdir}/projection_2d.parquet")
    tproj = pd.read_parquet(f"{tdir}/projection_2d.parquet")
    assert list(tproj.columns) == list(jproj.columns) == ["x", "y"]
    _same_up_to_sign(tproj.to_numpy(), jproj.to_numpy())


# ---------------------------------------------------------------- judge


def test_judge_helpers_match_jax():
    strings = ["<think>reasoning\nstuff</think>Yes", "Yes.", "no way",
               "maybe", "<think>no</think> yes indeed", "NO!", ""]
    for s in strings:
        assert llm_judge.strip_think(s) == jjudge.strip_think(s)
        assert llm_judge.parse_verdict(s) == jjudge.parse_verdict(s)
    records = [
        {"task": "t1", "model_output": "Yes it binds", "label": "positive"},
        {"task": "t1", "model_output": "No", "label": "positive"},
        {"task": "t2", "decoded_output": "<think>hmm</think>Yes",
         "gt_label": "positive"},
    ]

    def stub(prompt):
        return "Yes" if "yes" in prompt.lower().split("model answer:")[1] \
            else "No"

    assert llm_judge.JUDGE_PROMPT == jjudge.JUDGE_PROMPT
    out = llm_judge.judge_records(records, stub)
    assert out == jjudge.judge_records(records, stub)
    assert out["t1"]["accuracy"] == 0.5 and out["overall"]["total"] == 3
    assert ttools.judge_records is llm_judge.judge_records


def test_engine_judge_matches_jax():
    """A small random judge on both packages' engines: the same responses,
    and ``judge_records`` over them the same table."""
    from molly_tpu.data import load_text_tokenizer as jload
    from molly_tpu_torch.data import load_text_tokenizer
    jtok, ttok = jload(None), load_text_tokenizer(None)
    vocab = -(-ttok.vocab_size // 128) * 128
    cfg = FusionConfig(
        text=tiny_qwen3(vocab_size=vocab, tie_word_embeddings=False),
        dna_rna=tiny_esm(), protein=tiny_esm(), dna_rna_k_tokens=4,
        protein_k_tokens=4)
    tree = _weights(cfg, 3)["text"]
    jfn = jjudge.make_engine_judge(jax.tree.map(jnp.asarray, tree),
                                   cfg.text, jtok, max_new_tokens=6)
    tfn = llm_judge.make_engine_judge(params_from_jax(tree),
                                      _tcfg_of(cfg.text), ttok,
                                      max_new_tokens=6)
    records = [{"task": "t", "model_output": f"answer {i}",
                "label": "positive" if i % 2 else "negative"}
               for i in range(3)]
    for rec in records:
        prompt = jjudge.JUDGE_PROMPT.format(label=rec["label"],
                                            answer=rec["model_output"])
        got = tfn(prompt)
        assert got == jfn(prompt) and got
    assert llm_judge.judge_records(records, tfn) == \
        jjudge.judge_records(records, jfn)


# ---------------------------------------------------------------- cot_gen


class _MockChat(BaseHTTPRequestHandler):
    """An OpenAI-style /chat/completions endpoint: reasoning in a <think>
    span of the content, as ``tests/test_cot_gen.py``'s fake transport."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        prompt = req["messages"][-1]["content"]
        body = json.dumps({"choices": [{"message": {
            "content": f"<think>because {prompt}</think>\nAnswer: yes"}}],
            "usage": {"completion_tokens": 7}}).encode()
        self.send_response(200 if self.path.endswith("/chat/completions")
                           else 404)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def mock_endpoint():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _MockChat)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/v1"
    httpd.shutdown()
    httpd.server_close()


def test_cot_gen_against_mock_server_matches_jax(mock_endpoint, tmp_path):
    df = pd.DataFrame([{"task": f"t{i}", "input": f"q{i}"}
                       for i in range(6)])
    rows = {}
    for name, mod in (("jax", jcot), ("port", cot_gen)):
        out = str(tmp_path / f"{name}.jsonl")
        stats = mod.process_dataframe(df, out, base_url=mock_endpoint,
                                      model="m", workers=3,
                                      progress_every=0)
        assert stats == {"done": 6, "skipped": 0, "failed": 0}
        rows[name] = sorted((json.loads(line) for line in open(out)),
                            key=lambda r: r["id"])
        # resume: nothing is asked again
        again = mod.process_dataframe(df, out, base_url=mock_endpoint,
                                      model="m", workers=3,
                                      progress_every=0)
        assert again == {"done": 0, "skipped": 6, "failed": 0}
    assert rows["port"] == rows["jax"]
    assert rows["port"][0]["think"] == "because q0"
    assert rows["port"][0]["output"] == "Answer: yes"


def test_cot_gen_copy_matches_jax_source():
    """The copy differs from the JAX module only in its docstring and
    parser name."""
    import inspect
    for name in ("chat_completion", "read_existing_ids", "process_dataframe"):
        assert inspect.getsource(getattr(cot_gen, name)) == \
            inspect.getsource(getattr(jcot, name)), name
    assert cot_gen.SYSTEM_PROMPT == jcot.SYSTEM_PROMPT
    assert cot_gen.REPHRASE_SYSTEM_PROMPT == jcot.REPHRASE_SYSTEM_PROMPT


@pytest.mark.parametrize("transport,want", [
    ("think", ("because q1", "Answer: yes", 7)),
    ("r1", ("deep thought", "Answer: no", 3)),
])
def test_cot_gen_transports(transport, want):
    def fake(url, payload):
        prompt = json.loads(payload)["messages"][-1]["content"]
        if transport == "think":
            return {"choices": [{"message": {
                "content": f"<think>because {prompt}</think>\nAnswer: yes"}}],
                "usage": {"completion_tokens": 7}}
        return {"choices": [{"message": {"content": "Answer: no",
                                         "reasoning_content": "deep thought"}}],
                "usage": {"completion_tokens": 3}}

    out = cot_gen.chat_completion("http://x/v1", "m", "q1", transport=fake)
    assert (out["reasoning"], out["content"], out["completion_tokens"]) == want


def test_cot_gen_failures_and_rephrase(tmp_path, monkeypatch):
    calls, systems = [], []

    def flaky(url, payload):
        calls.append(1)
        raise ConnectionError("boom")

    df = pd.DataFrame([{"task": "t", "input": "q", "label": "GOLD"}])
    out = str(tmp_path / "f.jsonl")
    monkeypatch.setattr(cot_gen.time, "sleep", lambda s: None)  # no waits
    stats = cot_gen.process_dataframe(df, out, base_url="http://x/v1",
                                      model="m", workers=1, max_retries=2,
                                      transport=flaky, progress_every=0)
    assert stats["failed"] == 1 and len(calls) == 2
    assert cot_gen.read_existing_ids(out) == set()

    def capture(url, payload):
        systems.append(json.loads(payload)["messages"][0]["content"])
        return {"choices": [{"message": {"content": "rephrased"}}],
                "usage": {}}

    stats = cot_gen.process_dataframe(df, str(tmp_path / "r.jsonl"),
                                      base_url="http://x/v1", model="m",
                                      workers=1, transport=capture,
                                      progress_every=0, rephrase=True)
    assert stats["done"] == 1
    assert "bioinformatics" in systems[0] and "GOLD" in systems[0]
