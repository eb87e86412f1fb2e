"""The port's OpenAI-style HTTP API (``inference.api_server``) held against
molly_tpu's on the CPU, in fp32: both servers run in this process on
ephemeral 127.0.0.1 ports over the same numpy-seeded weights, get the same
requests, and their JSON answers are compared field for field (``created``
aside, and ``id`` where concurrent requests race for request numbers):
greedy texts, ``finish_reason`` and ``usage`` under concurrency, SSE
against the non-streamed answer, chat, error status codes, stop
sequences, ``logprobs`` (1e-4), ``n`` choices, multi-LoRA routing,
``/v1/embeddings`` (1e-5) and the paged engine. The engine thread's
shutdown frees the KV pool without a garbage collection.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.data import DataConfig as JDataConfig
from molly_tpu.data import default_modality_tokenizers as jtoks
from molly_tpu.data import load_text_tokenizer as jload_tok
from molly_tpu.data.omics_dataset import OmicsSampleEncoder as JEncoder
from molly_tpu.inference import api_server as japi
from molly_tpu.inference.engine import GenerationConfig as JGen
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import lora as jlora
from molly_tpu.models import tiny_esm, tiny_qwen3
from molly_tpu.models.fusion import FusionConfig
from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                  default_modality_tokenizers,
                                  load_text_tokenizer)
from molly_tpu_torch.inference import api_server
from molly_tpu_torch.models import lora
from molly_tpu_torch.models.configs import GenerationConfig
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _np_tree, _tcfg_of

PROMPTS = [
    "What does this protein do? <protein>MKTAYIAKQR</protein>",
    "Classify this sequence: <dna>ACGTACGTAACC</dna>",
    "Is the sky blue?",
]
LOGPROB_ATOL = 1e-4
EMBED_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side (a pool of threads a worker made each
    small op wait on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg, seed):
    """Unit-scale numpy weights and an untied head that favours printable
    ASCII bytes (its other columns shrunk), so completions vary and decode
    to text."""
    tree = _np_tree(jfusion.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    text = tree["text"]
    text["embed"] = rng.normal(size=text["embed"].shape).astype(np.float32)
    for name, w in text["layers"].items():
        if w.ndim == 3:
            text["layers"][name] = (rng.normal(size=w.shape)
                                    * w.shape[1] ** -0.5).astype(np.float32)
    head = (rng.normal(size=text["lm_head"].shape)
            * text["lm_head"].shape[0] ** -0.5).astype(np.float32)
    printable = np.zeros(head.shape[1], bool)
    printable[32:127] = True
    head[:, ~printable] *= 0.1
    text["lm_head"] = head
    return tree


class Pair:
    """A JAX server and a port server on the same weights and settings."""

    def __init__(self, max_len=256, T=8, sampling=True, bank=None,
                 **server_kw):
        text_tok, dna_tok, prot_tok = (load_text_tokenizer(None),
                                       *default_modality_tokenizers())
        jt, (jd, jpr) = jload_tok(None), jtoks()
        vocab = -(-text_tok.vocab_size // 128) * 128
        cfg = FusionConfig(
            text=tiny_qwen3(vocab_size=vocab, dtype="float32",
                            tie_word_embeddings=False),
            dna_rna=tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                             dtype="float32"),
            protein=tiny_esm(vocab_size=prot_tok.vocab_size,
                             mask_token_id=prot_tok.mask_id,
                             dtype="float32"),
            dna_rna_k_tokens=4, protein_k_tokens=4)
        tree = _weights(cfg, 1)
        jparams = jax.tree.map(jnp.asarray, tree)
        tparams = params_from_jax(tree)
        kw = dict(max_new_tokens=T, do_sample=sampling, temperature=0.8,
                  top_k=20, top_p=0.95, repetition_penalty=1.1,
                  eos_token_id=text_tok.eos_token_id,
                  pad_token_id=text_tok.pad_token_id)
        jbank = tbank = None
        if bank is not None:
            jbank, tbank, names = bank(cfg)
            server_kw = dict(server_kw, adapter_names=names)
        dkw = dict(max_len=max_len, dna_rna_k_tokens=4, protein_k_tokens=4)
        self.jonline = japi.OnlineServer(
            jparams, cfg, JGen(**kw), JEncoder(jt, jd, jpr, JDataConfig(**dkw)),
            jt, lora_bank=jbank, **server_kw)
        self.online = api_server.OnlineServer(
            tparams, _tcfg_of(cfg), GenerationConfig(**kw),
            OmicsSampleEncoder(text_tok, dna_tok, prot_tok,
                               DataConfig(**dkw)),
            text_tok, lora_bank=tbank, **server_kw)
        self.servers = []
        for online, mod in ((self.jonline, japi), (self.online, api_server)):
            httpd = mod.make_http_server(online, "127.0.0.1", 0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            self.servers.append(httpd)
        self.ports = [h.server_address[1] for h in self.servers]

    def close(self):
        for h in self.servers:
            h.shutdown()
            h.server_close()
        self.jonline.close()
        self.online.close()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def post_json(port, path, body):
    with _post(port, path, body) as r:
        return json.loads(r.read())


def strip(body, keep_id=True):
    body = dict(body)
    body.pop("created", None)
    if not keep_id:
        body.pop("id", None)
    return body


def both(pair, path, body, keep_id=True):
    """(JAX answer, port answer) to the same request, compared after."""
    return [strip(post_json(p, path, body), keep_id) for p in pair.ports]


@pytest.fixture(scope="module")
def pair():
    p = Pair(n_slots=2, decode_chunk=2, admit_batch=1)
    yield p
    p.close()


def test_completions_concurrent_equal_jax(pair):
    """Three concurrent greedy completions on each server (the server
    samples by default; temperature 0 pins each request greedy)."""
    results = {}

    def hit(key, port, prompt):
        results[key] = post_json(port, "/v1/completions",
                                 {"prompt": prompt, "max_tokens": 8,
                                  "temperature": 0})

    threads = [threading.Thread(target=hit, args=((s, i), port, p))
               for s, port in enumerate(pair.ports)
               for i, p in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    texts = []
    for i in range(len(PROMPTS)):
        ref, got = (strip(results[(s, i)], keep_id=False) for s in (0, 1))
        assert got == ref
        assert got["usage"]["completion_tokens"] > 0
        texts.append(got["choices"][0]["text"])
    assert any(texts), texts  # the weights decode to text


def test_stream_sse_equals_nonstream(pair):
    def sse(port, body):
        deltas = []
        with _post(port, "/v1/completions", body) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: "):]
                if payload == "[DONE]":
                    break
                chunk = json.loads(payload)
                assert chunk["object"] == "text_completion"
                deltas.append(chunk["choices"][0]["text"])
        return "".join(deltas)

    body = {"prompt": PROMPTS[2], "temperature": 0}
    ref, got = (sse(p, dict(body, stream=True)) for p in pair.ports)
    assert got == ref
    plain = post_json(pair.ports[1], "/v1/completions", body)
    assert got == plain["choices"][0]["text"]


def test_chat_equal_jax(pair):
    ref, got = both(pair, "/v1/chat/completions", {
        "temperature": 0, "messages": [
            {"role": "system", "content": "ignored (fixed template)"},
            {"role": "user", "content": PROMPTS[0]}]}, keep_id=False)
    assert got == ref
    assert got["object"] == "chat.completion"
    assert got["choices"][0]["message"]["role"] == "assistant"


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/v1/completions", {"prompt": ""}, 400),
    ("POST", "/v1/nope", {"prompt": "x"}, 404),
    ("POST", "/v1/completions", {"prompt": "x", "n": 0}, 400),
    ("POST", "/v1/completions", {"prompt": "x", "n": "many"}, 400),
    ("POST", "/v1/completions", {"prompt": "x", "n": 2, "stream": True},
     400),
    ("POST", "/v1/embeddings", {"input": []}, 400),
    ("POST", "/v1/chat/completions", {"messages": []}, 400),
    ("GET", "/nope", None, 404),
    ("GET", "/health", None, 200),
    ("GET", "/v1/models", None, 200),
])
def test_status_codes_equal_jax(pair, method, path, body, code):
    answers = []
    for port in pair.ports:
        url = f"http://127.0.0.1:{port}{path}"
        try:
            if method == "GET":
                with urllib.request.urlopen(url, timeout=60) as r:
                    answers.append((r.status, json.loads(r.read())))
            else:
                with _post(port, path, body) as r:
                    answers.append((r.status, json.loads(r.read())))
        except urllib.error.HTTPError as e:
            answers.append((e.code, json.loads(e.read())))
    assert answers[1] == answers[0]
    assert answers[1][0] == code


def test_bad_json_is_400(pair):
    for port in pair.ports:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=b"{nope")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400


def test_stop_sequences_equal_jax(pair):
    """The stop string cuts the text (finish_reason "stop"), streamed or
    not."""
    ref = post_json(pair.ports[1], "/v1/completions",
                    {"prompt": PROMPTS[2], "temperature": 0})
    text = ref["choices"][0]["text"]
    assert len(text) >= 3, text
    stop = text[1:3]
    j, t = both(pair, "/v1/completions", {"prompt": PROMPTS[2],
                                          "temperature": 0, "stop": stop},
                keep_id=False)
    assert t == j
    assert t["choices"][0]["text"] == text[:text.find(stop)]
    assert t["choices"][0]["finish_reason"] == "stop"


def test_logprobs_equal_jax(pair):
    j, t = both(pair, "/v1/completions", {"prompt": PROMPTS[1],
                                          "temperature": 0, "logprobs": 1},
                keep_id=False)
    jl = j["choices"][0].pop("logprobs")
    tl = t["choices"][0].pop("logprobs")
    assert t == j
    assert tl["tokens"] == jl["tokens"]
    assert len(tl["token_logprobs"]) == t["usage"]["completion_tokens"] > 0
    np.testing.assert_allclose(tl["token_logprobs"], jl["token_logprobs"],
                               atol=LOGPROB_ATOL)


def test_n_choices(pair):
    """Greedy n choices equal JAX's; sampled ones diverge."""
    j, t = both(pair, "/v1/completions", {"prompt": PROMPTS[2],
                                          "max_tokens": 8, "temperature": 0,
                                          "n": 3}, keep_id=False)
    assert t == j
    assert [c["index"] for c in t["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in t["choices"]}) == 1
    body = post_json(pair.ports[1], "/v1/completions",
                     {"prompt": PROMPTS[2], "max_tokens": 8,
                      "temperature": 1.5, "n": 4})
    assert len({c["text"] for c in body["choices"]}) > 1
    assert body["usage"]["total_tokens"] == (
        body["usage"]["prompt_tokens"] + body["usage"]["completion_tokens"])


def test_embeddings_equal_jax(pair):
    j, t = both(pair, "/v1/embeddings", {"input": [PROMPTS[0], PROMPTS[2]]})
    vj = np.asarray([d.pop("embedding") for d in j["data"]])
    vt = np.asarray([d.pop("embedding") for d in t["data"]])
    assert t == j
    assert vt.shape == vj.shape and vt.shape[1] == 64 + 32 + 32
    np.testing.assert_allclose(vt, vj, atol=EMBED_ATOL)
    assert not np.allclose(vt[0], vt[1])


def test_models_and_health(pair):
    answers = []
    for port in pair.ports:
        for path in ("/v1/models", "/health"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                answers.append(json.loads(r.read()))
    assert answers[2:] == answers[:2]
    assert [m["id"] for m in answers[2]["data"]] == ["molly-tpu"]
    assert answers[3] == {"status": "ok"}


def _bank(cfg):
    """One adapter with a strong delta, stacked (index 0 = the base)."""
    lcfg = jlora.LoraConfig(r=4, alpha=8.0, dropout=0.0)
    key = jax.random.key(9)
    ad = jlora.init_lora(cfg.text, lcfg, key)
    ad = {"layers": {t: {"a": ab["a"],
                         "b": 0.5 * jax.random.normal(
                             jax.random.fold_in(key, j), ab["b"].shape)}
                     for j, (t, ab) in enumerate(sorted(ad["layers"].items()))}}
    jbank = jlora.stack_adapters([ad], scales=[lcfg.scale])
    tbank = lora.stack_adapters([params_from_jax(_np_tree(ad))],
                                scales=[lcfg.scale])
    return jbank, tbank, ["bio-ft"]


def test_multi_lora_routing_equal_jax():
    """The OpenAI "model" field routes to the adapter; unknown names serve
    the base; both servers answer the same."""
    p = Pair(max_len=192, T=6, sampling=False, bank=_bank, n_slots=2,
             decode_chunk=2, admit_batch=1)
    try:
        outs = {}
        for model in ("molly-tpu", "bio-ft", "not-a-model"):
            j, t = both(p, "/v1/completions", {"prompt": "hello",
                                               "model": model,
                                               "temperature": 0},
                        keep_id=False)
            assert t == j, model
            outs[model] = t["choices"][0]["text"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{p.ports[1]}/v1/models", timeout=30) as r:
            assert [m["id"] for m in json.loads(r.read())["data"]] == \
                ["molly-tpu", "bio-ft"]
    finally:
        p.close()
    assert outs["not-a-model"] == outs["molly-tpu"]
    assert outs["bio-ft"] != outs["molly-tpu"]


def test_paged_engine_equal_jax():
    """The API over the paged engine (the system prompt's full pages
    shared across slots)."""
    p = Pair(T=6, n_slots=2, decode_chunk=2, admit_batch=1, paged=True,
             page_size=32)
    try:
        from molly_tpu_torch.inference.paged import PagedServingEngine
        assert isinstance(p.online.engine, PagedServingEngine)
        assert p.online.engine._n_shared >= 1
        j, t = both(p, "/v1/completions",
                    {"prompt": "Is this DNA GC rich? <dna>ACGTACGT</dna>",
                     "temperature": 0})
        assert t == j
    finally:
        p.close()


def test_close_joins_the_engine_thread_and_frees_the_pool():
    """After ``close`` the engine thread is gone and the KV pool dies by
    reference counting alone."""
    import gc
    import weakref

    text_tok, dna_tok, prot_tok = (load_text_tokenizer(None),
                                   *default_modality_tokenizers())
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=192, dna_rna_k_tokens=4, protein_k_tokens=4))
    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.configs import FusionConfig as TFusion
    from molly_tpu_torch.models.configs import tiny_esm as ttiny_esm
    from molly_tpu_torch.models.configs import tiny_qwen3 as ttiny_qwen3
    cfg = TFusion(
        text=ttiny_qwen3(vocab_size=-(-text_tok.vocab_size // 128) * 128),
        dna_rna=ttiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2),
        protein=ttiny_esm(vocab_size=prot_tok.vocab_size,
                          mask_token_id=prot_tok.mask_id),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    params = fusion.init_params(cfg, torch.Generator().manual_seed(0))
    gen = GenerationConfig(max_new_tokens=3, do_sample=False,
                           eos_token_id=-1)
    gc.collect()
    gc.disable()
    try:
        online = api_server.OnlineServer(params, cfg, gen, enc, text_tok,
                                         n_slots=2, decode_chunk=2)
        uid = online.enqueue("hello", max_tokens=3)
        assert online.wait(uid)[2] == 3
        pool = weakref.ref(online.engine.hot["cache"])
        thread = online._thread
        online.close()
        assert not thread.is_alive() and online.engine is None
        assert pool() is None, "the KV pool outlives the server"
    finally:
        gc.enable()


def test_concurrent_requests_stress(pair):
    """24 concurrent greedy completions on the port's server (more clients
    than cores) with a short interpreter switch interval: each answer is
    the one a lone request gets, so no handler saw another's state."""
    import sys

    port = pair.ports[1]
    want = [post_json(port, "/v1/completions",
                      {"prompt": p, "max_tokens": 6, "temperature": 0}
                      )["choices"][0]["text"] for p in PROMPTS]
    got, errors = {}, []

    def hit(i):
        try:
            got[i] = post_json(port, "/v1/completions",
                               {"prompt": PROMPTS[i % 3], "max_tokens": 6,
                                "temperature": 0})["choices"][0]["text"]
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert [got[i] for i in range(24)] == [want[i % 3] for i in range(24)]
