"""OpenAI-compatible HTTP front end over the continuous-batching engines, the
counterpart of ``molly_tpu/inference/api_server.py`` (stdlib
``http.server`` only):

  POST /v1/completions        {"prompt": ..., "max_tokens": ..., "stream": ...}
  POST /v1/chat/completions   {"messages": [...], ...}
  POST /v1/embeddings         {"input": str | [str]}  (tools.embed, online)
  GET  /v1/models, GET /health

Prompts go through the dataset's encoder (chat template, <dna>/<rna>/
<protein> tag splicing, placeholder blocks), so omics tags work in API
prompts as they do in parquet rows. Per-request ``max_tokens``,
``temperature`` (0 = greedy), ``top_k``, ``top_p`` and
``repetition_penalty`` ride the engine's per-slot sampling rows; unset keys
inherit the server's defaults, echoed in ``"molly_sampling_defaults"``.

Threads: one engine thread builds the engine, drives ``engine.step()``
and runs every embedding request; it alone launches work on the device,
which is the device of the params, on one explicit CUDA stream there. HTTP
handler threads only encode prompts on the host, queue requests and wait
for (or stream) their results. ``close`` joins the engine thread and drops
the engine, whose KV pool is then freed by reference counting.

Run: ``python -m molly_tpu_torch.inference.cli --api-serve --port 8000 ...``
(the batch CLI's model, adapter and quantization flags apply).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

def _cut_at_stop(text: str, stops) -> tuple:
    """Truncate at the earliest stop sequence (OpenAI semantics: the stop
    string itself is not returned). -> (text, hit)."""
    cut = min((i for i in (text.find(s) for s in stops) if i >= 0),
              default=-1)
    return (text[:cut], True) if cut >= 0 else (text, False)


@dataclass
class _Pending:
    done: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[np.ndarray] = None
    stream: Optional["queue.Queue[Optional[str]]"] = None
    sent_text: str = ""  # already-delivered decoded prefix (stream mode)
    stop: tuple = ()     # stop sequences (OpenAI "stop")
    final_text: Optional[str] = None  # set when a stop sequence hit
    hit_stop: bool = False
    n_prompt: int = 0    # prompt tokens (usage reporting)
    logps: Optional[np.ndarray] = None  # chosen-token logprobs


class _Job:
    """A call the engine thread runs for a handler (an embedding)."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn, self.done = fn, threading.Event()
        self.result = self.error = None


class OnlineServer:
    """Thread-safe online wrapper around ``ServingEngine`` (or
    ``PagedServingEngine`` with ``paged``).

    ``enqueue`` encodes a prompt and submits it; ``wait`` / ``stream_iter``
    deliver the result. The engine thread runs engine rounds only while
    there is work (no idle polling of the device)."""

    def __init__(self, params, cfg, gen, encoder, text_tok, *,
                 n_slots: int = 8, decode_chunk: int = 16,
                 admit_batch: int = 4, kv_quant: Optional[str] = None,
                 paged: bool = False, page_size: int = 64,
                 kv_pages: Optional[int] = None,
                 lora_bank=None, adapter_names=None,
                 generator: Optional[torch.Generator] = None):
        self.encoder = encoder
        self.tok = text_tok
        self.gen = gen
        self.params, self.cfg = params, cfg  # the /v1/embeddings path
        self.device = params["text"]["embed"].device
        # multi-LoRA: OpenAI "model" -> bank index (0 = base). The shared
        # system-prompt prefix KV would differ per adapter, so prefix
        # caching is off when a bank is loaded.
        self.adapters = {n: i + 1 for i, n in
                         enumerate(adapter_names or [])}
        self._engine_kw = dict(
            n_slots=n_slots, decode_chunk=decode_chunk,
            admit_batch=admit_batch, kv_quant=kv_quant, paged=paged,
            page_size=page_size, kv_pages=kv_pages, lora_bank=lora_bank,
            generator=generator)
        self.engine = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._uid = itertools.count()
        self._mu = threading.Lock()          # guards engine state
        self._cv = threading.Condition()     # work-arrival signal
        self._reqs: Dict[int, _Pending] = {}
        self._jobs: List[_Job] = []
        self._stop = False
        self._error: Optional[Exception] = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._error is not None:
            self._thread.join()
            raise RuntimeError("the serving engine failed to start") \
                from self._error

    def _build_engine(self, *, n_slots, decode_chunk, admit_batch, kv_quant,
                      paged, page_size, kv_pages, lora_bank, generator):
        """The engine over ``encode_test``'s fixed window (as the CLI's
        ``run_serve``): every prompt starts with the system prompt, whose KV
        is shared unless a LoRA bank is loaded."""
        from .server import ServingEngine

        encoder, gen = self.encoder, self.gen
        if lora_bank is None:
            prefix_ids = encoder.system_prompt_ids
            s_pre = len(prefix_ids)
        else:
            prefix_ids, s_pre = None, 0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        common = dict(decode_chunk=decode_chunk, admit_batch=admit_batch,
                      kv_quant=kv_quant, prefix_ids=prefix_ids,
                      stream_cb=self._on_stream, logprobs=True,
                      lora_bank=lora_bank, generator=generator)
        if paged:
            from .paged import PagedServingEngine
            P = page_size
            s_share = (s_pre // P) * P  # paged shares full pages only
            bucket = -(-(encoder.cfg.max_len - s_share) // P) * P
            return PagedServingEngine(
                self.params, self.cfg, gen, n_slots=n_slots, page_size=P,
                n_pages=kv_pages, prefill_buckets=(bucket,), **common)
        return ServingEngine(
            self.params, self.cfg, gen, n_slots=n_slots,
            max_len=encoder.cfg.max_len + gen.max_new_tokens,
            prefill_buckets=(encoder.cfg.max_len - s_pre,), **common)

    # -- engine thread ------------------------------------------------------

    def _run(self) -> None:
        if self._stream is not None:
            torch.cuda.set_device(self.device)
            # the params were made on the default stream
            self._stream.wait_stream(torch.cuda.default_stream(self.device))
            ctx = torch.cuda.stream(self._stream)
        else:
            ctx = contextlib.nullcontext()  # the CPU has no streams
        with ctx:
            try:
                self.engine = self._build_engine(**self._engine_kw)
            except Exception as e:  # re-raised by __init__
                self._error = e
                self._ready.set()
                return
            self._ready.set()
            try:
                self._loop()
            except Exception as e:  # every waiter gets it (``_check``)
                self._fail(e)

    def _loop(self) -> None:
        while not self._stop:
            with self._mu:
                jobs, self._jobs = self._jobs, []
            for job in jobs:
                try:
                    job.result = job.fn()
                except Exception as e:  # handed to the waiting handler
                    job.error = e
                job.done.set()
            with self._mu:
                busy = self.engine.step()
                self._harvest()
            if not busy:
                with self._cv:
                    if not (self._stop or self.engine._pending
                            or self._jobs):
                        self._cv.wait(timeout=0.1)

    def _fail(self, e: Exception) -> None:
        """The engine loop raised: every waiter gets the error."""
        self._error = e
        with self._mu:
            for p in self._reqs.values():
                if p.stream is not None:
                    p.stream.put(None)
                p.done.set()
            for job in self._jobs:
                job.error = e
                job.done.set()

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError("the serving engine failed") from self._error

    def _harvest(self) -> None:
        """Materialize finished results and resolve waiters (mu held)."""
        res = self.engine._results
        for uid in list(res):
            v = res.pop(uid)
            if isinstance(v, tuple):
                rows, j, n = v
                if isinstance(rows, torch.Tensor):
                    rows = rows.cpu().numpy()
                v = rows[j, :n]
            # a preempted request's stashed tokens (paged engine) lead
            pre = getattr(self.engine, "_partial", {}).pop(uid, None)
            if pre is not None:
                v = np.concatenate([pre, np.asarray(v, np.int32)])
            lp = self.engine.pop_logprobs(uid)  # always pop (no leak)
            p = self._reqs.get(uid)
            if p is None:
                continue
            p.tokens = np.asarray(v)
            p.logps = lp
            if p.final_text is None and p.stop:
                # a stop sequence may land inside the final harvested span
                p.final_text, p.hit_stop = _cut_at_stop(
                    self._decode(p.tokens), p.stop)
            if p.stream is not None:
                text = (p.final_text if p.final_text is not None
                        else self._decode(p.tokens))
                delta = text[len(p.sent_text):]
                if delta:
                    p.stream.put(delta)
                p.stream.put(None)  # sentinel
            p.done.set()

    def _on_stream(self, uid, toks: np.ndarray) -> None:
        """The engine's stream_cb (inside step, on the engine thread)."""
        p = self._reqs.get(uid)
        if p is None or p.done.is_set():
            return
        if p.stream is None and not p.stop:
            return  # nothing to deliver or watch for
        text = self._decode(toks)
        if p.stop and p.final_text is None:
            cut, hit = _cut_at_stop(text, p.stop)
            if hit:
                p.final_text, p.hit_stop = cut, True
                self.engine.cancel(uid)  # free the slot; harvest follows
        if p.final_text is not None:
            # stop already hit: never stream past it (the slot may decode a
            # few more tokens until the cancel lands)
            text = p.final_text
        if p.stream is None:
            return
        # never emit a partial final token's replacement char mid-stream
        if text.endswith("�"):
            return
        if len(text) > len(p.sent_text):
            p.stream.put(text[len(p.sent_text):])
            p.sent_text = text

    # -- request API ----------------------------------------------------

    def _decode(self, toks: np.ndarray) -> str:
        ids = toks[toks != self.gen.pad_token_id]
        return self.tok.decode(ids.tolist(), skip_special_tokens=True)

    def resolve_adapter(self, model: Optional[str]) -> int:
        """OpenAI "model" -> bank index; unknown or absent names serve the
        base model (index 0)."""
        return self.adapters.get(model or "", 0)

    def enqueue(self, prompt: str, max_tokens: Optional[int] = None,
                stream: bool = False,
                sampling: Optional[Dict[str, Any]] = None,
                stop=(), adapter: int = 0) -> int:
        from .server import REQUEST_KEYS, Request

        self._check()
        sample = self.encoder.encode_test({"input": prompt})
        batch = {k: np.asarray(sample[k])[None] for k in REQUEST_KEYS
                 if k in sample}
        uid = next(self._uid)
        cap = (min(int(max_tokens), self.gen.max_new_tokens)
               if max_tokens else None)
        p = _Pending(stream=queue.Queue() if stream else None,
                     stop=tuple(s for s in stop if s),
                     n_prompt=int(np.asarray(
                         batch["attention_mask"]).sum()))
        with self._mu:
            self._reqs[uid] = p
            self.engine.submit(Request(uid=uid, batch=batch,
                                       max_new_tokens=cap,
                                       sampling=sampling,
                                       adapter=adapter))
        with self._cv:
            self._cv.notify_all()
        return uid

    def wait(self, uid: int, timeout: float = 600.0):
        """Block until finished; returns (text, finish_reason,
        n_completion_tokens, n_prompt_tokens, logprobs-or-None)."""
        p = self._reqs[uid]
        if not p.done.wait(timeout):
            raise TimeoutError(f"request {uid} timed out")
        self._check()
        toks = p.tokens
        del self._reqs[uid]
        text = (p.final_text if p.final_text is not None
                else self._decode(toks))
        stopped = p.hit_stop or bool(np.any(toks == self.gen.eos_token_id))
        real = toks[toks != self.gen.pad_token_id]
        logprobs = None
        if p.logps is not None:
            n = min(real.size, p.logps.size)
            logprobs = {"tokens": [self.tok.decode([int(t)])
                                   for t in real[:n]],
                        "token_logprobs": [round(float(x), 6)
                                           for x in p.logps[:n]]}
        return (text, "stop" if stopped else "length", int(real.size),
                p.n_prompt, logprobs)

    def stream_iter(self, uid: int, timeout: float = 600.0):
        """Yield text deltas until the request finishes."""
        p = self._reqs[uid]
        while True:
            delta = p.stream.get(timeout=timeout)
            if delta is None:
                break
            yield delta
        self._check()
        del self._reqs[uid]

    def embed(self, texts: List[str], timeout: float = 600.0) -> np.ndarray:
        """Pooled embeddings for /v1/embeddings (``tools.embed``: text last
        token ‖ mean-pooled DNA/RNA ‖ mean-pooled protein) of the prompts in
        the train layout (right-padded, so the last-token pool is defined),
        computed on the engine thread between engine rounds."""
        from ..data.collate import collate_train
        from ..tools.embed import embed_batch

        self._check()
        rows = [self.encoder.encode_train({"input": t, "output": ""})
                for t in texts]
        batch = collate_train(rows)
        job = _Job(lambda: embed_batch(self.params, self.cfg, batch))
        with self._mu:
            self._jobs.append(job)
        with self._cv:
            self._cv.notify_all()
        if not job.done.wait(timeout):
            raise TimeoutError("embedding request timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def close(self) -> None:
        """Stop and join the engine thread, then drop the engine (its KV
        pool goes with it)."""
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        self._thread.join()
        self.engine = None


# -- HTTP layer -----------------------------------------------------------


def _chat_to_prompt(messages: List[Dict[str, str]]) -> str:
    """Map OpenAI chat messages onto molly's single-turn contract: the
    system prompt is FIXED by the dataset chat template, so user turns
    concatenate into the `input` field and other roles are ignored."""
    return "\n".join(m.get("content", "") for m in messages
                     if m.get("role") == "user").strip()


def make_http_server(online: OnlineServer, host: str, port: int,
                     model_name: str = "molly-tpu") -> ThreadingHTTPServer:
    """The HTTP server over ``online``; the same routes, JSON fields and
    status codes as the JAX package's (``model_name`` and ``owned_by``
    included, so clients of either see one API)."""
    gen = online.gen
    sampling = {"temperature": gen.temperature, "top_p": gen.top_p,
                "top_k": gen.top_k,
                "repetition_penalty": gen.repetition_penalty,
                "do_sample": gen.do_sample}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                ids = [model_name] + sorted(online.adapters)
                self._json(200, {"object": "list", "data": [
                    {"id": mid, "object": "model",
                     "owned_by": "molly_tpu"} for mid in ids]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._json(400, {"error": "bad json"})
            if self.path == "/v1/embeddings":
                texts = body.get("input", "")
                if isinstance(texts, str):
                    texts = [texts]
                if not texts or not all(isinstance(t, str) and t
                                        for t in texts):
                    return self._json(400, {"error": "empty input"})
                emb = online.embed(texts)
                return self._json(200, {
                    "object": "list",
                    "model": model_name,
                    "data": [{"object": "embedding", "index": i,
                              "embedding": [float(x) for x in row]}
                             for i, row in enumerate(emb)],
                    "usage": {"prompt_tokens": 0, "total_tokens": 0}})
            chat = self.path == "/v1/chat/completions"
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                return self._json(404, {"error": "not found"})
            if chat:
                prompt = _chat_to_prompt(body.get("messages", []))
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
            if not prompt:
                return self._json(400, {"error": "empty prompt"})
            # per-request sampling overrides (the engine's per-slot rows);
            # unset keys inherit the defaults
            req_samp = {k: body[k] for k in
                        ("temperature", "top_k", "top_p",
                         "repetition_penalty") if k in body}
            stop = body.get("stop") or ()
            if isinstance(stop, str):
                stop = (stop,)
            try:
                n_choices = int(body.get("n", 1))
            except (TypeError, ValueError):
                return self._json(400, {"error": "bad n"})
            if not 1 <= n_choices <= 16:
                return self._json(400, {"error": "n must be in [1, 16]"})
            if n_choices > 1 and body.get("stream"):
                return self._json(
                    400, {"error": "n > 1 with stream not supported"})
            # OpenAI "n": the prompt is admitted n times; slots sample
            # independently, so choices diverge under sampling and coincide
            # under greedy
            uids = [online.enqueue(prompt, body.get("max_tokens"),
                                   stream=bool(body.get("stream")),
                                   sampling=req_samp or None,
                                   stop=stop,
                                   adapter=online.resolve_adapter(
                                       body.get("model")))
                    for _ in range(n_choices)]
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uids[0]}"
            if body.get("stream"):
                return self._sse(uids[0], rid, chat)
            choices, tot_tok, n_prompt = [], 0, 0
            for i, uid in enumerate(uids):
                text, reason, n_tok, n_prompt, logprobs = online.wait(uid)
                tot_tok += n_tok
                choice = ({"index": i, "message": {"role": "assistant",
                                                   "content": text},
                           "finish_reason": reason} if chat else
                          {"index": i, "text": text,
                           "finish_reason": reason})
                if body.get("logprobs") and logprobs is not None:
                    choice["logprobs"] = logprobs
                choices.append(choice)
            self._json(200, {
                "id": rid,
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()),
                "model": (body.get("model")
                          if body.get("model") in online.adapters
                          else model_name),
                "choices": choices,
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": tot_tok,
                          "total_tokens": n_prompt + tot_tok},
                "molly_sampling_defaults": sampling,
            })

        def _sse(self, uid: int, rid: str, chat: bool) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion"
            for delta in online.stream_iter(uid):
                choice = ({"index": 0, "delta": {"content": delta},
                           "finish_reason": None} if chat else
                          {"index": 0, "text": delta,
                           "finish_reason": None})
                chunk = {"id": rid, "object": obj,
                         "created": int(time.time()), "choices": [choice]}
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd


def run_api_server(args, params, cfg, gen, text_tok, dna_tok, prot_tok,
                   dcfg, lora_bank=None, adapter_names=None,
                   generator: Optional[torch.Generator] = None) -> None:
    """The batch CLI's ``--api-serve``: serve until interrupted (or until
    ``shutdown`` is called on the server), then stop the engine."""
    from ..data.omics_dataset import OmicsSampleEncoder

    encoder = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, dcfg)
    online = OnlineServer(
        params, cfg, gen, encoder, text_tok,
        n_slots=args.batch_size, decode_chunk=args.serve_chunk,
        admit_batch=args.serve_admit,
        kv_quant="int8" if args.serve_kv_int8 else None,
        paged=args.serve_paged, page_size=args.page_size,
        kv_pages=args.kv_pages,
        lora_bank=lora_bank, adapter_names=adapter_names,
        generator=generator)
    httpd = make_http_server(online, args.host, args.port)
    extra = (f", adapters: {adapter_names}" if adapter_names else "")
    print(f"[api-serve] listening on http://{args.host}:"
          f"{httpd.server_address[1]} (slots={args.batch_size}, "
          f"per-request sampling enabled{extra})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        online.close()
