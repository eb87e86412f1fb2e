"""The batch generation CLI's loop: ``inference.cli.run_batches`` over
samples that ``OmicsSampleEncoder.encode_test`` makes from the mix's rows,
inside the window, as the CLI calls it; ``engine.generate`` underneath.

Set-up: the program's kernels (built once per checkout), its tokenizers
and encoder, the weights drawn on the card from the seed, and one batch at
the cell's batch size and prompt length with ``warmup_new_tokens`` new
tokens (every decode step runs the same kernels at the same shapes). The
window runs whole batches until ``--seconds`` has passed, the same in every
run; batch b is greedy when b % ``greedy_every`` == 0, sampled at the
traffic's settings otherwise. Once it has closed, a traced run runs the
window's batches ``stats_batches`` again with ``stats`` (which synchronizes
between phases), then batch ``profile_batch`` again under the profiler.

The check: once the window has closed and the program's state is freed, a
sample of the window's greedy requests drawn from the seed, the longest
among them, is run through the float32 reference (the configuration's
``reference/<decoder>.py`` for the decoder) over its prompt and the tokens
it was served; the mean over the served tokens of the squared gap
by which each token's logit lies below the reference's best (0 where it is
the reference's argmax) must stay within the cell's limit. The widest gap,
the mean gap and the share of tokens off the argmax are printed beside
it."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import tempfile
import time
from typing import List

import numpy as np
import torch

from h100_bench.harness import weights
from h100_bench.harness.result import Outcome
from h100_bench.harness.trace import ProfiledSlice
from h100_bench.reference import model as ref_model
from h100_bench.reference import prompt as ref_prompt
from h100_bench.roofline.shapes import batch_shape
from h100_bench.traffic.omics import batch_rows


class _GenerateTap:
    """Keeps each token tensor ``engine.generate`` returns (the CLI's loop
    decodes them to text, which does not give the ids back)."""

    def __enter__(self):
        from molly_tpu_torch.inference import engine
        self.engine, self.orig, self.outputs = engine, engine.generate, []

        def tapped(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.outputs.append(out)
            return out

        engine.generate = tapped
        return self

    def __exit__(self, *exc):
        self.engine.generate = self.orig
        return False


def _emitted(tokens: np.ndarray, eos: int) -> List[int]:
    """Tokens each row emitted, its EOS included."""
    out = []
    for row in tokens:
        hit = np.flatnonzero(row == eos)
        out.append(int(hit[0]) + 1 if hit.size else int(row.shape[0]))
    return out


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell) -> Outcome:
    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.inference.cli import run_batches
    from molly_tpu_torch.inference.sampling import sample_tokens
    from molly_tpu_torch.models.configs import GenerationConfig

    t, dev = cell.traffic, cell.device
    decoder = cell.decoder()  # a name with no file stops here
    if dev == "cuda":
        from molly_tpu_torch.ops import _cuda_build
        _cuda_build.build()
    cfg = cell.fusion_config()
    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=t["max_length"], dna_rna_k_tokens=t["dna_rna_k_tokens"],
        protein_k_tokens=t["protein_k_tokens"],
        max_dna_rna_segments=t["max_dna_rna_segments"],
        max_protein_segments=t["max_protein_segments"]))
    params = weights.make(cell.config, cell.seed, dev, decoder)
    if cell.control == "int8":  # calibration only: the program's int8 path
        program = importlib.import_module(
            f"molly_tpu_torch.models.{decoder.PROGRAM_MODULE}")
        params["text"] = program.quantize_for_decode(
            params["text"], cfg.text, moe_experts=bool(cfg.text.num_experts),
            donate=True)
    s = t["sampling"]
    common = dict(max_new_tokens=t["max_new_tokens"],
                  temperature=s["temperature"], top_p=s["top_p"],
                  top_k=s["top_k"], repetition_penalty=s["repetition_penalty"],
                  eos_token_id=text_tok.eos_token_id,
                  pad_token_id=text_tok.pad_token_id)
    gens = {True: GenerationConfig(do_sample=False, **common),
            False: GenerationConfig(do_sample=True, **common)}
    generator = torch.Generator(device=dev).manual_seed(cell.seed)
    B, every = t["batch_size"], t["greedy_every"]
    sink = tempfile.NamedTemporaryFile("w", suffix=".jsonl", delete=False,
                                       dir=os.environ.get("TMPDIR"))

    def one_batch(index: int, stats: bool = False, new_tokens=None):
        """One batch through ``run_batches``: its record. ``stats`` (which
        synchronizes between phases) only after the window."""
        rows = batch_rows(t["mix"], B, cell.seed, index)
        spans: List[float] = []

        def encoded():
            for row in rows:
                t0 = time.perf_counter()
                sample = enc.encode_test(row)
                spans.append(time.perf_counter() - t0)
                yield sample

        greedy = index % every == 0
        gen = gens[greedy]
        if new_tokens is not None:
            gen = dataclasses.replace(gen, max_new_tokens=new_tokens)
        st = {} if stats else None
        t0 = time.perf_counter()
        recs = run_batches(encoded(), params, cfg, gen, text_tok, sink,
                           batch_size=B, generator=generator, stats=st)
        return {"rows": rows, "greedy": greedy, "written": len(recs),
                "encode_test_s": sum(spans), "stats": st,
                "wall": time.perf_counter() - t0}

    with _GenerateTap() as tap:
        # set-up: one greedy batch at the window's shapes and a few new
        # tokens, and the sampled path's processors once
        if not cell.extra.get("no_warmup"):  # calibration skips it
            one_batch(-every, new_tokens=t.get("warmup_new_tokens"))
        with torch.inference_mode():
            sample_tokens(torch.zeros((B, cfg.text.vocab_size), device=dev),
                          generator, do_sample=True,
                          temperature=s["temperature"], top_k=s["top_k"],
                          top_p=s["top_p"],
                          repetition_penalty=s["repetition_penalty"],
                          presence=torch.zeros((B, cfg.text.vocab_size),
                                               dtype=torch.bool, device=dev))
        _sync(dev)
        tap.outputs.clear()
        cell.extra["setup_done"]()

        # the window: whole batches until --seconds have passed, untraced
        batches = []
        t0 = time.perf_counter()
        while True:
            batches.append(one_batch(len(batches)))
            if "batches" in cell.extra:  # calibration: a fixed count
                if len(batches) == cell.extra["batches"]:
                    break
            elif time.perf_counter() - t0 >= cell.seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        memory_peak = (torch.cuda.max_memory_allocated() if dev == "cuda"
                       else 0)
        tokens = [o.cpu().numpy() for o in tap.outputs]

        # a traced run, after the window: batches again with stats, then
        # one again under the profiler
        stat_batches, summary, profiled = [], None, None
        if cell.trace:
            for index in t["stats_batches"]:
                stat_batches.append(one_batch(index, stats=True))
            index = min(t["profile_batch"], len(batches) - 1)
            with ProfiledSlice() as sl:
                profiled = one_batch(index)
            summary = sl.summary
            profiled.update(index=index,
                            untraced_s=batches[index]["wall"])
            extra_tokens = [o.cpu().numpy()
                            for o in tap.outputs[len(tokens):]]
    sink.close()
    os.unlink(sink.name)
    retries = (torch.cuda.memory_stats().get("num_alloc_retries", 0)
               if dev == "cuda" else 0)

    # the record the per-layer readers read, shapes from the reference's
    # own prompt building
    k = {"dna_rna": t["dna_rna_k_tokens"], "protein": t["protein_k_tokens"]}
    eos = text_tok.eos_token_id
    prompts = []

    def shape_of(batch, toks, keep_prompts=False):
        built = [ref_prompt.build(r, k, t["max_length"])
                 for r in batch.pop("rows")]
        if keep_prompts:
            prompts.append(built)
        batch["shape"] = batch_shape(built, t, _emitted(toks, eos))

    for batch, toks in zip(batches, tokens):
        shape_of(batch, toks, keep_prompts=True)
    if cell.trace:
        for batch, toks in zip(stat_batches + [profiled], extra_tokens):
            shape_of(batch, toks)
    attempted = B * len(batches)
    written = sum(batch["written"] for batch in batches)
    record = {
        "config": cell.config, "decoder": decoder, "traffic": t,
        "window_s": window_s,
        "bench_dir": cell.bench_dir, "batches": batches,
        "stats_batches": stat_batches, "trace": summary,
        "profiled": profiled, "memory_peak_bytes": memory_peak,
    }
    shapes = [batch["shape"] for batch in batches]
    emitted = sum(sum(r["emitted"] for r in sh["rows"]) for sh in shapes)
    e2e = {"samples_per_s": written / window_s,
           "gen_tokens_per_s": emitted / window_s}

    # the check, once the program's state is freed
    del params, tap
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([cell.seed % 2 ** 63, 7])
    pool = [(bi, ri) for bi, batch in enumerate(batches) if batch["greedy"]
            for ri in range(B)]
    longest = max(pool, key=lambda x: (shapes[x[0]]["rows"][x[1]]["emitted"],
                                       shapes[x[0]]["rows"][x[1]]["n"]))
    rest = [p for p in pool if p != longest]
    n_check = min(t["check_requests"], len(pool))
    picked = [longest] + [rest[i] for i in sorted(
        rng.choice(len(rest), n_check - 1, replace=False))]
    requests = []
    for bi, ri in picked:
        ids, segments = prompts[bi][ri]
        served = tokens[bi][ri][:shapes[bi]["rows"][ri]["emitted"]].tolist()
        requests.append({"ids": ids, "segments": segments, "served": served})
    ref_params = weights.make(cell.config, cell.seed, dev, decoder)
    t_ref = time.perf_counter()
    with ref_model.full_float32(), torch.no_grad():
        logits = ref_model.served_logits(ref_params, cell.config, requests,
                                         decoder)
        gaps = torch.cat([ref_model.greedy_gaps(lg, rq["served"],
                                                s["repetition_penalty"])
                          for lg, rq in zip(logits, requests)])
        numbers = ref_model.gap_numbers(gaps)
    _sync(dev)
    ref_s = time.perf_counter() - t_ref
    n_tokens = sum(len(rq["served"]) for rq in requests)
    checks = [(name, numbers[name], cell.limits[name])
              for name in numbers if name in cell.limits]
    if not checks:
        raise ValueError(f"limits/{cell.name}.json names none of {numbers}")
    record["check_numbers"] = numbers
    record["check_gaps"] = gaps.cpu().numpy()
    return Outcome(
        attempted=attempted, failed=attempted - written, end_to_end=e2e,
        record=record, checks=checks,
        memory_peak_bytes=memory_peak,
        notes=[f"window {window_s:.3f} s, {len(batches)} batches "
               f"({sum(x['greedy'] for x in batches)} greedy), {written} "
               f"samples, {emitted} tokens emitted, {retries} allocator "
               f"retries; batches "
               + " ".join(f"{x['wall']:.3f}" for x in batches) + " s"
               + ("" if profiled is None else
                  f"; batch {profiled['index']} again under the profiler "
                  f"{profiled['wall']:.3f} s, device busy "
                  f"{summary.busy_s if summary else 0.0:.3f} s"),
               f"check: {len(requests)} greedy requests, {n_tokens} served "
               f"tokens against the float32 reference in {ref_s:.2f} s: "
               + ", ".join(f"{k} {v!r}" for k, v in numbers.items())])
