#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``molly_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile-dir DIR]

Phases, each printed with its time; any failure exits non-zero:
  1. preamble: TF32 off for matmuls and cuDNN; the card's name and power
     limit from nvidia-smi.
  2. build: compile every CUDA kernel in ``molly_tpu_torch/csrc`` with nvcc
     for sm_90a (all sources in parallel).
  3. kernel parity: each of the ten kernels (the paged flash-decode
     kernel counts twice: over bf16 pages and over int8 pages; the grouped
     GEMM counts as the forward kernel, which also runs transposed and over
     int8 experts, and the weight-gradient kernel tgmm) against its
     plain PyTorch version (run in fp32 from the same inputs) at the shapes
     the main paths give it, with the tolerances stated below; kernel and plain
     times by CUDA events, the time of the one PyTorch call that computes
     the same function (``library_ms``, used nowhere in the port), and the
     bound: the least time the card could take, the larger of bytes / 3.35
     TB/s (each input read once, each output written once) and operations
     / peak rate (989 TFLOP/s for bf16 products, 67 TFLOP/s fp32
     otherwise), counting only the (query, key) pairs this run's masks
     allow and only the weights of the experts this run's router chose. The
     grouped GEMMs take their group sizes from a real ``router_topk`` with
     one expert forced empty; each case names the source whose kernel ran
     (at prefill and training shapes the TMA and wgmma kernels over bf16
     experts, the int8 TMA kernel of ``grouped_gemm_int8_tma.cu`` over int8
     experts, the fp32 tensor-core kernels of ``grouped_gemm_f32_tc.cu`` for
     the expert adapters' products and weight gradients; the split weight
     stream of
     ``grouped_gemm_decode.cu`` at decode and serving shapes over bf16 and
     int8 experts; the mma.sync and SIMT kernels elsewhere), two runs are
     bit-equal, a split-stream, int8 TMA or fp32 tensor-core case replays a
     captured launch after the group sizes change (equal to an eager call),
     a case with an fp32 ``dout`` times the wrapper, its one rounding
     pass to bf16 included, and a weight gradient is timed through the call
     the autograd backward makes (the adapters': a bf16 lhs and an fp32
     ``dout``, no widening pass); an int8 case prints ``F.grouped_mm`` over
     experts dequantized beforehand as a yardstick. The int8 GEMM runs its
     decode shapes (the lm head, and every fused layer product of both
     decoders) on the weight stream of ``int8_matmul_stream.cu``, and its
     prefill and QLoRA shapes on the
     TMA and wgmma kernel of ``int8_matmul_tma.cu`` (route and counter
     printed, two runs bit-equal on both), with cuBLAS's bf16 product over
     dequantized weights printed beside it as a yardstick, not as its
     library time. The RMSNorm forward runs the hidden, decode, training
     and every per-head shape of the main paths, the fused branch's
     stacked qk_norm also as the strided view of the qkv product that the
     main path hands it (two runs bit-equal); its backward the training
     step's hidden and per-head shapes of both decoders, with and without
     dw (two runs bit-equal, dx and dw). The flash
     forward runs eight cases (decoder, serving and MoE prefill, encoder,
     training, the training and prefill shapes of phases 19a-19b's
     local heads, 8 q over 4 kv, and latent attention's prefill at q.k
     width 192 and v width 128), each on the TMA and wgmma kernel (its
     route is printed),
     with its rows without a valid key exactly zero and two runs bit-equal.
     The flash dQ and dK/dV kernels (``flash_attention_bwd_tma.cu``) run
     four cases (training, MoE training at 32 q heads over 4 kv heads, an
     encoder's shape, 19a's local heads), each on the TMA and wgmma kernels (routes printed),
     two runs bit-equal, dK = dV = 0 exactly on every key the mask removes;
     the time of the delta = rowsum(dO * O) pass is printed beside theirs,
     so that their sum compares with SDPA's whole backward. The paged
     flash-decode kernel runs seven cases (bf16 and int8 pages at 32 and 8
     slots, the MoE serving shape with 32 q heads over 4 kv heads, two small
     fp32 ones), each printing its route (bf16 q on the split TMA kernel of
     ``paged_attention_tma.cu``, fp32 on ``paged_attention.cu``), two runs
     bit-equal, empty slots exactly zero, and (split kernel) one captured
     launch replayed after the lengths and the page table change in place,
     equal to an eager call on the new data.
  4. small reference, generation: a small fp32 fusion model on the card
     (through the kernels) against the same weights on the CPU (plain
     versions): logits and greedy tokens must agree.
  4b. small reference, speculative decoding: the small model with unit-
     scale text weights (so greedy tokens vary), one fusion prompt whose
     text repeats a pattern: greedy ``generate_speculative`` with the int8
     self-draft (``quantize_for_decode``) at k = 1, 3, 4 and
     ``generate_lookup`` at k = 8, n = 3, each equal to the target's own
     greedy ``generate`` exactly, on the card and on the CPU, with the
     card's tokens and round counts equal to the CPU's.
  5. small reference, serving: the same model through ``ServingEngine``
     and ``PagedServingEngine`` (fp32 pages and int8 pages, page size 16) on
     the card against the same engines on the CPU: greedy tokens equal
     (int8: first tokens equal, at most 3 flips), with a page pool small
     enough that requests are preempted, and every page back on the free
     list.
  5b. small reference, offline ring: ``run_offline`` of the 4b model over
     12 left-padded requests (every third tri-modal) into 4 slots in
     admission groups of 2, 24 new tokens, greedy: KV in the model dtype,
     int8 KV, ``spec_lookup`` 4 and the adaptive threshold (0.2, chunks of
     4); each equals ``ServingEngine``'s dense ring on the same device
     (int8: first tokens equal, at most 3 flips) and the card equals the
     CPU.
  5c. small reference, HTTP API: ``OnlineServer`` on 127.0.0.1 over
     ``PagedServingEngine`` (int8 pages of 16) of the 4b model with two
     adapters in one bank over ``quantize_for_decode(fuse=False)``; each
     adapter's greedy completion equals a single-adapter paged engine with
     that adapter merged (the int8-pages rule), the base model's differs.
  6. small reference, training: the same model, one full fine-tune step and
     one LoRA step on the card against the CPU (loss and every trainable
     gradient), and five steps on one repeated batch must lower the loss.
     Then the same three references with the decoder replaced by
     ``tiny_moe`` (4 experts, top-2) at the same widths: logits and greedy
     tokens (also over int8 experts), one paged serving run, one full
     fine-tune step and one expert-LoRA step with the load-balance term.
  7. main path, generation, bf16: molly-1.7B width — qwen3-1.7b (vocab
     151,936, 28 layers) fused with nt-500m and esm2-650m, k = 1024 tokens
     and 4 slots per modality, max length 3072 — random weights from
     --seed, four tri-modal requests encoded by
     OmicsSampleEncoder.encode_test and decoded by the batch CLI's
     ``run_batches`` with sampling.
  8. main path, serving: the same weights through the inference CLI's
     ``run_serve`` (continuous batching over the fixed system prompt's
     shared prefix): 12 tri-modal requests into 8 slots so that slots
     backfill, chunk 16, admission groups of 4, 32 new tokens, once with
     paged KV in bf16 pages of 64 (sampled), once with int8 pages of 128
     (greedy); then the dense ring with 4 requests and 16 new tokens.
  8b. prompt lookup, molly-1.7B width, on phase 7's bf16 weights: the
     batch CLI's ``run_lookup`` (``--decoding lookup --lookup-k 8
     --lookup-n 3``) over the phase-7 requests, greedy, 32 new tokens,
     against ``run_batches`` greedy one request a batch under the near-tie
     rule (below); rounds, accepted drafts a round and tokens/s beside
     plain greedy's.
  8c. self-draft speculation: ``generate_speculative`` with the int8 copy
     of the same weights as draft, k = 4, the first request; the same rule
     and prints.
  8d. the offline ring: ``run_offline_ring`` (``--offline-ring``), 12
     tri-modal requests into 8 slots, admission groups of 4, 32 new tokens,
     greedy, with bf16 KV, int8 KV and ``--ring-spec 8``; the bf16 run and
     ``run_serve``'s dense ring (same slots, groups and requests) under the
     near-tie rule, the ``--ring-spec`` run against the bf16 ring;
     requests/s, tokens/s, ticks, admissions and host syncs printed.
  8e. the HTTP API: ``run_api_server`` (``--api-serve``) on 127.0.0.1 at an
     ephemeral port over paged bf16 pages of 64, 8 slots, driven from
     client threads: 8 concurrent tri-modal completions (greedy, 16
     tokens), a streamed request equal to its non-streamed twin, a chat
     completion, /v1/embeddings of 4 inputs (2048 + 1280 + 1280 wide,
     within 1e-2 of the max of ``embed_batch`` called directly), /health and
     /v1/models, then a clean shutdown; every paged launch on the split
     kernel.
     The near-tie rule: two greedy runs of the same requests give equal
     tokens up to the first position where the reference's gap between its
     top two repetition-penalized logits is below 2^-7 of its largest
     |logit| (its own logits, recorded while it runs); the position and
     gap are printed, and a difference before it fails. The 8d bf16 ring
     is the reference of ``run_serve``'s dense ring and of the
     ``--ring-spec`` ring.
  8a. checkpoints, molly-1.7B width, on phase 7's bf16 weights (before
     training changes them): ``save_hf_checkpoint`` of the text decoder (fp32
     safetensors by the port's own writer, ~6.9 GB, into a temporary
     directory whose free space is checked first; GB and seconds written
     printed); the batch CLI's ``_load_params`` with ``--checkpoint <dir>``
     (GB and seconds read printed; every text leaf bit-equal to phase 7's,
     16 greedy tokens through ``run_batches`` equal to the in-memory
     weights'); a PEFT directory (a rank-64 adapter on all seven targets
     with nonzero B written by ``peft_lora_to_hf_state`` and the port's
     writer, ``adapter_config.json``, both projector ``.bin`` files) through
     ``--peft-adapter``: merged text and projectors bit-equal to the
     in-memory ``merge_lora`` and graft, greedy tokens equal; the train
     CLI's ``build_params`` with ``--text-model-path`` (bit-equal) and 3
     full fine-tune steps of ``train_loop`` at phase 9's settings. Every
     flash forward and backward of these runs on the TMA kernels.
  9. main path, training, full fine-tune: the same weights, the train CLI's
     defaults (batch 4, max length 1024, k = 128 tokens and 4 slots per
     modality, train-llm and train-mlp, frozen encoders, fused LCE, no
     remat), four tri-modal samples through
     OmicsSampleEncoder.encode_train and ``train_loop`` for 3 steps.
 10. main path, training, QLoRA: the same with --use-lora --qlora (r 64,
     dropout 0.05) over an int8 base, 3 steps, then export_adapter,
     load_adapter, merge_lora and 8 greedy tokens through ``run_batches``.
  9a. main path, training, remat ``dots``: one batch's loss and every
     trainable gradient under ``--gradient-checkpointing true
     --remat-policy dots`` against ``full`` and no remat (bit-equal, or
     within 1e-2 of each leaf's max; the largest difference printed), then
     3 steps each under ``full`` and ``dots``: peak memory and s a step
     beside phase 9's.
  9b. main path, training, ``--offload-opt-state true``: 3 steps of
     ``train_loop`` with the Adam moments in pinned host memory (the copies'
     seconds and bytes printed, every moment pinned on the host), then 3
     steps on the card's moments and 3 offloaded from the same weights and
     batches, every trainable leaf bit-equal after every step.
 11. main path, generation, int8: the requests of phase 7 after
     ``quantize_for_decode``, greedy.
 11a. int8, after phase 11's ``quantize_for_decode``: ``run_lookup`` and
     ``run_offline_ring`` with ``ring_spec`` 8 over the int8 decoder (16 new
     tokens; int8 launches on both the TMA kernel and the weight stream,
     none on SIMT), then ``esm.quantize_for_decode`` of both encoders: the
     phase-7 requests' projected embeddings no further from the bf16
     encoders' than the quantization's own error in fp32 (the int8 weights
     dequantized against the bf16 ones) plus twice bf16's against fp32 (the
     design's 5e-2 of the max is printed beside it), every encoder int8
     launch on the TMA kernel.
 12. checks: every kernel of each main-path run launched at least once in
     that run (counts set to 0 just before it, read just after); each paged
     serving run launched the paged kernel, the flash forward and the
     RMSNorm forward; every flash forward, dQ and dK/dV launch of every
     main-path run (the MoE ones too) ran on the TMA and wgmma kernels,
     every paged launch of the three paged serving runs (bf16, int8, MoE) on
     the split TMA kernel, and every int8 GEMM launch (1.7B int8
     generation, QLoRA, MoE int8 experts and expert QLoRA) at M > 16 on the
     int8 TMA kernel, at M <= 16 on the weight stream (none on SIMT).
 13. main path, MoE generation, bf16: qwen3-30b-a3b width (hidden 2048, 128
     experts of width 768, top-8, 32 q heads over 4 kv heads, vocab 151,936,
     untied head, 48 layers) fused with nt-500m and esm2-650m, after the
     molly-1.7B weights are freed; the requests of phase 7 through
     ``run_batches``, sampled, 32 new tokens.
 14. main path, MoE serving: the same weights through ``run_serve``, paged
     bf16 pages of 64, 12 requests into 8 slots, 32 new tokens.
 15. main path, MoE generation, int8 experts: ``quantize_for_decode(
     moe_experts=True, donate=True)`` (fused int8 gate-and-up stacks, the
     bf16 stacks released leaf by leaf), greedy, 16 new tokens.
 15b. the offline ring over the same int8 experts: ``run_offline_ring``,
     the phase-7 requests into 8 slots (one admission group of 4), 16 new
     tokens, greedy, under the near-tie rule against phase 15's tokens; the
     admission's grouped GEMMs on the int8 TMA kernel (2 a layer), every
     tick's on the split stream, none on grouped_gemm.cu.
 15a. checkpoints, qwen3-30b-a3b width, on phase 16's weights before they
     train (4 of 48 layers, in memory): ``qwen3_to_hf_state`` writes the
     per-expert keys (4 x 128 x 3) and ``qwen3_from_hf`` restacks them on
     the card; leaves bit-equal, the router in fp32; 16 greedy tokens equal
     to the in-memory model's, with the grouped GEMM on the TMA kernel at
     prefill and the split stream at decode, none on grouped_gemm.cu.
 16. main path, MoE training, full fine-tune: 3 steps of ``train_loop`` at
     the train CLI's defaults at 4 of the 48 layers (router and expert
     stacks train), with ``moe_load_balance`` printed.
 16a. main path, MoE training under remat ``dots`` at 4 layers: one
     batch's gradients against ``full`` and no remat (the router's products
     saved, the grouped GEMMs recomputed), then 3 steps.
 17. main path, MoE training, QLoRA with expert adapters (r 64) over int8
     experts, 4 layers, 3 steps.
 16b. main path, MoE training with the moments offloaded at 18 of 48
     layers (host MemTotal and the moments' bytes printed), 3 steps, then
     the same depth with the moments on the card, which must run out of
     device memory.
 18. main path, the encoder + head baseline: ``baselines.train.main``
     with --model-type NT+ESM at full width (nt-500m and esm2-650m in bf16,
     k = 1024 each, batch 16, 5 steps) on rows made from the seed: every
     flash launch on the TMA kernel (57 a step), ``head_delta`` > 0, one
     batch's logits within 2e-2 of their max of the same weights through
     the plain attention; a small fp32 NT+ESM model on the card within
     1e-4 of the CPU.
     Each MoE phase prints its depth and peak device memory and must launch
     the grouped GEMM (the training phases tgmm too), and prints how many of
     those launches ran on the TMA and wgmma kernels (every prefill product
     over bf16 experts, and every product of the full fine-tune), on the
     int8 TMA kernel (the int8-experts prefill's 96, and every int8 product
     of the QLoRA run), on the fp32 tensor-core kernels (every adapter
     product and every weight gradient of the QLoRA run) and on the split
     stream (every decode and serving product, bf16 and int8); the
     generation, serving and QLoRA phases fail on any launch left on
     grouped_gemm.cu.
19a-19e. multi-device parallelism, in ranks spawned on the one card
     (``parallel.launch.run_ranks``, gloo: NCCL refuses two ranks on one
     device; gloo's collectives take the CUDA tensors as they are, its
     point-to-point calls are staged through pinned host memory, printed
     as "gloo, point-to-point host-staged"); the kernels at these phases'
     new shapes are held against their plain versions in phase 3 (the
     ``p19_`` and ``ep_`` cases: flash forward and backward and the q and
     k norms on 8 q over 4 kv local heads; the grouped GEMM and tgmm over
     rank 0's expert=2 capacity buffer, 64 local experts, one empty, rows
     past sum(sizes) garbage that must come out exactly zero, an empty
     expert's weight gradient exactly zero); the kernels were built above
     and the ranks only load them. Each against the one-rank run of the
     same seed's weights on the card; each rank prints its seconds, peak
     device memory, collective bytes a step and launch counts, which the
     kernels line includes. 19a: (fsdp=2, tensor=2), 4 ranks, molly-1.7B
     width cut to 4 of 28 decoder layers and 4 layers of each encoder: 2
     full fine-tune and 2 QLoRA steps (r 64, dropout 0) through
     ``train_loop`` (each rank its (data, fsdp) shard of the four
     samples), losses within 2e-3 relative and gradient norms within 3e-3.
     19b: the same mesh and cut, greedy decode of the phase-7 requests (8
     new tokens) under the near-tie rule. 19c: one full fine-tune step with
     ring attention over seq=2 (zigzag), and one with the GPipe decoder
     over pipe=2 (2 microbatches), 2 ranks each, losses and gradient norms
     as 19a. 19d: expert=2, 2 ranks, qwen3-30b-a3b width cut to 2 of 48
     layers (encoders to 4): greedy KV-cache decode under the near-tie
     rule, one full fine-tune and one expert-QLoRA step (losses and
     gradient norms as 19a, ``moe_ep_dropped_frac`` printed). 19e: the
     small fp32 models of phase 6 on (fsdp=2, tensor=2) and (expert=2)
     against one rank on the CPU (loss within 1e-4, gradients within 1e-3
     of their max); which gloo collectives take CUDA tensors as they are,
     values checked (the four that ``parallel.comm`` hands them must), and
     whether its ``batch_isend_irecv`` does (in two processes of its own).

Cut against the CLIs' defaults: generation runs batch 4 instead of 32 and
32 (bf16) / 16 (int8) new tokens instead of 3072; serving runs 8 slots
instead of 32, chunk 16 instead of 64, admission groups of 4 instead of 8
and 32 new tokens instead of 3072; training runs 3 steps. The MoE phases
keep every width of qwen3-30b-a3b; generation and serving run all 48
layers, training 4 of the 48 (full fine-tune of 30.5 B parameters does not
fit one card), with the moments offloaded 18. The parallel phases cut
depth only (19a-19d, printed on each phase's line).
The last two lines of standard output are the kernels JSON line and the
device JSON line.
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import math
import os
import subprocess
import sys
import time

# tolerances (stated here, checked below)
FLASH_O_ATOL = 2e-2     # bf16 output of unit-scale attention
FLASH_LSE_ATOL = 1e-3   # fp32 LSE, same fp32 math on both sides
RMS_REL = 2.0 ** -7     # one bf16 ulp at the top of a binade: the kernel
#                         rounds twice (x_hat, then w * x_hat) like the
#                         reference's weight-after-cast
INT8_REL = 1e-2         # of the output's max-abs (bf16 output rounding)
SMALL_LOGIT_ATOL = 1e-3  # fp32 small model, card kernels vs CPU plain path
FLASH_BWD_REL = 1e-2    # of the reference's max-abs: one bf16 rounding of
#                         dQ/dK/dV (2^-8 of the value) plus the few P and dS
#                         terms that round to the other bf16 neighbour
RMS_BWD_REL = 2.0 ** -7  # dx: one bf16 rounding of the output ...
RMS_BWD_ABS = 1e-5      # ... plus the fp32 sums' order where dx cancels to 0
RMS_DW_REL = 1e-2       # of max|dw|: dw is a sum over up to 65,536 rows,
#                         rounded once to bf16 at the end
PAGED_O_ATOL = 2e-2     # bf16 output of unit-scale attention (bf16 and int8
#                         pages: int8 rows are dequantized exactly on both
#                         sides, so only the output's rounding differs)
PAGED_F32_ATOL = 1e-4   # fp32 pages: the kernel's fp32 sums run in another
#                         order and its exp is the fast one
SERVE_INT8_FLIPS = 3    # greedy tokens that may differ, card vs CPU, over
#                         int8 pages (a quantization tie can flip an argmax)
GG_BF16_REL = 1e-2      # grouped GEMMs with anything in bf16, of the plain
#                         version's max-abs: operands (an fp32 dout is staged
#                         as bf16) or the result rounded to bf16
GG_F32_REL = 1e-4       # grouped GEMMs in fp32, of the max-abs: other sum order
TRAIN_LOSS_ATOL = 1e-4  # fp32 small model, one step, card vs CPU
TRAIN_GRAD_REL = 1e-3   # of each gradient's max-abs

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "tf32": 495e12}

REPLACES = {
    "flash_attention_fwd": "molly_tpu/ops/flash_attention.py:61",
    "flash_attention_dq": "molly_tpu/ops/flash_attention.py:221",
    "flash_attention_dkv": "molly_tpu/ops/flash_attention.py:264",
    "rmsnorm_fwd": "molly_tpu/ops/rmsnorm_pallas.py:26",
    "rmsnorm_bwd": "molly_tpu/ops/rmsnorm_pallas.py:34",
    "int8_matmul": "molly_tpu/ops/quant.py:46",
    "paged_attention": "molly_tpu/ops/paged_attention.py:112",
    "paged_attention_int8": "molly_tpu/ops/paged_attention_int8.py:225",
    # the launch site: the kernel bodies are megablox's (gmm, and tgmm
    # through gmm's VJP), in jax.experimental.pallas.ops.tpu.megablox
    "grouped_gemm": "molly_tpu/ops/moe.py:100",
    "grouped_gemm_tgmm": "molly_tpu/ops/moe.py:100",
}
# every bf16 forward and backward of the main paths (fp32 and unaligned
# views run the SIMT kernels of flash_attention_fwd.cu and
# flash_attention_bwd.cu)
_FWD_TMA_CU = "molly_tpu_torch/csrc/flash_attention_fwd_tma.cu"
_BWD_TMA_CU = "molly_tpu_torch/csrc/flash_attention_bwd_tma.cu"
# every bf16 paged launch of the main paths (fp32 pages and fp32 q over
# int8 pages run csrc/paged_attention.cu)
_PAGED_TMA_CU = "molly_tpu_torch/csrc/paged_attention_tma.cu"
_GG_CU = "molly_tpu_torch/csrc/grouped_gemm.cu"
# the kernels of each table row's first case: prefill and training in bf16
_GG_TMA_CU = "molly_tpu_torch/csrc/grouped_gemm_tma.cu"
# every decode- and serving-shaped grouped GEMM (bf16 lhs, bf16 or int8
# experts, M < 64 G)
_GG_STREAM_CU = "molly_tpu_torch/csrc/grouped_gemm_decode.cu"
# int8 experts at prefill and training shapes (M >= 64 G), forward and the
# QLoRA lhs gradient
_GG_INT8_TMA_CU = "molly_tpu_torch/csrc/grouped_gemm_int8_tma.cu"
# the fp32 expert-LoRA adapters' products at M >= 64 G
_GG_TC_CU = "molly_tpu_torch/csrc/grouped_gemm_f32_tc.cu"
# the int8 GEMM: the SIMT fallback (fp32 x, unaligned), every bf16 product
# at M > 16, every one at M <= 16 (the row's first case)
_INT8_CU = "molly_tpu_torch/csrc/int8_matmul.cu"
_INT8_TMA_CU = "molly_tpu_torch/csrc/int8_matmul_tma.cu"
_INT8_STREAM_CU = "molly_tpu_torch/csrc/int8_matmul_stream.cu"
SOURCES = {
    "flash_attention_fwd": ("cuda", _FWD_TMA_CU),
    "flash_attention_dq": ("cuda", _BWD_TMA_CU),
    "flash_attention_dkv": ("cuda", _BWD_TMA_CU),
    "rmsnorm_fwd": ("triton", "molly_tpu_torch/ops/rmsnorm_triton.py"),
    "rmsnorm_bwd": ("triton", "molly_tpu_torch/ops/rmsnorm_triton.py"),
    "int8_matmul": ("cuda", _INT8_STREAM_CU),
    "paged_attention": ("cuda", _PAGED_TMA_CU),
    "paged_attention_int8": ("cuda", _PAGED_TMA_CU),
    "grouped_gemm": ("cuda", _GG_TMA_CU),
    "grouped_gemm_tgmm": ("cuda", _GG_TC_CU),
}
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "rmsnorm_fwd", "rmsnorm_bwd")


def log(msg: str) -> None:
    """Print a line (in the spawned ranks of the parallel phases, rank 0
    only)."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_rank() != 0:
        return
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[phase] {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        if exc_type is None:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[phase] {self.name}: {status} in {dt:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        return False


@functools.cache
def side_stream():
    """The one stream every timing captures on."""
    import torch
    return torch.cuda.Stream()


def time_ms(fn, iters: int, warmup: int = 1, setup=None) -> float:
    """Device milliseconds per call: ``iters`` calls are captured into one
    CUDA graph and the graph's replay is timed with CUDA events, so the
    host's cost of launching (tens of microseconds for a small kernel,
    which would otherwise be all that is measured) does not count.
    ``setup``, when given, runs once on the capturing stream and its result
    is handed to ``fn`` (a forward pass whose backward is what is timed:
    autograd runs a backward on its forward's stream).

    Every call captures on the same side stream: cuBLAS keeps a workspace
    for each stream it has run on for the life of the process, so a new
    stream per timing (the pool hands out 32 in turn) left up to one more
    workspace allocated after each timed plain version."""
    import torch
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if setup is not None:
            ctx = setup()
            call = lambda: fn(ctx)  # noqa: E731
        else:
            call = fn
        for _ in range(warmup):
            call()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``iters`` eager calls in a row: the host's
    launch cost included, which bounds a small kernel in an eager loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def release():
    """Return what is no longer referenced to the card."""
    import torch
    torch.cuda.empty_cache()


def counters():
    from molly_tpu_torch.ops import (flash_attention, grouped_gemm, quant,
                                     rmsnorm_triton)
    return {"grouped_gemm": grouped_gemm.grouped_gemm,
            "grouped_gemm_tgmm": grouped_gemm.grouped_gemm_tgmm,
            "flash_attention_fwd": flash_attention.flash_attention_fwd,
            "flash_attention_dq": flash_attention.flash_attention_dq,
            "flash_attention_dkv": flash_attention.flash_attention_dkv,
            "rmsnorm_fwd": rmsnorm_triton.rms_norm,
            "rmsnorm_bwd": rmsnorm_triton.rms_norm_bwd,
            "int8_matmul": quant.int8_matmul}


def bound(nbytes: float, flops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def allowed_pairs(mask, Sq, causal, q_offset=0) -> int:
    """(query, key) pairs per head that the padding mask and the causal
    rule allow, summed over the batch: the work this run's data needs."""
    import torch
    keep = (mask != 0)                                   # [B, Skv]
    if not causal:
        return int(keep.sum().item()) * Sq
    # query i sees keys <= q_offset + i
    csum = torch.cumsum(keep.to(torch.int64), dim=1)
    idx = torch.arange(Sq, device=mask.device) + q_offset
    idx = idx.clamp(max=mask.shape[1] - 1)
    return int(csum[:, idx].sum().item())


def sdpa_inputs(q, k, v, mask, causal, q_offset=0):
    """The same attention as one ``scaled_dot_product_attention`` call:
    [B, N, S, D] views and one boolean mask [B, 1, Sq, Skv]."""
    import torch
    Sq, Skv = q.shape[1], k.shape[1]
    allow = (mask != 0)[:, None, None, :].expand(-1, 1, Sq, -1)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        allow = allow & (q_pos >= torch.arange(Skv, device=q.device))
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            allow.contiguous())


def reset_counts():
    from molly_tpu_torch.ops.paged_attention import paged_attention
    for fn in counters().values():
        fn.launches = 0
    counters()["grouped_gemm"].launches_int8 = 0
    counters()["grouped_gemm"].launches_tma = 0
    counters()["grouped_gemm"].launches_stream = 0
    counters()["grouped_gemm"].launches_int8_tma = 0
    counters()["grouped_gemm"].launches_tc = 0
    counters()["grouped_gemm_tgmm"].launches_tma = 0
    counters()["grouped_gemm_tgmm"].launches_tc = 0
    counters()["int8_matmul"].launches_tma = 0
    counters()["int8_matmul"].launches_gemv = 0
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        counters()[name].launches_tma = 0
    paged_attention.launches = paged_attention.launches_int8 = 0
    paged_attention.launches_tma = 0


def check_flash_tma(label: str) -> None:
    """Every flash forward, dQ and dK/dV launch since ``reset_counts`` ran
    on the TMA and wgmma kernels: the main paths give them bf16 at aligned
    strides only."""
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        fn = counters()[name]
        if fn.launches:
            log(f"  {label}: {name} {fn.launches} launches, "
                f"{fn.launches_tma} on the TMA and wgmma kernel")
        if fn.launches_tma != fn.launches:
            raise AssertionError(f"{label}: a {name} launch ran on the SIMT "
                                 f"kernel")


def check_paged_tma(label: str) -> None:
    """Every paged launch since ``reset_counts`` ran on the split TMA
    kernel: the main paths give it bf16 q over bf16 or int8 pages."""
    from molly_tpu_torch.ops.paged_attention import paged_attention
    if paged_attention.launches:
        log(f"  {label}: paged_attention {paged_attention.launches} "
            f"launches, {paged_attention.launches_tma} on the split TMA "
            f"kernel")
    if paged_attention.launches_tma != paged_attention.launches:
        raise AssertionError(f"{label}: a paged launch ran on "
                             f"paged_attention.cu")


def check_int8_tma(label: str) -> None:
    """Every int8 GEMM launch since ``reset_counts`` ran on the TMA and
    wgmma kernel (M > 16) or on the weight stream (M <= 16): the main paths
    give it bf16 x at aligned shapes only, so a launch on the SIMT kernel
    is a product that missed its route."""
    fn = counters()["int8_matmul"]
    if fn.launches:
        log(f"  {label}: int8_matmul {fn.launches} launches, "
            f"{fn.launches_tma} on the TMA and wgmma kernel, "
            f"{fn.launches_gemv} on the weight stream (M <= 16)")
    if fn.launches != fn.launches_tma + fn.launches_gemv:
        raise AssertionError(f"{label}: an int8 launch ran on the SIMT "
                             f"kernel")


def grouped_off_route() -> int:
    """Forward grouped-GEMM launches since ``reset_counts`` on none of the
    TMA, int8 TMA, fp32 tensor-core and split-stream kernels, i.e. on
    grouped_gemm.cu."""
    c = counters()["grouped_gemm"]
    return (c.launches - c.launches_tma - c.launches_stream
            - c.launches_int8_tma - c.launches_tc)


def int8_grouped_launches() -> int:
    """Grouped-GEMM launches over an int8 rhs since ``reset_counts`` (they
    are part of ``grouped_gemm``'s count)."""
    return counters()["grouped_gemm"].launches_int8


def tma_launches():
    """(forward, tgmm) launches since ``reset_counts`` that ran on the TMA
    and wgmma kernels (they are part of the two kernels' counts; the
    forward's split-stream launches are ``grouped_gemm.launches_stream``)."""
    c = counters()
    return (c["grouped_gemm"].launches_tma,
            c["grouped_gemm_tgmm"].launches_tma)


def read_counts():
    """Launches since ``reset_counts``. The paged wrapper launches one
    templated kernel and counts its int8-page launches apart."""
    from molly_tpu_torch.ops.paged_attention import paged_attention
    counts = {name: fn.launches for name, fn in counters().items()}
    counts["paged_attention_int8"] = paged_attention.launches_int8
    counts["paged_attention"] = (paged_attention.launches
                                 - paged_attention.launches_int8)
    return counts


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------


def parity_flash(g, results):
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    dev = "cuda"

    def case(name, q, k, v, mask, causal, scale, valid_rows, iters,
             q_offset=0):
        tma0 = flash_attention_fwd.launches_tma
        o, lse = flash_attention_fwd(q, k, v, mask, causal, scale, q_offset)
        route = "tma" if flash_attention_fwd.launches_tma > tma0 else "simt"
        again = flash_attention_fwd(q, k, v, mask, causal, scale, q_offset)
        ro, rlse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         mask, causal, scale, q_offset)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(o).all()) or not bool(
                torch.isfinite(lse).all()):
            raise AssertionError(f"flash {name}: non-finite output")
        if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"flash {name}: two runs differ")
        del again
        # rows without a valid key (left padding): O = 0 and LSE = 0
        none = valid_rows == 0
        no_key_zero = bool((o[none] == 0).all()) and bool(
            (lse.transpose(1, 2)[none] == 0).all())
        if not no_key_zero:
            raise AssertionError(f"flash {name}: a row without a valid key "
                                 f"is not zero")
        vr = valid_rows[:, :, None, None]                   # [B, Sq, 1, 1]
        err = ((o.float() - ro).abs() * vr).max().item()
        lse_err = ((lse - rlse).abs()
                   * valid_rows[:, None, :]).max().item()
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal,
                                                 scale, q_offset), iters)
        plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, mask, causal, scale, q_offset), max(1, iters // 2))
        sq, sk, sv, allow = sdpa_inputs(q, k, v, mask, causal, q_offset)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=allow, scale=scale,
            enable_gqa=q.shape[2] != k.shape[2]), iters)
        pairs = allowed_pairs(mask, q.shape[1], causal, q_offset)
        bound_ms, bound_by = bound(
            nbytes(q, k, v, o, lse),
            2 * pairs * q.shape[2] * (q.shape[3] + v.shape[3]), "bf16")
        log(f"  flash {name}: route {route}; max|dO| {err:.3e} (tol "
            f"{FLASH_O_ATOL}), max|dLSE| {lse_err:.3e} (tol {FLASH_LSE_ATOL}),"
            f" {int(none.sum())} rows without a key exactly zero, two runs "
            f"bit-equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library"
            f" {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= FLASH_O_ATOL and lse_err <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash {name}: parity miss")
        if route != "tma":
            raise AssertionError(f"flash {name}: ran on the SIMT kernel")
        del ro, rlse, allow
        torch.cuda.empty_cache()
        return {"case": name, "route": route, "max_abs_err": err,
                "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    cases = []
    # decoder prefill: q [4, 3072, 16, 128] over the [4, 8, 3136, 256]
    # bnsd cache window (k = [..., :128], v = [..., 128:]), causal, with the
    # engine's full-cache mask (left padding, empty decode columns)
    B, S, T, N, Nkv, D = 4, 3072, 64, 16, 8, 128
    q = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, Nkv, S + T, 2 * D), generator=g,
                     device=dev).to(torch.bfloat16)
    k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    mask = torch.zeros((B, S + T), dtype=torch.int32, device=dev)
    pads = (0, 517, 1203, 2999)
    for b, p in enumerate(pads):
        mask[b, p:S] = 1
    valid = (torch.cumsum(mask[:, :S], dim=1) > 0).float()
    cases.append(case("decoder_prefill_bf16[4,3072,16,128]x3136", q, k, v,
                      mask, True, D ** -0.5, valid, 5))
    del q, kv, k, v
    # encoders: [16, 1024, 20, 64] bidirectional at scale 1.0 (ESM scales q
    # by Dh^-0.5 before rotary); dummy segments attend to position 0 only
    B, S, N, D = 16, 1024, 20, 64
    q = (torch.randn((B, S, N, D), generator=g, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    k = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = (1024, 669, 602, 1, 1, 1, 1, 1, 1024, 311, 1, 1, 77, 1, 1, 1)
    mask = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    valid = torch.ones((B, S), device=dev)
    cases.append(case("encoder_bf16[16,1024,20,64]", q, k, v, mask, False,
                      1.0, valid, 10))
    del q, k, v
    # the training forward: [4, 1024, 16, 128] over 8 kv heads, causal,
    # right-padded
    q, k, v, _, mask = train_attention_inputs(g)
    valid = torch.ones((4, 1024), device=dev)
    cases.append(case("train_bf16[4,1024,16,128]", q, k, v, mask, True,
                      128 ** -0.5, valid, 10))
    del q, k, v
    # serving prefill behind a shared prefix: the cache starts with 64
    # prefix columns, q holds only the right-padded suffix [4, 3008, 16,
    # 128], so q_offset = 64 and Sq < Skv = 3072
    B, S, pre, N, Nkv, D = 4, 3008, 64, 16, 8, 128
    q = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, Nkv, pre + S, 2 * D), generator=g,
                     device=dev).to(torch.bfloat16)
    k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    mask = torch.zeros((B, pre + S), dtype=torch.int32, device=dev)
    for b, n in enumerate((3008, 2400, 1117, 41)):
        mask[b, :pre + n] = 1
    valid = torch.ones((B, S), device=dev)  # every row sees the prefix
    cases.append(case("serve_prefill_bf16[4,3008,16,128]x3072,q_offset=64",
                      q, k, v, mask, True, D ** -0.5, valid, 5, q_offset=pre))
    del q, kv, k, v
    # MoE prefill (qwen3-30b-a3b: 32 q heads over 4 kv heads): q [4, 3072,
    # 32, 128] over the [4, 4, 3136, 256] cache, the decoder prefill's pads
    B, S, T, N, Nkv, D = 4, 3072, 64, 32, 4, 128
    q = torch.randn((B, S, N, D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, Nkv, S + T, 2 * D), generator=g,
                     device=dev).to(torch.bfloat16)
    k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    mask = torch.zeros((B, S + T), dtype=torch.int32, device=dev)
    for b, p in enumerate(pads):
        mask[b, p:S] = 1
    valid = (torch.cumsum(mask[:, :S], dim=1) > 0).float()
    cases.append(case("moe_prefill_bf16[4,3072,32,128]x3136,4kv", q, k, v,
                      mask, True, D ** -0.5, valid, 5))
    del q, kv, k, v
    # phases 19a-19b (tensor=2): molly-1.7B's local heads, 8 q over 4 kv, at
    # the train step's shape and at the decoder prefill's (from a generator
    # of their own: the cases above keep their inputs)
    p19 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 19)
    q, k, v, _, mask = train_attention_inputs(p19, N=8, Nkv=4)
    cases.append(case("p19_tp_train_bf16[4,1024,8,128]x4kv", q, k, v, mask,
                      True, 128 ** -0.5, torch.ones((4, 1024), device=dev),
                      10))
    del q, k, v
    B, S, T, N, Nkv, D = 4, 3072, 64, 8, 4, 128
    q = torch.randn((B, S, N, D), generator=p19, device=dev).to(
        torch.bfloat16)
    kv = torch.randn((B, Nkv, S + T, 2 * D), generator=p19,
                     device=dev).to(torch.bfloat16)
    k, v = kv[..., :D].transpose(1, 2), kv[..., D:].transpose(1, 2)
    mask = torch.zeros((B, S + T), dtype=torch.int32, device=dev)
    for b, p in enumerate(pads):
        mask[b, p:S] = 1
    valid = (torch.cumsum(mask[:, :S], dim=1) > 0).float()
    cases.append(case("p19_tp_prefill_bf16[4,3072,8,128]x3136,4kv", q, k, v,
                      mask, True, D ** -0.5, valid, 5))
    del q, kv, k, v
    # latent attention's prefill (Moonlight-16B-A3B): q [4, 3072, 16, 192]
    # over the decompressed K [4, 3136, 16, 192] = [k_nope | k_rope] and V
    # [4, 3136, 16, 128], the strided half of kv [.., 256] = [k_nope | v]
    # as W_kv_b gives it, causal, the decoder prefill's pads (a generator
    # of its own)
    mla = torch.Generator(device=dev).manual_seed(g.initial_seed() + 25)
    B, S, T, N, Dqk, Dv = 4, 3072, 64, 16, 192, 128
    q = torch.randn((B, S, N, Dqk), generator=mla, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, S + T, N, Dqk), generator=mla, device=dev).to(
        torch.bfloat16)
    kv = torch.randn((B, S + T, N, 2 * Dv), generator=mla, device=dev).to(
        torch.bfloat16)
    v = kv[..., Dv:]
    mask = torch.zeros((B, S + T), dtype=torch.int32, device=dev)
    for b, p in enumerate(pads):
        mask[b, p:S] = 1
    valid = (torch.cumsum(mask[:, :S], dim=1) > 0).float()
    cases.append(case("mla_prefill_bf16[4,3072,16,192]x3136,v128", q, k, v,
                      mask, True, Dqk ** -0.5, valid, 5))
    results["flash_attention_fwd"] = cases


def train_attention_inputs(g, B=4, S=1024, N=16, Nkv=8, D=128,
                           lengths=(1024, 913, 660, 402), q_scale=1.0):
    """q, k, v, dO and the right-padded mask at the train step's shapes."""
    import torch
    dev = "cuda"

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q = (rand(B, S, N, D) * q_scale).to(torch.bfloat16)
    k = rand(B, S, Nkv, D).to(torch.bfloat16)
    v = rand(B, S, Nkv, D).to(torch.bfloat16)
    dout = rand(B, S, N, D).to(torch.bfloat16)
    mask = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, :lengths[b % len(lengths)]] = 1
    return q, k, v, dout, mask


def parity_flash_bwd(g, results):
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_delta, flash_attention_dkv,
        flash_attention_dq, flash_attention_fwd)

    def case(name, q, k, v, dout, mask, causal, scale, iters):
        N, D = q.shape[2], q.shape[3]
        o, lse = flash_attention_fwd(q, k, v, mask, causal, scale, 0)
        # rows without a valid key (none here under right padding, but the
        # rule holds for any mask): dO is zero there, as in the model
        has_key = (torch.cumsum(mask, dim=1) > 0) if causal else \
            (mask.sum(dim=1, keepdim=True) > 0).expand_as(mask)
        dout = dout * has_key[:, :, None, None].to(dout.dtype)

        def delta_pass():  # tensor ops, as flash_attention_bwd computes it
            return flash_attention_delta(dout, o)

        delta = delta_pass()
        args = (q, k, v, mask, lse, delta, dout, causal, scale, 0)
        tma0 = (flash_attention_dq.launches_tma,
                flash_attention_dkv.launches_tma)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        routes = tuple("tma" if n > n0 else "simt" for n, n0 in zip(
            (flash_attention_dq.launches_tma,
             flash_attention_dkv.launches_tma), tma0))
        again = (flash_attention_dq(*args), *flash_attention_dkv(*args))
        # the plain version on the same bf16 tensors: fp32 math inside, P
        # and dS rounded to bf16 before their second product as the kernel
        # rounds them
        rq, rk, rv = (t.float() for t in flash_attention_bwd_plain(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash bwd {name}: two runs differ")
        del again
        # keys the mask removes get exactly nothing
        masked = mask == 0
        if not (bool((dk[masked] == 0).all()) and
                bool((dv[masked] == 0).all())):
            raise AssertionError(f"flash bwd {name}: a masked key's dK or "
                                 f"dV is not zero")
        errs = {}
        for nm, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"flash bwd {name}: non-finite {nm}")
            err = (a.float() - r).abs().max().item()
            tol = FLASH_BWD_REL * r.abs().max().item()
            errs[nm] = err
            if not err <= tol:
                raise AssertionError(f"flash bwd {name}: {nm} max err "
                                     f"{err:.3e} > {tol:.3e}")
        # random dO on every row must still come out finite
        noise = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        nargs = (q, k, v, mask, lse, delta, noise, causal, scale, 0)
        for t in (flash_attention_dq(*nargs), *flash_attention_dkv(*nargs)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"flash bwd {name}: non-finite with "
                                     f"random dO")
        dq_ms = time_ms(lambda: flash_attention_dq(*args), iters)
        dkv_ms = time_ms(lambda: flash_attention_dkv(*args), iters)
        delta_ms = time_ms(delta_pass, iters)
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(*args),
                           max(1, iters // 2))
        # the library's backward computes dQ, dK and dV in one call
        sq, sk, sv, allow = sdpa_inputs(q, k, v, mask, causal)
        sq, sk, sv = (t.detach().requires_grad_(True) for t in (sq, sk, sv))
        sdo = dout.transpose(1, 2)
        library_ms = time_ms(
            lambda so: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                           retain_graph=True),
            iters, setup=lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=allow, scale=scale,
                enable_gqa=q.shape[2] != k.shape[2]))
        pairs = allowed_pairs(mask, q.shape[1], causal)
        dq_bound = bound(nbytes(q, k, v, dout, lse, delta, dq),
                         3 * 2 * D * pairs * N, "bf16")
        dkv_bound = bound(nbytes(q, k, v, dout, lse, delta, dk, dv),
                          4 * 2 * D * pairs * N, "bf16")
        log(f"  flash bwd {name}: routes dq {routes[0]}, dkv {routes[1]}; "
            f"max err dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv "
            f"{errs['dv']:.3e} (tol {FLASH_BWD_REL} of max|ref|), two runs "
            f"bit-equal, {int(masked.sum())} masked keys' dK, dV exactly "
            f"zero; dq {dq_ms:.4f} ms (bound {dq_bound[0]:.4f} ms, "
            f"{dq_bound[1]}), dkv {dkv_ms:.4f} ms (bound "
            f"{dkv_bound[0]:.4f} ms, {dkv_bound[1]}), delta pass "
            f"{delta_ms:.4f} ms: dq + dkv + delta "
            f"{dq_ms + dkv_ms + delta_ms:.4f} ms against library dq+dk+dv "
            f"{library_ms:.4f} ms; plain dq+dk+dv {plain_ms:.3f} ms")
        if routes != ("tma", "tma"):
            raise AssertionError(f"flash bwd {name}: ran on the SIMT kernels")
        del rq, rk, rv, allow
        torch.cuda.empty_cache()
        common = {"case": name, "plain_ms": plain_ms,
                  "library_ms": library_ms, "delta_ms": delta_ms,
                  "note": "plain_ms and library_ms time dQ, dK and dV "
                          "together; delta_ms the rowsum(dO * O) pass"}
        return ({**common, "route": routes[0], "max_abs_err": errs["dq"],
                 "ms": dq_ms, "bound_ms": dq_bound[0],
                 "bound_by": dq_bound[1]},
                {**common, "route": routes[1],
                 "max_abs_err": max(errs["dk"], errs["dv"]),
                 "ms": dkv_ms, "bound_ms": dkv_bound[0],
                 "bound_by": dkv_bound[1]})

    dq_cases, dkv_cases = [], []
    q, k, v, dout, mask = train_attention_inputs(g)
    a, b = case("train_bf16[4,1024,16,128]x8kv", q, k, v, dout, mask, True,
                128 ** -0.5, 5)
    dq_cases.append(a)
    dkv_cases.append(b)
    del q, k, v, dout
    # MoE training (qwen3-30b-a3b: 32 q heads over 4 kv heads, group 8)
    q, k, v, dout, mask = train_attention_inputs(g, N=32, Nkv=4)
    a, b = case("moe_train_bf16[4,1024,32,128]x4kv", q, k, v, dout, mask,
                True, 128 ** -0.5, 5)
    dq_cases.append(a)
    dkv_cases.append(b)
    del q, k, v, dout
    # bidirectional, D = 64, an encoder's head count (the train step's
    # encoder shape; the encoders are frozen there, so this is parity only)
    q, k, v, dout, mask = train_attention_inputs(
        g, B=16, S=128, N=20, Nkv=20, D=64, lengths=(128, 97, 31, 1),
        q_scale=64 ** -0.5)
    a, b = case("encoder_bf16[16,128,20,64]", q, k, v, dout, mask, False,
                1.0, 10)
    dq_cases.append(a)
    dkv_cases.append(b)
    del q, k, v, dout
    # phase 19a (tensor=2): molly-1.7B's local heads, 8 q over 4 kv
    p19 = torch.Generator(device="cuda").manual_seed(g.initial_seed() + 19)
    q, k, v, dout, mask = train_attention_inputs(p19, N=8, Nkv=4)
    a, b = case("p19_tp_train_bf16[4,1024,8,128]x4kv", q, k, v, dout, mask,
                True, 128 ** -0.5, 5)
    dq_cases.append(a)
    dkv_cases.append(b)
    results["flash_attention_dq"] = dq_cases
    results["flash_attention_dkv"] = dkv_cases


def parity_rmsnorm(g, results):
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.rmsnorm_triton import (rms_norm, rms_norm_bwd,
                                                    rms_norm_bwd_plain,
                                                    rms_norm_plain)
    dev = "cuda"

    def case(name, x, w, iters):
        y = rms_norm(x, w, 1e-6)
        bit_equal = torch.equal(y, rms_norm(x, w, 1e-6))
        ref = rms_norm_plain(x.float(), w.float(), 1e-6)
        err = (y.float() - ref).abs()
        rel_excess = (err - RMS_REL * ref.abs()).max().item()
        max_err = err.max().item()
        del ref
        ms = time_ms(lambda: rms_norm(x, w, 1e-6), iters)
        eager = eager_ms(lambda: rms_norm(x, w, 1e-6), iters)
        plain_ms = time_ms(lambda: rms_norm_plain(x, w, 1e-6), iters)
        # the library call exists for a 1-D weight only
        library_ms = (time_ms(lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
                              iters) if w.ndim == 1 else None)
        bound_ms, bound_by = bound(nbytes(x, w, y), 4 * x.numel(), "fp32")
        log(f"  rmsnorm {name}: max|err| {max_err:.3e}, max(err - 2^-7|ref|)"
            f" {rel_excess:.3e} (must be <= 0), two runs bit-equal: "
            f"{bit_equal}; kernel {ms:.4f} ms "
            f"({eager:.4f} ms a call in an eager loop), "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if rel_excess > 0 or not bool(torch.isfinite(y).all()) or \
                not bit_equal:
            raise AssertionError(f"rmsnorm {name}: parity miss")
        return {"case": name, "max_abs_err": max_err, "ms": ms,
                "eager_ms": eager, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def bwd_case(name, shape, iters, g=g):
        H = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        gr = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).to(
            torch.bfloat16)
        dx, dw = rms_norm_bwd(x, w, gr, 1e-6, True)
        dx_again, dw_again = rms_norm_bwd(x, w, gr, 1e-6, True)
        dx_only, none = rms_norm_bwd(x, w, gr, 1e-6, False)
        rx, rw = rms_norm_bwd_plain(x.float(), w.float(), gr.float(), 1e-6)
        bit_equal = torch.equal(dx, dx_again) and torch.equal(dw, dw_again)
        torch.cuda.synchronize()
        err = (dx.float() - rx).abs()
        dx_excess = (err - RMS_BWD_REL * rx.abs() - RMS_BWD_ABS).max().item()
        dw_err = (dw.float() - rw).abs().max().item()
        dw_tol = RMS_DW_REL * rw.abs().max().item()
        ms = time_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, True), iters)
        eager = eager_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, True), iters)
        dx_ms = time_ms(lambda: rms_norm_bwd(x, w, gr, 1e-6, False), iters)
        plain_ms = time_ms(lambda: rms_norm_bwd_plain(x, w, gr, 1e-6), iters)
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        library_ms = time_ms(
            lambda yl: torch.autograd.grad(yl, (xl, wl), gr,
                                           retain_graph=True),
            iters, setup=lambda: F.rms_norm(xl, (H,), wl, 1e-6))
        bound_ms, bound_by = bound(nbytes(x, gr, w, dx, dw), 12 * x.numel(),
                                   "fp32")
        log(f"  rmsnorm bwd {name}: max|dx err| {err.max().item():.3e}, "
            f"max(err - 2^-7|ref| - 1e-5) {dx_excess:.3e} (must be <= 0), "
            f"max|dw err| {dw_err:.3e} (tol {dw_tol:.3e}), two runs "
            f"bit-equal: {bit_equal}; kernel "
            f"{ms:.4f} ms ({dx_ms:.4f} ms without dw, {eager:.4f} ms a call "
            f"in an eager loop), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if dx_excess > 0 or dw_err > dw_tol or none is not None or \
                not bit_equal or not torch.equal(dx, dx_only) or \
                not bool(torch.isfinite(dx).all()):
            raise AssertionError(f"rmsnorm bwd {name}: parity miss")
        return {"case": name, "max_abs_err": max(err.max().item(), dw_err),
                "ms": ms, "ms_without_dw": dx_ms, "eager_ms": eager,
                "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    x = torch.randn((4 * 3072, 2048), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases = [case("hidden_bf16[12288,2048]", x, w, 20)]
    # fused decode branch: stacked qk_norm over [B, S, Nq+Nkv, Dh]
    x = torch.randn((4, 3072, 24, 128), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((24, 128), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("qk_norm_bf16[4,3072,24,128]x[24,128]", x, w, 20))
    # decode step: [4, 1, 2048]
    x = torch.randn((4, 1, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("decode_bf16[4,1,2048]", x, w, 50))
    # the train step's shapes: hidden rows, and per-head rows of 128
    x = torch.randn((4096, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("train_hidden_bf16[4096,2048]", x, w, 20))
    x = torch.randn((4, 1024, 16, 128), generator=g, device=dev).to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((128,), generator=g, device=dev)).to(
        torch.bfloat16)
    cases.append(case("train_q_norm_bf16[4,1024,16,128]x[128]", x, w, 20))
    # the cases below draw from a generator of their own, so that every
    # later case gets the inputs it got before they were added
    extra = torch.Generator(device=dev).manual_seed(g.initial_seed() + 1)

    def heads(shape, stacked, qkv_width=None, g=extra):
        """bf16 per-head rows [B, S, N, 128] with a weight [N, 128]
        (stacked) or [128]; with ``qkv_width``, as the fused branch's view
        ``qkv[..., :N * 128]`` of a [B, S, qkv_width] product."""
        B, S, N, Dh = shape
        if qkv_width is None:
            x = torch.randn(shape, generator=g, device=dev)
        else:
            qkv = torch.randn((B, S, qkv_width), generator=g, device=dev)
            x = qkv.to(torch.bfloat16)[..., :N * Dh].reshape(shape)
        w = 1 + 0.1 * torch.randn((N, Dh) if stacked else (Dh,),
                                  generator=g, device=dev)
        return x.to(torch.bfloat16), w.to(torch.bfloat16)

    # the main paths' other per-head shapes: 1.7B k_norm at prefill; the
    # MoE decoder's q_norm (32 heads) and its fused branch's stacked
    # qk_norm (int8 experts); the 1.7B fused branch's view as it lies in
    # qkv [4,3072,4096] (q 2048 + k 1024 + v 1024 columns)
    for name, shape, stacked, width in (
            ("k_norm_bf16[4,3072,8,128]x[128]", (4, 3072, 8, 128), False,
             None),
            ("moe_q_norm_bf16[4,3072,32,128]x[128]", (4, 3072, 32, 128),
             False, None),
            ("moe_qk_norm_view_bf16[4,3072,36,128]x[36,128] of "
             "[4,3072,5120]", (4, 3072, 36, 128), True, 5120),
            ("qk_norm_view_bf16[4,3072,24,128]x[24,128] of [4,3072,4096]",
             (4, 3072, 24, 128), True, 4096)):
        x, w = heads(shape, stacked, width)
        cases.append(case(name, x, w, 20))
    # phases 19a-19b (tensor=2): the q and k norms on molly-1.7B's local
    # heads (their backward's shapes are train_k_norm's and
    # moe_train_k_norm's below)
    p19 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 19)
    for name, shape in (("p19_tp_q_norm_bf16[4,1024,8,128]x[128]",
                         (4, 1024, 8, 128)),
                        ("p19_tp_k_norm_bf16[4,1024,4,128]x[128]",
                         (4, 1024, 4, 128))):
        x, w = heads(shape, False, None, p19)
        cases.append(case(name, x, w, 20))
    results["rmsnorm_fwd"] = cases
    results["rmsnorm_bwd"] = [
        bwd_case("train_hidden_bf16[4096,2048]", (4096, 2048), 20),
        bwd_case("train_q_norm_bf16[4,1024,16,128]x[128]",
                 (4, 1024, 16, 128), 20),
        bwd_case("train_k_norm_bf16[4,1024,8,128]x[128]",
                 (4, 1024, 8, 128), 20),
        # the MoE training step's per-head norms (32 q heads, 4 kv heads)
        bwd_case("moe_train_q_norm_bf16[4,1024,32,128]x[128]",
                 (4, 1024, 32, 128), 20, extra),
        bwd_case("moe_train_k_norm_bf16[4,1024,4,128]x[128]",
                 (4, 1024, 4, 128), 20, extra),
    ]


def parity_int8(g, results):
    """The int8 GEMM at the main paths' shapes: decode (M = 4: the weight
    stream of int8_matmul_stream.cu) and the --int8
    prefill and QLoRA base products (bf16 x at M > 16: the TMA and wgmma
    kernel of int8_matmul_tma.cu). Each case prints its route and the
    counter that shows it, checks it against ``int8_takes_tma`` and
    ``int8_takes_stream``, two runs bit-equal on either, its bound, and on
    a line of its own, as a yardstick only, cuBLAS's time for the bf16
    product of the same shape over the weights dequantized beforehand: not
    the same function (no PyTorch call multiplies bf16 by int8 weights), so
    not the library column."""
    import torch

    from molly_tpu_torch.ops.quant import (int8_matmul, int8_matmul_plain,
                                           int8_takes_stream, int8_takes_tma)
    dev = "cuda"

    def case(name, M, K, N, iters, g=g):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8)
        scale = (torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4)
        q = {"w_q": w_q, "scale": scale}
        c0 = (int8_matmul.launches_tma, int8_matmul.launches_gemv)
        y = int8_matmul(x, q)
        route = ("tma" if int8_matmul.launches_tma > c0[0] else
                 "stream" if int8_matmul.launches_gemv > c0[1] else "simt")
        bit_equal = torch.equal(y, int8_matmul(x, q))
        ref = int8_matmul_plain(x.float(), q)
        err = (y.float() - ref).abs().max().item()
        tol = INT8_REL * ref.abs().max().item()
        del ref
        ms = time_ms(lambda: int8_matmul(x, q), iters)
        plain_ms = time_ms(lambda: int8_matmul_plain(x, q), iters)
        w_bf16 = (w_q.float() * scale).to(torch.bfloat16)
        cublas_ms = time_ms(lambda: x @ w_bf16, iters)
        del w_bf16
        bound_ms, bound_by = bound(nbytes(x, w_q, scale, y), 2 * M * N * K,
                                   "bf16")
        source = {"tma": _INT8_TMA_CU, "stream": _INT8_STREAM_CU,
                  "simt": _INT8_CU}[route]
        log(f"  int8 {name}: route {route} ({source.rsplit('/', 1)[1]}); "
            f"max|err| {err:.3e} (tol {tol:.3e}), two runs bit-equal: "
            f"{bit_equal}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library none (no PyTorch call multiplies bf16 by int8 "
            f"weights), bound {bound_ms:.4f} ms ({bound_by})")
        log(f"  int8 {name}: yardstick, not the same function: cuBLAS bf16 "
            f"x @ w over the weights dequantized beforehand "
            f"{cublas_ms:.4f} ms")
        if not err <= tol or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"int8 {name}: parity miss")
        expected = ("tma" if int8_takes_tma(M, K, N, x.dtype) else
                    "stream" if int8_takes_stream(M, K, N, x.dtype) else
                    "simt")
        if route != expected or not bit_equal:
            raise AssertionError(f"int8 {name}: ran on the {route} route "
                                 f"(expected {expected}), bit-equal "
                                 f"{bit_equal}")
        return {"case": name, "route": route, "source": source,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "cublas_bf16_yardstick_ms": cublas_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}

    # the decode cases at the end draw from a generator of their own, so that
    # every later phase gets the inputs it got before they were added
    extra = torch.Generator(device=dev).manual_seed(g.initial_seed() + 2)
    results["int8_matmul"] = [
        case("lm_head_decode_bf16[4,2048]x[2048,151936]", 4, 2048, 151936,
             20),
        case("qkv_prefill_bf16[12288,2048]x[2048,4096]", 12288, 2048, 4096,
             5),
        case("down_decode_bf16[4,6144]x[6144,2048]", 4, 6144, 2048, 50),
        # the QLoRA train step's base products
        case("qlora_gate_bf16[4096,2048]x[2048,6144]", 4096, 2048, 6144, 5),
        case("qlora_down_bf16[4096,6144]x[6144,2048]", 4096, 6144, 2048, 5),
        # the decode step's other fused products: 1.7B qkv, o and gate-up,
        # the MoE decoder's qkv (32 q heads, 4 kv heads) and o
        case("qkv_decode_bf16[4,2048]x[2048,4096]", 4, 2048, 4096, 50,
             extra),
        case("o_decode_bf16[4,2048]x[2048,2048]", 4, 2048, 2048, 50, extra),
        case("gateup_decode_bf16[4,2048]x[2048,12288]", 4, 2048, 12288, 50,
             extra),
        case("moe_qkv_decode_bf16[4,2048]x[2048,5120]", 4, 2048, 5120, 50,
             extra),
        case("moe_o_decode_bf16[4,4096]x[4096,2048]", 4, 4096, 2048, 50,
             extra),
    ]


def parity_paged(g, results):
    """The paged flash-decode kernel over bf16 pages and over int8 pages at
    the serving shape (32 slots, 16 q heads over 8 kv heads, Dh 128, all 28
    layers' pages in one pool, a shuffled page table, lengths from 1 to
    3136 that mostly end inside a page, one empty slot), at 8 slots, at the
    MoE serving shape (8 slots, 32 q heads over 4 kv heads, 48 layers'
    pages), and one fp32 case at Dh 64 with one q head a kv head. Each case
    prints its route (bf16 q: the split TMA kernel; fp32: the SIMT kernel
    of paged_attention.cu), checks two runs bit-equal, and (split TMA
    kernel) replays a captured launch after the lengths and the page table
    change in place, which must equal an eager call on the new data."""
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.models.qwen3 import quantize_page_rows
    from molly_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    dev = "cuda"

    def case(name, B, Nq, Nkv, Dh, P, rows, lens, dtype, quant, tol, iters):
        pps = -(-max(lens) // P)
        q = torch.randn((B, Nq, Dh), generator=g, device=dev).to(dtype)
        table = torch.randperm(rows - 1, generator=g, device=dev)[
            :B * pps].reshape(B, pps).to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        pools = []
        for _ in range(2):  # K then V, made in slices to bound fp32 scratch
            pool = torch.empty((Nkv, rows, P, Dh), device=dev,
                               dtype=torch.int8 if quant else dtype)
            scales = (torch.empty((Nkv, rows, P), device=dev)
                      if quant else None)
            for h in range(Nkv):
                x = torch.randn((rows, P, Dh), generator=g, device=dev)
                if quant:
                    w, sc = quantize_page_rows(x)
                    pool[h], scales[h] = w, sc[..., 0]
                else:
                    pool[h] = x.to(dtype)
            pools.append((pool, scales))
        (kp, ks), (vp, vs) = pools
        kw = dict(k_scales=ks, v_scales=vs)
        tma0 = paged_attention.launches_tma
        out = paged_attention(q, kp, vp, lengths, table, **kw)
        route = "tma" if paged_attention.launches_tma > tma0 else "simt"
        bit_equal = torch.equal(out, paged_attention(q, kp, vp, lengths,
                                                     table, **kw))
        # the plain version gathers each slot's pages; give it the pools as
        # they are (it dequantizes int8 itself) and q in fp32
        ref = paged_attention_plain(q.float(), kp, vp, lengths, table, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged {name}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        empty = lengths == 0
        zero_rows = bool((out[empty] == 0).all())
        replay_equal = None
        if route == "tma":
            replay_equal = graph_replay_equal(q, kp, vp, lengths, table, kw)
        ms = time_ms(lambda: paged_attention(q, kp, vp, lengths, table, **kw),
                     iters)
        plain_ms = time_ms(lambda: paged_attention_plain(
            q, kp, vp, lengths, table, **kw), max(1, iters // 4))
        library_ms = None
        if not quant:
            # one library call on the same data: attention over each slot's
            # gathered dense K/V (the gather is not timed)
            idx = table.long()
            dk = kp[:, idx].movedim(1, 0).reshape(B, Nkv, pps * P, Dh)
            dv = vp[:, idx].movedim(1, 0).reshape(B, Nkv, pps * P, Dh)
            live = (torch.arange(pps * P, device=dev)[None, :]
                    < lengths.clamp(min=1)[:, None])[:, None, None, :]
            sq = q[:, :, None, :]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                sq, dk, dv, attn_mask=live, scale=Dh ** -0.5,
                enable_gqa=Nq != Nkv), iters)
            del dk, dv
        tokens = int(lengths.sum().item())
        used_pages = int((-(-lengths // P)).sum().item())
        # live K and V rows (and their scales) once, q, out, lengths and the
        # table entries that name a live page
        row_bytes = 2 * Dh * kp.element_size() + (8 if quant else 0)
        bound_ms, bound_by = bound(
            tokens * Nkv * row_bytes + nbytes(q, out, lengths)
            + 4 * used_pages, 4 * Nq * Dh * tokens,
            "int8" if quant else ("bf16" if dtype == torch.bfloat16
                                  else "fp32"))
        log(f"  paged {name}: route {route}; max|dO| {err:.3e} (tol {tol}), "
            f"empty slots zero: {zero_rows}, two runs bit-equal: {bit_equal},"
            f" graph replay with new lengths equal: {replay_equal}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {tokens} live tokens in "
            f"{B} slots")
        if not (err <= tol and zero_rows and bit_equal):
            raise AssertionError(f"paged {name}: parity miss")
        if (route == "tma") != (q.dtype == torch.bfloat16):
            raise AssertionError(f"paged {name}: ran on the {route} route")
        if replay_equal is False:
            raise AssertionError(f"paged {name}: the graph replay with new "
                                 f"lengths differs from an eager call")
        del ref, pools, kp, vp
        torch.cuda.empty_cache()
        return {"case": name, "route": route, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "live_tokens": tokens}

    cpu = torch.Generator().manual_seed(1)
    lens = [1, 3136, 63, 64, 65, 1000, 2047, 0] + torch.randint(
        1, 3137, (24,), generator=cpu).tolist()
    # 8 slots as the serving smoke runs them
    lens8 = [3136, 2900, 2047, 1531, 1000, 640, 65, 1]
    results["paged_attention"] = [
        case("serve_bf16[32,16,128]x[8,28*441+1,64,128]", 32, 16, 8, 128, 64,
             28 * 441 + 1, lens, torch.bfloat16, False, PAGED_O_ATOL, 20),
        case("serve_bf16[8,16,128]x[8,28*441+1,64,128]", 8, 16, 8, 128, 64,
             28 * 441 + 1, lens8, torch.bfloat16, False, PAGED_O_ATOL, 20),
        # the MoE serving shape (qwen3-30b-a3b: 32 q heads over 4 kv heads)
        case("moe_serve_bf16[8,32,128]x[4,48*441+1,64,128]", 8, 32, 4, 128,
             64, 48 * 441 + 1, lens8, torch.bfloat16, False, PAGED_O_ATOL,
             20),
        case("small_fp32[8,4,64]x[4,2*40+1,16,64]", 8, 4, 4, 64, 16,
             2 * 40 + 1, [1, 17, 100, 0, 33, 64, 15, 128], torch.float32,
             False, PAGED_F32_ATOL, 50),
    ]
    results["paged_attention_int8"] = [
        case("serve_int8[32,16,128]x[8,28*221+1,128,128]", 32, 16, 8, 128,
             128, 28 * 221 + 1, lens, torch.bfloat16, True, PAGED_O_ATOL, 20),
        case("serve_int8[8,16,128]x[8,28*221+1,128,128]", 8, 16, 8, 128, 128,
             28 * 221 + 1, lens8, torch.bfloat16, True, PAGED_O_ATOL, 20),
        case("small_int8_fp32q[8,4,64]x[2,2*40+1,16,64]", 8, 4, 2, 64, 16,
             2 * 40 + 1, [1, 17, 100, 0, 33, 64, 15, 128], torch.float32,
             True, PAGED_F32_ATOL, 50),
    ]




def graph_replay_equal(q, kp, vp, lengths, table, kw) -> bool:
    """Capture one paged launch, change the lengths (rolled by one slot,
    one set to 0) and the page table (its slots reversed) in place on the
    device, replay, and compare with an eager call on the new data."""
    import torch

    from molly_tpu_torch.ops.paged_attention import paged_attention
    lengths, table = lengths.clone(), table.clone()
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention(q, kp, vp, lengths, table, **kw)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = paged_attention(q, kp, vp, lengths, table, **kw)
    new = lengths.roll(1)
    new[0] = 0
    lengths.copy_(new)
    table.copy_(table.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    eager = paged_attention(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    same = torch.equal(out, eager) and bool((out[0] == 0).all())
    del graph
    return same


def routed_group_sizes(g, tokens, hidden, experts, k, empty):
    """Group sizes [experts] int32 as ``moe_mlp`` makes them: a real
    ``router_topk`` over random activations and a random router, with
    expert ``empty`` forced to receive nothing (its pairs go to the next
    expert)."""
    import torch

    from molly_tpu_torch.ops.moe import router_topk
    x = torch.randn((tokens, hidden), generator=g, device="cuda").to(
        torch.bfloat16)
    router = 0.02 * torch.randn((hidden, experts), generator=g, device="cuda")
    flat = router_topk(x, router, k)[1].reshape(-1)
    flat = torch.where(flat == empty, (empty + 1) % experts, flat)
    counts = torch.zeros(experts, dtype=torch.int64, device="cuda")
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.to(torch.int32)


def grouped_replay_equal(call, gs) -> bool:
    """Capture one grouped-GEMM launch ``call(gs)``, change the group sizes
    in place on the device (the same rows over other experts with one of
    the old ones empty, then every row in one expert), replay, and compare
    each replay with an eager call on the new sizes, bit for bit."""
    import torch

    gs = gs.clone()
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(gs)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call(gs)
    G, owned = gs.shape[0], gs.sum()
    busiest = int(gs.argmax())
    moved = gs.roll(G // 3)
    moved[(busiest + G // 3 + 1) % G] += moved[busiest]
    moved[busiest] = 0
    one = torch.zeros_like(gs)
    one[G - 1] = owned
    same = True
    for sizes in (moved, one):
        gs.copy_(sizes)
        graph.replay()
        torch.cuda.synchronize()
        same &= torch.equal(out, call(gs))
    del graph
    return bool(same)


def parity_grouped_gemm(g, results):
    """The grouped-GEMM kernels (forward, transposed, int8, fp32, tgmm)
    against their plain versions at qwen3-30b-a3b width: 128 experts,
    top-8, hidden 2048, per-expert width 768, LoRA rank 64. Each forward
    case prints the source that ran (``grouped_gemm_tma.cu`` at prefill and
    training shapes over bf16 experts, ``grouped_gemm_int8_tma.cu`` there
    over int8 experts, ``grouped_gemm_f32_tc.cu`` for the fp32 adapters
    there, ``grouped_gemm_decode.cu`` at decode and serving shapes in bf16
    and int8, ``grouped_gemm.cu`` for the rest) and checks two runs
    bit-equal; the split-stream, int8 TMA and fp32 tensor-core cases also
    replay a captured launch after the group sizes change, which must equal
    an eager call bit for bit. Each tgmm case likewise, through the call
    the autograd backward makes (``_rhs_grad``): the adapters' gradients on
    ``grouped_gemm_f32_tc.cu``, the bf16 experts' on
    ``grouped_gemm_tma.cu``, an all-fp32 one on ``grouped_gemm.cu``. An
    int8 case prints, as a yardstick only, ``F.grouped_mm`` over the
    experts dequantized to bf16 beforehand (not the same function, so not
    its library time); an fp32 tensor-core case's bound counts its three
    split products (at the TF32 rate, or bf16 for the weight gradient's
    bf16 parts), and the SIMT rate's bound is printed beside it."""
    import torch
    import torch.nn.functional as F

    from molly_tpu_torch.ops.grouped_gemm import (_bounds, _rhs_grad,
                                                  grouped_gemm,
                                                  grouped_gemm_plain,
                                                  grouped_gemm_tgmm,
                                                  grouped_gemm_tgmm_plain)
    dev = "cuda"
    E, TOPK, H = 128, 8, 2048
    grouped_mm = getattr(F, "grouped_mm", None) or getattr(
        torch, "_grouped_mm", None)

    def library(name, fn):
        """Time the one PyTorch call; None where it refuses the operands."""
        if grouped_mm is None:
            return None
        try:
            fn()
            torch.cuda.synchronize()
        except Exception as exc:  # the yardstick's refusal, not the port's
            log(f"  grouped {name}: the library call refused these "
                f"operands ({type(exc).__name__}: {str(exc)[:120]})")
            return None
        return fn

    def report(name, err, tol, ms, plain_ms, library_ms, bound_ms, bound_by,
               extra, source):
        extra = f"{extra}; {source.rsplit('/', 1)[1]}"
        log(f"  grouped {name}: max|err| {err:.3e} (tol {tol:.3e}); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {extra}")
        if not err <= tol:
            raise AssertionError(f"grouped {name}: parity miss")
        return {"case": name, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "source": source}

    def ep_buffer(gen, tokens, G=E // 2, k=TOPK, factor=2.0):
        """(group sizes [G], rows C) of expert rank 0 of an expert=2 mesh
        as ``moe_mlp_expert_sharded`` makes them: ``tokens`` routed by a
        real ``router_topk`` over all E experts, local expert G // 2 forced
        empty, the local pairs counted into a buffer of C = min(ceil(
        tokens * k * factor / 2), tokens * k) rows; rows past sum(sizes)
        are empty."""
        from molly_tpu_torch.ops.moe import router_topk
        x = torch.randn((tokens, H), generator=gen, device=dev).to(
            torch.bfloat16)
        router = 0.02 * torch.randn((H, E), generator=gen, device=dev)
        flat = router_topk(x, router, k)[1].reshape(-1)
        flat = torch.where(flat == G // 2, G // 2 + 1, flat)
        C = int(min(math.ceil(tokens * k * factor / 2), tokens * k))
        counts = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, flat.clamp(max=G), torch.ones_like(flat))
        cum = torch.cumsum(counts[:G], 0).clamp(max=C)
        return torch.diff(cum, prepend=cum.new_zeros(1)).to(torch.int32), C

    def operand(gen, M, cols, live, dt):
        """[M, cols] random rows; under a capacity buffer the rows past
        ``live`` hold garbage of 1e3, which must reach no result."""
        t = torch.randn((M, cols), generator=gen, device=dev)
        if live < M:
            t[live:] *= 1e3
        return t.to(dt)

    def fwd_case(name, tokens, K, N, iters, lhs_dt=torch.bfloat16,
                 rhs_dt=torch.bfloat16, out_dt=torch.float32,
                 transpose_rhs=False, G=E, k=TOPK, ep=None):
        gen = g if ep is None else ep
        if ep is None:
            M = tokens * k
            gs = routed_group_sizes(g, tokens, H, G, k, empty=G // 2)
        else:  # the EP capacity buffer over E // 2 local experts
            G = E // 2
            gs, M = ep_buffer(ep, tokens, G, k)
        live = int(gs.sum())
        bounds = _bounds(gs, M)
        active = sum(1 for a, b in bounds if b > a)
        lhs = operand(gen, M, K, live, lhs_dt)
        shape = (G, N, K) if transpose_rhs else (G, K, N)
        scale = None
        if rhs_dt == torch.int8:
            rhs = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8)
            if not transpose_rhs:  # transposed: the caller scales dout
                scale = (torch.rand((G, N), generator=gen, device=dev)
                         * 1e-3 + 1e-4) * K ** -0.5
        else:
            rhs = torch.empty(shape, device=dev, dtype=rhs_dt)
            for e in range(G):  # in slices: bounds the fp32 scratch
                rhs[e] = (torch.randn(shape[1:], generator=gen, device=dev)
                          * K ** -0.5).to(rhs_dt)
        kw = dict(transpose_rhs=transpose_rhs, scale=scale)
        c = grouped_gemm
        c0 = (c.launches_tma, c.launches_int8_tma, c.launches_tc,
              c.launches_stream)
        out = grouped_gemm(lhs, rhs, gs, out_dtype=out_dt, **kw)
        moved = [a > b for a, b in zip(
            (c.launches_tma, c.launches_int8_tma, c.launches_tc,
             c.launches_stream), c0)]
        source = ([_GG_TMA_CU, _GG_INT8_TMA_CU, _GG_TC_CU, _GG_STREAM_CU]
                  [moved.index(True)] if any(moved) else _GG_CU)
        bit_equal = torch.equal(out, grouped_gemm(lhs, rhs, gs,
                                                  out_dtype=out_dt, **kw))
        replay_equal = None
        if source in (_GG_STREAM_CU, _GG_INT8_TMA_CU, _GG_TC_CU):
            replay_equal = grouped_replay_equal(
                lambda sizes: grouped_gemm(lhs, rhs, sizes, out_dtype=out_dt,
                                           **kw), gs)
        ref = grouped_gemm_plain(lhs, rhs, gs, bounds=bounds, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"grouped {name}: non-finite output")
        if not bool((out[live:] == 0).all()):
            raise AssertionError(f"grouped {name}: a row past sum(sizes) "
                                 f"is not zero")
        if not bit_equal or replay_equal is False:
            raise AssertionError(f"grouped {name}: two runs bit-equal "
                                 f"{bit_equal}, graph replay with new group "
                                 f"sizes equal {replay_equal}")
        err = (out.float() - ref).abs().max().item()
        # a bf16 operand or result rounds; a bf16 lhs over fp32 weights is
        # widened exactly, an int8 rhs with an fp32 lhs runs in fp32
        rounded = (rhs_dt == torch.bfloat16 or out_dt == torch.bfloat16 or
                   (lhs_dt == torch.bfloat16 and rhs_dt != torch.float32))
        tol = (GG_BF16_REL if rounded else GG_F32_REL) * \
            ref.abs().max().item()
        del ref
        ms = time_ms(lambda: grouped_gemm(lhs, rhs, gs, out_dtype=out_dt,
                                          **kw), iters)
        plain_ms = time_ms(lambda: grouped_gemm_plain(
            lhs, rhs, gs, bounds=bounds, **kw), max(1, iters // 4))
        library_ms = None
        if rhs_dt == torch.bfloat16:
            offs = torch.cumsum(gs, 0).to(torch.int32)
            a16 = lhs.to(torch.bfloat16)
            b = rhs.transpose(1, 2) if transpose_rhs else rhs
            call = library(name, lambda: grouped_mm(a16, b, offs=offs))
            if call is not None:
                library_ms = time_ms(call, iters)
        yardstick_ms = None
        if rhs_dt == torch.int8 and grouped_mm is not None:
            offs = torch.cumsum(gs, 0).to(torch.int32)
            a16 = lhs.to(torch.bfloat16)
            dense = torch.empty(shape, device=dev, dtype=torch.bfloat16)
            for e in range(G):  # in slices: bounds the fp32 scratch
                dense[e] = (rhs[e].float() * (1.0 if scale is None else
                                              scale[e])).to(torch.bfloat16)
            b = dense.transpose(1, 2) if transpose_rhs else dense
            call = library(name, lambda: grouped_mm(a16, b, offs=offs))
            if call is not None:
                yardstick_ms = time_ms(call, iters)
                log(f"  grouped {name}: yardstick, not the same function: "
                    f"F.grouped_mm over the experts dequantized to bf16 "
                    f"beforehand {yardstick_ms:.4f} ms")
            del dense, b, a16
        # the live lhs rows once, only the ACTIVE groups' weights (and
        # scales) once, the sizes, out once (its empty rows too)
        w_bytes = active * K * N * rhs.element_size() + (
            active * N * 4 if scale is not None else 0)
        io_bytes = (live * K * lhs.element_size() + nbytes(gs, out)
                    + w_bytes)
        if source == _GG_TC_CU:  # three split products at the TF32 rate
            bound_ms, bound_by = bound(io_bytes, 3 * 2 * live * K * N,
                                       "tf32")
            log(f"  grouped {name}: bound at the SIMT fp32 rate "
                f"(67 TFLOP/s) "
                f"{bound(io_bytes, 2 * live * K * N, 'fp32')[0]:.4f} ms")
        else:
            bound_ms, bound_by = bound(io_bytes, 2 * live * K * N,
                                       "bf16" if rounded else "fp32")
        res = report(name, err, tol, ms, plain_ms, library_ms, bound_ms,
                     bound_by, f"{M} rows over {active} of {G} groups, "
                     + (f"{live} live, the {M - live} past them exactly "
                        f"zero, " if live < M else "")
                     + f"largest {int(gs.max())}, two runs bit-equal"
                     + ("" if replay_equal is None else
                        ", graph replay with new group sizes equal"), source)
        if yardstick_ms is not None:
            res["grouped_mm_bf16_yardstick_ms"] = yardstick_ms
        return res

    def tgmm_case(name, tokens, K, N, iters, lhs_dt=torch.bfloat16,
                  dout_dt=torch.float32, out_dt=torch.bfloat16, G=E, k=TOPK,
                  ep=None):
        gen = g if ep is None else ep
        if ep is None:
            M = tokens * k
            gs = routed_group_sizes(g, tokens, H, G, k, empty=G // 2)
        else:  # the EP capacity buffer over E // 2 local experts
            G = E // 2
            gs, M = ep_buffer(ep, tokens, G, k)
        live = int(gs.sum())
        bounds = _bounds(gs, M)
        lhs = operand(gen, M, K, live, lhs_dt)
        dout = operand(gen, M, N, live, dout_dt)

        def call(sizes):
            """The call the autograd backward makes for this gradient."""
            return _rhs_grad(lhs, dout, sizes, False, out_dt)

        c = grouped_gemm_tgmm
        c0 = (c.launches_tma, c.launches_tc)
        out = call(gs)
        source = (_GG_TMA_CU if c.launches_tma > c0[0] else
                  _GG_TC_CU if c.launches_tc > c0[1] else _GG_CU)
        again = call(gs)
        replay_equal = (grouped_replay_equal(call, gs)
                        if source == _GG_TC_CU else None)
        ref = grouped_gemm_tgmm_plain(lhs, dout, gs, torch.float32,
                                      bounds=bounds)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        # an fp32 result of an fp32 operand is an fp32 product (a bf16 lhs
        # is exact); anything else is a bf16 product
        f32 = out_dt == torch.float32 and torch.float32 in (lhs_dt, dout_dt)
        tol = (GG_F32_REL if f32 else GG_BF16_REL) * ref.abs().max().item()
        del ref
        if not torch.equal(out, again) or replay_equal is False:
            raise AssertionError(f"grouped {name}: two runs bit-equal "
                                 f"{torch.equal(out, again)}, graph replay "
                                 f"with new group sizes equal {replay_equal}")
        if bool(out[gs == 0].any()):
            raise AssertionError(f"grouped {name}: an empty group's "
                                 f"gradient is not zero")
        ms = time_ms(lambda: call(gs), iters)
        plain_ms = time_ms(lambda: grouped_gemm_tgmm_plain(
            lhs, dout, gs, torch.float32, bounds=bounds), max(1, iters // 4))
        library_ms = None
        if not f32:
            offs = torch.cumsum(gs, 0).to(torch.int32)
            at, d16 = lhs.to(torch.bfloat16).t(), dout.to(torch.bfloat16)
            call16 = library(name, lambda: grouped_mm(at, d16, offs=offs))
            if call16 is not None:
                library_ms = time_ms(call16, iters)
        # the live rows of lhs and dout once, the sizes, out once
        io_bytes = (live * (K * lhs.element_size() + N * dout.element_size())
                    + nbytes(gs, out))
        if source == _GG_TC_CU:  # three split products at the bf16 rate
            bound_ms, bound_by = bound(io_bytes, 3 * 2 * live * K * N,
                                       "bf16")
            log(f"  grouped {name}: bound at the SIMT fp32 rate "
                f"(67 TFLOP/s) "
                f"{bound(io_bytes, 2 * live * K * N, 'fp32')[0]:.4f} ms")
        else:
            bound_ms, bound_by = bound(io_bytes, 2 * live * K * N,
                                       "fp32" if f32 else "bf16")
        return report(name, err, tol, ms, plain_ms, library_ms, bound_ms,
                      bound_by, f"{M} rows"
                      + (f" ({live} live, garbage past them)"
                         if live < M else "")
                      + f", largest group {int(gs.max())}, "
                      f"{int((gs == 0).sum())} empty groups exact zero, two "
                      f"runs bit-equal"
                      + ("" if replay_equal is None else
                         ", graph replay with new group sizes equal"),
                      source)

    i8, f32, b16 = torch.int8, torch.float32, torch.bfloat16
    results["grouped_gemm"] = [
        fwd_case("prefill_gate_bf16[98304,2048]x[128,2048,768]", 12288, 2048,
                 768, 4),
        fwd_case("prefill_down_bf16[98304,768]x[128,768,2048]", 12288, 768,
                 2048, 4),
        fwd_case("decode_gate_bf16[32,2048]x[128,2048,768]", 4, 2048, 768,
                 20),
        fwd_case("serving_gate_bf16[64,2048]x[128,2048,768]", 8, 2048, 768,
                 20),
        fwd_case("decode_down_bf16[32,768]x[128,768,2048]", 4, 768, 2048,
                 20),
        fwd_case("decode_gateup_int8[32,2048]x[128,2048,1536]", 4, 2048,
                 1536, 20, rhs_dt=i8),
        fwd_case("decode_down_int8[32,768]x[128,768,2048]", 4, 768, 2048,
                 20, rhs_dt=i8),
        fwd_case("serving_gateup_int8[64,2048]x[128,2048,1536]", 8, 2048,
                 1536, 20, rhs_dt=i8),
        fwd_case("prefill_gateup_int8[98304,2048]x[128,2048,1536]", 12288,
                 2048, 1536, 4, rhs_dt=i8),
        fwd_case("prefill_down_int8[98304,768]x[128,768,2048]", 12288, 768,
                 2048, 4, rhs_dt=i8),
        fwd_case("train_dlhs_f32xbf16T[32768,768]x[128,2048,768]T->bf16",
                 4096, 768, 2048, 4, lhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("train_gate_bf16[32768,2048]x[128,2048,768]", 4096, 2048,
                 768, 4),
        fwd_case("train_dlhs_down_f32xbf16T[32768,2048]x[128,768,2048]T"
                 "->bf16", 4096, 2048, 768, 4, lhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        # the MoE QLoRA step: the int8 base's forward and lhs gradients (the
        # fp32 lhs rounded to bf16 once before the launch)
        fwd_case("qlora_gate_int8[32768,2048]x[128,2048,768]", 4096, 2048,
                 768, 4, rhs_dt=i8),
        fwd_case("qlora_down_int8[32768,768]x[128,768,2048]", 4096, 768,
                 2048, 4, rhs_dt=i8),
        fwd_case("qlora_dlhs_f32xint8T[32768,768]x[128,2048,768]T->bf16",
                 4096, 768, 2048, 4, lhs_dt=f32, rhs_dt=i8, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("qlora_dlhs_down_f32xint8T[32768,2048]x[128,768,2048]T"
                 "->bf16", 4096, 2048, 768, 4, lhs_dt=f32, rhs_dt=i8,
                 out_dt=b16, transpose_rhs=True),
        # ... and its expert adapters (rank 64): A and B of the gate / up
        # (K, N 2048 / 768) and of the down projection, their lhs gradients
        fwd_case("lora_a_bf16xfp32[32768,2048]x[128,2048,64]", 4096, 2048,
                 64, 4, rhs_dt=f32),
        fwd_case("lora_a_down_bf16xfp32[32768,768]x[128,768,64]", 4096, 768,
                 64, 4, rhs_dt=f32),
        fwd_case("lora_b_bf16xfp32[32768,64]x[128,64,768]", 4096, 64, 768, 4,
                 rhs_dt=f32),
        fwd_case("lora_b_down_bf16xfp32[32768,64]x[128,64,2048]", 4096, 64,
                 2048, 4, rhs_dt=f32),
        fwd_case("lora_dlhs_b_fp32T[32768,768]x[128,64,768]T->bf16", 4096,
                 768, 64, 4, lhs_dt=f32, rhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("lora_dlhs_b_down_fp32T[32768,2048]x[128,64,2048]T->bf16",
                 4096, 2048, 64, 4, lhs_dt=f32, rhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("lora_dlhs_a_fp32T[32768,64]x[128,2048,64]T->bf16", 4096,
                 64, 2048, 4, lhs_dt=f32, rhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("lora_dlhs_a_down_fp32T[32768,64]x[128,768,64]T->bf16",
                 4096, 64, 768, 4, lhs_dt=f32, rhs_dt=f32, out_dt=b16,
                 transpose_rhs=True),
        fwd_case("small_fp32[300,64]x[4,64,128]", 150, 64, 128, 20,
                 lhs_dt=f32, rhs_dt=f32, G=4, k=2),
    ]
    # phase 19d (expert=2): rank 0's capacity buffer over its 64 local
    # experts, one of them empty, rows past sum(sizes) garbage (from a
    # generator of their own: the cases above keep their inputs): prefill
    # and decode of the generation, the full fine-tune's products and lhs
    # gradient, the expert QLoRA's int8 base and an adapter
    p19 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 19)
    results["grouped_gemm"] += [
        fwd_case("ep_prefill_gate_bf16[98304,2048]x[64,2048,768]", 12288,
                 2048, 768, 4, ep=p19),
        fwd_case("ep_decode_gate_bf16[32,2048]x[64,2048,768]", 4, 2048, 768,
                 20, ep=p19),
        fwd_case("ep_decode_down_bf16[32,768]x[64,768,2048]", 4, 768, 2048,
                 20, ep=p19),
        fwd_case("ep_train_gate_bf16[32768,2048]x[64,2048,768]", 4096, 2048,
                 768, 4, ep=p19),
        fwd_case("ep_train_down_bf16[32768,768]x[64,768,2048]", 4096, 768,
                 2048, 4, ep=p19),
        fwd_case("ep_train_dlhs_f32xbf16T[32768,768]x[64,2048,768]T->bf16",
                 4096, 768, 2048, 4, lhs_dt=f32, out_dt=b16,
                 transpose_rhs=True, ep=p19),
        fwd_case("ep_qlora_gate_int8[32768,2048]x[64,2048,768]", 4096, 2048,
                 768, 4, rhs_dt=i8, ep=p19),
        fwd_case("ep_qlora_dlhs_f32xint8T[32768,768]x[64,2048,768]T->bf16",
                 4096, 768, 2048, 4, lhs_dt=f32, rhs_dt=i8, out_dt=b16,
                 transpose_rhs=True, ep=p19),
        fwd_case("ep_lora_a_bf16xfp32[32768,2048]x[64,2048,64]", 4096, 2048,
                 64, 4, rhs_dt=f32, ep=p19),
    ]
    for case in results["grouped_gemm"]:
        name = case["case"].removeprefix("ep_")
        expected = (_GG_STREAM_CU if name.startswith(("decode_", "serving_"))
                    else _GG_CU if name.startswith("small_")
                    else _GG_INT8_TMA_CU if "int8" in name
                    else _GG_TC_CU if name.startswith("lora_")
                    else _GG_TMA_CU)
        if case["source"] != expected:
            raise AssertionError(f"grouped {name}: ran from "
                                 f"{case['source']}, expected {expected}")
    results["grouped_gemm_tgmm"] = [
        # the MoE QLoRA step's expert-adapter weight gradients (rank 64), as
        # its backward makes them: a bf16 lhs (the activations xs, h, or the
        # rank-64 intermediate) and an fp32 dout into fp32; LoRA A and B of
        # the gate / up (K, N 2048 / 768) and of the down projection
        tgmm_case("lora_a_bf16xf32[2048,32768].[32768,64]", 4096, 2048, 64,
                  4, out_dt=f32),
        tgmm_case("train_bf16xf32[2048,32768].[32768,768]->[128,2048,768]",
                  4096, 2048, 768, 4),
        tgmm_case("train_down_bf16xf32[768,32768].[32768,2048]", 4096, 768,
                  2048, 4),
        tgmm_case("train_bf16xbf16[2048,32768].[32768,768]->[128,2048,768]",
                  4096, 2048, 768, 4, dout_dt=b16),
        tgmm_case("train_down_bf16xbf16[768,32768].[32768,2048]", 4096, 768,
                  2048, 4, dout_dt=b16),
        tgmm_case("small_fp32[64,300].[300,128]->[4,64,128]", 150, 64, 128,
                  20, lhs_dt=f32, out_dt=f32, G=4, k=2),
        tgmm_case("lora_a_down_bf16xf32[768,32768].[32768,64]", 4096, 768,
                  64, 4, out_dt=f32),
        tgmm_case("lora_b_bf16xf32[64,32768].[32768,768]", 4096, 64, 768, 4,
                  out_dt=f32),
        tgmm_case("lora_b_down_bf16xf32[64,32768].[32768,2048]", 4096, 64,
                  2048, 4, out_dt=f32),
        # phase 19d: the weight gradients over rank 0's capacity buffer
        tgmm_case("ep_train_bf16xf32[2048,32768].[32768,768]->[64,2048,768]",
                  4096, 2048, 768, 4, ep=p19),
        tgmm_case("ep_train_down_bf16xf32[768,32768].[32768,2048]", 4096,
                  768, 2048, 4, ep=p19),
        tgmm_case("ep_lora_a_bf16xf32[2048,32768].[32768,64]", 4096, 2048,
                  64, 4, out_dt=f32, ep=p19),
    ]
    for case in results["grouped_gemm_tgmm"]:
        name = case["case"].removeprefix("ep_")
        expected = (_GG_TC_CU if name.startswith("lora_") else
                    _GG_CU if name.startswith("small_") else _GG_TMA_CU)
        if case["source"] != expected:
            raise AssertionError(f"grouped {name}: ran from "
                                 f"{case['source']}, expected {expected}")


# ---------------------------------------------------------------------------
# small reference and main path
# ---------------------------------------------------------------------------


def small_config(moe: bool = False):
    """A small fp32 fusion model with head dims the kernels take; ``moe``:
    its decoder is ``tiny_moe`` (4 experts, top-2) at the same widths."""
    from molly_tpu_torch.models import (FusionConfig, tiny_esm, tiny_moe,
                                        tiny_qwen3)
    return FusionConfig(
        text=(tiny_moe if moe else tiny_qwen3)(
            vocab_size=384, hidden_size=256, intermediate_size=512,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64),
        dna_rna=tiny_esm(vocab_size=4107, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2,
                         mask_token_id=2, mlp_type="swiglu", mlp_bias=False),
        protein=tiny_esm(vocab_size=33, hidden_size=128,
                         intermediate_size=256, num_attention_heads=2),
        dna_rna_k_tokens=16, protein_k_tokens=16)


def small_reference(seed: int, moe: bool = False):
    """The small model on the card (through the kernels) against the same
    weights on the CPU (plain versions): logits and greedy tokens, in the
    model dtype and after ``quantize_for_decode`` (an MoE decoder's expert
    stacks quantized and fused with it)."""
    import torch

    from molly_tpu_torch.inference.engine import generate
    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config(moe)
    cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
    gpu = tree_to(cpu, "cuda")
    g = torch.Generator().manual_seed(seed + 1)
    B, S = 3, 96
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, :20] = 0
    mask[2, :70] = 0
    batch = {
        "input_ids": torch.randint(0, 384, (B, S), generator=g),
        "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75]]),
    }
    out = {}
    with torch.inference_mode():
        for name, p in (("plain", cpu), ("kernels", gpu)):
            dev = "cpu" if name == "plain" else "cuda"
            b = {k: t.to(dev) for k, t in batch.items()}
            for tag, params in (("", p), ("_int8", {
                    **p, "text": qwen3.quantize_for_decode(
                        p["text"], cfg.text, moe_experts=moe)})):
                logits = fusion.forward_logits(params, cfg, b)
                toks = generate(params, cfg, b, GenerationConfig(
                    max_new_tokens=8, do_sample=False, eos_token_id=-1))
                out[name + tag] = (logits.float().cpu(), toks.cpu())
    errs = {}
    for tag in ("", "_int8"):
        lp, tp = out["plain" + tag]
        lk, tk = out["kernels" + tag]
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"small reference{tag}: non-finite logits")
        valid = mask.bool()[:, :, None]
        err = ((lk - lp).abs() * valid).max().item()
        errs[tag or "_bf"] = err
        log(f"  small{' MoE' if moe else ''} reference{tag or ''}: "
            f"max|dlogits| {err:.3e} "
            f"(tol {SMALL_LOGIT_ATOL}); greedy tokens equal: "
            f"{bool(torch.equal(tk, tp))}")
        if err > SMALL_LOGIT_ATOL or not torch.equal(tk, tp):
            raise AssertionError(f"small reference{tag}: kernels disagree "
                                 f"with the plain path")
    return errs


def small_reference_serving(seed: int, moe: bool = False):
    """(``moe``: the MoE decoder through the paged engine over fp32 pages
    only.) The small model through both serving engines on the card (through
    the kernels: flash prefill behind a shared prefix, RMSNorm, the paged
    kernel over fp32 and int8 pages) against the same engines on the CPU
    (plain versions): greedy tokens, the scheduler's counters, and every
    page back on the free list after a run that had to preempt."""
    import numpy as np
    import torch

    from molly_tpu_torch.inference.paged import PagedServingEngine
    from molly_tpu_torch.inference.server import Request, ServingEngine
    from molly_tpu_torch.models import GenerationConfig, fusion
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config(moe)
    cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
    gpu = tree_to(cpu, "cuda")
    rng = np.random.default_rng(seed + 3)
    prefix = rng.integers(1, 384, 20).astype(np.int32)  # one page + 4 tokens
    batches = []
    for i, n in enumerate((9, 40, 17, 44, 25)):
        ids = np.concatenate(
            [prefix, rng.integers(1, 384, n).astype(np.int32)])[None]
        batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
        if n >= 40:  # tri-modal prompts among text-only ones
            batch.update(
                dna_rna_tokens=rng.integers(6, 4102, (1, 1, 16)).astype(
                    np.int32),
                dna_rna_pos=np.asarray([[21 + i]], np.int32),
                protein_tokens=rng.integers(4, 24, (1, 1, 16)).astype(
                    np.int32),
                protein_pos=np.asarray([[40 + i]], np.int32))
        batches.append(batch)

    def requests():
        return [Request(uid=i, batch=dict(b)) for i, b in enumerate(batches)]

    gen = GenerationConfig(max_new_tokens=24, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    common = dict(n_slots=3, prefill_buckets=(64,), decode_chunk=4,
                  admit_batch=2, prefix_ids=prefix)
    paged = dict(page_size=16, n_pages=10, **common)
    engines = {
        "dense ring": (ServingEngine, dict(max_len=128, **common)),
        "paged, fp32 pages": (PagedServingEngine, paged),
        "paged, int8 pages": (PagedServingEngine,
                              dict(kv_quant="int8", **paged)),
    }
    if moe:
        engines = {"MoE, paged, fp32 pages": engines["paged, fp32 pages"]}
    for name, (cls, kw) in engines.items():
        runs = {}
        for where, params in (("cpu", cpu), ("card", gpu)):
            eng = cls(params, cfg, gen, **kw)
            runs[where] = (eng.run(requests()), eng)
        (ref, ceng), (got, geng) = runs["cpu"], runs["card"]
        flips = sum(int(np.sum(got[u] != ref[u])) for u in ref)
        firsts = all(got[u][0] == ref[u][0] for u in ref)
        allowed = SERVE_INT8_FLIPS if "int8" in name else 0
        stats = {k: v for k, v in geng.stats.items() if k != "fetch_wait_s"}
        log(f"  small serving reference, {name}: {len(got)} requests, "
            f"{flips} greedy tokens differ from the CPU (allowed {allowed}), "
            f"first tokens equal: {firsts}; {stats}")
        if set(got) != set(ref) or flips > allowed or not firsts or any(
                len(got[u]) != 24 for u in got):
            raise AssertionError(f"small serving reference, {name}: the card "
                                 f"disagrees with the CPU")
        if cls is PagedServingEngine:
            if geng.stats["preemptions"] < 1:
                raise AssertionError(f"small serving reference, {name}: the "
                                     f"pool was never exhausted")
            if len(geng._free_pages) != geng.n_pages - geng._n_shared or \
                    any(geng._slot_pages):
                raise AssertionError(f"small serving reference, {name}: "
                                     f"pages were not returned")


def small_reference_training(seed: int, moe: bool = False):
    """The small model's train step on the card (through the kernels)
    against the same step on the CPU (plain versions): loss and every
    trainable gradient for a full fine-tune step and a LoRA step (``moe``:
    router and expert stacks among the leaves, adapters on the expert
    stacks, and the load-balance term); then five steps on one repeated
    batch at lr 1e-3 must lower the loss."""
    import torch

    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.models.lora import LoraConfig
    from molly_tpu_torch.training.trainer import (TrainConfig, attach_lora,
                                                  init_train_state,
                                                  make_grad_fn,
                                                  make_train_step,
                                                  trainable_paths)
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config(moe)
    g = torch.Generator().manual_seed(seed + 2)
    B, S = 4, 96
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, 80:] = 0   # training batches are right-padded
    mask[3, 50:] = 0
    ids = torch.randint(0, 384, (B, S), generator=g)
    labels = torch.where(mask.bool(), ids, -100)
    labels[:, :30] = -100
    batch = {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1], [5, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75], [25]]),
        "task_label": torch.tensor([0, 3, 100, 7]),
    }
    gpu_batch = {k: t.cuda() for k, t in batch.items()}
    regimes = {
        "full fine-tune": TrainConfig(learning_rate=1e-3, total_steps=5,
                                      warmup_ratio=0.0, schedule="constant"),
        "LoRA": TrainConfig(learning_rate=1e-3, total_steps=5,
                            warmup_ratio=0.0, schedule="constant",
                            lora=LoraConfig(r=8, alpha=16.0, dropout=0.0)),
    }
    for name, tc in regimes.items():
        cpu = fusion.init_params(cfg, torch.Generator().manual_seed(seed))
        if tc.lora is not None:
            cpu = attach_lora(cpu, cfg, tc.lora,
                              torch.Generator().manual_seed(seed + 1))
            for ab in cpu["lora"]["layers"].values():  # B starts at zero:
                ab["b"].normal_(0.0, 0.02, generator=g)  # give A a gradient
        gpu = tree_to(cpu, "cuda")
        init_train_state(cpu, tc)
        state = init_train_state(gpu, tc)
        grad_fn = make_grad_fn(cfg, tc)
        gc, mc = grad_fn(cpu, batch)
        gg, mg = grad_fn(gpu, gpu_batch)
        dloss = abs(float(mc["loss"]) - float(mg["loss"]))
        if moe:
            name = "MoE " + name
            dloss = max(dloss, abs(float(mc["moe_load_balance"])
                                   - float(mg["moe_load_balance"])))
            paths = trainable_paths(gpu, tc)
            if not any("expert_" in p for p in paths):
                raise AssertionError(f"{name}: no expert leaf trains")
        worst = 0.0
        for a, b in zip(gc, gg):
            ref = a.abs().max().item()
            rel = (a - b.cpu()).abs().max().item() / max(ref, 1e-12)
            worst = max(worst, rel)
        log(f"  small training reference, {name}: |dloss| {dloss:.3e} (tol "
            f"{TRAIN_LOSS_ATOL}), worst gradient error {worst:.3e} of its "
            f"max (tol {TRAIN_GRAD_REL}) over {len(gc)} leaves")
        if not (dloss <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_REL):
            raise AssertionError(f"small training reference, {name}: the "
                                 f"card disagrees with the CPU")
        if tc.lora is None:
            step = make_train_step(cfg, tc)
            losses = []
            for _ in range(5):
                state, m = step(state, gpu_batch, None)
                losses.append(float(m["loss"]))
            log(f"  small training reference: five steps on one batch, loss "
                f"{' -> '.join(f'{x:.4f}' for x in losses)}")
            if not losses[-1] < losses[0]:
                raise AssertionError("small training reference: the loss "
                                     "did not fall")


def make_requests(seed: int):
    """Four prompts (DNA, protein, RNA + protein, two DNA segments) with
    inline <dna>/<rna>/<protein> tags."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def dna(n):
        return "".join(rng.choice(list("ACGT"), n))

    def protein(n):
        return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))

    return [
        {"task": "pd-prom_300", "kind": "DNA",
         "input": f"Is this a promoter? <dna>{dna(4000)}</dna> "
                  "Answer yes or no.", "output": "yes", "label": "1"},
        {"task": "Solubility-Solubility", "kind": "Protein",
         "input": f"Predict the solubility of <protein>{protein(600)}"
                  "</protein>.", "output": "soluble", "label": "1"},
        {"task": "rna_protein_interaction", "kind": "Multi",
         "input": f"Does <rna>{dna(2500)}</rna> bind <protein>"
                  f"{protein(400)}</protein>?", "output": "no", "label": "0"},
        {"task": "promoter_enhancer_interaction", "kind": "DNA",
         "input": f"Promoter <dna>{dna(1500)}</dna> and enhancer "
                  f"<dna>{dna(1800)}</dna>: do they interact?",
         "output": "yes", "label": "1"},
    ]


def main_path(params, cfg, samples, text_tok, gen, seed, label,
              records_out=None):
    """Drive the batch CLI's ``run_batches`` once; returns the run's launch
    counts (and appends its JSONL records to ``records_out``)."""
    import torch

    from molly_tpu_torch.inference.cli import run_batches

    stats = {}
    buf = io.StringIO()
    reset_counts()
    records = run_batches(samples, params, cfg, gen, text_tok, buf,
                          batch_size=4,
                          generator=torch.Generator("cuda").manual_seed(seed),
                          total=len(samples), stats=stats)
    counts = read_counts()
    check_flash_tma(label)
    check_paged_tma(label)
    check_int8_tma(label)
    lines = buf.getvalue().splitlines()
    steps = stats.get("decode_steps", 0)
    log(f"  {label}: encoders {stats['encode_s']:.3f} s, prefill "
        f"{stats['prefill_s']:.3f} s, decode {steps} steps in "
        f"{stats['decode_s']:.3f} s = "
        f"{len(samples) * steps / max(stats['decode_s'], 1e-9):.1f} tok/s "
        f"(batch {len(samples)}); launches {counts}")
    log(f"  {label}: first record: {lines[0][:300]}")
    if len(records) != len(samples) or not stats.get("logits_finite"):
        raise AssertionError(f"{label}: bad output (records "
                             f"{len(records)}, finite "
                             f"{stats.get('logits_finite')})")
    for line in lines:
        rec = json.loads(line)
        assert set(rec) == {"decoded_output", "input", "gt_output",
                            "gt_label", "task", "kind"}, rec.keys()
    if records_out is not None:
        records_out.extend(records)
    return counts


def serve_main_path(params, cfg, samples, text_tok, gen, seed, label,
                    prefix_ids, n_slots, **serve_kw):
    """Drive the CLI's ``run_serve`` once; returns the run's launch
    counts."""
    import torch

    from molly_tpu_torch.inference.cli import run_serve

    stats = {}
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    records = run_serve(
        samples, params, cfg, gen, text_tok, buf, n_slots=n_slots,
        max_length=3072, prefix_ids=prefix_ids, decode_chunk=16,
        admit_batch=4, generator=torch.Generator("cuda").manual_seed(seed),
        stats=stats, **serve_kw)
    counts = read_counts()
    check_flash_tma(label)
    check_paged_tma(label)
    check_int8_tma(label)
    lines = buf.getvalue().splitlines()
    dispatches = (stats["decode_dispatches"] + stats["fused_dispatches"]
                  + stats["prefill_dispatches"])
    pages = (f", pages peak {stats['pages_peak']} of {stats['n_pages']} "
             f"({stats['n_shared_pages']} shared), preemptions "
             f"{stats['preemptions']}, stalls {stats['stalls']}"
             if "pages_peak" in stats else "")
    log(f"  {label}: {len(records)} requests done in {stats['rounds']} "
        f"rounds, {dispatches} dispatches ({stats['prefill_rows']} rows "
        f"prefilled); prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_s']:.3f} s, scheduler {stats['host_s']:.3f} s; "
        f"{stats['tokens_out']} tokens = "
        f"{stats['tokens_out'] / max(stats['decode_s'], 1e-9):.1f} tok/s of "
        f"decode time ({n_slots} slots){pages}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{counts}")
    log(f"  {label}: first record: {lines[0][:300]}")
    if len(records) != len(samples) or not stats["logprobs_finite"]:
        raise AssertionError(f"{label}: bad output (records {len(records)} "
                             f"of {len(samples)}, finite log-probabilities "
                             f"{stats['logprobs_finite']})")
    if "free_pages" in stats and stats["free_pages"] != (
            stats["n_pages"] - stats["n_shared_pages"]):
        raise AssertionError(f"{label}: pages were not returned ({stats})")
    for line in lines:
        rec = json.loads(line)
        assert set(rec) == {"decoded_output", "input", "gt_output",
                            "gt_label", "task", "kind"}, rec.keys()
    return counts


# label -> {"peak_gib", "step_s"} of each train_main_path run (steps 2-3)
TRAIN_RUNS = {}


def train_main_path(params, cfg, samples, tc, label, seed, needed,
                    profile_dir=None):
    """Drive ``train_loop`` for 3 steps on the four samples; returns (the
    launch counts of the run, the trained state). The run's peak device
    memory and step seconds go to ``TRAIN_RUNS[label]``."""
    import torch

    from molly_tpu_torch.training.cli import train_loop
    from molly_tpu_torch.training.trainer import init_train_state

    state = init_train_state(params, tc)
    probe = params["protein_projector"]["bias"]
    before = probe.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    result = train_loop(state, cfg, tc, samples, batch_size=4, epochs=3,
                        total_steps=3, seed=seed, device="cuda",
                        output_dir=None, profile_log_dir=profile_dir,
                        stats=stats)
    counts = read_counts()
    check_flash_tma(label)
    check_int8_tma(label)
    hist = result["history"]
    for h in hist:
        ph = h["phases"]
        lb = (f"moe_load_balance {h['moe_load_balance']:.4f}, "
              if "moe_load_balance" in h else "")
        off = (f"; the offloaded update's copies: H2D "
               f"{ph['offload_h2d_s']:.3f} s, D2H {ph['offload_d2h_s']:.3f} "
               f"s, first in to last out {ph['offload_span_s']:.3f} s, "
               f"{ph['offload_bytes'] / 1e9:.2f} GB"
               if "offload_h2d_s" in ph else "")
        log(f"  {label}: step {h['step']}: loss {h['loss']:.4f}, {lb}grad norm "
            f"{h['grad_norm']:.4f}, {h['seconds']:.3f} s (device: forward "
            f"{ph['forward_s']:.3f}, backward {ph['backward_s']:.3f}, "
            f"optimizer {ph['optimizer_s']:.3f}{off}), skipped "
            f"{h['skipped']}")
    rows = len(samples) * samples[0]["input_ids"].shape[0]
    # step 1 warms up (Triton compiles, allocator); a traced step 3 carries
    # the profiler's overhead
    steady = hist[1:2] if profile_dir else hist[1:]
    log(f"  {label}: {rows * len(steady) / sum(h['seconds'] for h in steady):.0f}"
        f" tokens/s over step{' 2' if profile_dir else 's 2-3'} ({rows} "
        f"token positions a step, {hist[-1]['tokens']} supervised), peak "
        f"device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{counts}")
    TRAIN_RUNS[label] = {
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "step_s": [h["seconds"] for h in steady]}
    import math
    if len(hist) != 3 or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 and h["grad_norm"] > 0) or h["skipped"] for h in hist):
        raise AssertionError(f"{label}: a step was skipped or not finite")
    if torch.equal(before, probe.detach()):
        raise AssertionError(f"{label}: the projector did not change")
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    return counts, result["state"]


def inputs(seed: int):
    """The tokenizers, encoders, requests and configs of the molly-1.7B
    phases: generation at k = 1024 and max length 3072, training at the
    train CLI's defaults (max length 1024, k = 128, 4 slots)."""
    import dataclasses

    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.models import (ESM_PRESETS, QWEN3_PRESETS,
                                        FusionConfig)

    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=3072, dna_rna_k_tokens=1024, protein_k_tokens=1024,
        max_dna_rna_segments=4, max_protein_segments=4))
    requests = make_requests(seed)
    cfg = FusionConfig(text=QWEN3_PRESETS["qwen3-1.7b"],
                       dna_rna=ESM_PRESETS["nt-500m"],
                       protein=ESM_PRESETS["esm2-650m"],
                       dna_rna_k_tokens=1024, protein_k_tokens=1024)
    train_enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=1024, dna_rna_k_tokens=128, protein_k_tokens=128,
        max_dna_rna_segments=4, max_protein_segments=4))
    return dict(
        text_tok=text_tok, dna_tok=dna_tok, prot_tok=prot_tok, enc=enc,
        train_enc=train_enc, requests=requests,
        samples=[enc.encode_test(r) for r in requests],
        train_samples=[train_enc.encode_train(r) for r in requests], cfg=cfg,
        train_cfg=dataclasses.replace(cfg, dna_rna_k_tokens=128,
                                      protein_k_tokens=128))


def drive_main_paths(seed: int, profile_dir=None):
    """Phases 7-12 (with 9a-9b): generation (bf16, int8), serving (paged
    bf16, paged int8, dense ring) and training (full fine-tune, QLoRA,
    the ``dots`` policy, offloaded moments) at molly-1.7B width; returns
    each kernel's launches summed over the runs."""
    import tempfile

    import torch

    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.models.lora import LoraConfig, merge_lora
    from molly_tpu_torch.training import checkpoint as ckpt
    from molly_tpu_torch.training.trainer import TrainConfig, attach_lora
    from molly_tpu_torch.utils.tree import leaves

    base = inputs(seed)
    text_tok, dna_tok, prot_tok = (base["text_tok"], base["dna_tok"],
                                   base["prot_tok"])
    enc, train_enc, requests = (base["enc"], base["train_enc"],
                                base["requests"])
    samples, train_samples = base["samples"], base["train_samples"]
    cfg, train_cfg = base["cfg"], base["train_cfg"]
    with Phase("init molly-1.7B-width params"):
        params = fusion.init_params(
            cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t.numel() for t in leaves(params))
    log(f"  {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    common = dict(temperature=0.8, top_p=0.95, top_k=20,
                  repetition_penalty=1.1, eos_token_id=text_tok.eos_token_id,
                  pad_token_id=text_tok.pad_token_id)
    launches = {name: 0 for name in REPLACES}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    def run_path(label, run_params, run_cfg, run_samples, gen, needed):
        with Phase(f"main path {label}, {gen.max_new_tokens} new tokens"):
            counts = main_path(run_params, run_cfg, run_samples, text_tok,
                               gen, seed, label)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"{label} main path never launched "
                                     f"{name}")
        add(counts)

    run_path("generation, bf16 sampled", params, cfg, samples,
             GenerationConfig(max_new_tokens=32, do_sample=True, **common),
             ("flash_attention_fwd", "rmsnorm_fwd"))

    # serving: 12 requests (three draws of the four prompts) into 8 slots
    serve_samples = samples + [enc.encode_test(r) for s in (1, 2)
                               for r in make_requests(seed + s)]

    def run_serve_path(label, run_samples, gen, needed, absent=(), **kw):
        with Phase(f"main path {label}, {len(run_samples)} requests, "
                   f"{gen.max_new_tokens} new tokens"):
            counts = serve_main_path(params, cfg, run_samples, text_tok, gen,
                                     seed, label, enc.system_prompt_ids, **kw)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"{label} main path never launched "
                                     f"{name}")
        for name in absent:
            if counts[name] != 0:
                raise AssertionError(f"{label} main path launched {name}")
        add(counts)
        release()

    run_serve_path(
        "serving, paged bf16 pages of 64, sampled", serve_samples,
        GenerationConfig(max_new_tokens=32, do_sample=True, **common),
        ("paged_attention", "flash_attention_fwd", "rmsnorm_fwd"),
        absent=("paged_attention_int8",), n_slots=8, paged=True,
        page_size=64)
    run_serve_path(
        "serving, paged int8 pages of 128, greedy", serve_samples,
        GenerationConfig(max_new_tokens=32, do_sample=False, **common),
        ("paged_attention_int8", "flash_attention_fwd", "rmsnorm_fwd"),
        absent=("paged_attention",), n_slots=8, paged=True, page_size=128,
        kv_int8=True)
    run_serve_path(
        "serving, dense ring, sampled", samples,
        GenerationConfig(max_new_tokens=16, do_sample=True, **common),
        ("flash_attention_fwd", "rmsnorm_fwd"), n_slots=4)

    # the rest of serving (8b-8e), on phase 7's weights before training
    inp = dict(text_tok=text_tok, samples=samples,
               serve_samples=serve_samples, enc=enc, common=common,
               modality_toks=(dna_tok, prot_tok))
    serving_rest_paths(seed, params, cfg, inp, add)

    # the checkpoint phases read phase 7's weights, which training changes
    checkpoint_paths(seed, params, cfg, train_cfg, dict(
        text_tok=text_tok, samples=samples, train_samples=train_samples,
        common=common), add)
    release()

    with Phase("main path training, full fine-tune, 3 steps"):
        counts, state = train_main_path(
            params, train_cfg, train_samples, TrainConfig(total_steps=3),
            "full fine-tune", seed, TRAIN_KERNELS, profile_dir)
        add(counts)
    del state
    torch.cuda.empty_cache()

    lora_cfg = LoraConfig(r=64, alpha=64.0, dropout=0.05)
    with Phase("main path training, QLoRA, 3 steps"):
        qparams = attach_lora(params, train_cfg, lora_cfg,
                              torch.Generator("cuda").manual_seed(seed + 1))
        with torch.no_grad():
            qparams["text"] = qwen3.quantize_for_training(
                qparams["text"], train_cfg.text)
        counts, state = train_main_path(
            qparams, train_cfg, train_samples,
            TrainConfig(total_steps=3, lora=lora_cfg), "QLoRA", seed,
            TRAIN_KERNELS + ("int8_matmul",))
        add(counts)
    with Phase("QLoRA: export_adapter, load_adapter, merge_lora, 8 greedy "
               "tokens"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "adapter.npz")
            ckpt.export_adapter(path, state.params, lora_cfg=lora_cfg)
            meta = ckpt.adapter_meta(path)
            fresh = ckpt.load_adapter(path, dict(params))
        assert meta == {"r": 64, "alpha": 64.0}, meta
        lora = fresh.pop("lora")
        with torch.no_grad():
            fresh["text"] = merge_lora(
                fresh["text"], lora, LoraConfig(r=meta["r"],
                                                alpha=meta["alpha"]))
        del lora, state, qparams
        torch.cuda.empty_cache()
        main_path(fresh, train_cfg,
                  [train_enc.encode_test(r) for r in requests], text_tok,
                  GenerationConfig(max_new_tokens=8, do_sample=False,
                                   **common), seed, "merged adapter, greedy")
        del fresh
        torch.cuda.empty_cache()

    # 9a-9b: the remat policy dots and the offloaded moments, on the full
    # fine-tune's weights
    train_leftover_paths(seed, params, train_cfg, train_samples, add)
    release()

    with Phase("quantize_for_decode"), torch.no_grad():
        params["text"] = qwen3.quantize_for_decode(params["text"], cfg.text)
    run_path("generation, int8 greedy", params, cfg, samples,
             GenerationConfig(max_new_tokens=16, do_sample=False, **common),
             ("flash_attention_fwd", "rmsnorm_fwd", "int8_matmul"))
    int8_rest_paths(seed, params, cfg, inp, add)
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params  # the 30B-A3B weights need the room
    release()
    drive_moe_paths(seed, launches, dict(
        text_tok=text_tok, enc=enc, train_enc=train_enc, requests=requests,
        samples=samples, serve_samples=serve_samples,
        train_samples=train_samples, common=common))
    return launches


# ---------------------------------------------------------------------------
# the rest of serving: speculation, the offline ring, the HTTP API
# ---------------------------------------------------------------------------


def varied_config():
    """The small model with an untied head (phases 4b-5c)."""
    import dataclasses
    cfg = small_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, tie_word_embeddings=False))


def varied_small(params):
    """The small model's text weights at unit scale (embedding unit normal,
    each stacked linear and the untied head N(0, 1/fan_in)), drawn from a
    fixed generator, so that greedy tokens vary (the 0.02 init, or a tied
    head, repeats one token)."""
    import torch
    g = torch.Generator().manual_seed(17)
    text = params["text"]
    text["embed"] = torch.randn(text["embed"].shape, generator=g)
    for name, w in text["layers"].items():
        if not isinstance(w, dict) and w.ndim == 3:
            text["layers"][name] = (torch.randn(w.shape, generator=g)
                                    * w.shape[1] ** -0.5)
    text["lm_head"] = (torch.randn(text["lm_head"].shape, generator=g)
                       * text["lm_head"].shape[0] ** -0.5)
    return params


def spec_prompt(seed: int):
    """A fusion prompt [1, 48] whose text repeats a 6-token pattern (so the
    lookup draft finds matches), with a DNA segment at position 2."""
    import torch
    g = torch.Generator().manual_seed(seed)
    pat = torch.randint(1, 384, (6,), generator=g)
    ids = torch.cat([torch.randint(1, 384, (20,), generator=g),
                     pat.repeat(4), pat[:4]])[None]
    return {"input_ids": ids,
            "attention_mask": torch.ones_like(ids, dtype=torch.int32),
            "dna_rna_tokens": torch.randint(6, 4102, (1, 1, 16),
                                            generator=g),
            "dna_rna_pos": torch.tensor([[2]])}


def small_reference_speculative(seed: int):
    """Phase 4b. The small fp32 model's greedy ``generate_speculative``
    with the int8 self-draft at k = 1, 3, 4 and ``generate_lookup`` at
    k = 8, n = 3: on the card and on the CPU each equals the target's own
    greedy ``generate`` (what ``run_batches`` calls) exactly, and the card's
    tokens equal the CPU's."""
    import torch

    from molly_tpu_torch.inference.engine import generate
    from molly_tpu_torch.inference.speculative import (generate_lookup,
                                                       generate_speculative)
    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.utils.tree import tree_to

    cfg = varied_config()
    cpu = varied_small(fusion.init_params(cfg,
                                          torch.Generator().manual_seed(seed)))
    gpu = tree_to(cpu, "cuda")
    batch = spec_prompt(seed)
    gen = GenerationConfig(max_new_tokens=24, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    runs = {}
    with torch.inference_mode():
        for where, p in (("cpu", cpu), ("cuda", gpu)):
            b = {k: t.to(where) for k, t in batch.items()}
            ref = generate(p, cfg, b, gen).cpu()
            emb = fusion.build_inputs_embeds(p, cfg, b)
            draft = qwen3.quantize_for_decode(p["text"], cfg.text)
            out = {"target": (ref, None, None)}
            for k in (1, 3, 4):
                out[f"self-draft k={k}"] = generate_speculative(
                    p["text"], cfg.text, draft, cfg.text, b["input_ids"],
                    gen, k=k, inputs_embeds=emb, return_stats=True)
            out["lookup k=8 n=3"] = generate_lookup(
                p["text"], cfg.text, b["input_ids"], gen, k=8, n=3,
                inputs_embeds=emb, return_stats=True)
            runs[where] = out
    ref = runs["cpu"]["target"][0]
    if len(set(ref[0].tolist())) < 4:
        raise AssertionError("small speculative reference: the target's "
                             "tokens do not vary")
    for name in runs["cpu"]:
        (ct, cr, ca), (gt, gr, ga) = runs["cpu"][name], runs["cuda"][name]
        gt = gt.cpu()
        log(f"  small speculative reference, {name}: rounds {gr}, accepted "
            f"drafts {ga}; equal to the target's greedy: card "
            f"{bool(torch.equal(gt, ref))}, CPU {bool(torch.equal(ct, ref))}"
            f"; card equals CPU {bool(torch.equal(gt, ct))}")
        if not (torch.equal(gt, ref) and torch.equal(ct, ref)
                and (gr, ga) == (cr, ca)):
            raise AssertionError(f"small speculative reference, {name}: "
                                 f"tokens or rounds differ")


def small_ring_queue(seed: int, n: int = 12, bucket: int = 64):
    """n left-padded prompts in one bucket (every third tri-modal) for the
    ring and its per-request batches for the engine."""
    import numpy as np

    from molly_tpu_torch.inference.server import _pad_to_bucket
    rng = np.random.default_rng(seed)
    rows, batches = [], []
    for i in range(n):
        s = int(rng.integers(24, bucket + 1))
        b = {"input_ids": rng.integers(1, 384, (1, s)).astype(np.int32),
             "attention_mask": np.ones((1, s), np.int32),
             "dna_rna_tokens": rng.integers(6, 4102, (1, 1, 16)).astype(
                 np.int32),
             "dna_rna_pos": np.asarray([[2 if i % 3 == 0 else -1]],
                                       np.int32)}
        batches.append(b)
        rows.append(_pad_to_bucket(b, bucket, 0))
    queue = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    return queue, batches


def small_reference_ring(seed: int):
    """Phase 5b. ``run_offline`` of the small fp32 model over 12 requests
    into 4 slots in admission groups of 2: KV in the model dtype and int8,
    greedy, then with ``spec_lookup`` 4 and with the adaptive threshold.
    Each equals the port's ``ServingEngine`` dense ring on the same device
    exactly (int8 KV: first tokens equal, at most 3 flips), and the card
    equals the CPU."""
    import numpy as np
    import torch

    from molly_tpu_torch.inference.offline import run_offline
    from molly_tpu_torch.inference.server import Request, ServingEngine
    from molly_tpu_torch.models import GenerationConfig, fusion
    from molly_tpu_torch.utils.tree import tree_to

    cfg = varied_config()
    cpu = varied_small(fusion.init_params(cfg,
                                          torch.Generator().manual_seed(seed)))
    gpu = tree_to(cpu, "cuda")
    queue, batches = small_ring_queue(seed + 4)
    T, bucket = 24, 64
    gen = GenerationConfig(max_new_tokens=T, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    omics = {k: queue[k] for k in ("dna_rna_tokens", "dna_rna_pos")}
    variants = {"model-dtype KV": {}, "int8 KV": {"kv_quant": "int8"},
                "spec_lookup 4": {"spec_lookup": 4},
                "adaptive": {"spec_lookup": 4, "spec_threshold": 0.2,
                             "spec_chunk": 4}}
    got = {}
    for where, p in (("cpu", cpu), ("cuda", gpu)):
        for quant in (None, "int8"):
            eng = ServingEngine(p, cfg, gen, n_slots=4, max_len=bucket + T,
                                prefill_buckets=(bucket,), kv_quant=quant)
            res = eng.run([Request(uid=i, batch=dict(b))
                           for i, b in enumerate(batches)])
            got[where, "engine", quant] = [np.asarray(res[i])
                                           for i in range(len(batches))]
        for name, kw in variants.items():
            out = run_offline(p, cfg, gen, queue["input_ids"],
                              queue["attention_mask"], n_slots=4,
                              max_len=bucket + T + kw.get("spec_lookup", 0),
                              admit_group=2, queue_omics=omics, **kw)
            got[where, name] = [out["tokens"][i, :out["lengths"][i]]
                                for i in range(len(batches))]
            if where == "cuda":
                log(f"  small ring reference, {name}: {out['ticks']} ticks, "
                    f"{out['decode_ticks']} decode ticks, accepted "
                    f"{out['accepted']}, {out['host_syncs']} host syncs")

    def flips(a, b):
        if [len(x) for x in a] != [len(x) for x in b]:
            return None
        return sum(int(np.sum(x != y)) for x, y in zip(a, b))

    for name, kw in variants.items():
        quant = kw.get("kv_quant")
        allowed = SERVE_INT8_FLIPS if quant else 0
        for where in ("cpu", "cuda"):
            ring, ref = got[where, name], got[where, "engine", quant]
            f = flips(ring, ref)
            firsts = all(x[0] == y[0] for x, y in zip(ring, ref))
            log(f"  small ring reference, {name}, {where}: {f} tokens differ "
                f"from ServingEngine (allowed {allowed}), first tokens "
                f"equal: {firsts}")
            if f is None or f > allowed or not firsts:
                raise AssertionError(f"small ring reference, {name}, "
                                     f"{where}: the ring disagrees with the "
                                     f"engine")
        f = flips(got["cuda", name], got["cpu", name])
        if f is None or f > allowed:
            raise AssertionError(f"small ring reference, {name}: the card "
                                 f"disagrees with the CPU ({f} tokens)")
    if len({int(t) for r in got["cpu", "model-dtype KV"] for t in r}) < 8:
        raise AssertionError("small ring reference: tokens do not vary")


def small_reference_api(seed: int):
    """Phase 5c. The HTTP API on 127.0.0.1 over ``PagedServingEngine``
    (int8 pages of 16) of the small model, with two adapters in one
    multi-LoRA bank over ``quantize_for_decode(fuse=False)``: each
    adapter's greedy completion (token ids spelled out by the server's
    tokenizer) equals a single-adapter paged engine with that adapter merged
    (first tokens equal, at most 3 flips, the int8-pages rule), and the
    base model's differs from both."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.inference import api_server
    from molly_tpu_torch.inference.paged import PagedServingEngine
    from molly_tpu_torch.inference.server import REQUEST_KEYS, Request
    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.models.lora import (LoraConfig, init_lora,
                                             merge_lora, stack_adapters)
    from molly_tpu_torch.utils.tree import tree_to

    cfg = varied_config()
    params = tree_to(varied_small(fusion.init_params(
        cfg, torch.Generator().manual_seed(seed))), "cuda")
    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=192, dna_rna_k_tokens=16, protein_k_tokens=16))
    lcfg = LoraConfig(r=8, alpha=16.0)
    adapters = []
    for i in range(2):
        g = torch.Generator("cuda").manual_seed(seed + 10 + i)
        ad = init_lora(cfg.text, lcfg, g, device="cuda")
        for ab in ad["layers"].values():
            ab["b"].normal_(0.0, 0.3, generator=g)
        adapters.append(ad)
    with torch.no_grad():
        base = qwen3.quantize_for_decode(params["text"], cfg.text,
                                         fuse=False)
    bank = stack_adapters(adapters, scales=[lcfg.scale] * 2)
    gen = GenerationConfig(max_new_tokens=8, do_sample=False,
                           repetition_penalty=1.1,
                           eos_token_id=text_tok.eos_token_id,
                           pad_token_id=text_tok.pad_token_id)
    prompt = f"Does <dna>{'ACGT' * 12}</dna> bind <protein>MKTAYIAKQR</protein>?"
    paged = dict(n_slots=4, decode_chunk=4, kv_quant="int8", paged=True,
                 page_size=16)
    online = api_server.OnlineServer({**params, "text": base}, cfg, gen, enc,
                                     TokenIds(text_tok), lora_bank=bank,
                                     adapter_names=["a1", "a2"], **paged)
    httpd = api_server.make_http_server(online, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    answers = {}
    try:
        for model in ("a1", "a2", "molly-tpu"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions",
                data=json.dumps({"prompt": prompt, "model": model,
                                 "temperature": 0}).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            answers[model] = [int(t) for t in
                              body["choices"][0]["text"].split()]
    finally:
        httpd.shutdown()
        httpd.server_close()
        online.close()
    sample = enc.encode_test({"input": prompt})
    batch = {k: np.asarray(sample[k])[None] for k in REQUEST_KEYS
             if k in sample}
    s_pre = len(enc.system_prompt_ids)
    bucket = -(-(192 - (s_pre // 16) * 16) // 16) * 16
    for i, model in enumerate(("a1", "a2")):
        with torch.no_grad():
            merged = merge_lora(base, adapters[i], lcfg)
        eng = PagedServingEngine(
            {**params, "text": merged}, cfg, gen, n_slots=4, page_size=16,
            prefill_buckets=(bucket,), decode_chunk=4, kv_quant="int8",
            prefix_ids=enc.system_prompt_ids)
        ref = eng.run([Request(uid=0, batch=dict(batch))])[0].tolist()
        ref = [t for t in ref if t != gen.pad_token_id]
        got = answers[model]
        flips = (sum(a != b for a, b in zip(got, ref))
                 if len(got) == len(ref) else None)
        log(f"  small API reference, adapter {model}: {got} against the "
            f"merged engine's {ref}: {flips} differ (allowed "
            f"{SERVE_INT8_FLIPS})")
        if flips is None or flips > SERVE_INT8_FLIPS or got[0] != ref[0]:
            raise AssertionError(f"small API reference, {model}: the bank "
                                 f"disagrees with the merged adapter")
    if answers["a1"] == answers["molly-tpu"] or \
            answers["a2"] == answers["molly-tpu"]:
        raise AssertionError("small API reference: an adapter was not "
                             "routed")


NEAR_TIE_REL = 2.0 ** -7  # the near-tie rule: top-two gap / max |logit|


def ids_of(records):
    """Token ids of ``TokenIds``-decoded JSONL records."""
    return [[int(t) for t in r["decoded_output"].split()] for r in records]


def penalized_gap(logits, presence, penalty):
    """Per row: the gap between the top two repetition-penalized logits (the
    quantity greedy decoding takes the argmax of), over the largest
    |logit|. logits [R, V] fp32, presence [R, V] bool."""
    import torch
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where(presence, pen, logits)
    top = logits.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / logits.abs().amax(dim=-1)).tolist()


class LogitTap:
    """While active, keep every ``qwen3.logits_from_hidden`` result: the
    reference run's own logits, one [rows, V] tensor a call."""

    def __enter__(self):
        from molly_tpu_torch.models import qwen3
        self.mod, self.orig, self.calls = qwen3, qwen3.logits_from_hidden, []

        def tap(params, cfg, hidden):
            out = self.orig(params, cfg, hidden)
            self.calls.append(out.float())
            return out

        qwen3.logits_from_hidden = tap
        return self

    def __exit__(self, *exc):
        self.mod.logits_from_hidden = self.orig
        return False

    def gaps(self, token_rows, penalty):
        """Greedy generation's calls in lockstep (call i gives every row's
        token i): each row's gap at each of its positions, the presence set
        being the row's earlier tokens."""
        import torch
        out = [[] for _ in token_rows]
        for i, lg in enumerate(self.calls):
            rows = [r for r, t in enumerate(token_rows) if i < len(t)]
            if not rows:
                break
            pres = torch.zeros((len(rows), lg.shape[-1]), dtype=torch.bool,
                               device=lg.device)
            for j, r in enumerate(rows):
                pres[j, token_rows[r][:i]] = True
            for r, g in zip(rows, penalized_gap(lg[rows], pres, penalty)):
                out[r].append(g)
        return out


class RingTap:
    """While active, the offline ring's admissions and plain ticks record
    each request's gap (``penalized_gap``) at each position, from the
    ring's own logits and presence sets: the reference gaps of a ring
    run."""

    def __init__(self, n_req: int, penalty: float):
        self.n_req, self.penalty = n_req, penalty
        self.by_pos = [dict() for _ in range(n_req)]

    def __enter__(self):
        import torch

        from molly_tpu_torch.inference import offline
        from molly_tpu_torch.models import qwen3
        self.off, self.q = offline, qwen3
        self.saved = (offline._decode_tick, offline._admit,
                      qwen3.logits_from_hidden)
        o_tick, o_admit, o_logits = self.saved
        last = {}

        def logits(params, cfg, hidden):
            last["l"] = o_logits(params, cfg, hidden)
            return last["l"]

        def tick(params, st, generator, head, **kw):
            V = kw["tcfg"].vocab_size
            snap = (st["active"].clone(), st["req_of_slot"].clone(),
                    st["out_len"].clone(), st["presence"][:, :V].clone())
            o_tick(params, st, generator, head, **kw)
            self.record(last["l"].float(), *snap)

        def admit(params, st, generator, qh, **kw):
            o_admit(params, st, generator, qh, **kw)
            lg = last["l"].float()
            k = lg.shape[0]
            self.record(lg, torch.ones(k, dtype=torch.bool),
                        qh + torch.arange(k), torch.zeros(k, dtype=torch.long),
                        torch.zeros_like(lg, dtype=torch.bool))

        offline._decode_tick, offline._admit = tick, admit
        qwen3.logits_from_hidden = logits
        return self

    def __exit__(self, *exc):
        (self.off._decode_tick, self.off._admit,
         self.q.logits_from_hidden) = self.saved
        return False

    def record(self, lg, active, req, pos, presence):
        gaps = penalized_gap(lg, presence.to(lg.device), self.penalty)
        for g, a, r, p in zip(gaps, active.tolist(), req.tolist(),
                              pos.tolist()):
            if a and 0 <= r < self.n_req:
                self.by_pos[r][p] = g

    def gaps(self, token_rows):
        return [[self.by_pos[r].get(i, 0.0) for i in range(len(t))]
                for r, t in enumerate(token_rows)]


def near_tie_check(label, ref_rows, got_rows, gaps):
    """Two greedy runs agree up to the first position where the reference
    run's own gap is below NEAR_TIE_REL: a difference before it fails.
    Prints each row's first near tie, its first difference and the gap
    there."""
    for r, (a, b, g) in enumerate(zip(ref_rows, got_rows, gaps)):
        tie = next((t for t, x in enumerate(g) if x < NEAR_TIE_REL), None)
        diff = next((t for t in range(max(len(a), len(b)))
                     if t >= len(a) or t >= len(b) or a[t] != b[t]), None)
        tie_s = (f"first near tie at {tie} (gap {g[tie]:.2e} of max|logit|)"
                 if tie is not None else f"no near tie in {len(a)} tokens "
                 f"(smallest gap {min(g):.2e})")
        diff_s = ("none" if diff is None else f"at {diff}" + (
            f" (gap there {g[diff]:.2e})" if diff < len(g) else ""))
        log(f"  {label}: request {r}: {tie_s}; first difference {diff_s}")
        if diff is not None and (tie is None or diff < tie):
            raise AssertionError(f"{label}: request {r} differs at {diff} "
                                 f"before any near tie")


def peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def serving_rest_paths(seed: int, params, cfg, inp, add):
    """Phases 8b-8e at molly-1.7B width on phase 7's bf16 weights: the
    batch CLI's ``--decoding lookup`` (``run_lookup``), the int8 self-draft
    (``generate_speculative``), the ``--offline-ring`` (``run_offline_ring``:
    KV in bf16, in int8, with ``--ring-spec 8``) and ``--api-serve``
    (``run_api_server``) over paged bf16 pages. ``add`` takes each run's
    launch counts."""
    import numpy as np
    import torch

    from molly_tpu_torch.data import collate_test, collate_train
    from molly_tpu_torch.inference import api_server
    from molly_tpu_torch.inference import cli as icli
    from molly_tpu_torch.inference.server import REQUEST_KEYS
    from molly_tpu_torch.inference.speculative import generate_speculative
    from molly_tpu_torch.models import GenerationConfig, fusion, qwen3
    from molly_tpu_torch.tools.embed import embed_batch

    text_tok, samples, enc = TokenIds(inp["text_tok"]), inp["samples"], \
        inp["enc"]
    common = inp["common"]
    gen = GenerationConfig(max_new_tokens=32, do_sample=False, **common)
    pen = common["repetition_penalty"]

    def counted(label, fn, needed=("flash_attention_fwd", "rmsnorm_fwd")):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        check_flash_tma(label)
        check_paged_tma(label)
        check_int8_tma(label)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"{label} never launched {name}")
        add(counts)
        log(f"  {label}: {dt:.3f} s, peak device memory {peak_gib():.2f} "
            f"GiB; launches {counts}")
        return out, dt

    # the reference: plain greedy through run_batches, one request a batch
    def plain_greedy():
        recs, gaps = [], []
        for s_ in samples:
            with LogitTap() as tap:
                rec = icli.run_batches([s_], params, cfg, gen, text_tok,
                                       io.StringIO(), batch_size=1)
            recs += rec
            gaps += tap.gaps(ids_of(rec), pen)
        return recs, gaps

    with Phase("8b. reference: run_batches greedy, one request a batch, "
               "32 new tokens"):
        (recs, gaps), t_plain = counted("plain greedy", plain_greedy)
        ref = ids_of(recs)
        n_plain = sum(len(r) for r in ref)
    with Phase("8b. --decoding lookup --lookup-k 8 --lookup-n 3, greedy, 32 "
               "new tokens"):
        stats = {}
        recs, dt = counted("lookup", lambda: icli.run_lookup(
            samples, params, cfg, gen, text_tok, io.StringIO(), k=8, n=3,
            generator=torch.Generator("cuda").manual_seed(seed),
            stats=stats))
        near_tie_check("lookup", ref, ids_of(recs), gaps)
        log(f"  lookup: {stats['rounds']} rounds, "
            f"{stats['accepted'] / stats['rounds']:.2f} accepted drafts a "
            f"round, {stats['tokens'] / dt:.1f} tokens/s against plain "
            f"greedy's {n_plain / t_plain:.1f} (one request at a time)")

    with Phase("8c. generate_speculative, int8 self-draft, k = 4, one "
               "request, 32 new tokens"):
        with torch.no_grad():
            draft = qwen3.quantize_for_decode(params["text"], cfg.text)
        row = collate_test([samples[0]])
        b = {k: torch.as_tensor(v, device="cuda") for k, v in
             icli._strip_left_pad({k: row[k] for k in REQUEST_KEYS
                                   if k in row}).items()}

        def spec():
            with torch.inference_mode():
                emb = fusion.build_inputs_embeds(params, cfg, b)
            return generate_speculative(
                params["text"], cfg.text, draft, cfg.text, b["input_ids"],
                gen, k=4, inputs_embeds=emb, return_stats=True)

        (toks, rounds, acc), dt = counted("self-draft", spec,
                                          ("flash_attention_fwd",
                                           "rmsnorm_fwd", "int8_matmul"))
        toks = [t for t in toks[0].tolist() if t != gen.pad_token_id]
        near_tie_check("self-draft", ref[:1], [toks], gaps[:1])
        log(f"  self-draft: {rounds} rounds, {acc / rounds:.2f} accepted "
            f"drafts a round, {len(toks) / dt:.1f} tokens/s against plain "
            f"greedy's {n_plain / t_plain:.1f}")
        del draft
        release()

    # the offline ring: 12 tri-modal requests into 8 slots, groups of 4
    serve_samples = inp["serve_samples"]
    with Phase("8d. run_serve dense ring, 12 requests, 8 slots, 32 new "
               "tokens, greedy"):
        recs, _ = counted("dense ring", lambda: icli.run_serve(
            serve_samples, params, cfg, gen, text_tok, io.StringIO(),
            n_slots=8, max_length=3072, prefix_ids=enc.system_prompt_ids,
            decode_chunk=16, admit_batch=4))
        serve_ids = ids_of(recs)
    ring_runs = {}
    # the bf16 ring is the reference: its own logits give the gaps
    tap = RingTap(len(serve_samples), pen)
    for name, kw in (("bf16 KV", {}), ("int8 KV", {"kv_int8": True}),
                     ("--ring-spec 8", {"ring_spec": 8})):
        with Phase(f"8d. --offline-ring, {name}, 12 requests, 8 slots, "
                   f"groups of 4, 32 new tokens"):
            stats = {}

            def ring():
                return icli.run_offline_ring(
                    serve_samples, params, cfg, gen, text_tok, io.StringIO(),
                    n_slots=8, max_length=3072, admit_group=4, stats=stats,
                    generator=torch.Generator("cuda").manual_seed(seed),
                    **kw)

            if name == "bf16 KV":
                with tap:
                    recs, dt = counted(f"offline ring, {name}", ring)
            else:
                recs, dt = counted(f"offline ring, {name}", ring)
            ring_runs[name] = ids_of(recs)
            log(f"  offline ring, {name}: {len(recs) / dt:.2f} requests/s, "
                f"{stats['tokens_out'] / dt:.1f} tokens/s, {stats['ticks']} "
                f"ticks ({stats['decode_ticks']} decode), "
                f"{-(-len(recs) // 4)} admissions, {stats['host_syncs']} "
                f"host syncs, accepted drafts {stats['accepted']}")
    ring_gaps = tap.gaps(ring_runs["bf16 KV"])
    near_tie_check("offline ring bf16 KV against run_serve's dense ring",
                   ring_runs["bf16 KV"], serve_ids, ring_gaps)
    near_tie_check("offline ring --ring-spec 8 against the bf16 ring",
                   ring_runs["bf16 KV"], ring_runs["--ring-spec 8"],
                   ring_gaps)
    if not all(ring_runs["int8 KV"]):
        raise AssertionError("offline ring, int8 KV: an empty output")

    with Phase("8e. --api-serve on 127.0.0.1, paged bf16 pages of 64, 8 "
               "slots: 8 concurrent completions, a stream, a chat, 4 "
               "embeddings"):
        import argparse
        import threading
        import urllib.request

        args = argparse.Namespace(
            batch_size=8, serve_chunk=16, serve_admit=4, serve_kv_int8=False,
            serve_paged=True, page_size=64, kv_pages=None, host="127.0.0.1",
            port=0)
        agen = GenerationConfig(max_new_tokens=16, do_sample=True, **common)
        servers = []
        make = api_server.make_http_server

        def capture(*a, **kw):
            servers.append(make(*a, **kw))
            return servers[-1]

        api_server.make_http_server = capture
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        main = threading.Thread(target=api_server.run_api_server, args=(
            args, params, cfg, agen, inp["text_tok"], *inp["modality_toks"],
            enc.cfg), kwargs={"generator": torch.Generator(
                "cuda").manual_seed(seed)})
        main.start()
        try:
            for _ in range(1200):
                if servers or not main.is_alive():
                    break
                main.join(0.1)
            if not servers:
                raise AssertionError("--api-serve did not start")
            port = servers[0].server_address[1]
            log(f"  --api-serve listening on 127.0.0.1:{port} after "
                f"{time.perf_counter() - t0:.2f} s")

            def post(path, body):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    data=json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=600) as r:
                    if body.get("stream"):
                        return r.read().decode()
                    return json.loads(r.read())

            prompts = [r["input"] for s in (0, 1)
                       for r in make_requests(seed + s)]
            results = {}

            def hit(i):
                results[i] = post("/v1/completions",
                                  {"prompt": prompts[i], "max_tokens": 16,
                                   "temperature": 0})

            t1 = time.perf_counter()
            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            dt = time.perf_counter() - t1
            toks = sum(results[i]["usage"]["completion_tokens"]
                       for i in range(8))
            log(f"  8 concurrent completions in {dt:.3f} s, {toks} tokens = "
                f"{toks / dt:.1f} tokens/s; first: "
                f"{json.dumps(results[0])[:300]}")
            if len(results) != 8 or any(
                    not 0 < results[i]["usage"]["completion_tokens"] <= 16
                    or results[i]["object"] != "text_completion"
                    for i in range(8)):
                raise AssertionError("--api-serve: a completion is missing "
                                     "or malformed")
            twin = post("/v1/completions", {"prompt": prompts[2],
                                            "max_tokens": 16,
                                            "temperature": 0})
            raw = post("/v1/completions", {"prompt": prompts[2],
                                           "max_tokens": 16,
                                           "temperature": 0, "stream": True})
            deltas = [json.loads(line[6:])["choices"][0]["text"]
                      for line in raw.splitlines()
                      if line.startswith("data: {")]
            if "".join(deltas) != twin["choices"][0]["text"] or \
                    not raw.rstrip().endswith("data: [DONE]"):
                raise AssertionError("--api-serve: the stream differs from "
                                     "its non-streamed twin")
            chat = post("/v1/chat/completions", {
                "messages": [{"role": "user", "content": prompts[1]}],
                "max_tokens": 16, "temperature": 0})
            if chat["object"] != "chat.completion" or \
                    chat["choices"][0]["message"]["role"] != "assistant":
                raise AssertionError("--api-serve: bad chat answer")
            texts = prompts[:4]
            emb = post("/v1/embeddings", {"input": texts})
            vec = np.asarray([d["embedding"] for d in emb["data"]])
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=60) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/models", timeout=60) as r:
                models = json.loads(r.read())
        finally:
            api_server.make_http_server = make
            if servers:
                servers[0].shutdown()
            main.join(600)
        if main.is_alive():
            raise AssertionError("--api-serve did not shut down")
        counts = read_counts()
        check_flash_tma("--api-serve")
        check_paged_tma("--api-serve")
        for name in ("paged_attention", "flash_attention_fwd", "rmsnorm_fwd"):
            if counts[name] <= 0:
                raise AssertionError(f"--api-serve never launched {name}")
        add(counts)
        direct = embed_batch(params, cfg, collate_train(
            [enc.encode_train({"input": t, "output": ""}) for t in texts]))
        err = float(np.abs(vec - direct).max())
        log(f"  embeddings {vec.shape}, max |served - embed_batch| "
            f"{err:.3e} (tol {1e-2 * np.abs(direct).max():.3e}); health "
            f"{health}; models {[m['id'] for m in models['data']]}; peak "
            f"device memory {peak_gib():.2f} GiB; launches {counts}")
        width = (cfg.text.hidden_size + cfg.dna_rna.hidden_size
                 + cfg.protein.hidden_size)  # 2048 + 1280 + 1280
        if vec.shape != (4, width) or \
                err > 1e-2 * np.abs(direct).max() or \
                health != {"status": "ok"}:
            raise AssertionError("--api-serve: bad embeddings or health")
    release()


def int8_rest_paths(seed: int, params, cfg, inp, add):
    """Phase 11a, after phase 11's ``quantize_for_decode``: ``--decoding
    lookup`` and ``--offline-ring --ring-spec 8`` over the int8 decoder
    (every int8 launch at M <= 16 on the weight stream, at M > 16 on the TMA
    kernel), then ``esm.quantize_for_decode`` of both encoders: the
    projected embeddings of the phase-7 requests against the bf16
    encoders', bounded by the scheme's own error in fp32 plus twice bf16's
    rounding (triangle inequality), every encoder int8 launch on the TMA
    kernel."""
    import dataclasses

    import torch

    from molly_tpu_torch.data import collate_test
    from molly_tpu_torch.inference import cli as icli
    from molly_tpu_torch.models import GenerationConfig, esm, fusion

    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)

    def dequantized(enc):
        """An int8 encoder's weights back in fp32 (w_q * scale)."""
        layers = {k: (v["w_q"].float() * v["scale"][:, None, :]
                      if isinstance(v, dict) and "w_q" in v
                      else tree_map(lambda t: t.float(), v))
                  for k, v in enc["layers"].items()}
        return {**tree_map(lambda t: t.float(), {k: v for k, v in enc.items()
                                                 if k != "layers"}),
                "layers": layers}

    text_tok, samples = TokenIds(inp["text_tok"]), inp["samples"]
    gen = GenerationConfig(max_new_tokens=16, do_sample=False,
                           **inp["common"])
    need = ("flash_attention_fwd", "rmsnorm_fwd", "int8_matmul")
    for label, fn in (
            ("int8 --decoding lookup", lambda: icli.run_lookup(
                samples, params, cfg, gen, text_tok, io.StringIO(), k=8,
                n=3)),
            ("int8 --offline-ring --ring-spec 8", lambda: icli.run_offline_ring(
                inp["serve_samples"], params, cfg, gen, text_tok,
                io.StringIO(), n_slots=8, max_length=3072, admit_group=4,
                ring_spec=8))):
        with Phase(f"11a. {label}, 16 new tokens"):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            recs = fn()
            counts = read_counts()
            check_flash_tma(label)
            check_int8_tma(label)
            c = counters()["int8_matmul"]
            for name in need:
                if counts[name] <= 0:
                    raise AssertionError(f"{label} never launched {name}")
            if not (c.launches_tma and c.launches_gemv):
                raise AssertionError(f"{label}: expected int8 launches on "
                                     f"both the TMA kernel and the stream")
            if not all(ids_of(recs)):
                raise AssertionError(f"{label}: an empty output")
            add(counts)
            log(f"  {label}: {len(recs)} records, peak device memory "
                f"{peak_gib():.2f} GiB; launches {counts}")
    with Phase("11a. esm.quantize_for_decode of both encoders, the phase-7 "
               "requests' projected embeddings"):
        torch.cuda.reset_peak_memory_stats()
        batch = collate_test(samples)
        q = {name: esm.quantize_for_decode(params[name])
             for name in ("dna_rna", "protein")}
        for name, enc_cfg, key in (("dna_rna", cfg.dna_rna, "dna_rna_tokens"),
                                   ("protein", cfg.protein,
                                    "protein_tokens")):
            tokens = torch.as_tensor(batch[key], device="cuda")
            proj = f"{name}_projector"
            with torch.inference_mode():
                ref = fusion.encode_and_project(params, enc_cfg, proj, name,
                                                tokens).float()
                reset_counts()
                got = fusion.encode_and_project(
                    {**params, name: q[name]}, enc_cfg, proj, name,
                    tokens).float()
                c = counters()["int8_matmul"]
                n, n_tma = c.launches, c.launches_tma
                # the scheme's own error, in fp32: the int8 weights
                # dequantized against the bf16 weights, and bf16 rounding
                f32_cfg = dataclasses.replace(enc_cfg, dtype="float32")
                f32 = {**params, name: tree_map(lambda t: t.float(),
                                                params[name])}
                deq = {**f32, name: dequantized(q[name])}
                exact = fusion.encode_and_project(f32, f32_cfg, proj, name,
                                                  tokens).float()
                scheme = fusion.encode_and_project(deq, f32_cfg, proj, name,
                                                   tokens).float()
                del f32, deq
            err = (got - ref).abs().max().item()
            e_scheme = (scheme - exact).abs().max().item()
            e_bf16 = (ref - exact).abs().max().item()
            top = ref.abs().max().item()
            log(f"  int8 {name} encoder: max |int8 - bf16| of the projected "
                f"embeddings {err:.3e} = {err / top:.3e} of the max "
                f"{top:.3e} (the 5e-2 estimate: {err <= 5e-2 * top}); the "
                f"scheme's own error in fp32 {e_scheme:.3e}, bf16 against "
                f"fp32 {e_bf16:.3e}; bound {e_scheme + 2 * e_bf16:.3e}; "
                f"{n} int8 launches, {n_tma} on the TMA kernel; peak device "
                f"memory {peak_gib():.2f} GiB")
            if err > e_scheme + 2 * e_bf16 or not n or n_tma != n:
                raise AssertionError(f"int8 {name} encoder: further from the "
                                     f"bf16 encoder than the scheme and bf16 "
                                     f"rounding allow, or off the TMA "
                                     f"kernel")
            release()
        del q
    release()


def assert_bit_equal(label, got, ref, path=""):
    """Same keys, dtypes, shapes and bits, leaf for leaf."""
    import torch
    if isinstance(ref, dict):
        if not isinstance(got, dict) or set(got) != set(ref):
            raise AssertionError(f"{label}: keys differ at {path or '/'}")
        for k in ref:
            assert_bit_equal(label, got[k], ref[k], f"{path}/{k}")
    elif got.dtype != ref.dtype or got.shape != ref.shape or \
            not torch.equal(got, ref):
        raise AssertionError(f"{label}: {path} differs ({got.dtype} "
                             f"{tuple(got.shape)} against {ref.dtype} "
                             f"{tuple(ref.shape)})")


class TokenIds:
    """The text tokenizer, but ``decode`` spells the token ids: two runs'
    JSONL records then compare token for token (random weights mostly emit
    ids past the byte tokenizer's 268, which decode to nothing)."""

    def __init__(self, tok):
        self.tok = tok

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def __getattr__(self, name):
        return getattr(self.tok, name)


def greedy_tokens_equal(label, run_a, run_b):
    """Drive two params through ``main_path`` greedily, each run handed a
    list for its records; both runs' tokens must be equal."""
    a, b = [], []
    run_a(a)
    run_b(b)
    ta = [r["decoded_output"] for r in a]
    if not all(ta) or ta != [r["decoded_output"] for r in b]:
        raise AssertionError(f"{label}: greedy tokens differ (or are none)")
    log(f"  {label}: {len(ta)} x {len(ta[0].split())} greedy tokens equal "
        f"(first row: {ta[0][:80]})")


def checkpoint_paths(seed: int, params, cfg, train_cfg, inp, add):
    """Phase 8a at molly-1.7B width, on phase 7's bf16 weights: export the
    text decoder as an HF checkpoint (fp32 safetensors, by the port's own
    writer), load it back through the batch CLI's ``--checkpoint``, load a
    PEFT directory through ``--peft-adapter``, and load the checkpoint
    through the train CLI's ``--text-model-path`` and fine-tune 3 steps.
    ``add`` takes each main-path run's launch counts."""
    import shutil
    import tempfile

    import torch

    from molly_tpu_torch.data import default_modality_tokenizers
    from molly_tpu_torch.inference import cli as icli
    from molly_tpu_torch.models import GenerationConfig
    from molly_tpu_torch.models.hf_export import (peft_lora_to_hf_state,
                                                  save_hf_checkpoint,
                                                  write_safetensors)
    from molly_tpu_torch.models.lora import (LORA_TARGETS, LoraConfig,
                                             init_lora, merge_lora)
    from molly_tpu_torch.training import cli as tcli
    from molly_tpu_torch.training.trainer import TrainConfig
    from molly_tpu_torch.utils.tree import leaves

    text_tok = TokenIds(inp["text_tok"])
    gen = GenerationConfig(max_new_tokens=16, do_sample=False,
                           **inp["common"])

    def run(run_params, label):
        def go(out):
            counts = main_path(run_params, cfg, inp["samples"], text_tok,
                               gen, seed, label, out)
            for name in ("flash_attention_fwd", "rmsnorm_fwd"):
                if counts[name] <= 0:
                    raise AssertionError(f"{label} never launched {name}")
            add(counts)
        return go

    need = sum(t.numel() * 4 for t in leaves(params["text"]))
    tmp = tempfile.mkdtemp(prefix="molly_hf_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"  checkpoint directory {tmp}: {need / 1e9:.2f} GB to write, "
            f"{free / 1e9:.2f} GB free")
        if need > free:
            raise AssertionError(f"the checkpoint needs {need / 1e9:.2f} GB "
                                 f"and {tmp} has {free / 1e9:.2f} GB free")
        hf_dir, peft_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "peft")
        with Phase("checkpoint: save_hf_checkpoint, molly-1.7B width, fp32"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            save_hf_checkpoint(hf_dir, params["text"], cfg.text)
            dt = time.perf_counter() - t0
            size = os.path.getsize(os.path.join(hf_dir, "model.safetensors"))
            log(f"  wrote {size / 1e9:.3f} GB in {dt:.2f} s = "
                f"{size / 1e9 / dt:.2f} GB/s; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        argv = ["--input-file", "unused", "--output-file", "unused",
                "--preset", "qwen3-1.7b", "--dna-rna-k-tokens", "1024",
                "--protein-k-tokens", "1024", "--checkpoint", hf_dir]
        with Phase("checkpoint: batch CLI --checkpoint <HF dir>, 16 greedy "
                   "tokens against the in-memory weights"):
            torch.cuda.reset_peak_memory_stats()
            args = icli.build_argparser().parse_args(argv)
            run_cfg = icli.build_config(args, text_tok.tok,
                                        *default_modality_tokenizers())
            if run_cfg != cfg:
                raise AssertionError(f"build_config with --checkpoint: "
                                     f"{run_cfg.text} against {cfg.text}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = icli._load_params(args, run_cfg, "cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"  read {size / 1e9:.3f} GB into bf16 params on the card "
                f"in {dt:.2f} s = {size / 1e9 / dt:.2f} GB/s (the encoders' "
                f"random init included)")
            assert_bit_equal("--checkpoint import", loaded["text"],
                             params["text"])
            # the encoders are left as initialised (as in the JAX CLI):
            # pair the import with phase 7's to compare tokens
            loaded = {**params, "text": loaded["text"]}
            greedy_tokens_equal("--checkpoint", run(params, "in memory"),
                                run(loaded, "--checkpoint import"))
            log(f"  peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del loaded
            release()

        with Phase("checkpoint: batch CLI --checkpoint --peft-adapter "
                   "(rank 64, seven targets), 16 greedy tokens"):
            torch.cuda.reset_peak_memory_stats()
            g = torch.Generator("cuda").manual_seed(seed + 3)
            lora = init_lora(cfg.text, LoraConfig(r=64), g, device="cuda")
            for ab in lora["layers"].values():
                ab["b"].normal_(0.0, 0.02, generator=g)
            if set(lora["layers"]) != set(LORA_TARGETS):
                raise AssertionError(f"adapter targets {sorted(lora)}")
            os.makedirs(peft_dir)
            write_safetensors(
                os.path.join(peft_dir, "adapter_model.safetensors"),
                peft_lora_to_hf_state(lora, cfg.text))
            with open(os.path.join(peft_dir, "adapter_config.json"),
                      "w") as f:
                json.dump({"r": 64, "lora_alpha": 128,
                           "target_modules": list(LORA_TARGETS)}, f)
            projectors = {}
            for name in ("dna_rna_projector", "protein_projector"):
                w = params[name]["kernel"]
                weight = torch.randn((w.shape[1], w.shape[0]), generator=g,
                                     device="cuda") * 0.02
                bias = torch.randn((w.shape[1],), generator=g,
                                   device="cuda") * 0.02
                torch.save({f"{name}.weight": weight.cpu(),
                            f"{name}.bias": bias.cpu()},
                           os.path.join(peft_dir, f"{name}.bin"))
                projectors[name] = {"kernel": weight.T.contiguous(),
                                    "bias": bias}
            args = icli.build_argparser().parse_args(
                argv + ["--peft-adapter", peft_dir])
            t0 = time.perf_counter()
            loaded = icli._load_params(args, cfg, "cuda")
            torch.cuda.synchronize()
            log(f"  HF checkpoint + PEFT adapter loaded and merged in "
                f"{time.perf_counter() - t0:.2f} s")
            merged = {**params, **projectors, "text": merge_lora(
                params["text"], lora, LoraConfig(r=64, alpha=128.0))}
            del lora
            assert_bit_equal("--peft-adapter merge", loaded["text"],
                             merged["text"])
            for name in projectors:
                assert_bit_equal("--peft-adapter projectors", loaded[name],
                                 projectors[name])
            loaded = {**params, **{k: loaded[k] for k in projectors},
                      "text": loaded["text"]}
            greedy_tokens_equal("--peft-adapter",
                                run(merged, "merged in memory"),
                                run(loaded, "--peft-adapter import"))
            log(f"  peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del loaded, merged
            release()

        with Phase("checkpoint: train CLI --text-model-path, 3 full "
                   "fine-tune steps"):
            targs = tcli.build_argparser().parse_args(
                ["--train-dataset-path", "unused", "--text-model-path",
                 hf_dir, "--seed", str(seed)])
            t0 = time.perf_counter()
            tparams = tcli.build_params(targs, train_cfg, "cuda")
            torch.cuda.synchronize()
            log(f"  build_params (import + encoders' init) in "
                f"{time.perf_counter() - t0:.2f} s")
            assert_bit_equal("--text-model-path import", tparams["text"],
                             params["text"])
            counts, state = train_main_path(
                tparams, train_cfg, inp["train_samples"],
                TrainConfig(total_steps=3), "fine-tune from "
                "--text-model-path", seed, TRAIN_KERNELS)
            add(counts)
            del state, tparams
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    release()


# depth of the MoE phases (the preset has 48 layers; only depth is ever cut)
MOE_LAYERS = 48        # generation and serving, bf16
MOE_INT8_LAYERS = 48   # generation over int8 experts
MOE_TRAIN_LAYERS = 4   # full fine-tune and QLoRA


def moe_config(layers: int, k_tokens: int):
    """qwen3-30b-a3b cut to ``layers`` of its 48, fused with nt-500m and
    esm2-650m at ``k_tokens`` a modality slot."""
    import dataclasses

    from molly_tpu_torch.models import ESM_PRESETS, QWEN3_PRESETS, \
        FusionConfig
    preset = QWEN3_PRESETS["qwen3-30b-a3b"]
    return FusionConfig(
        text=dataclasses.replace(preset, num_hidden_layers=layers),
        dna_rna=ESM_PRESETS["nt-500m"], protein=ESM_PRESETS["esm2-650m"],
        dna_rna_k_tokens=k_tokens, protein_k_tokens=k_tokens)


def moe_init(cfg, what: str, seed: int):
    """Random params of ``cfg`` from ``seed`` on the card."""
    import torch

    from molly_tpu_torch.models import QWEN3_PRESETS, fusion
    from molly_tpu_torch.utils.tree import leaves
    release()
    full = QWEN3_PRESETS["qwen3-30b-a3b"].num_hidden_layers
    with Phase(f"init qwen3-30b-a3b-width params, "
               f"{cfg.text.num_hidden_layers} of {full} layers ({what})"):
        params = fusion.init_params(
            cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n = sum(t.numel() for t in leaves(params))
    log(f"  {n / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return params


def moe_check(label, counts, needed, depth, launches):
    """Every kernel of ``needed`` launched; ``launches`` gains ``counts``;
    the grouped GEMMs' routes printed."""
    import torch

    from molly_tpu_torch.models import QWEN3_PRESETS
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    for name, n in counts.items():
        launches[name] += n
    log(f"  {label}: depth {depth} of "
        f"{QWEN3_PRESETS['qwen3-30b-a3b'].num_hidden_layers} layers, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"grouped_gemm launches {counts['grouped_gemm']} "
        f"({int8_grouped_launches()} over int8 experts, "
        f"{tma_launches()[0]} on the TMA and wgmma kernel, "
        f"{counters()['grouped_gemm'].launches_stream} on the split "
        f"stream, {counters()['grouped_gemm'].launches_int8_tma} on the "
        f"int8 TMA kernel, {counters()['grouped_gemm'].launches_tc} on "
        f"the fp32 tensor-core kernels, {grouped_off_route()} on "
        f"grouped_gemm.cu), tgmm "
        f"{counts['grouped_gemm_tgmm']} ({tma_launches()[1]} on the TMA "
        f"and wgmma kernel, "
        f"{counters()['grouped_gemm_tgmm'].launches_tc} on the fp32 "
        f"tensor-core kernel)")


def drive_moe_paths(seed: int, launches, inp):
    """Phases 13-17 (with 16a-16b): the Qwen3-MoE decoder at qwen3-30b-a3b
    width (hidden 2048, 128 experts of width 768, top-8, 32 q heads over 4
    kv heads, vocab 151,936, untied head) fused with nt-500m and esm2-650m,
    through the same entry points and requests as the molly-1.7B phases.
    ``launches`` gains each run's counts."""
    import torch

    from molly_tpu_torch.models import (QWEN3_PRESETS, GenerationConfig,
                                        qwen3)
    from molly_tpu_torch.models.lora import LoraConfig
    from molly_tpu_torch.training.trainer import TrainConfig, attach_lora

    text_tok, enc, common = inp["text_tok"], inp["enc"], inp["common"]
    preset = QWEN3_PRESETS["qwen3-30b-a3b"]
    config = moe_config

    def init(cfg, what):
        return moe_init(cfg, what, seed)

    def check(label, counts, needed, depth):
        moe_check(label, counts, needed, depth, launches)

    gen_kernels = ("grouped_gemm", "flash_attention_fwd", "rmsnorm_fwd")
    cfg = config(MOE_LAYERS, 1024)
    params = init(cfg, "generation and serving")

    label = "MoE generation, bf16 sampled"
    with Phase(f"main path {label}, 32 new tokens, {MOE_LAYERS} layers"):
        torch.cuda.reset_peak_memory_stats()
        counts = main_path(
            params, cfg, inp["samples"], text_tok,
            GenerationConfig(max_new_tokens=32, do_sample=True, **common),
            seed, label)
        check(label, counts, gen_kernels, MOE_LAYERS)
        # one prefill: gate, up and down of every layer at M >= 64 G; every
        # decode product (M = 32 < 64 G) on the split stream
        if tma_launches()[0] != 3 * MOE_LAYERS:
            raise AssertionError(f"{label}: {tma_launches()[0]} grouped "
                                 f"GEMMs on the TMA and wgmma kernel, "
                                 f"expected the prefill's {3 * MOE_LAYERS}")
        if grouped_off_route():
            raise AssertionError(f"{label}: a decode-shaped grouped GEMM "
                                 f"missed the split stream")

    label = "MoE serving, paged bf16 pages of 64, sampled"
    with Phase(f"main path {label}, {len(inp['serve_samples'])} requests, "
               f"32 new tokens, {MOE_LAYERS} layers"):
        counts = serve_main_path(
            params, cfg, inp["serve_samples"], text_tok,
            GenerationConfig(max_new_tokens=32, do_sample=True, **common),
            seed, label, enc.system_prompt_ids, n_slots=8, paged=True,
            page_size=64)
        check(label, counts, gen_kernels + ("paged_attention",), MOE_LAYERS)
        # prefill chunks at M >= 64 G on the TMA kernel, the rest (the
        # ticks, smaller chunks) on the split stream
        if grouped_off_route():
            raise AssertionError(f"{label}: a serving-shaped grouped GEMM "
                                 f"missed the split stream")
    release()

    if MOE_INT8_LAYERS != MOE_LAYERS:
        del params
        cfg = config(MOE_INT8_LAYERS, 1024)
        params = init(cfg, "generation over int8 experts")
    with Phase("quantize_for_decode(moe_experts=True), the bf16 stacks "
               "released leaf by leaf"), torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        params["text"] = qwen3.quantize_for_decode(
            params["text"], cfg.text, moe_experts=True, donate=True)
        release()
        log(f"  int8 tree {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
            f"peak while quantizing "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    label = "MoE generation, int8 experts, greedy"
    int8_gen = GenerationConfig(max_new_tokens=16, do_sample=False, **common)
    int8_records = []
    with Phase(f"main path {label}, 16 new tokens, {MOE_INT8_LAYERS} layers"):
        torch.cuda.reset_peak_memory_stats()
        with LogitTap() as int8_tap:  # the reference of phase 15b
            counts = main_path(params, cfg, inp["samples"],
                               TokenIds(text_tok), int8_gen, seed, label,
                               int8_records)
        check(label, counts, gen_kernels + ("int8_matmul",), MOE_INT8_LAYERS)
        if int8_grouped_launches() != counts["grouped_gemm"]:
            raise AssertionError(f"{label}: a grouped GEMM ran over "
                                 f"unquantized experts")
        # the prefill's fused gate-and-up and down products (M >= 64 G) run
        # on the int8 TMA kernel, every decode product on the split stream
        int8_tma = counters()["grouped_gemm"].launches_int8_tma
        if grouped_off_route() or int8_tma != 2 * MOE_INT8_LAYERS:
            raise AssertionError(f"{label}: {grouped_off_route()} grouped "
                                 f"GEMMs on grouped_gemm.cu (expected 0), "
                                 f"{int8_tma} on the int8 TMA kernel "
                                 f"(expected the prefill's "
                                 f"{2 * MOE_INT8_LAYERS})")

    # phase 15b: the offline ring over the same int8 experts
    from molly_tpu_torch.inference.cli import run_offline_ring
    label = "MoE offline ring, int8 experts, greedy"
    with Phase(f"15b. {label}, {len(inp['samples'])} requests, 8 slots, "
               f"16 new tokens, {MOE_INT8_LAYERS} layers"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats = {}
        t0 = time.perf_counter()
        recs = run_offline_ring(inp["samples"], params, cfg, int8_gen,
                                TokenIds(text_tok), io.StringIO(), n_slots=8,
                                max_length=3072, admit_group=4, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        check_flash_tma(label)
        check_int8_tma(label)
        check(label, counts, gen_kernels + ("int8_matmul",), MOE_INT8_LAYERS)
        c = counters()["grouped_gemm"]
        log(f"  {label}: {dt:.3f} s, {stats['tokens_out'] / dt:.1f} "
            f"tokens/s, {stats['ticks']} ticks, {stats['host_syncs']} host "
            f"syncs; launches {counts}")
        # one admission: the fused gate-and-up and the down product of every
        # layer on the int8 TMA kernel; every tick on the split stream
        if grouped_off_route() or c.launches_int8_tma != 2 * MOE_INT8_LAYERS \
                or not c.launches_stream:
            raise AssertionError(f"{label}: {grouped_off_route()} grouped "
                                 f"GEMMs on grouped_gemm.cu, "
                                 f"{c.launches_int8_tma} on the int8 TMA "
                                 f"kernel (expected {2 * MOE_INT8_LAYERS}), "
                                 f"{c.launches_stream} on the split stream")
        ref = ids_of(int8_records)
        near_tie_check(label, ref, ids_of(recs), int8_tap.gaps(
            ref, common["repetition_penalty"]))
    del params
    release()

    # training: the train CLI's defaults (batch 4, max length 1024, k = 128)
    train_cfg = config(MOE_TRAIN_LAYERS, 128)
    train_kernels = TRAIN_KERNELS + ("grouped_gemm", "grouped_gemm_tgmm")
    params = init(train_cfg, "training")

    # phase 15a: the HF Qwen3-MoE layout in memory, on phase 16's weights
    # before they train: per-expert keys out, stacks back in
    from molly_tpu_torch.models.hf_export import qwen3_to_hf_state
    from molly_tpu_torch.models.hf_import import qwen3_from_hf
    label = "MoE HF import"
    with Phase(f"checkpoint: {label}, qwen3_to_hf_state -> qwen3_from_hf "
               f"in memory, {MOE_TRAIN_LAYERS} layers, 16 greedy tokens"):
        t0 = time.perf_counter()
        state = qwen3_to_hf_state(params["text"], train_cfg.text)
        n_experts = sum(".mlp.experts." in k for k in state)
        text = qwen3_from_hf(state, train_cfg.text, device="cuda")
        torch.cuda.synchronize()
        del state
        log(f"  {label}: {n_experts} per-expert keys "
            f"({MOE_TRAIN_LAYERS} x {preset.num_experts} x 3) restacked in "
            f"{time.perf_counter() - t0:.2f} s; router "
            f"{text['layers']['router'].dtype}")
        if n_experts != MOE_TRAIN_LAYERS * preset.num_experts * 3:
            raise AssertionError(f"{label}: {n_experts} expert keys")
        if text["layers"]["router"].dtype != torch.float32:
            raise AssertionError(f"{label}: the router is not fp32")
        assert_bit_equal(label, text, params["text"])
        gen_cfg = config(MOE_TRAIN_LAYERS, 1024)
        gen = GenerationConfig(max_new_tokens=16, do_sample=False, **common)

        def run(run_params, what):
            def go(out):
                counts = main_path(run_params, gen_cfg, inp["samples"],
                                   TokenIds(text_tok), gen, seed,
                                   f"{label}, {what}", out)
                check(f"{label}, {what}", counts, gen_kernels,
                      MOE_TRAIN_LAYERS)
                # prefill on the TMA kernel, decode on the split stream
                if tma_launches()[0] != 3 * MOE_TRAIN_LAYERS or \
                        grouped_off_route():
                    raise AssertionError(
                        f"{label}, {what}: {tma_launches()[0]} grouped "
                        f"GEMMs on the TMA kernel (expected "
                        f"{3 * MOE_TRAIN_LAYERS}), {grouped_off_route()} on "
                        f"grouped_gemm.cu")
            return go

        greedy_tokens_equal(label, run(params, "in memory"),
                            run({**params, "text": text}, "imported"))
        del text
    release()

    label = "MoE full fine-tune"
    with Phase(f"main path training, {label}, 3 steps, {MOE_TRAIN_LAYERS} "
               f"layers"):
        counts, state = train_main_path(
            params, train_cfg, inp["train_samples"],
            TrainConfig(total_steps=3), label, seed, train_kernels)
        check(label, counts, train_kernels, MOE_TRAIN_LAYERS)
        # every expert product of a bf16 step is at M >= 64 G
        if tma_launches() != (counts["grouped_gemm"],
                              counts["grouped_gemm_tgmm"]):
            raise AssertionError(f"{label}: a grouped GEMM missed the TMA "
                                 f"and wgmma kernels: {tma_launches()}")
    del state
    release()
    # 16a: the remat policy dots on the same weights
    moe_dots_path(seed, params, train_cfg, inp, launches)
    release()

    lora_cfg = LoraConfig(r=64, alpha=64.0, dropout=0.05)
    label = "MoE QLoRA, expert adapters"
    with Phase(f"main path training, {label}, 3 steps, {MOE_TRAIN_LAYERS} "
               f"layers"):
        qparams = attach_lora(params, train_cfg, lora_cfg,
                              torch.Generator("cuda").manual_seed(seed + 1))
        if "expert_down" not in qparams["lora"]["layers"]:
            raise AssertionError(f"{label}: no adapter on the expert stacks")
        with torch.no_grad():
            qparams["text"] = qwen3.quantize_for_training(
                qparams["text"], train_cfg.text)
        del params
        release()
        counts, state = train_main_path(
            qparams, train_cfg, inp["train_samples"],
            TrainConfig(total_steps=3, lora=lora_cfg), label, seed,
            train_kernels + ("int8_matmul",))
        check(label, counts, train_kernels + ("int8_matmul",),
              MOE_TRAIN_LAYERS)
        # every int8 product (M = 32,768 >= 64 G: forward and lhs gradient)
        # on the int8 TMA kernel, every fp32 adapter product on the fp32
        # tensor-core kernels: nothing left on grouped_gemm.cu
        c = counters()["grouped_gemm"]
        fp32 = c.launches - c.launches_int8 - c.launches_tma - \
            c.launches_stream
        log(f"  {label}: {c.launches_int8} int8 grouped launches, "
            f"{c.launches_int8_tma} on the int8 TMA kernel; {fp32} fp32 "
            f"adapter launches, {c.launches_tc} on the fp32 tensor-core "
            f"kernels")
        if c.launches_int8 <= 0 or fp32 <= 0:
            raise AssertionError(f"{label}: no grouped GEMM over int8 experts "
                                 f"or fp32 adapters")
        if c.launches_int8_tma != c.launches_int8 or c.launches_tc != fp32 \
                or grouped_off_route():
            raise AssertionError(f"{label}: a grouped GEMM missed the int8 "
                                 f"TMA or fp32 tensor-core kernels "
                                 f"({grouped_off_route()} on "
                                 f"grouped_gemm.cu)")
        # every weight gradient is an fp32 adapter's (the int8 base is
        # frozen): all on the tensor-core kernel, none on grouped_gemm.cu
        t = counters()["grouped_gemm_tgmm"]
        log(f"  {label}: {t.launches} tgmm launches, {t.launches_tc} on the "
            f"fp32 tensor-core kernel, "
            f"{t.launches - t.launches_tc - t.launches_tma} left on "
            f"grouped_gemm.cu")
        if t.launches <= 0 or t.launches_tc != t.launches:
            raise AssertionError(f"{label}: a tgmm missed the fp32 "
                                 f"tensor-core kernel ({t.launches_tc} of "
                                 f"{t.launches})")
    del state, qparams
    release()
    # 16b: deeper than 4 layers, the moments offloaded to the host
    moe_offload_path(seed, inp, launches)
    release()


# ---------------------------------------------------------------------------
# the last one-device training options and the baselines
# ---------------------------------------------------------------------------

# depth of the MoE full fine-tune with the moments offloaded: the on-card
# moments' run does not fit there (phase 16b tries it); at 20 layers the
# offloaded run itself ran out of memory in its first step (51 GiB
# allocated, 20 GiB reserved by the caching allocator but unallocated)
MOE_OFFLOAD_LAYERS = 18
DOTS_GRAD_REL = 1e-2   # dots against full, of each gradient's max-abs (in
#                        practice 0: the recompute reruns the same kernels)
BASELINE_LOGIT_REL = 2e-2  # bf16 encoders, flash against plain attention,
#                            of the logits' max-abs (flash O's tolerance)
BASELINE_F32_ATOL = 1e-4   # small fp32 baseline, card against the CPU


def with_remat(cfg, policy):
    import dataclasses
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, remat=policy is not None, remat_policy=policy or "full"))


def first_batch(samples, seed):
    """The first batch ``train_loop`` hands its step (epoch 0), on the
    card."""
    from molly_tpu_torch.data import iterate_batches
    from molly_tpu_torch.data.pipeline import to_device
    return to_device("cuda")(next(iter(iterate_batches(
        samples, len(samples), shuffle=True, seed=seed, epoch=0))))


def dots_against_full(label, params, cfg, tc, batch):
    """Loss and every trainable gradient of one step on ``batch`` under
    ``dots``, ``full`` and no remat; ``dots`` must equal ``full`` bit for
    bit or within ``DOTS_GRAD_REL`` of each leaf's max (the largest
    difference is printed either way)."""
    import torch

    from molly_tpu_torch.training.trainer import (init_train_state,
                                                  make_grad_fn)
    init_train_state(params, tc)
    out = {}
    for policy in (None, "full", "dots"):
        g, m = make_grad_fn(with_remat(cfg, policy), tc)(params, batch)
        out[policy] = (g, float(m["loss"]))
    (gd, ld), (gf, lf), (gn, ln) = out["dots"], out["full"], out[None]
    for other, (go, lo) in (("full", (gf, lf)), ("no remat", (gn, ln))):
        worst, equal = 0.0, ld == lo
        for a, b in zip(gd, go):
            ref = b.float().abs().max().item()
            worst = max(worst, (a.float() - b.float()).abs().max().item()
                        / max(ref, 1e-12))
            equal = equal and torch.equal(a, b)
        log(f"  {label}: dots against {other}: loss {ld:.6f} / {lo:.6f}, "
            f"{'bit-equal' if equal else 'not bit-equal'}; largest gradient"
            f" difference {worst:.3e} of its leaf's max over {len(gd)} "
            f"leaves (tol {DOTS_GRAD_REL})")
        if other == "full" and not (worst <= DOTS_GRAD_REL and abs(
                ld - lo) <= DOTS_GRAD_REL * abs(lo)):
            raise AssertionError(f"{label}: dots disagrees with full")
    del out, gd, gf, gn


def offload_bit_equal(label, params, cfg, samples, seed):
    """3 full fine-tune steps on the card's moments and 3 with the moments
    offloaded (``make_offloaded_step``), from the same weights and batches
    in ``train_loop``'s order: every trainable leaf bit-equal after every
    step, the offloaded moments pinned on the host; s per step of both."""
    import torch

    from molly_tpu_torch.data import iterate_batches
    from molly_tpu_torch.data.pipeline import to_device
    from molly_tpu_torch.training.trainer import (TrainConfig,
                                                  _trainable_leaves,
                                                  init_train_state,
                                                  make_offloaded_step,
                                                  make_train_step,
                                                  offload_opt_state,
                                                  trainable_mask)
    dev_tc = TrainConfig(total_steps=3)
    off_tc = TrainConfig(total_steps=3, offload_opt_state=True)
    mask = trainable_mask(params, dev_tc)
    trains = {k for k in params if any(
        leaf for leaf in _leaves(mask[k]))}
    with torch.no_grad():   # the frozen encoders are shared
        ref = {k: (_clone(v) if k in trains else v)
               for k, v in params.items()}
    a = init_train_state(ref, dev_tc)
    b = offload_opt_state(init_train_state(params, off_tc))
    step_a = make_train_step(cfg, dev_tc)
    step_b = make_offloaded_step(make_train_step(cfg, off_tc), b)
    gen_a = torch.Generator("cuda").manual_seed(seed + 7)
    gen_b = torch.Generator("cuda").manual_seed(seed + 7)
    put = to_device("cuda")
    secs = {"on the card": [], "offloaded": []}
    for epoch in range(3):
        batch = put(next(iter(iterate_batches(samples, len(samples),
                                              shuffle=True, seed=seed,
                                              epoch=epoch))))
        for key, (st, step, gen) in (("on the card", (a, step_a, gen_a)),
                                     ("offloaded", (b, step_b, gen_b))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, batch, gen)
            torch.cuda.synchronize()
            secs[key].append(time.perf_counter() - t0)
            if m["skipped"]:
                raise AssertionError(f"{label}: step {epoch + 1} skipped")
        equal = all(torch.equal(x, y) for x, y in zip(
            _trainable_leaves(ref, dev_tc), _trainable_leaves(params,
                                                              off_tc)))
        log(f"  {label}: step {epoch + 1}: params "
            f"{'bit-equal' if equal else 'DIFFER'}")
        if not equal:
            raise AssertionError(f"{label}: the offloaded step differs from "
                                 f"the on-card step at step {epoch + 1}")
    moments = b.opt_state["mu"] + b.opt_state["nu"]
    if not all(t.device.type == "cpu" and t.is_pinned() for t in moments):
        raise AssertionError(f"{label}: a moment is not pinned on the host")
    n = sum(t.numel() for t in b.opt_state["mu"])
    log(f"  {label}: {len(moments)} moments ({n / 1e9:.3f} B trainable "
        f"parameters, {2 * sum(t.numel() * t.element_size() for t in b.opt_state['mu']) / 1e9:.2f} GB) pinned on the "
        f"host; s a step on the card "
        f"{' '.join(f'{x:.3f}' for x in secs['on the card'])}, offloaded "
        f"{' '.join(f'{x:.3f}' for x in secs['offloaded'])}")
    del a, b, ref, moments


def _leaves(tree):
    from molly_tpu_torch.utils.tree import leaves
    return list(leaves(tree))


def _clone(tree):
    from molly_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def remat_comparison(label, runs):
    """One line: peak memory and s a step of ``train_main_path`` runs."""
    parts = []
    for name in runs:
        r = TRAIN_RUNS.get(name)
        if r:
            parts.append(f"{name}: peak {r['peak_gib']:.2f} GiB, "
                         f"{' '.join(f'{x:.3f}' for x in r['step_s'])} s a "
                         f"step")
    log(f"  {label}: " + "; ".join(parts))


def train_leftover_paths(seed, params, train_cfg, train_samples, add):
    """Phases 9a-9b at molly-1.7B width, the train CLI's defaults (batch 4,
    max length 1024, k = 128, bf16): the full fine-tune under
    ``--gradient-checkpointing true --remat-policy dots`` (and ``full``),
    and with ``--offload-opt-state true``."""
    import torch

    from molly_tpu_torch.training.trainer import TrainConfig
    label = "full fine-tune, remat dots"
    with Phase(f"9a. main path training, {label}: one batch's gradients "
               f"against full and no remat, then 3 steps each under full "
               f"and dots"):
        dots_against_full(label, params, train_cfg, TrainConfig(),
                          first_batch(train_samples, seed))
        release()
        counts, state = train_main_path(
            params, with_remat(train_cfg, "full"), train_samples,
            TrainConfig(total_steps=3), "full fine-tune, remat full", seed,
            TRAIN_KERNELS)
        del state
        add(counts)
        release()
        counts, state = train_main_path(
            params, with_remat(train_cfg, "dots"), train_samples,
            TrainConfig(total_steps=3), label, seed, TRAIN_KERNELS)
        del state
        add(counts)
        remat_comparison("remat at molly-1.7B width", (
            "full fine-tune", "full fine-tune, remat full", label))
    release()
    label = "full fine-tune, offloaded moments"
    with Phase(f"9b. main path training, {label}, 3 steps; then 3 steps "
               f"on the card and offloaded, params compared after each"):
        counts, state = train_main_path(
            params, train_cfg, train_samples,
            TrainConfig(total_steps=3, offload_opt_state=True), label, seed,
            TRAIN_KERNELS)
        moments = state.opt_state["mu"] + state.opt_state["nu"]
        if not all(t.device.type == "cpu" and t.is_pinned()
                   for t in moments):
            raise AssertionError(f"{label}: a moment is not pinned")
        n = sum(t.numel() for t in state.opt_state["mu"])
        log(f"  {label}: {n / 1e9:.3f} B trainable parameters, moments "
            f"{2 * 2 * n / 1e9:.2f} GB off the card")
        del state, moments
        add(counts)
        remat_comparison("offload at molly-1.7B width",
                         ("full fine-tune", label))
        release()
        offload_bit_equal(label, params, train_cfg, train_samples, seed)
    release()


def moe_dots_path(seed, params, train_cfg, inp, launches):
    """Phase 16a: the MoE full fine-tune (4 layers) under ``dots``: one
    batch's gradients against full (the router's products saved beside
    the recomputed grouped GEMMs), then 3 steps."""
    from molly_tpu_torch.training.trainer import TrainConfig
    train_kernels = TRAIN_KERNELS + ("grouped_gemm", "grouped_gemm_tgmm")
    depth = train_cfg.text.num_hidden_layers
    label = "MoE full fine-tune, remat dots"
    with Phase(f"16a. main path training, {label}, {depth} layers: one "
               f"batch's gradients against full and no remat, then 3 "
               f"steps"):
        dots_against_full(label, params, train_cfg, TrainConfig(),
                          first_batch(inp["train_samples"], seed))
        release()
        counts, state = train_main_path(
            params, with_remat(train_cfg, "dots"), inp["train_samples"],
            TrainConfig(total_steps=3), label, seed, train_kernels)
        del state
        moe_check(label, counts, train_kernels, depth, launches)
        if tma_launches() != (counts["grouped_gemm"],
                              counts["grouped_gemm_tgmm"]):
            raise AssertionError(f"{label}: a grouped GEMM missed the TMA "
                                 f"and wgmma kernels: {tma_launches()}")
        remat_comparison("MoE remat", ("MoE full fine-tune", label))


def _mem_total_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def moe_offload_path(seed, inp, launches):
    """Phase 16b: the MoE full fine-tune at ``MOE_OFFLOAD_LAYERS`` of 48
    layers with the moments in pinned host memory (3 steps), then the same
    depth with the moments on the card, which must run out of memory."""
    import gc

    import torch

    from molly_tpu_torch.training.trainer import TrainConfig
    train_kernels = TRAIN_KERNELS + ("grouped_gemm", "grouped_gemm_tgmm")
    depth = MOE_OFFLOAD_LAYERS
    cfg = moe_config(depth, 128)
    params = moe_init(cfg, "training, moments offloaded", seed)
    label = "MoE full fine-tune, offloaded moments"
    with Phase(f"16b. main path training, {label}, 3 steps, {depth} "
               f"layers"):
        tc = TrainConfig(total_steps=3, offload_opt_state=True)
        n = sum(t.numel() for t in _leaves({k: v for k, v in params.items()
                                            if k not in ("dna_rna",
                                                         "protein")}))
        log(f"  {label}: host MemTotal {_mem_total_gib():.1f} GiB; "
            f"{n / 1e9:.3f} B trainable parameters, moments "
            f"{2 * 2 * n / 2**30:.2f} GiB to pin")
        counts, state = train_main_path(params, cfg, inp["train_samples"],
                                        tc, label, seed, train_kernels)
        moments = state.opt_state["mu"] + state.opt_state["nu"]
        if not all(t.device.type == "cpu" and t.is_pinned()
                   for t in moments):
            raise AssertionError(f"{label}: a moment is not pinned")
        host_stats = getattr(torch.cuda, "host_memory_stats", None)
        if host_stats is not None:
            log(f"  {label}: pinned host memory "
                f"{ {k: v for k, v in host_stats().items() if 'bytes' in k} }")
        del state, moments
        moe_check(label, counts, train_kernels, depth, launches)
        if tma_launches() != (counts["grouped_gemm"],
                              counts["grouped_gemm_tgmm"]):
            raise AssertionError(f"{label}: a grouped GEMM missed the TMA "
                                 f"and wgmma kernels: {tma_launches()}")
    gc.collect()
    release()
    with Phase(f"16b. the same depth ({depth} layers) with the moments on "
               f"the card: one step must run out of device memory"):
        fits = _try_on_card_step(params, cfg, inp["train_samples"], seed)
        gc.collect()
        release()
        log(f"  {label}: with the moments on the card, depth {depth}: "
            f"{'fits' if fits else 'out of device memory'}")
        if fits:
            raise AssertionError(f"{label}: depth {depth} fits with the "
                                 f"moments on the card; offload is not "
                                 f"what made it run")
    del params
    release()


def _try_on_card_step(params, cfg, samples, seed) -> bool:
    """One full fine-tune step with the moments on the card; False when the
    card runs out of memory (everything it made is freed on return)."""
    import torch

    from molly_tpu_torch.training.trainer import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step)
    tc = TrainConfig(total_steps=1)
    try:
        state = init_train_state(params, tc)
        make_train_step(cfg, tc)(state, first_batch(samples, seed), None)
        torch.cuda.synchronize()
        return True
    except torch.cuda.OutOfMemoryError:
        return False


def baseline_rows(seed: int, n: int, dna_len: int, prot_len: int):
    """``n`` NT+ESM classification rows made from ``seed``: a random DNA
    sequence of ``dna_len`` bases and a random protein of ``prot_len``
    residues each, binary labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    amino = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    rows = []
    for i in range(n):
        dna = "".join(rng.choice(np.array(list("ACGT")), dna_len))
        prot = "".join(rng.choice(amino, prot_len))
        rows.append({"input": f"Does <dna>{dna}</dna> encode "
                              f"<protein>{prot}</protein>?",
                     "label": "positive" if rng.random() < 0.5
                     else "negative"})
    return rows


def baseline_path(seed: int, add):
    """Phase 18: the encoder + head baseline at full width, through
    ``molly_tpu_torch.baselines.train.main``: NT+ESM (nt-500m, 24 layers,
    and esm2-650m, 33 layers, bf16), k = 1024 tokens each, batch 16 (the
    CLI's default), 5 steps on rows made from the seed (DNA for 1,023
    6-mer tokens, proteins of 1,024 residues), no eval metric (the card has
    no sklearn). Every flash launch on the TMA kernel (57 a step); one
    batch's logits against the same weights through the plain attention;
    a small fp32 NT+ESM model on the card against the CPU."""
    import tempfile

    import torch

    from molly_tpu_torch.baselines import dataset as bdata
    from molly_tpu_torch.baselines import model as bmodel
    from molly_tpu_torch.baselines import train as btrain
    from molly_tpu_torch.data import default_modality_tokenizers
    from molly_tpu_torch.data.pipeline import to_device
    from molly_tpu_torch.models import ESM_PRESETS, tiny_esm
    from molly_tpu_torch.utils.tree import tree_to

    steps, batch = 5, 16
    rows = baseline_rows(seed, steps * batch, 6 * 1023, 1024)
    label = "baseline NT+ESM"
    with Phase(f"18. main path, {label}, full width, batch {batch}, "
               f"{steps} steps"):
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        with tempfile.TemporaryDirectory() as out:
            res = btrain.main(
                ["--model-type", "NT+ESM", "--train-file", "in-memory",
                 "--output-dir", out, "--train-iters", str(steps),
                 "--batch-size", str(batch), "--seed", str(seed)],
                train_rows=rows, stats=stats)
        counts = read_counts()
        check_flash_tma(label)
        add(counts)
        fwd = counts["flash_attention_fwd"]
        log(f"  {label}: {res['steps']} steps, final loss "
            f"{res['final_loss']:.4f}, head_delta {res['head_delta']:.4e}; "
            f"s a step {' '.join(f'{x:.3f}' for x in stats['step_s'])}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"flash launches {fwd} ({fwd // max(res['steps'], 1)} a step); "
            f"launches {counts}")
        import math
        if not (res["steps"] == steps and math.isfinite(res["final_loss"])
                and res["head_delta"] > 0):
            raise AssertionError(f"{label}: bad run {res}")
        if fwd != steps * (24 + 33) or counts["flash_attention_dq"]:
            raise AssertionError(f"{label}: {fwd} flash launches, "
                                 f"{counts['flash_attention_dq']} backward "
                                 f"(expected {steps * 57} and none)")
        params = res["params"]
        cfg = bmodel.BaselineConfig(model_type="NT+ESM",
                                    nt=ESM_PRESETS["nt-500m"],
                                    protein=ESM_PRESETS["esm2-650m"])
        dna_tok, prot_tok = default_modality_tokenizers()
        ds = bdata.ClassificationDataset(rows[:batch], "NT+ESM", dna_tok,
                                         prot_tok, 1024, 1024)
        one = to_device("cuda")(bdata.collate([ds[i] for i in
                                               range(batch)]))
        with torch.no_grad():
            got = bmodel.forward_logits(params, cfg, one)
            ref = plain_logits(bmodel, params, cfg, one)
        err = (got - ref).abs().max().item()
        tol = BASELINE_LOGIT_REL * ref.abs().max().item()
        log(f"  {label}: logits [{batch}, 2] through the flash kernel "
            f"against the plain attention: max|diff| {err:.3e} (tol "
            f"{tol:.3e}, {BASELINE_LOGIT_REL} of the max)")
        if not err <= tol:
            raise AssertionError(f"{label}: flash and plain logits differ")
        del params, res, got, ref, one
    release()
    with Phase(f"18. small reference, fp32 {label}, card against the CPU"):
        nt = tiny_esm(vocab_size=dna_tok.vocab_size, hidden_size=128,
                      intermediate_size=256, num_attention_heads=2,
                      mask_token_id=2, mlp_type="swiglu", mlp_bias=False)
        prot = tiny_esm(vocab_size=prot_tok.vocab_size, hidden_size=128,
                        intermediate_size=256, num_hidden_layers=3,
                        num_attention_heads=2)
        cfg = bmodel.BaselineConfig(model_type="NT+ESM", nt=nt,
                                    protein=prot)
        cpu = bmodel.init_params(cfg, torch.Generator().manual_seed(seed))
        small = baseline_rows(seed + 1, 8, 6 * 40, 50)
        small[3]["input"] = small[3]["input"].replace("A", "", 30)
        ds = bdata.ClassificationDataset(small, "NT+ESM", dna_tok, prot_tok,
                                         64, 48)
        b = bdata.collate([ds[i] for i in range(8)])
        with torch.no_grad():
            ref = bmodel.forward_logits(cpu, cfg, to_device("cpu")(b))
            got = bmodel.forward_logits(tree_to(cpu, "cuda"), cfg,
                                        to_device("cuda")(b)).cpu()
        err = (got - ref).abs().max().item()
        log(f"  small fp32 {label}: logits card against CPU max|diff| "
            f"{err:.3e} (tol {BASELINE_F32_ATOL})")
        if not err <= BASELINE_F32_ATOL:
            raise AssertionError(f"small fp32 {label}: the card disagrees "
                                 f"with the CPU")


def plain_logits(bmodel, params, cfg, batch):
    """``forward_logits`` with the encoders' attention on the plain
    PyTorch version instead of the flash kernel."""
    from molly_tpu_torch.models import esm
    from molly_tpu_torch.ops.attention import plain_attention
    flash = esm.dot_product_attention
    esm.dot_product_attention = lambda q, k, v, **kw: plain_attention(
        q, k, v, mask=kw["mask"], causal=kw["causal"], scale=kw["scale"])
    try:
        return bmodel.forward_logits(params, cfg, batch)
    finally:
        esm.dot_product_attention = flash


# ---------------------------------------------------------------------------
# multi-device parallelism: ranks spawned on the one card
# ---------------------------------------------------------------------------

# depths of the parallel phases (only depth is cut; every width is the
# preset's): the ranks share one card and one host's cores, and every
# collective stages through host memory
PAR_TEXT_LAYERS = 4    # of qwen3-1.7b's 28 (phases 19a-19c)
PAR_ENC_LAYERS = 4     # of nt-500m's 24 and esm2-650m's 33 (19a-19d)
PAR_MOE_LAYERS = 2     # of qwen3-30b-a3b's 48 (19d)
PAR_NEW_TOKENS = 8     # greedy tokens of the sharded decode runs
# bf16, sharded against one rank: about 7x the largest differences of the
# sound runs (losses 2.89e-4, gradient norms 4.04e-4; H100, 700 W)
PAR_LOSS_RTOL = 2e-3
PAR_GNORM_RTOL = 3e-3
PAR_GLOO_TIMEOUT_S = 600
PAR_DEVICE = "cuda"    # where every parallel phase's rank computes


def par_cut(cfg, text_layers: int):
    """``cfg`` at ``text_layers`` decoder layers and PAR_ENC_LAYERS encoder
    layers a modality."""
    import dataclasses
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text,
                                      num_hidden_layers=text_layers),
        dna_rna=dataclasses.replace(cfg.dna_rna,
                                    num_hidden_layers=PAR_ENC_LAYERS),
        protein=dataclasses.replace(cfg.protein,
                                    num_hidden_layers=PAR_ENC_LAYERS))


def par_init(cfg, seed: int):
    """The same random params on every rank: drawn on the card from
    ``seed``."""
    import torch

    from molly_tpu_torch.models import fusion
    return fusion.init_params(
        cfg, torch.Generator(PAR_DEVICE).manual_seed(seed), PAR_DEVICE)


def par_local(samples, mesh):
    """This rank's rows: its (data, fsdp) shard of the samples."""
    if mesh is None:
        return samples
    from molly_tpu_torch.parallel import host_shard_range
    from molly_tpu_torch.training.cli import batch_shard
    i, n = batch_shard(mesh)
    a, b = host_shard_range(len(samples), i, n)
    return samples[a:b]


def par_measure(fn):
    """Run ``fn`` with the launch counts, the peak memory and the
    collective byte count reset; returns (its result, a dict of seconds,
    peak GiB, collective bytes and launch counts)."""
    import torch

    from molly_tpu_torch.parallel import comm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    info = {"s": time.perf_counter() - t0, "peak_gib": peak_gib(),
            "bytes": comm.bytes_moved(), "counts": read_counts()}
    return out, info


def par_train(params, cfg, tc, samples, mesh, steps, seed, label):
    """``train_loop`` (the train CLI's loop) for ``steps`` steps over this
    rank's rows of the four samples (one global batch of 4 a step)."""
    from molly_tpu_torch.training.cli import train_loop
    from molly_tpu_torch.training.trainer import init_train_state

    def run():
        state = init_train_state(params, tc)
        return train_loop(state, cfg, tc, par_local(samples, mesh),
                          batch_size=4, epochs=steps, total_steps=steps,
                          seed=seed, device=PAR_DEVICE, output_dir=None)

    res, info = par_measure(run)
    check_flash_tma(label)
    check_int8_tma(label)
    info["history"] = [{k: h[k] for k in ("loss", "grad_norm", "skipped")
                        if k in h} | {k: h[k] for k in (
                            "moe_load_balance", "moe_ep_dropped_frac")
                            if k in h} for h in res["history"]]
    info["steps"] = steps
    return info


def par_decode(params, cfg, samples, text_tok, label, tap=False):
    """Greedy ``run_batches`` of the phase-7 requests, PAR_NEW_TOKENS new
    tokens; with ``tap`` the run's own logits give each position's gap."""
    from molly_tpu_torch.inference.cli import run_batches
    from molly_tpu_torch.models import GenerationConfig
    gen = GenerationConfig(max_new_tokens=PAR_NEW_TOKENS, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=text_tok.pad_token_id or 0)
    stats = {}
    with LogitTap() as lt:
        recs, info = par_measure(lambda: run_batches(
            samples, params, cfg, gen, TokenIds(text_tok), io.StringIO(),
            batch_size=4, total=len(samples), stats=stats))
    check_flash_tma(label)
    check_int8_tma(label)
    info["rows"] = ids_of(recs)
    info["steps"] = stats.get("decode_steps", 0) + 1
    if tap:
        info["gaps"] = lt.gaps(info["rows"], gen.repetition_penalty)
    return info


def par_dense_runs(seed: int, mesh):
    """Phases 19a-19b on one rank (``mesh`` None, the reference) or on this
    rank of ``mesh``: greedy decode of the phase-7 requests, 2 full
    fine-tune steps and 2 QLoRA steps (adapters r 64, dropout 0 so that the
    runs compare) through ``train_loop``, all at molly-1.7B width cut to
    PAR_TEXT_LAYERS / PAR_ENC_LAYERS, each from the seed's weights."""
    import torch

    from molly_tpu_torch.models import qwen3
    from molly_tpu_torch.models.lora import LoraConfig
    from molly_tpu_torch.parallel import shard_params, use_mesh
    from molly_tpu_torch.training.trainer import TrainConfig, attach_lora

    base = inputs(seed)
    gcfg = par_cut(base["cfg"], PAR_TEXT_LAYERS)
    tcfg = par_cut(base["train_cfg"], PAR_TEXT_LAYERS)

    def shard(p):
        return shard_params(p, mesh) if mesh is not None else p

    out = {}
    with use_mesh(mesh):
        params = shard(par_init(gcfg, seed))
        out["decode"] = par_decode(params, gcfg, base["samples"],
                                   base["text_tok"], "19b. sharded decode",
                                   tap=mesh is None)
        del params
        release()
        params = shard(par_init(tcfg, seed))
        out["ft"] = par_train(params, tcfg, TrainConfig(total_steps=2),
                              base["train_samples"], mesh, 2, seed,
                              "19a. full fine-tune")
        del params
        release()
        lora = LoraConfig(r=64, alpha=64.0, dropout=0.0)
        params = attach_lora(par_init(tcfg, seed), tcfg, lora,
                             torch.Generator(PAR_DEVICE).manual_seed(
                                 seed + 1))
        with torch.no_grad():
            params["text"] = qwen3.quantize_for_training(params["text"],
                                                         tcfg.text)
        params = shard(params)
        out["qlora"] = par_train(params, tcfg,
                                 TrainConfig(total_steps=2, lora=lora),
                                 base["train_samples"], mesh, 2, seed,
                                 "19a. QLoRA")
        del params
        release()
    return out


def par_cp_pp_runs(seed: int, mesh, kind: str):
    """Phase 19c on this rank: one full fine-tune step of ``train_loop``
    with the decoder ring-attended over ``seq`` (zigzag) or pipelined over
    ``pipe`` (2 microbatches), molly-1.7B width cut as 19a."""
    import dataclasses

    from molly_tpu_torch.parallel import pp_param_specs, sharding, use_mesh
    from molly_tpu_torch.training.trainer import TrainConfig

    base = inputs(seed)
    tcfg = par_cut(base["train_cfg"], PAR_TEXT_LAYERS)
    tc = TrainConfig(total_steps=1)
    if kind == "seq":
        tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
            tcfg.text, context_parallel=True, context_parallel_zigzag=True))
    else:
        tc = TrainConfig(total_steps=1, pp_micro=2)
    with use_mesh(mesh):
        params = par_init(tcfg, seed)
        params = (sharding.shard_tree(params, pp_param_specs(params), mesh)
                  if kind == "pipe" else sharding.shard_params(params, mesh))
        return {kind: par_train(params, tcfg, tc, base["train_samples"],
                                mesh, 1, seed, f"19c. {kind}")}


def par_moe_runs(seed: int, mesh):
    """Phase 19d on one rank (the reference) or this rank of an expert=2
    mesh: qwen3-30b-a3b width cut to PAR_MOE_LAYERS (encoders to
    PAR_ENC_LAYERS) with ``expert_parallel``: one full fine-tune step, one
    expert-QLoRA step (adapters on the expert stacks, r 64, dropout 0), and
    greedy KV-cache decode of the phase-7 requests."""
    import dataclasses

    import torch

    from molly_tpu_torch.models import qwen3
    from molly_tpu_torch.models.lora import LoraConfig
    from molly_tpu_torch.parallel import shard_params, use_mesh
    from molly_tpu_torch.training.trainer import TrainConfig, attach_lora

    base = inputs(seed)

    def cfg_of(k_tokens):
        c = par_cut(moe_config(PAR_MOE_LAYERS, k_tokens), PAR_MOE_LAYERS)
        return dataclasses.replace(c, text=dataclasses.replace(
            c.text, expert_parallel=True))

    gcfg, tcfg = cfg_of(1024), cfg_of(128)

    def shard(p):
        return shard_params(p, mesh) if mesh is not None else p

    out = {}
    with use_mesh(mesh):
        params = shard(par_init(gcfg, seed))
        out["decode"] = par_decode(params, gcfg, base["samples"],
                                   base["text_tok"], "19d. EP decode",
                                   tap=mesh is None)
        del params
        release()
        params = shard(par_init(tcfg, seed))
        out["ft"] = par_train(params, tcfg, TrainConfig(total_steps=1),
                              base["train_samples"], mesh, 1, seed,
                              "19d. EP full fine-tune")
        del params
        release()
        lora = LoraConfig(r=64, alpha=64.0, dropout=0.0)
        params = attach_lora(par_init(tcfg, seed), tcfg, lora,
                             torch.Generator(PAR_DEVICE).manual_seed(
                                 seed + 1))
        with torch.no_grad():
            params["text"] = qwen3.quantize_for_training(params["text"],
                                                         tcfg.text)
        params = shard(params)
        out["qlora"] = par_train(params, tcfg,
                                 TrainConfig(total_steps=1, lora=lora),
                                 base["train_samples"], mesh, 1, seed,
                                 "19d. EP expert QLoRA")
        del params
        release()
    return out


def small_train_batch(seed: int):
    """The small models' training batch of phase 6 (right-padded rows,
    tri-modal segments, task labels)."""
    import torch
    g = torch.Generator().manual_seed(seed + 2)
    B, S = 4, 96
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, 80:] = 0
    mask[3, 50:] = 0
    ids = torch.randint(0, 384, (B, S), generator=g)
    labels = torch.where(mask.bool(), ids, -100)
    labels[:, :30] = -100
    return {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "dna_rna_tokens": torch.randint(6, 4102, (B, 2, 16), generator=g),
        "dna_rna_pos": torch.tensor([[2, 40], [30, -1], [-1, -1], [5, -1]]),
        "protein_tokens": torch.randint(4, 24, (B, 1, 16), generator=g),
        "protein_pos": torch.tensor([[60], [-1], [75], [25]]),
        "task_label": torch.tensor([0, 3, 100, 7]),
    }


def small_par_grads(seed: int, moe: bool, mesh, device: str):
    """Phase 19e: the small fp32 model's loss and every gradient (whole, on
    the CPU) of one full fine-tune step, on this rank of ``mesh`` (its
    rows, its blocks) or on one rank (``mesh`` None)."""
    import dataclasses

    import torch

    from molly_tpu_torch.models import fusion
    from molly_tpu_torch.parallel import (shard_batch, shard_params,
                                          sharding, use_mesh)
    from molly_tpu_torch.training.trainer import (TrainConfig,
                                                  _trainable_leaves,
                                                  init_train_state,
                                                  make_grad_fn,
                                                  trainable_paths)
    from molly_tpu_torch.utils.tree import tree_to

    cfg = small_config(moe)
    if moe:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, expert_parallel=True, ep_capacity_factor=4.0))
    params = tree_to(fusion.init_params(cfg, torch.Generator().manual_seed(
        seed)), device)
    batch = {k: t.to(device) for k, t in small_train_batch(seed).items()}
    tc = TrainConfig(learning_rate=1e-3, total_steps=5, warmup_ratio=0.0)
    with use_mesh(mesh):
        if mesh is not None:
            params = shard_params(params, mesh)
            batch = shard_batch(batch, mesh)
        state = init_train_state(params, tc)
        train = _trainable_leaves(state.params, tc)
        (grads, metrics), info = par_measure(
            lambda: make_grad_fn(cfg, tc)(state.params, batch))
        full = sharding.gather_params(
            [sharding.set_spec(g, sharding.spec_of(t))
             for g, t in zip(grads, train)], mesh)
    info.update(loss=float(metrics["loss"]),
                grads=dict(zip(trainable_paths(state.params, tc),
                               [g.detach().cpu() for g in full])))
    return info


def gloo_cuda_probe(world: int):
    """Which gloo collectives take a CUDA tensor as it is, their values
    checked (``parallel.comm`` hands them CUDA tensors)."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    t = torch.full((8 * world,), float(rank + 1), device="cuda")
    whole = float(world * (world + 1) // 2)

    def all_reduce():
        x = t.clone()
        dist.all_reduce(x)
        return bool((x == whole).all())

    def broadcast():
        x = t.clone()
        dist.broadcast(x, 0)
        return bool((x == 1).all())

    def all_gather_into_tensor():
        out = torch.empty(8 * world * world, device="cuda")
        dist.all_gather_into_tensor(out, t)
        want = torch.arange(1, world + 1, device="cuda", dtype=torch.float32
                            ).repeat_interleave(8 * world)
        return bool((out == want).all())

    def reduce_scatter_tensor():
        out = torch.empty(8, device="cuda")
        dist.reduce_scatter_tensor(out, t)
        return bool((out == whole).all())

    out = {}
    for fn in (all_reduce, broadcast, all_gather_into_tensor,
               reduce_scatter_tensor):
        try:
            right = fn()
            torch.cuda.synchronize()
            out[fn.__name__] = ("takes CUDA tensors" if right else
                                "takes CUDA tensors but gives wrong values")
        except Exception as e:  # the probe's answer, not a failure
            out[fn.__name__] = (f"refuses ({type(e).__name__}: "
                                f"{str(e)[:80]})")
    return out


def _p2p_probe_child(rank: int, root: str) -> None:
    """One of two processes of ``gloo_p2p_probe``: a ``batch_isend_irecv``
    ring of CUDA tensors over gloo; writes its answer, then leaves without
    tearing the group down (a refusal may have broken it)."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    t = torch.full((16,), float(rank + 1), device="cuda")
    buf = torch.empty_like(t)
    try:
        ops = [dist.P2POp(dist.isend, t, 1 - rank),
               dist.P2POp(dist.irecv, buf, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        answer = ("takes CUDA tensors" if bool((buf == 2 - rank).all())
                  else "takes CUDA tensors but gives wrong values")
    except Exception as e:  # the probe's answer, not a failure
        answer = f"refuses ({type(e).__name__}: {str(e)[:80]})"
    with open(os.path.join(root, f"p2p{rank}.txt"), "w") as f:
        f.write(answer)
    sys.stdout.flush()
    os._exit(0)


def gloo_p2p_probe() -> str:
    """Does gloo's point-to-point take CUDA tensors? Two processes of their
    own on cuda:0 (a refusal can abort a process from gloo's I/O thread, so
    it stays out of the phases' groups); ``parallel.comm.exchange`` stages
    through pinned host memory under gloo whatever this says."""
    import multiprocessing
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        procs = [ctx.Process(target=_p2p_probe_child, args=(r, root))
                 for r in range(2)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(120)
        answers = []
        for r, pr in enumerate(procs):
            if pr.is_alive():
                pr.kill()
                pr.join()
            path = os.path.join(root, f"p2p{r}.txt")
            answers.append(open(path).read() if os.path.exists(path) else
                           f"refuses (the process ended with exit code "
                           f"{pr.exitcode})")
    return "; ".join(f"rank {r}: {a}" for r, a in enumerate(answers))


def par_rank(rank: int, world: int, dev, job):
    """One rank of a parallel phase (spawned by ``parallel.launch``): the
    kernels were built by the parent, which this rank only loads."""
    import torch

    from molly_tpu_torch.parallel import comm, make_mesh, make_pp_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, seed = job["kind"], job["seed"]
    if kind == "pipe":
        mesh = make_pp_mesh(pipe=world)
    else:
        mesh = make_mesh(**job["mesh"])
    out = {"backend": comm.describe_backend(dev), "mesh": dict(mesh.shape)}
    if kind == "dense":
        out.update(par_dense_runs(seed, mesh))
    elif kind in ("seq", "pipe"):
        out.update(par_cp_pp_runs(seed, mesh, kind))
    elif kind == "moe":
        out.update(par_moe_runs(seed, mesh))
    elif kind == "small":
        out.update(small=small_par_grads(seed, job["moe"], mesh,
                                         PAR_DEVICE))
        out["probe"] = gloo_cuda_probe(world)
    return out


def par_spawn(label: str, world: int, job):
    """Spawn ``world`` ranks on cuda:0 (gloo) for ``job``; every rank must
    exit 0. Prints the backend."""
    from molly_tpu_torch.parallel.launch import run_ranks
    release()
    outs = run_ranks(par_rank, world, (job,), device=PAR_DEVICE,
                     timeout_s=PAR_GLOO_TIMEOUT_S)
    log(f"  {label}: {world} ranks on {PAR_DEVICE}, mesh {outs[0]['mesh']}, "
        f"backend: {outs[0]['backend']}")
    return outs


def par_report(label: str, outs, key: str, launches, needed=()):
    """Print each rank's seconds, peak memory and collective bytes a step of
    run ``key``; the launches of all ranks go to ``launches`` (every
    kernel of ``needed`` launched on every rank)."""
    for r, o in enumerate(outs):
        info = o[key]
        steps = max(info.get("steps", 1), 1)
        log(f"  {label}, rank {r}: {info['s']:.2f} s, peak device memory "
            f"{info['peak_gib']:.2f} GiB, collectives "
            f"{info['bytes'] / steps / 1e6:.1f} MB a step ({steps} steps); "
            f"launches {info['counts']}")
        for name in needed:
            if info["counts"][name] <= 0:
                raise AssertionError(f"{label}: rank {r} never launched "
                                     f"{name}")
        for name, n in info["counts"].items():
            launches[name] += n


def par_losses_close(label, ref, outs, key):
    """Every rank's step losses within PAR_LOSS_RTOL and gradient norms
    within PAR_GNORM_RTOL of the one-rank run's (printed): the norm is what
    a missing or doubled reduction over the batch or tensor axes, or a
    block counted more than once, would move (the losses of two steps at
    the trainer's learning rate barely see the update)."""
    want = [h["loss"] for h in ref[key]["history"]]
    want_gn = [h["grad_norm"] for h in ref[key]["history"]]
    for r, o in enumerate(outs):
        got = [h["loss"] for h in o[key]["history"]]
        got_gn = [h["grad_norm"] for h in o[key]["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        rel_gn = max(abs(a - b) / abs(b) for a, b in zip(got_gn, want_gn))
        extra = ""
        if "moe_ep_dropped_frac" in o[key]["history"][0]:
            extra = (", moe_ep_dropped_frac " + ", ".join(
                f"{h['moe_ep_dropped_frac']:.4f}" for h in o[key]["history"])
                + ", moe_load_balance " + ", ".join(
                f"{h['moe_load_balance']:.4f}" for h in o[key]["history"]))
        log(f"  {label}, rank {r}: losses "
            f"{', '.join(f'{x:.5f}' for x in got)} against one rank's "
            f"{', '.join(f'{x:.5f}' for x in want)} (largest relative "
            f"difference {rel:.2e}, tol {PAR_LOSS_RTOL}); gradient norms "
            f"{', '.join(f'{x:.5f}' for x in got_gn)} against "
            f"{', '.join(f'{x:.5f}' for x in want_gn)} (largest relative "
            f"difference {rel_gn:.2e}, tol {PAR_GNORM_RTOL}){extra}")
        if len(got) != len(want) or rel > PAR_LOSS_RTOL or \
                rel_gn > PAR_GNORM_RTOL or any(
                    h["skipped"] for h in o[key]["history"]):
            raise AssertionError(f"{label}: rank {r} disagrees with the "
                                 f"one-rank run")


def parallel_paths(seed: int, launches):
    """Phases 19a-19e: the multi-device paths in ranks spawned on the one
    card (gloo), each against the one-rank run of the same
    seed's weights on the card."""
    from molly_tpu_torch.models import QWEN3_PRESETS
    full = QWEN3_PRESETS["qwen3-1.7b"].num_hidden_layers
    cuts = (f"depth cut: qwen3-1.7b {PAR_TEXT_LAYERS} of {full} layers, "
            f"nt-500m and esm2-650m {PAR_ENC_LAYERS} layers each")
    with Phase(f"19a-19b reference: one rank on the card ({cuts})"):
        ref = par_dense_runs(seed, None)
    release()
    with Phase(f"19a-19b. fsdp=2, tensor=2 (4 ranks): greedy decode, 2 full "
               f"fine-tune and 2 QLoRA steps ({cuts})"):
        outs = par_spawn("19a-19b", 4, {"kind": "dense", "seed": seed,
                                        "mesh": dict(fsdp=2, tensor=2)})
        for r, o in enumerate(outs):
            near_tie_check(f"19b. sharded decode, rank {r}",
                           ref["decode"]["rows"], o["decode"]["rows"],
                           ref["decode"]["gaps"])
        par_report("19b. sharded decode", outs, "decode", launches,
                   ("flash_attention_fwd", "rmsnorm_fwd"))
        par_losses_close("19a. full fine-tune", ref, outs, "ft")
        par_report("19a. full fine-tune", outs, "ft", launches,
                   TRAIN_KERNELS)
        par_losses_close("19a. QLoRA", ref, outs, "qlora")
        par_report("19a. QLoRA", outs, "qlora", launches,
                   TRAIN_KERNELS + ("int8_matmul",))
    for kind, label in (("seq", "seq=2, zigzag ring attention"),
                        ("pipe", "pipe=2, 2 microbatches")):
        with Phase(f"19c. {label} (2 ranks): one full fine-tune step "
                   f"({cuts})"):
            outs = par_spawn(f"19c. {kind}", 2, {
                "kind": kind, "seed": seed, "mesh": dict(seq=2, fsdp=1)})
            one = {kind: {"history": ref["ft"]["history"][:1]}}
            par_losses_close(f"19c. {kind}", one, outs, kind)
            # the decoder's attention is the ring's plain chunks under seq;
            # the frozen encoders' flash forward runs under both
            par_report(f"19c. {kind}", outs, kind, launches,
                       TRAIN_KERNELS if kind == "pipe" else
                       ("flash_attention_fwd", "rmsnorm_fwd", "rmsnorm_bwd"))
    moe_full = QWEN3_PRESETS["qwen3-30b-a3b"].num_hidden_layers
    mcuts = (f"depth cut: qwen3-30b-a3b {PAR_MOE_LAYERS} of {moe_full} "
             f"layers, encoders {PAR_ENC_LAYERS} layers each")
    with Phase(f"19d reference: one rank on the card ({mcuts})"):
        mref = par_moe_runs(seed, None)
    release()
    with Phase(f"19d. expert=2 (2 ranks): greedy KV-cache decode, one full "
               f"fine-tune and one expert-QLoRA step ({mcuts})"):
        outs = par_spawn("19d", 2, {"kind": "moe", "seed": seed,
                                    "mesh": dict(fsdp=1, expert=2)})
        for r, o in enumerate(outs):
            near_tie_check(f"19d. EP decode, rank {r}",
                           mref["decode"]["rows"], o["decode"]["rows"],
                           mref["decode"]["gaps"])
        par_report("19d. EP decode", outs, "decode", launches,
                   ("grouped_gemm",))
        par_losses_close("19d. EP full fine-tune", mref, outs, "ft")
        par_report("19d. EP full fine-tune", outs, "ft", launches,
                   ("grouped_gemm", "grouped_gemm_tgmm"))
        par_losses_close("19d. EP expert QLoRA", mref, outs, "qlora")
        par_report("19d. EP expert QLoRA", outs, "qlora", launches,
                   ("grouped_gemm", "grouped_gemm_tgmm"))
    for moe, world, mesh in ((False, 4, dict(fsdp=2, tensor=2)),
                             (True, 2, dict(fsdp=1, expert=2))):
        name = "MoE " if moe else ""
        with Phase(f"19e. small {name}fp32 model, {mesh} ({world} ranks) "
                   f"on the card against one rank on the CPU"):
            cpu = small_par_grads(seed, moe, None, "cpu")
            outs = par_spawn(f"19e. small {name}model", world, {
                "kind": "small", "seed": seed, "moe": moe, "mesh": mesh})
            for r, o in enumerate(outs):
                got = o["small"]
                dloss = abs(got["loss"] - cpu["loss"])
                worst = max(
                    (got["grads"][p] - g).abs().max().item()
                    / max(g.abs().max().item(), 1e-12)
                    for p, g in cpu["grads"].items())
                log(f"  19e. small {name}model, rank {r}: |dloss| "
                    f"{dloss:.3e} (tol {TRAIN_LOSS_ATOL}), worst gradient "
                    f"error {worst:.3e} of its max (tol {TRAIN_GRAD_REL}) "
                    f"over {len(cpu['grads'])} leaves")
                if dloss > TRAIN_LOSS_ATOL or worst > TRAIN_GRAD_REL or \
                        set(got["grads"]) != set(cpu["grads"]):
                    raise AssertionError(f"19e. small {name}model: rank {r} "
                                         f"disagrees with the CPU")
            if not moe:
                log(f"  gloo with CUDA tensors: {outs[0]['probe']}; "
                    f"batch_isend_irecv (two processes of its own): "
                    f"{gloo_p2p_probe()}")
                for name in ("all_reduce", "broadcast",
                             "all_gather_into_tensor",
                             "reduce_scatter_tensor"):
                    if outs[0]["probe"][name] != "takes CUDA tensors":
                        raise AssertionError(
                            f"gloo {name} does not take CUDA tensors: "
                            f"parallel.comm hands them to it unstaged")


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from molly_tpu_torch.ops import _cuda_build

    with Phase(f"build ({len(_cuda_build.SOURCES)} CUDA sources, nvcc "
               f"in parallel)"):
        _cuda_build.build()

    g = torch.Generator("cuda").manual_seed(args.seed)
    parity = {}
    with Phase("parity flash_attention_fwd"):
        parity_flash(g, parity)
    with Phase("parity flash_attention_dq, flash_attention_dkv"):
        parity_flash_bwd(g, parity)
    with Phase("parity rmsnorm_fwd, rmsnorm_bwd"):
        parity_rmsnorm(g, parity)
    with Phase("parity int8_matmul"):
        parity_int8(g, parity)
    with Phase("parity paged_attention, paged_attention_int8"):
        parity_paged(g, parity)
    with Phase("parity grouped_gemm, grouped_gemm_tgmm"):
        parity_grouped_gemm(g, parity)
    with Phase("small reference, generation"):
        small_reference(args.seed)
    with Phase("4b. small reference, speculative decoding (int8 self-draft "
               "k = 1, 3, 4; lookup k = 8, n = 3), card and CPU"):
        small_reference_speculative(args.seed)
    with Phase("small reference, serving"):
        small_reference_serving(args.seed)
    with Phase("5b. small reference, offline ring (12 requests, 4 slots, "
               "groups of 2), card and CPU"):
        small_reference_ring(args.seed)
    with Phase("5c. small reference, HTTP API over int8 pages with a "
               "two-adapter bank"):
        small_reference_api(args.seed)
    with Phase("small reference, training"):
        small_reference_training(args.seed)
    with Phase("small MoE reference, generation, serving, training"):
        small_reference(args.seed, moe=True)
        small_reference_serving(args.seed, moe=True)
        small_reference_training(args.seed, moe=True)

    launches = drive_main_paths(args.seed, args.profile_dir)

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    baseline_path(args.seed, add)
    parallel_paths(args.seed, launches)

    kernels = []
    for name in REPLACES:
        cases = parity[name]
        route, source = SOURCES[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
            "bound_ms": cases[0]["bound_ms"],
            "bound_by": cases[0]["bound_by"],
            "library_ms": cases[0]["library_ms"], "cases": cases})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the third full "
                         "fine-tune step here (trace.json, "
                         "key_averages.txt)")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
