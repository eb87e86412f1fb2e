"""Training entry point, the counterpart of ``molly_tpu/training/cli.py``.

Flow: tokenizers (+9 omics specials) -> model config + random params ->
datasets -> freeze / LoRA regime -> train loop with periodic eval, early
stopping, checkpointing, per-task domain losses and JSONL metric logging.

Usage:
  python -m molly_tpu_torch.training.cli --train-dataset-path train.parquet \
      [--eval-dataset-path eval.parquet] [--tiny] [--device cpu] ...
  torchrun --nproc-per-node N -m molly_tpu_torch.training.cli ... \
      --mesh-fsdp 2 --mesh-tensor 2 ...

The flags and defaults are the JAX CLI's, plus ``--device``. Several ranks
(``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)
build the mesh from the mesh flags as the JAX CLI does: ``--mesh-data``,
``--mesh-dcn-data``, ``--mesh-fsdp``, ``--mesh-tensor``, ``--mesh-seq``
(``--cp-zigzag``), ``--mesh-expert`` on the 5-axis mesh, or ``--mesh-pipe``
(``--pp-microbatches``) on a (pipe, data) mesh. Each rank holds its blocks
of the params and moments (``parallel.shard_params``) and reads its rows:
the dataset is split over the (data, fsdp) coordinate, not the rank, so
ranks that differ only on tensor, seq, expert or pipe read the same rows.
Checkpoints keep the port's format: rank 0 writes the gathered state, and a
resume cuts each rank's blocks from it. One process is the one-device run,
unchanged. ``--offload-opt-state
true`` keeps the Adam moments in pinned host memory and streams them
through the card during each update (``trainer.make_offloaded_step``).
``--text-model-path``,
``--dna-rna-model-path`` and ``--protein-model-path`` are HF checkpoint
directories imported by ``models.hf_import`` (``build_params``) unless
``--no-load-pretrained`` or ``--tiny`` is given.
``--moe-experts`` / ``--moe-topk`` turn the text decoder into a sparse MoE
(as does an MoE ``--text-preset``); its ``moe_load_balance`` is logged. The loop itself is
``train_loop``, which takes datasets or in-memory lists of encoded samples
(``OmicsSampleEncoder.encode_train`` rows), so a caller without pandas can
drive it; ``run_training`` builds the datasets and calls it.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in {"true", "t", "1", "yes", "y"}:
        return True
    if v.lower() in {"false", "f", "0", "no", "n"}:
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molly_tpu_torch train")
    # experiment / logging
    p.add_argument("--experiment-name", default="molly_tpu")
    p.add_argument("--report-to", default="jsonl",
                   help="comma list of metric sinks: jsonl,wandb,swanlab,"
                        "tensorboard (missing libs degrade to a warning)")
    p.add_argument("--output-dir", default="runs/molly")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    # model
    p.add_argument("--text-model-path", default=None)
    p.add_argument("--dna-rna-model-path", default=None)
    p.add_argument("--protein-model-path", default=None)
    p.add_argument("--text-preset", default="qwen3-1.7b")
    p.add_argument("--dna-rna-preset", default="nt-500m")
    p.add_argument("--protein-preset", default="esm2-650m")
    p.add_argument("--no-load-pretrained", action="store_true",
                   help="random init (smoke runs)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model (CI smoke)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="override the text config to a MoE decoder with "
                        "this many experts (0 keeps the preset)")
    p.add_argument("--moe-topk", type=int, default=2,
                   help="experts per token under --moe-experts")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--gradient-checkpointing", type=str2bool, default=False)
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "dots", "attn", "hot"],
                   help="with --gradient-checkpointing: 'full' recomputes "
                        "each layer; 'dots' saves every matrix product's "
                        "output and recomputes the rest; 'attn' / 'hot' "
                        "recompute the parts before and after attention and "
                        "never re-run flash attention")
    p.add_argument("--remat-skip-layers", type=int, default=0,
                   help="segmented remat: first N layers skip "
                        "checkpointing entirely")
    p.add_argument("--offload-opt-state", type=str2bool, default=False,
                   help="keep the Adam moments in pinned host memory "
                        "between steps and stream them through the card "
                        "during the update (DeepSpeed's optimizer offload)")
    # data
    p.add_argument("--train-dataset-path", required=True)
    p.add_argument("--eval-dataset-path", default=None)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--eval-max-len", type=int, default=1024)
    p.add_argument("--dna-rna-k-tokens", type=int, default=128)
    p.add_argument("--protein-k-tokens", type=int, default=128)
    p.add_argument("--max-dna-rna-segments", type=int, default=4)
    p.add_argument("--max-protein-segments", type=int, default=4)
    p.add_argument("--strict-segments", type=str2bool, default=False,
                   help="error on segment-slot overflow / truncation "
                        "straddle instead of degrading loudly")
    p.add_argument("--read-nums", type=int, default=None)
    p.add_argument("--eval-read-nums", type=int, default=None)
    p.add_argument("--mode", default="sft", choices=["sft", "pretrain"])
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="background-thread batch prefetch depth "
                        "(0 disables; 2 double-buffers)")
    p.add_argument("--streaming", type=str2bool, default=False,
                   help="stream the train parquet by row group instead of "
                        "loading it into memory")
    p.add_argument("--cache-dataset", type=str2bool, default=True,
                   help="tokenize each sample once and replay from memory "
                        "across epochs")
    # optimization
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--train-iters", type=int, default=None,
                   help="cap total optimizer steps")
    p.add_argument("--batch-size-per-gpu", type=int, default=4,
                   help="global microbatch size (name kept for parity)")
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=float, default=0.03,
                   help="warmup ratio")
    p.add_argument("--lr-decay-style", default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip-grad-max-norm", type=float, default=1.0)
    p.add_argument("--z-loss", type=float, default=0.0)
    # freeze / LoRA
    p.add_argument("--train-bio", type=str2bool, default=False)
    p.add_argument("--train-mlp", type=str2bool, default=True)
    p.add_argument("--train-llm", type=str2bool, default=True)
    p.add_argument("--use-lora", type=str2bool, default=False)
    p.add_argument("--lora-r", type=int, default=64)
    p.add_argument("--lora-alpha", type=float, default=64.0)
    p.add_argument("--lora-dropout", type=float, default=0.05)
    p.add_argument("--qlora", type=str2bool, default=False,
                   help="with --use-lora: int8-quantize the FROZEN text "
                        "base (qwen3.quantize_for_training); adapters stay "
                        "fp32")
    # eval / save
    p.add_argument("--eval-interval", type=int, default=200)
    p.add_argument("--save-interval", type=int, default=500)
    p.add_argument("--save-total-limit", type=int, default=3)
    p.add_argument("--early-stopping-patience", type=int, default=3)
    p.add_argument("--compute-domain-losses", type=str2bool, default=False)
    p.add_argument("--profile-log-dir", default=None,
                   help="torch.profiler trace output dir (step 3 is traced)")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint dir (this package's format) to resume "
                        "the train state from")
    p.add_argument("--init-from", default=None,
                   help="checkpoint dir (this package's format) to "
                        "warm-start PARAMS from (optimizer/step start "
                        "fresh; applied BEFORE --use-lora/--qlora)")
    # parallelism (several ranks: torchrun)
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-dcn-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1)
    p.add_argument("--cp-zigzag", type=str2bool, default=False)
    p.add_argument("--mesh-pipe", type=int, default=1)
    p.add_argument("--pp-microbatches", type=int, default=2)
    p.add_argument("--mesh-expert", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only on "
                        "request)")
    return p


def build_mesh(args):
    """The mesh of the mesh flags over the running process group (JAX
    ``cli.py:364-382``): a (pipe, data) mesh under ``--mesh-pipe``, else the
    5-axis one."""
    import torch.distributed as dist

    from ..parallel import make_mesh
    if args.mesh_pipe > 1:
        from ..parallel import make_pp_mesh
        assert args.mesh_tensor == 1 and args.mesh_seq == 1, (
            "--mesh-pipe uses a (pipe, data) mesh; tensor/seq axes "
            "compose with the fsdp mesh instead")
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        return make_pp_mesh(pipe=args.mesh_pipe,
                            data=n_dev // args.mesh_pipe)
    return make_mesh(data=args.mesh_data, fsdp=args.mesh_fsdp,
                     tensor=args.mesh_tensor, seq=args.mesh_seq,
                     expert=args.mesh_expert, dcn_data=args.mesh_dcn_data)


def batch_shard(mesh):
    """(index, count) of this rank's rows: its coordinate over the axes
    that split the batch (data and fsdp; data on a pipeline mesh)."""
    axes = tuple(a for a in ("data", "fsdp") if a in mesh.shape)
    if mesh.coords is None:
        return 0, 1
    return mesh.index(*axes), mesh.size(*axes)


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    run_training(args)


def build_params(args, cfg, device):
    """The params a run starts from: ``--text-model-path``,
    ``--dna-rna-model-path`` and ``--protein-model-path`` imported from their
    HF directories in the model dtype (unless ``--no-load-pretrained`` or
    ``--tiny``), everything else random from ``--seed``."""
    import torch

    from ..models import fusion
    loaded = {}
    if not args.no_load_pretrained and not args.tiny:
        from ..models.hf_import import esm_from_hf, load_hf_state, \
            qwen3_from_hf
        if args.text_model_path:
            loaded["text"] = qwen3_from_hf(
                load_hf_state(args.text_model_path), cfg.text, device=device)
        for name, path in (("dna_rna", args.dna_rna_model_path),
                           ("protein", args.protein_model_path)):
            if path:
                loaded[name] = esm_from_hf(load_hf_state(path),
                                           getattr(cfg, name), device=device)
    return fusion.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device,
        given=loaded)


def train_loop(state, cfg, tc, train_data, *, eval_data=None,
               batch_size: int = 4, epochs: int = 1,
               total_steps: Optional[int] = None, seed: int = 42,
               device=None, logger=None, log_interval: int = 10,
               eval_interval: int = 200, save_interval: int = 500,
               save_total_limit: int = 3, early_stopping_patience: int = 3,
               compute_domain_losses: bool = False,
               output_dir: Optional[str] = None,
               profile_log_dir: Optional[str] = None,
               prefetch_depth: int = 2,
               stats: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The train loop: logging, eval, early stopping, save rotation and the
    SIGTERM checkpoint around ``make_train_step``.

    ``train_data`` / ``eval_data``: a dataset (``OmicsDataset``, a
    streaming one) or an in-memory list of encoded samples. ``batch_size``
    is the per-step row count BEFORE accumulation (the step sees
    ``batch_size * tc.accum_steps`` rows). ``output_dir`` None disables
    checkpoints. ``stats`` collects seconds per phase (see
    ``make_train_step``; with ``tc.offload_opt_state`` also the offloaded
    update's copy seconds and bytes, ``make_offloaded_step``). With
    ``tc.offload_opt_state`` the state's moments are moved to host memory
    first (``offload_opt_state``: a restored state is re-placed too).
    Returns the summary dict of the JAX CLI plus ``state`` and
    ``history`` (per step: loss, grad_norm, skipped, tokens, seconds, an MoE
    decoder's moe_load_balance (and moe_ep_dropped_frac under expert
    parallelism), and with ``stats`` the step's phase seconds).

    Under a mesh (``parallel.use_mesh``, ``state`` of blocks) ``batch_size``
    stays the GLOBAL row count and ``train_data`` / ``eval_data`` are this
    rank's shard: each step reads ``batch_size * accum / (data * fsdp)``
    rows; the metrics are the global batch's, eval losses are summed over
    the ranks, and rank 0 writes the gathered checkpoints."""
    import signal

    import numpy as np
    import torch

    from ..data import iterate_batches
    from ..data.pipeline import input_pipeline, to_device
    from ..parallel import comm
    from ..utils import domain_loss_metrics, print_rank_0
    from ..utils.profiling import StepTimer, trace
    from . import checkpoint as ckpt_lib
    from .trainer import (make_eval_loss, make_offloaded_step,
                          make_train_step, offload_opt_state)

    device = torch.device(device or state.params["text"]["embed"].device)
    put_batch = to_device(device)
    step_fn = make_train_step(cfg, tc, stats)
    eval_loss = make_eval_loss(cfg, tc)
    if tc.offload_opt_state:
        state = offload_opt_state(state)  # also re-places restores
        step_fn = make_offloaded_step(step_fn, state, stats)
    micro = batch_size * tc.accum_steps
    mesh = comm.current_mesh()
    if mesh is not None:
        n_shard = batch_shard(mesh)[1]
        assert micro % n_shard == 0, (
            f"global microbatch {micro} must divide over data*fsdp="
            f"{n_shard}")
        micro //= n_shard  # the rows THIS rank feeds a step
    if total_steps is None:
        total_steps = max((len(train_data) // max(1, micro)) * epochs, 1)

    # preemption handling: SIGTERM requests a checkpoint at the next step
    # boundary
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous = None  # non-main thread (tests)

    def run_eval() -> float:
        losses = []
        with torch.no_grad():
            for eb in iterate_batches(eval_data, micro, drop_last=True):
                losses.append(float(eval_loss(state.params,
                                              put_batch(eb))))
        return float(np.mean(losses)) if losses else float("nan")

    best_eval, bad_evals = float("inf"), 0
    saved, history, seen = [], [], {}
    step = 0
    metrics = None  # stays None if no step runs (tiny dataset/epochs=0)
    timer = StepTimer()
    t_start = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(seed + 7)
    stop = False
    try:
        for epoch in range(epochs):
            if stop:
                break
            # tokenize/collate the NEXT batch on a background thread while
            # the device runs the CURRENT step, and issue batch i+1's
            # device transfer before blocking on step i
            batches = input_pipeline(
                train_data, micro, shuffle=True, seed=seed, epoch=epoch,
                put=put_batch, depth=prefetch_depth) if prefetch_depth else (
                put_batch(b) for b in iterate_batches(
                    train_data, micro, shuffle=True, seed=seed, epoch=epoch))
            for batch in batches:
                timer.start()
                with trace(profile_log_dir if step == 2 else None):
                    state, metrics = step_fn(state, batch, generator)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                seconds = timer.stop()
                step += 1
                history.append({
                    "step": step, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "skipped": bool(metrics["skipped"]),
                    "tokens": int(metrics["tokens"]), "seconds": seconds})
                for mk in ("moe_load_balance", "moe_ep_dropped_frac"):
                    if mk in metrics:
                        history[-1][mk] = float(metrics[mk])
                if stats is not None:  # this step's share of each phase
                    history[-1]["phases"] = {
                        k: v - seen.get(k, 0.0) for k, v in stats.items()}
                    seen = dict(stats)
                if logger is not None and step % log_interval == 0:
                    record = {"loss": metrics["loss"],
                              "grad_norm": metrics["grad_norm"],
                              "learning_rate": metrics["learning_rate"],
                              "epoch": epoch}
                    for mk in ("moe_load_balance", "moe_ep_dropped_frac"):
                        if mk in metrics:
                            record[mk] = metrics[mk]
                    if compute_domain_losses:
                        record.update(domain_loss_metrics(
                            {k: v.cpu().numpy() for k, v in metrics.items()
                             if k.startswith("domain_loss")}))
                    logger.log(step, record)
                if eval_data is not None and step % eval_interval == 0:
                    el = run_eval()
                    if logger is not None:
                        logger.log(step, {"eval_loss": el})
                    if el < best_eval:
                        best_eval, bad_evals = el, 0
                    else:
                        bad_evals += 1
                        if bad_evals >= early_stopping_patience:
                            print_rank_0(
                                f"early stopping at step {step} "
                                f"(best eval {best_eval:.4f})")
                            stop = True
                            break
                if output_dir and (step % save_interval == 0
                                   or step == total_steps):
                    path = os.path.join(output_dir, f"ckpt_{step}")
                    ckpt_lib.save_train_state(path, state)
                    ckpt_lib.export_adapter(
                        os.path.join(output_dir, f"adapter_{step}.npz"),
                        state.params, lora_cfg=tc.lora)
                    saved.append(path)
                    while len(saved) > save_total_limit:
                        old = saved.pop(0)
                        import shutil
                        ckpt_lib.wait_for_saves()
                        shutil.rmtree(old, ignore_errors=True)
                if preempted["flag"] and output_dir:
                    path = os.path.join(output_dir, "ckpt_preempt")
                    ckpt_lib.save_train_state(path, state, wait=True)
                    print_rank_0(f"SIGTERM: saved {path}; exiting")
                    stop = True
                    break
                if step >= total_steps:
                    stop = True
                    break
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)

    ckpt_lib.wait_for_saves()
    wall = time.perf_counter() - t_start
    if metrics is None:
        raise SystemExit(
            "no training step executed: dataset yielded zero batches "
            f"(len(train)={len(train_data)}, batch-size={batch_size} "
            f"x accum={tc.accum_steps}, epochs={epochs}) — "
            "reduce batch size / accumulation or add data")
    final_loss = float(metrics["loss"])
    print_rank_0(f"done: {step} steps in {wall:.1f}s "
                 f"(final loss {final_loss:.4f}) "
                 f"timing={timer.summary()}")
    return {"steps": step, "final_loss": final_loss, "best_eval": best_eval,
            "wall_seconds": wall, "step_timing": timer.summary(),
            "history": history, "state": state}


def run_training(args) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from ..data import (DataConfig, OmicsDataset,
                        default_modality_tokenizers, load_text_tokenizer)
    from ..models import (ESM_PRESETS, QWEN3_PRESETS, FusionConfig, qwen3,
                          tiny_esm, tiny_qwen3)
    from ..models.lora import LoraConfig
    from ..utils import MetricLogger, print_rank_0, time_count
    from ..utils.tree import leaves
    from . import checkpoint as ckpt_lib
    from .trainer import TrainConfig, attach_lora, init_train_state

    from ..parallel import initialize_distributed, shard_params, use_mesh
    from ..parallel.sharding import local_device
    np.random.seed(args.seed)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to train "
                         "on the CPU")
    device = local_device(args.device)
    initialize_distributed(device=device)
    mesh = build_mesh(args)
    multi = mesh.devices.size > 1
    if device.type == "cuda":
        torch.cuda.set_device(device)

    # ---- tokenizers ----
    text_tok = load_text_tokenizer(args.text_model_path)
    dna_tok, prot_tok = default_modality_tokenizers()

    # ---- model config + params ----
    remat = dict(remat=args.gradient_checkpointing,
                 remat_policy=args.remat_policy,
                 remat_skip_layers=args.remat_skip_layers)
    if args.tiny:
        text_cfg = tiny_qwen3(
            vocab_size=-(-text_tok.vocab_size // 128) * 128,
            dtype=args.dtype, **remat)
        dna_cfg = tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                           dtype=args.dtype)
        prot_cfg = tiny_esm(vocab_size=prot_tok.vocab_size,
                            mask_token_id=prot_tok.mask_id, dtype=args.dtype)
    else:
        text_cfg = dataclasses.replace(
            QWEN3_PRESETS[args.text_preset], dtype=args.dtype, **remat)
        dna_cfg = dataclasses.replace(ESM_PRESETS[args.dna_rna_preset],
                                      dtype=args.dtype)
        prot_cfg = dataclasses.replace(ESM_PRESETS[args.protein_preset],
                                       dtype=args.dtype)
    if args.moe_experts:
        text_cfg = dataclasses.replace(
            text_cfg, num_experts=args.moe_experts,
            num_experts_per_tok=args.moe_topk)
    if args.mesh_expert > 1:
        # the experts stay on their ranks (never gathered)
        text_cfg = dataclasses.replace(text_cfg, expert_parallel=True)
    if args.mesh_seq > 1:
        div = args.mesh_seq * (2 if args.cp_zigzag else 1)
        assert args.max_len % div == 0, (
            f"--max-len {args.max_len} must divide over "
            f"{div} (--mesh-seq{' x2 zigzag' if args.cp_zigzag else ''})")
        text_cfg = dataclasses.replace(
            text_cfg, context_parallel=True,
            context_parallel_zigzag=args.cp_zigzag)
    cfg = FusionConfig(text=text_cfg, dna_rna=dna_cfg, protein=prot_cfg,
                       dna_rna_k_tokens=args.dna_rna_k_tokens,
                       protein_k_tokens=args.protein_k_tokens)

    with time_count("init params"):
        params = build_params(args, cfg, device)
    n_params = sum(t.numel() for t in leaves(params))
    print_rank_0(f"Total parameters: {n_params:,}")

    # ---- datasets ----
    dconf = DataConfig(max_len=args.max_len, mode=args.mode,
                       dna_rna_k_tokens=args.dna_rna_k_tokens,
                       protein_k_tokens=args.protein_k_tokens,
                       max_dna_rna_segments=args.max_dna_rna_segments,
                       max_protein_segments=args.max_protein_segments,
                       strict_segments=args.strict_segments)
    # per-rank input sharding over the batch coordinate (data, fsdp): the
    # rows of ranks that differ only on tensor/seq/expert/pipe are the same
    si, sc = batch_shard(mesh)
    if args.streaming:
        from ..data import StreamingOmicsDataset
        assert not args.read_nums, "--read-nums unsupported with --streaming"
        train_ds = StreamingOmicsDataset(
            args.train_dataset_path, text_tok, dna_tok, prot_tok, dconf,
            seed=args.seed, shard_index=si, shard_count=sc)
    else:
        train_ds = OmicsDataset(args.train_dataset_path, text_tok, dna_tok,
                                prot_tok, dconf, read_nums=args.read_nums,
                                shuffle=True, seed=args.seed,
                                shard_index=si, shard_count=sc)
    eval_ds = None
    if args.eval_dataset_path:
        econf = dataclasses.replace(dconf, max_len=args.eval_max_len)
        eval_ds = OmicsDataset(args.eval_dataset_path, text_tok, dna_tok,
                               prot_tok, econf,
                               read_nums=args.eval_read_nums,
                               shard_index=si, shard_count=sc)
    if args.cache_dataset and not args.streaming:
        from ..data.pipeline import CachingDataset
        train_ds = CachingDataset(train_ds)
        if eval_ds is not None:
            eval_ds = CachingDataset(eval_ds)

    # ---- schedule length ----
    # len(train_ds) is this rank's shard; it feeds global_batch/sc rows
    steps_per_epoch = len(train_ds) // max(
        1, args.batch_size_per_gpu * args.gradient_accumulation_steps // sc)
    total_steps = steps_per_epoch * args.epochs
    if args.train_iters:
        total_steps = min(total_steps, args.train_iters)
    total_steps = max(total_steps, 1)

    lora_cfg = (LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                           dropout=args.lora_dropout)
                if args.use_lora else None)
    tc = TrainConfig(
        learning_rate=args.lr, warmup_ratio=args.warmup,
        total_steps=total_steps, schedule=args.lr_decay_style,
        weight_decay=args.weight_decay, grad_clip=args.clip_grad_max_norm,
        accum_steps=args.gradient_accumulation_steps,
        train_bio=args.train_bio, train_mlp=args.train_mlp,
        train_llm=args.train_llm, lora=lora_cfg, z_loss=args.z_loss,
        pp_micro=args.pp_microbatches if args.mesh_pipe > 1 else 0,
        offload_opt_state=args.offload_opt_state)

    if args.init_from:
        # params-only warm start: graft saved base weights onto the fresh
        # tree leaf by leaf, keeping init dtypes; a saved "lora" subtree is
        # ignored — this is a BASE warm start
        saved = ckpt_lib.load_params(args.init_from)
        params = ckpt_lib.graft_params(params, {k: saved[k] for k in params})
        print_rank_0(f"warm-started params from {args.init_from}")

    if lora_cfg:
        assert args.mesh_pipe == 1, \
            "--use-lora is unsupported under --mesh-pipe"
        # fp32 adapters whatever --dtype, as the JAX CLI attaches them
        params = attach_lora(
            params, cfg, lora_cfg,
            torch.Generator(device=device).manual_seed(1))
        if args.qlora:
            # int8 frozen base under the adapters (QLoRA): the layer
            # linears swap to quantized storage, embedding/head/norms stay
            # in the model dtype for the fused-LCE loss
            params["text"] = qwen3.quantize_for_training(params["text"],
                                                         cfg.text)
    else:
        assert not args.qlora, "--qlora requires --use-lora"

    # ---- mesh + sharding ----
    if args.mesh_expert > 1:
        assert cfg.text.num_experts, (
            "--mesh-expert requires a MoE text preset "
            "(cfg.text.num_experts > 0)")
    print_rank_0(f"mesh: {dict(mesh.shape)}")
    if multi:
        from ..parallel import comm
        print_rank_0(f"backend: {comm.describe_backend(device)}")
        if args.mesh_pipe > 1:
            from ..parallel.pipeline import pp_param_specs
            from ..parallel.sharding import shard_tree
            params = shard_tree(params, pp_param_specs(params), mesh)
        else:
            params = shard_params(params, mesh)

    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricLogger(args.output_dir, args.experiment_name,
                          console_every=args.log_interval,
                          report_to=args.report_to,
                          config={k: v for k, v in vars(args).items()
                                  if isinstance(v, (int, float, str, bool))})

    with use_mesh(mesh if multi else None):
        state = init_train_state(params, tc)
        del params
        if args.resume_from:
            state = ckpt_lib.restore_train_state(args.resume_from, state)
            print_rank_0(f"resumed from {args.resume_from} "
                         f"at step {int(state.step)}")

        result = train_loop(
            state, cfg, tc, train_ds, eval_data=eval_ds,
            batch_size=args.batch_size_per_gpu, epochs=args.epochs,
            total_steps=total_steps, seed=args.seed, device=device,
            logger=logger, log_interval=args.log_interval,
            eval_interval=args.eval_interval,
            save_interval=args.save_interval,
            save_total_limit=args.save_total_limit,
            early_stopping_patience=args.early_stopping_patience,
            compute_domain_losses=args.compute_domain_losses,
            output_dir=args.output_dir, profile_log_dir=args.profile_log_dir,
            prefetch_depth=args.prefetch_depth)
    logger.close()
    return result


if __name__ == "__main__":
    main()
