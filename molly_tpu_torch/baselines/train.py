"""Baseline training CLI, the counterpart of ``molly_tpu/baselines/train.py``:
frozen backbone(s) + a trainable linear head, the eval metrics acc / mcc /
fmax / auc, and the head-update check (``head_delta``: the norm of the
head's change since the start, logged every ``--log-interval`` steps).

Usage:
  python -m molly_tpu_torch.baselines.train --model-type NT+ESM \\
      --train-file train.parquet --eval-file eval.parquet --metric mcc \\
      [--tiny] [--device cpu] ...

The flags and defaults are the JAX CLI's, plus ``--device`` (default: the
card; the CPU only on request). Only the head trains, with AdamW at optax's
defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4: the port's
``trainer.apply_optimizer``, no clipping, a constant rate). ``main`` also
takes the rows in memory (``train_rows`` / ``eval_rows``, dicts with
``input`` and ``label``): then ``--train-file`` / ``--eval-file`` are not
read and pandas is not needed.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molly_tpu_torch baselines")
    p.add_argument("--model-type", default="NT",
                   choices=["NT", "ESM", "NT+ESM", "NT+NT", "ESM+ESM"])
    p.add_argument("--train-file", required=True)
    p.add_argument("--eval-file", default=None)
    p.add_argument("--output-dir", default="runs/baseline")
    p.add_argument("--num-labels", type=int, default=2)
    p.add_argument("--multi-label", action="store_true")
    p.add_argument("--label-set", default=None,
                   choices=[None, "ec", "ncrna", "modification"],
                   help="bundled label2id mapping for multilabel tasks")
    p.add_argument("--metric", default="acc",
                   choices=["acc", "mcc", "fmax", "auc"])
    p.add_argument("--dna-rna-k-tokens", type=int, default=1024)
    p.add_argument("--protein-k-tokens", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--train-iters", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--eval-interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only on "
                        "request)")
    return p


def load_label_set(name: str) -> Dict[str, int]:
    from ..evalsuite.harness import load_ec_labels
    from ..evalsuite.metrics import MODIFICATION_CLASSES, RNA_CLASSES

    if name == "ec":
        labels = load_ec_labels()
    elif name == "ncrna":
        labels = sorted(RNA_CLASSES)
    elif name == "modification":
        labels = [m for m in sorted(MODIFICATION_CLASSES) if m != "none"]
    else:
        raise ValueError(name)
    return {l: i for i, l in enumerate(labels)}


def compute_metric(name: str, logits, labels, multi_label: bool) -> float:
    """acc / mcc / auc by sklearn (imported only for them), fmax in numpy
    (``evalsuite.metrics.fmax``)."""
    import numpy as np

    logits = np.asarray(logits, dtype=np.float32)
    labels = np.asarray(labels)
    if name == "fmax":
        from ..evalsuite.metrics import fmax
        return float(fmax(1 / (1 + np.exp(-logits)), labels))
    from sklearn.metrics import (accuracy_score, matthews_corrcoef,
                                 roc_auc_score)
    if name == "acc":
        preds = ((logits > 0).astype(int) if multi_label
                 else logits.argmax(-1))
        return float(accuracy_score(labels, preds))
    if name == "mcc":
        return float(matthews_corrcoef(labels, logits.argmax(-1)))
    if name == "auc":
        try:
            return float(roc_auc_score(labels, logits, average="macro"))
        except ValueError:
            return 0.0
    raise ValueError(name)


def main(argv=None, *, train_rows=None, eval_rows=None,
         stats: Optional[Dict[str, list]] = None) -> dict:
    """Train the head; returns ``{"steps", "final_loss", "eval_<metric>"}``
    (printed as one JSON line) and, beside them, ``params`` (the trained
    tree) and ``head_delta`` (the norm of the head's change). ``stats``,
    when given, gains ``step_s``: each step's seconds, the card
    synchronized at its end."""
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from ..data import default_modality_tokenizers
    from ..data.collate import iterate_batches
    from ..data.pipeline import to_device
    from ..models import ESM_PRESETS, tiny_esm
    from ..training.trainer import TrainConfig, apply_optimizer
    from ..utils import MetricLogger, print_rank_0
    from ..utils.tree import leaves
    from . import model
    from .dataset import ClassificationDataset, collate

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to train "
                         "on the CPU")
    device = torch.device(args.device or "cuda")

    dna_tok, prot_tok = default_modality_tokenizers()
    if args.tiny:
        nt_cfg = tiny_esm(vocab_size=dna_tok.vocab_size, mask_token_id=2,
                          dtype="float32")
        prot_cfg = tiny_esm(vocab_size=prot_tok.vocab_size, dtype="float32")
    else:
        nt_cfg, prot_cfg = ESM_PRESETS["nt-500m"], ESM_PRESETS["esm2-650m"]

    label2id = load_label_set(args.label_set) if args.label_set else None
    num_labels = len(label2id) if label2id else args.num_labels
    cfg = model.BaselineConfig(model_type=args.model_type, nt=nt_cfg,
                               protein=prot_cfg, num_labels=num_labels,
                               multi_answer=args.multi_label)

    def make_ds(source, shuffle):
        return ClassificationDataset(
            source, args.model_type, dna_tok, prot_tok,
            args.dna_rna_k_tokens, args.protein_k_tokens,
            label2id=label2id, multi_label=args.multi_label,
            shuffle=shuffle, seed=args.seed)

    train_ds = make_ds(args.train_file if train_rows is None else train_rows,
                       True)
    eval_src = args.eval_file if eval_rows is None else eval_rows
    eval_ds = make_ds(eval_src, False) if eval_src is not None else None

    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    # frozen backbones: only the head trains (the reference's
    # freeze_backbone); the encoders then run without autograd
    for k in params:
        for t in leaves(params[k]):
            t.requires_grad_(k == "head")
    head = [params["head"]["kernel"], params["head"]["bias"]]
    # optax.adamw(lr) with its defaults, as the port's optimizer chain
    tc = TrainConfig(learning_rate=args.lr, warmup_ratio=0.0,
                     schedule="constant", weight_decay=1e-4, grad_clip=0.0)
    opt_state = {"mu": [torch.zeros_like(t) for t in head],
                 "nu": [torch.zeros_like(t) for t in head], "count": 0}
    no_norm = torch.zeros((), device=device)  # no clipping reads it
    put = to_device(device)

    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricLogger(args.output_dir, "baseline",
                          console_every=args.log_interval)
    head0 = head[0].detach().clone()

    def eval_metric() -> float:
        all_logits, all_labels = [], []
        with torch.no_grad():
            for eb in iterate_batches(eval_ds, args.batch_size,
                                      drop_last=False, collate_fn=collate):
                lb = eb.pop("labels")
                all_logits.append(model.forward_logits(
                    params, cfg, put(eb)).cpu().numpy())
                all_labels.append(lb)
        return compute_metric(args.metric, np.concatenate(all_logits),
                              np.concatenate(all_labels), args.multi_label)

    it = 0
    loss = None
    result = {}
    for epoch in range(args.epochs):
        for batch in iterate_batches(train_ds, args.batch_size, shuffle=True,
                                     seed=args.seed, epoch=epoch,
                                     collate_fn=collate):
            t0 = time.perf_counter()
            with torch.enable_grad():
                loss, _ = model.loss_fn(params, cfg, put(batch))
                grads = torch.autograd.grad(loss, head)
            apply_optimizer(head, list(grads), opt_state, tc, no_norm)
            loss = loss.detach()
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stats.setdefault("step_s", []).append(
                    time.perf_counter() - t0)
            it += 1
            if it % args.log_interval == 0:
                # head-update sanity check (HeadUpdateCallback equivalent)
                delta = float(torch.linalg.vector_norm(
                    head[0].detach() - head0))
                logger.log(it, {"loss": loss, "head_delta": delta})
            if eval_ds is not None and it % args.eval_interval == 0:
                m = eval_metric()
                logger.log(it, {f"eval_{args.metric}": m})
                result[f"eval_{args.metric}"] = m
            if args.train_iters and it >= args.train_iters:
                break
        if args.train_iters and it >= args.train_iters:
            break

    if loss is None:
        raise SystemExit("no training step executed: the dataset yielded "
                         f"no batch of {args.batch_size}")
    result.update(steps=it, final_loss=float(loss))
    print_rank_0(json.dumps(result))
    logger.close()
    delta = float(torch.linalg.vector_norm(head[0].detach() - head0))
    return {**result, "params": params, "head_delta": delta}


if __name__ == "__main__":
    main()
