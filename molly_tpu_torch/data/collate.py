"""Static-shape batch collation + a simple host-side data loader.

The reference collators (src/dataset/omics_dataset.py:451-557)
pad ragged per-batch; here every sample already has fixed shapes, so collation
is a plain stack — every batch shares one compiled shape, which is what XLA
wants. A lightweight epoch iterator with drop-last and deterministic shuffling
replaces torch DataLoader (the dataset work is pure numpy on host).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence

import numpy as np

STACK_KEYS_TRAIN = (
    "input_ids", "labels", "attention_mask",
    "dna_rna_tokens", "dna_rna_pos", "protein_tokens", "protein_pos",
    "task_label",
)
STACK_KEYS_TEST = (
    "input_ids", "attention_mask",
    "dna_rna_tokens", "dna_rna_pos", "protein_tokens", "protein_pos",
)
PASSTHROUGH_KEYS_TEST = ("task", "raw_input", "raw_output", "raw_label", "kind")


def collate_train(samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in STACK_KEYS_TRAIN}


def collate_test(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {
        k: np.stack([s[k] for s in samples]) for k in STACK_KEYS_TEST
    }
    for k in PASSTHROUGH_KEYS_TEST:
        batch[k] = [s.get(k, "") for s in samples]
    return batch


def iterate_stream_batches(
    dataset,
    batch_size: int,
    *,
    epoch: int = 0,
    drop_last: bool = True,
    collate_fn=collate_train,
) -> Iterator[Dict[str, Any]]:
    """Chunk a StreamingOmicsDataset epoch into collated batches
    (shuffling lives inside the dataset's row-group/reservoir logic)."""
    buf = []
    for s in dataset.iter_epoch(epoch):
        buf.append(s)
        if len(buf) == batch_size:
            yield collate_fn(buf)
            buf = []
    if buf and not drop_last:
        yield collate_fn(buf)


def iterate_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    collate_fn=collate_train,
    epoch: int = 0,
) -> Iterator[Dict[str, Any]]:
    """Deterministic epoch iterator. For multi-host runs, pass a dataset
    already restricted to this host's shard (see parallel.host_shard)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed + epoch)
        rng.shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        idx = order[i : i + batch_size]
        yield collate_fn([dataset[int(j)] for j in idx])
