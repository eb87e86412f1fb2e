"""Parquet-backed multi-omics SFT dataset.

Reproduces the splicing semantics of the reference dataset layer
(src/dataset/omics_dataset.py) with a static-shape output
format: every sample is a dict of fixed-shape numpy arrays, with omics
segments split per modality into ``[G, K]`` token blocks plus ``[G]`` start
positions (-1 = inactive slot), so batches have fully static shapes.

Semantics mirrored exactly (with file:line citations to the reference):
  - tag regexes for <dna>/<rna>/<protein> (omics_dataset.py:162-170)
  - fixed pre-tokenized system prompt + assistant header (:87-92)
  - placeholder splice: start + k*pad + end per segment, recording the
    start-token index (:265-293)
  - sft label masking: -100 on prompt, output + EOS supervised (:346-373)
  - truncation keeps the final EOS (:371-373)
  - Test mode: no output/EOS, left-padding with start-position shift
    (:384-391)
  - 20-task name -> id mapping for domain losses (:172-214)
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import profiling
from .tokenizers import (
    ASSISTANT_START_TEXT,
    SYSTEM_PROMPT_TEXT,
)

# Tagged-sequence regexes, identical to omics_dataset.py:162-170.
OMICS_REGEX = {
    "dna": re.compile(r"<dna>\s*([ACGTNacgtn]+)\s*</dna>"),
    "rna": re.compile(r"<rna>\s*([ACGTNacgtn]+)\s*</rna>"),
    "protein": re.compile(r"<protein>\s*([ACDEFGHIKLMNPQRSTVWYBXZOU]+)\s*</protein>"),
}

# Task-name fragment -> domain-loss id (omics_dataset.py:172-214).
TASK_ID_MAP = [
    ("antibody_antigen", 0),
    ("cpd-prom_core", 1),
    ("CRISPROnTarget", 2),
    ("emp-H", 3),
    ("enhancer_activity", 4),
    ("Fluorescence-Fluorescence", 5),
    ("FunctionEC-FunctionEC", 6),
    ("Isoform-Isoform", 7),
    ("MeanRibosomeLoading-MeanRibosomeLoading", 8),
    ("Modification-Modification", 9),
    ("NoncodingRNAFamily-NoncodingRNAFamily", 10),
    ("pd-prom_300", 11),
    ("ProgrammableRNASwitches-ProgrammableRNASwitches", 12),
    ("promoter_enhancer_interaction", 13),
    ("rna_protein_interaction", 14),
    ("Solubility-Solubility", 15),
    ("Stability-Stability", 16),
    ("Thermostability-Thermostability", 17),
    ("tf-h", 18),
    ("tf-m", 19),
]
UNKNOWN_TASK_ID = 100
NUM_DOMAIN_TASKS = 20

LABEL_IGNORE = -100
ENCODER_PAD_ID = 1  # both modality tokenizers pad with 1


def task_name_to_id(source: str) -> int:
    for frag, tid in TASK_ID_MAP:
        if frag in (source or ""):
            return tid
    return UNKNOWN_TASK_ID


@dataclass
class DataConfig:
    """Mirror of the reference DatasetConfig (omics_dataset.py:18-29) plus the
    static-shape knobs the device layout needs."""

    max_len: int = 1024
    mode: str = "sft"  # "sft" | "pretrain"
    padding: bool = True
    dna_rna_k_tokens: int = 128
    protein_k_tokens: int = 128
    # Static number of segment slots per modality per sample. The reference
    # pads ragged per-batch (omics_dataset.py:487-492); we fix it up front so
    # every batch has one compiled shape.
    max_dna_rna_segments: int = 4
    max_protein_segments: int = 4
    # Supervise the CoT "think" field by prepending <think>...</think> to
    # the answer. (The reference tokenizes `think` but never feeds it to the
    # loss, omics_dataset.py:298-299 vs :346-373 — its CoT runs bake the
    # reasoning into `output` upstream; this flag does it at the dataset.)
    include_think: bool = False
    # Segment-capacity / truncation policy. The reference hard-errors when
    # placeholder counts and injected segments disagree
    # (omics_one.py:167-170); we either raise (strict) or degrade loudly:
    # overflow segments keep their raw sequence as plain text (no orphan
    # placeholders), truncation-straddled segments are deactivated.
    strict_segments: bool = False


class OmicsSampleEncoder:
    """Turns one raw row {input, output, think, task, ...} into fixed-shape
    numpy arrays. Pure CPU, no JAX."""

    def __init__(self, text_tokenizer, dna_rna_tokenizer, protein_tokenizer,
                 config: DataConfig):
        self.tok = text_tokenizer
        self.dna_tok = dna_rna_tokenizer
        self.prot_tok = protein_tokenizer
        self.cfg = config

        t = text_tokenizer
        self.special = {
            kind: {
                "start": t.convert_tokens_to_ids(f"<|{kind}_start|>"),
                "pad": t.convert_tokens_to_ids(f"<|{kind}_pad|>"),
                "end": t.convert_tokens_to_ids(f"<|{kind}_end|>"),
            }
            for kind in ("dna", "rna", "protein")
        }
        self.eos_id = t.eos_token_id
        self.pad_id = t.pad_token_id
        # Fixed chat-template prefix/suffix (omics_dataset.py:87-92).
        self.system_prompt_ids = t.encode(SYSTEM_PROMPT_TEXT, add_special_tokens=False)
        self.assistant_start_ids = t.encode(
            ASSISTANT_START_TEXT, add_special_tokens=False
        )

    # -- step 1: splice tagged sequences into placeholder tokens -----------

    def splice(self, input_text: str) -> Dict[str, Any]:
        """Replace each tagged bio sequence with start + k*pad + end tokens,
        recording segment type/start and the raw sequence
        (omics_dataset.py:249-293)."""
        seq_info: List[Dict[str, Any]] = []
        raw_seqs: List[str] = []
        for kind in ("dna", "rna", "protein"):
            for m in OMICS_REGEX[kind].finditer(input_text):
                seq_info.append({"type": kind, "s": m.start(), "e": m.end()})
                raw_seqs.append(m.group(1).upper())

        order = sorted(range(len(seq_info)), key=lambda i: seq_info[i]["s"])
        input_ids: List[int] = list(self.system_prompt_ids)
        segments: List[Dict[str, Any]] = []  # {"type","start","raw"}
        cursor = 0
        counts = {"dna_rna": 0, "protein": 0}
        caps = {"dna_rna": self.cfg.max_dna_rna_segments,
                "protein": self.cfg.max_protein_segments}
        overflowed = []
        for i in order:
            info = seq_info[i]
            kind = info["type"]
            input_ids.extend(
                self.tok.encode(input_text[cursor : info["s"]],
                                add_special_tokens=False)
            )
            modality = "dna_rna" if kind in ("dna", "rna") else "protein"
            if counts[modality] >= caps[modality]:
                # over the static slot budget: keep the raw sequence as
                # plain text so no placeholder tokens are left uninjected
                overflowed.append(kind)
                input_ids.extend(self.tok.encode(raw_seqs[i],
                                                 add_special_tokens=False))
                cursor = info["e"]
                continue
            counts[modality] += 1
            # start position = index of the start token (the reference stores
            # len(input_ids) *before* appending start, then injects at
            # start+1 .. start+1+k — omics_dataset.py:277, omics_one.py:97).
            segments.append({"type": kind, "start": len(input_ids),
                             "raw": raw_seqs[i]})
            k = (self.cfg.dna_rna_k_tokens if kind in ("dna", "rna")
                 else self.cfg.protein_k_tokens)
            sp = self.special[kind]
            input_ids.append(sp["start"])
            input_ids.extend([sp["pad"]] * k)
            input_ids.append(sp["end"])
            cursor = info["e"]
        if overflowed:
            msg = (f"sample has more omics segments than the static slot "
                   f"budget (dropped {len(overflowed)}: {overflowed}; "
                   f"caps dna_rna={caps['dna_rna']} "
                   f"protein={caps['protein']}); overflow sequences were "
                   f"kept as plain text — raise max_*_segments to encode "
                   f"them")
            if self.cfg.strict_segments:
                raise ValueError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        if cursor < len(input_text):
            input_ids.extend(
                self.tok.encode(input_text[cursor:], add_special_tokens=False)
            )
        return {"input_ids": input_ids, "segments": segments}

    # -- step 2: full sample --------------------------------------------------

    def encode_train(self, row: Dict[str, Any]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        spliced = self.splice((row.get("input") or "").strip())
        input_ids: List[int] = spliced["input_ids"]
        input_ids.extend(self.assistant_start_ids)

        output_text = (row.get("output") or "").strip()
        if cfg.include_think:
            think = (row.get("think") or "").strip()
            if think:
                output_text = f"<think>{think}</think>\n{output_text}"
        if cfg.mode == "sft":
            output_ids = (
                self.tok.encode(output_text, add_special_tokens=False)
                if output_text else []
            )
            output_ids.append(self.eos_id)
            input_len = len(input_ids)
            full = input_ids + output_ids
            labels = [LABEL_IGNORE] * input_len + output_ids
        else:  # pretrain: supervise everything
            input_ids.append(self.eos_id)
            full = list(input_ids)
            labels = list(full)

        segments = spliced["segments"]
        if len(full) > cfg.max_len:  # keep EOS (omics_dataset.py:371-373)
            full = full[: cfg.max_len - 1] + [self.eos_id]
            labels = labels[: cfg.max_len - 1] + [self.eos_id]
            # deactivate segments whose placeholder block straddles the cut:
            # injecting them would overwrite the surviving tail rows
            # (including the supervised EOS) with encoder embeddings
            segments = self._drop_cut_segments(
                segments, lambda seg, k: seg["start"] + k + 1
                <= cfg.max_len - 2, "right-truncation")

        attention_mask = [1] * len(full)
        if cfg.padding and len(full) < cfg.max_len:
            pad_n = cfg.max_len - len(full)
            full += [self.pad_id] * pad_n
            labels += [LABEL_IGNORE] * pad_n
            attention_mask += [0] * pad_n

        out = self._pack_segments(segments, shift=0)
        out.update(
            input_ids=np.asarray(full, dtype=np.int32),
            labels=np.asarray(labels, dtype=np.int32),
            attention_mask=np.asarray(attention_mask, dtype=np.int32),
            task_label=np.int32(task_name_to_id(row.get("task", ""))),
        )
        return out

    def encode_test(self, row: Dict[str, Any]) -> Dict[str, Any]:
        """Inference-mode sample: prompt only, left-padded to max_len with
        omics start positions shifted (omics_dataset.py:384-391)."""
        with profiling.span("molly/encode_test"):
            return self._encode_test(row)

    def _encode_test(self, row: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.cfg
        spliced = self.splice((row.get("input") or "").strip())
        input_ids: List[int] = spliced["input_ids"]
        input_ids.extend(self.assistant_start_ids)
        segments = spliced["segments"]

        if len(input_ids) > cfg.max_len:
            # truncate from the LEFT (keep the prompt tail = the question),
            # never leaving a partial placeholder block in the stream: the
            # cut advances past any straddled start..start+k+1 block, and
            # fully-cut segments are dropped.
            cut = len(input_ids) - cfg.max_len
            for seg in segments:  # sorted by start
                k = (cfg.dna_rna_k_tokens if seg["type"] in ("dna", "rna")
                     else cfg.protein_k_tokens)
                if seg["start"] < cut <= seg["start"] + k + 1:
                    cut = seg["start"] + k + 2
            input_ids = input_ids[cut:]
            segments = self._drop_cut_segments(
                segments, lambda seg, k: seg["start"] >= cut,
                "left-truncation")
            segments = [dict(seg, start=seg["start"] - cut)
                        for seg in segments]

        attention_mask = [1] * len(input_ids)
        shift = 0
        if cfg.padding and len(input_ids) < cfg.max_len:
            shift = cfg.max_len - len(input_ids)
            input_ids = [self.pad_id] * shift + input_ids
            attention_mask = [0] * shift + attention_mask

        out = self._pack_segments(segments, shift=shift)
        out.update(
            input_ids=np.asarray(input_ids, dtype=np.int32),
            attention_mask=np.asarray(attention_mask, dtype=np.int32),
            task=row.get("task", ""),
            raw_input=(row.get("input") or "").strip(),
            raw_output=(row.get("output") or "").strip(),
            raw_label=row.get("label", ""),
            kind=row.get("kind", ""),
        )
        return out

    def _drop_cut_segments(self, segments, keep_fn, why: str):
        """Filter segments through keep_fn(seg, k); warn or raise on drops."""
        kept, dropped = [], []
        for seg in segments:
            k = (self.cfg.dna_rna_k_tokens if seg["type"] in ("dna", "rna")
                 else self.cfg.protein_k_tokens)
            (kept if keep_fn(seg, k) else dropped).append(seg)
        if dropped:
            msg = (f"{why} at max_len={self.cfg.max_len} cut "
                   f"{len(dropped)} omics segment(s) "
                   f"({[s['type'] for s in dropped]}); their injection is "
                   f"dropped — raise max_len or shorten the prompt")
            if self.cfg.strict_segments:
                raise ValueError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return kept

    def _pack_segments(self, segments: List[Dict[str, Any]], shift: int):
        """Pack ragged segments into fixed [G, K] token blocks + [G] starts."""
        cfg = self.cfg
        dna_tokens = np.full(
            (cfg.max_dna_rna_segments, cfg.dna_rna_k_tokens),
            ENCODER_PAD_ID, dtype=np.int32)
        dna_pos = np.full((cfg.max_dna_rna_segments,), -1, dtype=np.int32)
        prot_tokens = np.full(
            (cfg.max_protein_segments, cfg.protein_k_tokens),
            ENCODER_PAD_ID, dtype=np.int32)
        prot_pos = np.full((cfg.max_protein_segments,), -1, dtype=np.int32)

        di = pi = 0
        for seg in segments:
            start = seg["start"] + shift
            if seg["type"] in ("dna", "rna"):
                if di >= cfg.max_dna_rna_segments:
                    continue  # unreachable: splice() caps per-modality count
                dna_tokens[di] = self.dna_tok.encode(
                    seg["raw"], max_length=cfg.dna_rna_k_tokens)
                dna_pos[di] = start
                di += 1
            else:
                if pi >= cfg.max_protein_segments:
                    continue
                prot_tokens[pi] = self.prot_tok.encode(
                    seg["raw"], max_length=cfg.protein_k_tokens)
                prot_pos[pi] = start
                pi += 1
        return {
            "dna_rna_tokens": dna_tokens,
            "dna_rna_pos": dna_pos,
            "protein_tokens": prot_tokens,
            "protein_pos": prot_pos,
        }


class OmicsDataset:
    """Map-style dataset over a parquet (or pandas DataFrame) of raw rows
    with columns [task, input, think, output, label, kind]."""

    def __init__(self, source, text_tokenizer, dna_rna_tokenizer,
                 protein_tokenizer, config: DataConfig,
                 mode: str = "train", read_nums: Optional[int] = None,
                 shuffle: bool = False, seed: int = 42,
                 shard_index: int = 0, shard_count: int = 1):
        """shard_index/shard_count: per-host input sharding for multi-host
        training (every host must pass the same seed so the pre-shard
        shuffle is one consistent global permutation; hosts then own
        disjoint contiguous slices — the GSPMD analogue of the reference's
        DistributedSampler, the upstream project)."""
        import pandas as pd

        if isinstance(source, str):
            df = pd.read_parquet(source)
        else:
            df = source
        if read_nums:
            df = df.head(read_nums)
        if shuffle:
            rng = np.random.default_rng(seed)
            df = df.sample(frac=1, random_state=rng).reset_index(drop=True)
        if shard_count > 1:
            per = len(df) // shard_count
            start = shard_index * per
            stop = len(df) if shard_index == shard_count - 1 \
                else start + per
            df = df.iloc[start:stop]
        self.df = df.reset_index(drop=True)
        self.mode = mode
        self.encoder = OmicsSampleEncoder(
            text_tokenizer, dna_rna_tokenizer, protein_tokenizer, config)

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, idx: int):
        row = self.df.loc[idx].to_dict()
        if self.mode == "test":
            return self.encoder.encode_test(row)
        return self.encoder.encode_train(row)


class StreamingOmicsDataset:
    """Row-group-streaming dataset for corpora larger than host RAM.

    The reference (and OmicsDataset above) load the ENTIRE parquet into
    pandas before training (src/dataset/omics_dataset.py
    reads the file up front) — fine at SFT scale, a hard cap at
    production pretraining scale. This variant reads pyarrow ROW GROUPS
    lazily:

      - per-host sharding: row groups round-robin over
        ``shard_index::shard_count`` (the multi-host input contract of
        OmicsDataset, at row-group granularity)
      - approximate global shuffle (train mode): the row-group ORDER is
        permuted per epoch (seed + epoch) and samples additionally mix
        through a ``shuffle_buffer``-deep reservoir
      - samples are tokenized on the fly; compose with
        ``data.pipeline.prefetch`` for host/device overlap
        (``CachingDataset`` deliberately does not apply — the point is
        NOT holding the corpus in memory)
    """

    def __init__(self, path: str, text_tokenizer, dna_rna_tokenizer,
                 protein_tokenizer, config: DataConfig,
                 mode: str = "train", shard_index: int = 0,
                 shard_count: int = 1, shuffle_buffer: int = 2048,
                 seed: int = 42):
        import pyarrow.parquet as pq

        self._path = path
        md = pq.ParquetFile(path).metadata
        self._groups = list(range(md.num_row_groups))[
            shard_index::shard_count]
        self._rows = sum(md.row_group(g).num_rows for g in self._groups)
        self.mode = mode
        self._buffer = shuffle_buffer if mode == "train" else 0
        self._seed = seed
        self.encoder = OmicsSampleEncoder(
            text_tokenizer, dna_rna_tokenizer, protein_tokenizer, config)

    def __len__(self) -> int:
        return self._rows

    def iter_epoch(self, epoch: int = 0):
        """Yield encoded samples for one pass (a fresh file handle per
        epoch: safe under the background prefetch thread)."""
        import pyarrow.parquet as pq

        rng = np.random.default_rng(self._seed + epoch)
        order = list(rng.permutation(len(self._groups))
                     if self.mode == "train" else range(len(self._groups)))
        encode = (self.encoder.encode_test if self.mode == "test"
                  else self.encoder.encode_train)
        pf = pq.ParquetFile(self._path)
        try:
            buf = []
            for gi in order:
                rows = pf.read_row_group(self._groups[gi]).to_pylist()
                if self.mode == "train":
                    rng.shuffle(rows)
                for row in rows:
                    if self._buffer <= 1:
                        yield encode(row)
                        continue
                    buf.append(row)
                    if len(buf) >= self._buffer:
                        j = int(rng.integers(len(buf)))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield encode(buf.pop())
            rng.shuffle(buf)
            for row in buf:
                yield encode(row)
        finally:
            pf.close()
