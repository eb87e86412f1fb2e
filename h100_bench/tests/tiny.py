"""A tiny cell for the CPU tests: a copy of the benchmark's folder with a
tiny configuration, mix and limit added as new files and one new
``BENCHMARK.json`` entry, run on the CPU with the kernels' plain versions.
Nothing of it is ever a device measurement."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_CONFIG = {
    "name": "tiny", "source": "a CPU test model", "dtype": "float32",
    "decoder": "qwen3",
    "text": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-6,
             "rope_theta": 1e6, "tie_word_embeddings": True,
             "max_position_embeddings": 4096, "num_experts": 0},
    "dna_rna": {"vocab_size": 4107, "hidden_size": 32,
                "intermediate_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4,
                "position_embedding_type": "rotary", "mlp_type": "swiglu",
                "mlp_bias": False, "token_dropout": True,
                "layer_norm_eps": 1e-5, "pad_token_id": 1,
                "mask_token_id": 2, "max_position_embeddings": 2050},
    "protein": {"vocab_size": 33, "hidden_size": 32,
                "intermediate_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4,
                "position_embedding_type": "rotary", "mlp_type": "gelu",
                "mlp_bias": True, "token_dropout": True,
                "layer_norm_eps": 1e-5, "pad_token_id": 1,
                "mask_token_id": 32, "max_position_embeddings": 1026},
    "reduced": [], "assumed": {},
}


def tiny_moe_config():
    c = copy.deepcopy(TINY_CONFIG)
    c["name"] = "tiny-moe"
    c["text"].update(num_experts=4, num_experts_per_tok=2,
                     moe_intermediate_size=32, norm_topk_prob=True,
                     tie_word_embeddings=False)
    return c


def tiny_traffic(base: str = "omics_eval_b32.json", **over):
    with open(BENCH / "traffic" / base) as f:
        t = json.load(f)
    t.update(batch_size=4, max_length=256, dna_rna_k_tokens=16,
             protein_k_tokens=16, max_new_tokens=4, check_requests=3,
             greedy_every=2, profile_batch=1)
    t["mix"] = dict(t["mix"], lengths={"dna_rna": [30, 90],
                                       "protein": [8, 20]},
                    question_tokens=[10, 30])
    t.update(over)
    return t


def digest(folder: Path):
    """SHA-256 of each file under ``folder`` by its relative path."""
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def make_bench(tmp: Path, config=None, traffic=None, limit=1e-6,
               name="tiny.eval") -> Path:
    """A copy of the benchmark's folder under ``tmp`` with one added cell;
    returns the copy's folder (its ``BENCHMARK.json`` beside it)."""
    config = config or TINY_CONFIG
    dst = tmp / "h100_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    with open(BENCH.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": config["name"], "source": "test",
                             "file": f"h100_bench/configs/{config['name']}.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": f"tiny_{name}", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "molly-1.7b.eval" in m["workloads"]:
            m["workloads"].append(name)
    (dst / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (dst / "traffic" / f"tiny_{name}.json").write_text(
        json.dumps(traffic or tiny_traffic()))
    (dst / "limits" / f"{name}.json").write_text(
        json.dumps({"mean_sq_logit_gap": limit}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_tiny(bench_dir: Path, name="tiny.eval", seed=1234, seconds=0.0):
    """One run of the added cell on the CPU: the Outcome."""
    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.main import run_cell
    cell = load_cell(name, bench_dir)
    cell.seed, cell.seconds, cell.device = seed, seconds, "cpu"
    cell.started = time.time()
    return cell, run_cell(cell)
