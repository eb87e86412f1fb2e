"""A cell and the files it is made of, found by name: its entry in
``BENCHMARK.json`` (configuration, traffic), ``configs/<config>.json``
(which names its decoder, ``reference/<decoder>.py``),
``traffic/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``),
``limits/<cell>.json`` (the limit of each number its check compares), and
one reader a per-layer metric, ``metrics/<metric>.py`` or, shared by the
metric's cells, ``metrics/<metric before its first dot>.py``. Adding a
cell, a configuration, a decoder, a mix or a metric adds files and entries
and edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .env import BENCH_DIR


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    started: float = 0.0          # wall time of the process's start
    control: Optional[str] = None  # a lower precision, for calibration only
    extra: Dict[str, Any] = field(default_factory=dict)

    def fusion_config(self):
        """The program's ``FusionConfig`` for this configuration: the text
        part in the class and under the key names that the decoder's file
        gives (``PROGRAM_CONFIG``, ``PROGRAM_KEYS``), keeping only the
        class's fields."""
        from molly_tpu_torch.models import configs
        c, t, dec = self.config, self.traffic, self.decoder()
        text_class = getattr(configs, dec.PROGRAM_CONFIG)
        text = dict(c["text"])
        for key, program_key in dec.PROGRAM_KEYS.items():
            if key in text:
                text[program_key] = text.pop(key)
        keep = set(text_class.__dataclass_fields__)
        text = {k: v for k, v in text.items() if k in keep}

        def esm(d):
            keep_e = set(configs.EsmConfig.__dataclass_fields__)
            return configs.EsmConfig(
                **{k: v for k, v in d.items() if k in keep_e},
                dtype=c["dtype"])

        return configs.FusionConfig(
            text=text_class(**text, dtype=c["dtype"]),
            dna_rna=esm(c["dna_rna"]), protein=esm(c["protein"]),
            dna_rna_k_tokens=t["dna_rna_k_tokens"],
            protein_k_tokens=t["protein_k_tokens"])

    def decoder(self):
        """``reference/<decoder>.py`` of the configuration's ``"decoder"``:
        everything that depends on the decoder's equations. A name with no
        file stops the run, naming the path it looked for."""
        path = self.bench_dir / "reference" / f"{self.config['decoder']}.py"
        if not path.is_file():
            raise FileNotFoundError(
                f"configs/{self.entry['config']}.json names the decoder "
                f"{self.config['decoder']!r}, but {path} does not exist")
        return _load(path)

    def driver(self):
        """``drivers/<driver>.py`` of this cell's traffic file."""
        return _load(self.bench_dir / "drivers"
                     / f"{self.traffic['driver']}.py")


def load_cell(workload: str, bench_dir: Path = BENCH_DIR,
              bench_json: Optional[Path] = None) -> Cell:
    bench = _json(bench_json or bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    e2e_names = {m["name"] for m in bench["end_to_end"]}

    def mine(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"]
           if mine(m) is not False]
    cell_e2e = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) or (mine(m) is None and m["moves"] in cell_e2e)]
    assert all(m["moves"] in e2e_names for m in per_layer)
    limits_path = bench_dir / "limits" / f"{workload}.json"
    return Cell(
        name=workload, entry=entry,
        config=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "_bench_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: Path, name: str) -> Callable:
    """The ``read(record)`` of a per-layer metric."""
    for stem in (name, name.split(".", 1)[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            return _load(path).read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} "
                            f"under {bench_dir / 'metrics'}")

