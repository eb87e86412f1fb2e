"""Checkpointing, the counterpart of ``molly_tpu/training/checkpoint.py``.

  - ``export_adapter`` / ``adapter_meta`` / ``load_adapter``: LoRA A/B +
    projectors as one ``.npz`` with the SAME keys as the JAX package
    (``lora/layers/<target>/{a,b}``, ``<modality>_projector/{kernel,bias}``,
    ``__lora_meta__``), so an adapter written by one package loads in the
    other.
  - ``save_train_state`` / ``restore_train_state`` / ``wait_for_saves``: the
    full train state (params, moments, counts) with ``torch.save``. The JAX
    package writes Orbax directories; this format is the port's own — one
    ``state.pt`` per checkpoint directory — and the two do not read each
    other's. Saves are synchronous, so ``wait_for_saves`` has nothing to
    wait for; it exists so callers keep the same sequence of calls.

Under a mesh (``parallel.use_mesh``) every rank takes part in gathering the
blocks, rank 0 alone writes the whole tree (the same file a one-device run
writes), and a restore cuts each rank's blocks out of it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel import comm, sharding
from .trainer import TrainState


def _gathered(tree):
    """The tree with every block gathered (all ranks take part), and
    whether this rank is the one that writes."""
    mesh = comm.current_mesh()
    if mesh is None:
        return tree, True
    return sharding.gather_params(tree, mesh), mesh.rank == 0


def _barrier() -> None:
    mesh = comm.current_mesh()
    if mesh is not None and mesh.devices.size > 1:
        torch.distributed.barrier()


def _flatten(prefix: str, tree, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}{k}/", v, out)
    else:
        out[prefix[:-1]] = tree


def export_adapter(path: str, params: Dict[str, Any], lora_cfg=None) -> None:
    """Save LoRA A/B + projectors as one .npz (fp32). ``lora_cfg`` records
    r/alpha in a ``__lora_meta__`` entry so inference merges with the
    trained scale."""
    params, writer = _gathered({k: params[k] for k in
                                ("lora", "dna_rna_projector",
                                 "protein_projector") if k in params})
    if not writer:
        return _barrier()
    flat: Dict[str, np.ndarray] = {}

    def add(prefix, tree):
        leaves: Dict[str, torch.Tensor] = {}
        _flatten(prefix, tree, leaves)
        for key, leaf in leaves.items():
            flat[key] = leaf.detach().to("cpu", torch.float32).numpy()

    if "lora" in params:
        add("lora/", params["lora"])
        r = int(next(iter(params["lora"]["layers"].values()))["a"].shape[-1])
        alpha = float(lora_cfg.alpha) if lora_cfg is not None else 64.0
        if lora_cfg is not None and lora_cfg.r != r:
            raise ValueError(f"lora_cfg.r={lora_cfg.r} != adapter r={r}")
        flat["__lora_meta__"] = np.asarray([r, alpha], np.float32)
    add("dna_rna_projector/", params["dna_rna_projector"])
    add("protein_projector/", params["protein_projector"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    _barrier()


def _npz(path: str):
    return np.load(path if path.endswith(".npz") else path + ".npz")


def adapter_meta(path: str) -> Optional[Dict[str, float]]:
    """{'r': int, 'alpha': float} recorded at export time, or None for
    archives without it (callers fall back to shape-derived r, alpha=64)."""
    data = _npz(path)
    if "__lora_meta__" not in data.files:
        return None
    r, alpha = data["__lora_meta__"]
    return {"r": int(r), "alpha": float(alpha)}


def load_adapter(path: str, params: Dict[str, Any],
                 dtype=None) -> Dict[str, Any]:
    """Inverse of export_adapter: graft saved leaves onto a param tree (base
    weights untouched), on the device of each replaced leaf. The LoRA
    subtree is rebuilt from the archive keys, so it loads even when the
    target tree has no adapter attached yet (fp32 unless ``dtype``)."""
    data = _npz(path)
    out = dict(params)
    device = params["dna_rna_projector"]["kernel"].device

    def rebuild(prefix, tree):
        return {k: torch.from_numpy(np.array(data[f"{prefix}{k}"])).to(
            device, dtype or leaf.dtype) for k, leaf in tree.items()}

    lora_keys = [k for k in data.files if k.startswith("lora/")]
    if lora_keys:
        lora: Dict[str, Any] = {}
        for k in lora_keys:
            node = lora
            parts = k.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(np.array(data[k])).to(
                device, dtype or torch.float32)
        out["lora"] = lora
    out["dna_rna_projector"] = rebuild("dna_rna_projector/",
                                       params["dna_rna_projector"])
    out["protein_projector"] = rebuild("protein_projector/",
                                       params["protein_projector"])
    return out


def _state_file(path: str) -> str:
    return os.path.join(path, "state.pt")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    if isinstance(tree, torch.Tensor):  # a block keeps its spec
        return sharding.set_spec(tree.detach(), sharding.spec_of(tree))
    return tree


def save_train_state(path: str, state: TrainState, *, force: bool = True,
                     wait: bool = False) -> None:
    """Write the full train state to ``<path>/state.pt`` (atomically: a
    temporary file renamed into place). ``force`` and ``wait`` are the JAX
    function's; a save here always overwrites and is always durable on
    return."""
    del force, wait
    tree, writer = _gathered({"params": _detached(state.params),
                              "opt_state": _detached(state.opt_state)})
    if writer:
        os.makedirs(path, exist_ok=True)
        tmp = _state_file(path) + ".tmp"
        torch.save({**tree, "step": int(state.step)}, tmp)
        os.replace(tmp, _state_file(path))
    _barrier()


def wait_for_saves() -> None:
    """Saves are synchronous; nothing is pending."""


def load_params(path: str) -> Dict[str, Any]:
    """The ``params`` tree of a saved train state, on the CPU."""
    return torch.load(_state_file(path), map_location="cpu",
                      weights_only=True)["params"]


def graft_params(params: Dict[str, Any], saved: Dict[str, Any]):
    """``saved`` leaves onto the tree of ``params``, keeping each leaf's
    dtype and device (a params-only warm start)."""
    if isinstance(params, dict):
        return {k: graft_params(v, saved[k]) for k, v in params.items()}
    return saved.to(device=params.device, dtype=params.dtype)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load ``<path>/state.pt`` INTO ``state``'s tensors (same tree, same
    devices, requires-grad flags kept) and return the state at the saved
    step."""
    saved = torch.load(_state_file(path), map_location="cpu",
                       weights_only=True)

    def copy_into(dst, src, where):
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise ValueError(f"checkpoint tree mismatch at {where}: "
                                 f"{sorted(dst)} vs {sorted(src)}")
            for k in dst:
                copy_into(dst[k], src[k], f"{where}/{k}")
        elif isinstance(dst, list):
            if len(dst) != len(src):
                raise ValueError(f"checkpoint tree mismatch at {where}")
            for i, (d, s) in enumerate(zip(dst, src)):
                copy_into(d, s, f"{where}[{i}]")
        else:
            spec, mesh = sharding.spec_of(dst), comm.current_mesh()
            if spec is not None and mesh is not None:
                src = sharding.block(src, spec, mesh)  # this rank's block
            if dst.shape != src.shape:
                raise ValueError(f"checkpoint shape mismatch at {where}: "
                                 f"{tuple(dst.shape)} vs {tuple(src.shape)}")
            with torch.no_grad():
                dst.copy_(src)

    copy_into(state.params, saved["params"], "params")
    for name in ("mu", "nu"):
        copy_into(state.opt_state[name], saved["opt_state"][name],
                  f"opt_state/{name}")
    state.opt_state["count"] = int(saved["opt_state"]["count"])
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=int(saved["step"]))
