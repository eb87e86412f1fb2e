"""HF checkpoint -> port param trees, the counterpart of
``molly_tpu/models/hf_import.py``.

Maps the published checkpoints the reference trains from (Qwen3 and
Qwen3-MoE, ESM-2, nucleotide-transformer) and reference-style PEFT adapters
onto the stacked [L, ...] param dicts of ``models.qwen3``, ``models.esm``
and ``models.lora``. Works from an in-memory state dict (torch tensors or
numpy arrays) or a checkpoint directory holding ``*.safetensors`` (one file
or shards) or ``pytorch_model.bin``. Torch ``nn.Linear`` stores [out, in];
the port's linears are [in, out], so every linear is transposed on import.

The safetensors reader is this module's own, in plain Python over the file
layout: an 8-byte little-endian header length, a JSON header that names
each tensor's dtype, shape and byte range, then the raw bytes. It needs
neither ``safetensors`` nor ``transformers``, and it reads BF16 files, which
the JAX package's numpy reader cannot. Each tensor is a view of a private
memory map of its file (a copy only where its offset is not a multiple of
its element size).

Every leaf is checked against the shape its config implies, and a missing
key, a shape that does not fit or a dtype the reader does not know stops
with an error that names the key. A leaf is converted to the model dtype in
one ``Tensor.copy_`` (round to nearest even, once, from the stored
values) into a tensor allocated on ``device``, so an import equals
``convert.params_from_jax`` of the JAX package's import bit for bit, and a
stack of experts never holds a second copy of itself.
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .configs import EsmConfig, Qwen3Config
from .qwen3 import torch_dtype

# safetensors dtype names -> torch dtypes (the writer, hf_export, inverts it)
ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
             "F16": torch.float16, "BF16": torch.bfloat16,
             "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
             "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in header
    order."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file "
                             f"({size} bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes in a file of "
                             f"{size}")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"know ({sorted(ST_DTYPES)})")
        shape = tuple(info["shape"])
        b, e = info["data_offsets"]
        itemsize = torch.empty((), dtype=dt).element_size()
        if e - b != math.prod(shape) * itemsize or start + e > size:
            raise ValueError(f"{path}: tensor {name!r}: bytes {b}..{e} do "
                             f"not hold {list(shape)} {info['dtype']}")
        if e == b:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=e - b,
                               offset=start + b)
        if (start + b) % itemsize:
            raw = raw.clone()
        out[name] = raw.view(dt).reshape(shape)
    return out


def load_hf_state(path: str) -> Dict[str, torch.Tensor]:
    """Read all tensors from a local HF checkpoint directory: every
    ``*.safetensors`` file in it (with ``model.safetensors.index.json``,
    every key of its weight map must be found), else
    ``pytorch_model.bin``."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        state: Dict[str, torch.Tensor] = {}
        for f in st_files:
            state.update(read_safetensors(f))
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as fh:
                wanted = json.load(fh)["weight_map"]
            missing = sorted(set(wanted) - set(state))
            if missing:
                raise KeyError(f"{path}: {len(missing)} tensors of the index "
                               f"are in no shard, e.g. {missing[:3]}")
        return state
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no safetensors or pytorch_model.bin in {path}")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _get(state: Mapping[str, Any], key: str, shape: Tuple[int, ...],
         transpose: bool) -> torch.Tensor:
    if key not in state:
        raise KeyError(f"{key!r} is not in the checkpoint")
    t = _tensor(state[key])
    if transpose:
        t = t.T
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{key!r} has shape {list(t.shape)}"
            f"{' as [in, out]' if transpose else ''} where the config needs "
            f"{list(shape)}")
    return t


def _one(state, key, shape, dt, device, transpose=False) -> torch.Tensor:
    out = torch.empty(shape, dtype=dt, device=device)
    # the stored bytes go to the device as they are (a transposed view keeps
    # its strides); the transpose and the rounding happen in one copy there
    out.copy_(_get(state, key, shape, transpose).to(device))
    return out


def _stack(state, fmt: str, n: int, shape, dt, device,
           transpose: bool = False) -> torch.Tensor:
    """[n, *shape] from the keys ``fmt.format(i=0..n-1)``."""
    out = torch.empty((n, *shape), dtype=dt, device=device)
    for i in range(n):
        out[i].copy_(_get(state, fmt.format(i=i), shape, transpose).to(device))
    return out


def _experts(state, fmt: str, n_layers: int, n_experts: int, shape, dt,
             device) -> torch.Tensor:
    """[L, E, *shape] from the per-expert linears ``fmt.format(i=layer,
    j=expert)``, filled one expert at a time."""
    out = torch.empty((n_layers, n_experts, *shape), dtype=dt, device=device)
    for i in range(n_layers):
        for j in range(n_experts):
            out[i, j].copy_(_get(state, fmt.format(i=i, j=j), shape,
                                 True).to(device))
    return out


def qwen3_from_hf(state: Mapping[str, Any], cfg: Qwen3Config, dtype=None,
                  device="cpu") -> Dict[str, Any]:
    """HF Qwen3ForCausalLM / Qwen3MoeForCausalLM (or bare Qwen3Model) state
    dict -> ``models.qwen3`` params on ``device``; the MoE router stays in
    at least fp32."""
    dt = torch_dtype(dtype or cfg.dtype)
    L, H, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    I, Dq, Dkv, Dh = (cfg.intermediate_size, cfg.q_dim, cfg.kv_dim,
                      cfg.head_dim)
    pre = "model." if any(k.startswith("model.") for k in state) else ""
    lf = pre + "layers.{i}."

    def stack(name, shape, transpose=False, to=dt):
        return _stack(state, lf + name, L, shape, to, device, transpose)

    layers = {
        "input_norm": stack("input_layernorm.weight", (H,)),
        "post_attn_norm": stack("post_attention_layernorm.weight", (H,)),
        "q_proj": stack("self_attn.q_proj.weight", (H, Dq), True),
        "k_proj": stack("self_attn.k_proj.weight", (H, Dkv), True),
        "v_proj": stack("self_attn.v_proj.weight", (H, Dkv), True),
        "o_proj": stack("self_attn.o_proj.weight", (Dq, H), True),
        "q_norm": stack("self_attn.q_norm.weight", (Dh,)),
        "k_norm": stack("self_attn.k_norm.weight", (Dh,)),
    }
    params = {"embed": _one(state, pre + "embed_tokens.weight", (V, H), dt,
                            device),
              "layers": layers,
              "final_norm": _one(state, pre + "norm.weight", (H,), dt,
                                 device)}
    if cfg.num_experts:
        # mlp.gate = the router Linear [E, H]; mlp.experts.{j}.* per expert,
        # stacked [L, E, H, I] / [L, E, I, H] one expert at a time
        E = cfg.num_experts
        layers["router"] = stack("mlp.gate.weight", (H, E), True,
                                 torch.promote_types(torch.float32, dt))
        for hf_name, ours, shape in (("gate_proj", "expert_gate", (H, I)),
                                     ("up_proj", "expert_up", (H, I)),
                                     ("down_proj", "expert_down", (I, H))):
            layers[ours] = _experts(
                state, lf + "mlp.experts.{j}." + hf_name + ".weight", L, E,
                shape, dt, device)
    else:
        layers["gate_proj"] = stack("mlp.gate_proj.weight", (H, I), True)
        layers["up_proj"] = stack("mlp.up_proj.weight", (H, I), True)
        layers["down_proj"] = stack("mlp.down_proj.weight", (I, H), True)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _one(state, "lm_head.weight", (H, V), dt, device,
                                 transpose=True)
    return params


# NT-v2 custom-code checkpoints name the SwiGLU gate differently across
# releases
_GATE_KEYS = ("intermediate.gate_proj.weight", "gate_proj.weight",
              "intermediate.dense_gate.weight", "mlp.gate.weight")


def esm_from_hf(state: Mapping[str, Any], cfg: EsmConfig, dtype=None,
                device="cpu") -> Dict[str, Any]:
    """HF EsmForMaskedLM (or EsmModel) state dict -> ``models.esm``
    params on ``device``."""
    dt = torch_dtype(dtype or cfg.dtype)
    L, H, I, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    pre = "esm." if any(k.startswith("esm.") for k in state) else ""
    lf = pre + "encoder.layer.{i}."

    def one(key, shape, transpose=False):
        return _one(state, pre + key, shape, dt, device, transpose)

    def stack(name, shape, transpose=False):
        return _stack(state, lf + name, L, shape, dt, device, transpose)

    def ln_stack(name):
        return {"weight": stack(name + ".weight", (H,)),
                "bias": stack(name + ".bias", (H,))}

    layers = {
        "attn_ln": ln_stack("attention.LayerNorm"),
        "q": stack("attention.self.query.weight", (H, H), True),
        "q_b": stack("attention.self.query.bias", (H,)),
        "k": stack("attention.self.key.weight", (H, H), True),
        "k_b": stack("attention.self.key.bias", (H,)),
        "v": stack("attention.self.value.weight", (H, H), True),
        "v_b": stack("attention.self.value.bias", (H,)),
        "attn_out": stack("attention.output.dense.weight", (H, H), True),
        "attn_out_b": stack("attention.output.dense.bias", (H,)),
        "ffn_ln": ln_stack("LayerNorm"),
        "ffn_in": stack("intermediate.dense.weight", (H, I), True),
    }
    if cfg.mlp_bias:
        layers["ffn_in_b"] = stack("intermediate.dense.bias", (I,))
        layers["ffn_out"] = stack("output.dense.weight", (I, H), True)
        layers["ffn_out_b"] = stack("output.dense.bias", (H,))
    else:
        # bias-free FFN (NT-v2): zero biases keep init_params' structure
        layers["ffn_in_b"] = torch.zeros((L, I), dtype=dt, device=device)
        layers["ffn_out"] = stack("output.dense.weight", (I, H), True)
        layers["ffn_out_b"] = torch.zeros((L, H), dtype=dt, device=device)
    if cfg.mlp_type == "swiglu":
        for cand in _GATE_KEYS:
            if lf.format(i=0) + cand in state:
                layers["ffn_gate"] = stack(cand, (H, I), True)
                break
        else:
            raise KeyError(
                "could not locate the SwiGLU gate weight in this checkpoint; "
                "expected one of intermediate.gate_proj/gate_proj/"
                "intermediate.dense_gate/mlp.gate")
    params = {
        "embed": one("embeddings.word_embeddings.weight", (V, H)),
        "layers": layers,
        "final_ln": {
            "weight": one("encoder.emb_layer_norm_after.weight", (H,)),
            "bias": one("encoder.emb_layer_norm_after.bias", (H,)),
        },
    }
    if cfg.emb_layer_norm_before:
        params["emb_ln"] = {
            "weight": one("embeddings.layer_norm.weight", (H,)),
            "bias": one("embeddings.layer_norm.bias", (H,)),
        }
    if cfg.position_embedding_type == "absolute":
        params["pos_embed"] = one("embeddings.position_embeddings.weight",
                                  (cfg.max_position_embeddings, H))
    return params


def _getter(hf_cfg):
    return (hf_cfg.get if isinstance(hf_cfg, dict)
            else lambda k, d=None: getattr(hf_cfg, k, d))


def qwen3_cfg_from_hf_config(hf_cfg, **overrides) -> Qwen3Config:
    """The port's config from a ``config.json`` dict or a transformers
    Qwen3Config / Qwen3MoeConfig object."""
    get = _getter(hf_cfg)
    kw = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        rms_norm_eps=get("rms_norm_eps"),
        rope_theta=get("rope_theta"),
        tie_word_embeddings=get("tie_word_embeddings"),
        max_position_embeddings=get("max_position_embeddings"),
    )
    if get("num_experts"):  # Qwen3MoeConfig
        kw.update(
            num_experts=get("num_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 8),
            norm_topk_prob=bool(get("norm_topk_prob", True)),
            router_aux_coef=get("router_aux_loss_coef", 1e-3),
            intermediate_size=get("moe_intermediate_size"),
        )
    kw.update(overrides)
    return Qwen3Config(**kw)


def esm_cfg_from_hf_config(hf_cfg, **overrides) -> EsmConfig:
    """The port's config from a ``config.json`` dict or a transformers
    EsmConfig object."""
    get = _getter(hf_cfg)
    kw = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        position_embedding_type=get("position_embedding_type", "absolute"),
        emb_layer_norm_before=bool(get("emb_layer_norm_before", False)),
        token_dropout=bool(get("token_dropout", False)),
        layer_norm_eps=get("layer_norm_eps", 1e-5),
        pad_token_id=get("pad_token_id", 1),
        mask_token_id=get("mask_token_id", 32),
        max_position_embeddings=get("max_position_embeddings", 1026),
    )
    kw.update(overrides)
    return EsmConfig(**kw)


def peft_target_path(target: str) -> str:
    if target in ("q_proj", "k_proj", "v_proj", "o_proj"):
        return f"self_attn.{target}"
    return f"mlp.{target}"


def peft_lora_from_hf(state: Mapping[str, Any], cfg: Qwen3Config,
                      lora_r: int, dtype=torch.float32,
                      device="cpu") -> Dict[str, Any]:
    """PEFT adapter state dict -> ``models.lora`` tree.

    PEFT keys: ``<prefix>layers.{i}.self_attn.q_proj.lora_A.weight`` [r, in]
    and ``lora_B.weight`` [out, r] (the prefix differs across PEFT
    versions and is found from the first ``lora_A`` of layer 0); the port's
    are a [L, in, r] and b [L, r, out]. A target absent from the adapter is
    skipped; on an MoE config the experts' ``mlp.experts.{j}.*`` adapters
    stack to [L, E, in, r] / [L, E, r, out]. ``lora_r`` is the default rank
    of the JAX signature; the rank comes from the tensors."""
    from .lora import LORA_TARGETS, target_dims

    sample = next((k for k in state if "lora_A" in k and "layers.0." in k),
                  None)
    if sample is None:
        raise KeyError("no lora_A weights found in adapter state dict")
    prefix = sample.split("layers.0.")[0]
    r = _tensor(state[sample]).shape[0]
    dims = target_dims(cfg)
    L = cfg.num_hidden_layers

    layers: Dict[str, Any] = {}
    for target in LORA_TARGETS:
        fmt = (prefix + "layers.{i}." + peft_target_path(target)
               + ".lora_{ab}.weight")
        if fmt.format(i=0, ab="A") not in state:
            continue  # adapter trained on a subset of targets
        din, dout = dims[target]
        layers[target] = {
            "a": _stack(state, fmt.replace("{ab}", "A"), L, (din, r), dtype,
                        device, True),
            "b": _stack(state, fmt.replace("{ab}", "B"), L, (r, dout), dtype,
                        device, True)}
    if cfg.num_experts:
        E = cfg.num_experts
        for hf_t, ours in (("gate_proj", "expert_gate"),
                           ("up_proj", "expert_up"),
                           ("down_proj", "expert_down")):
            fmt = (prefix + "layers.{i}.mlp.experts.{j}." + hf_t
                   + ".lora_{ab}.weight")
            if fmt.format(i=0, j=0, ab="A") not in state:
                continue
            din, dout = dims[ours]
            layers[ours] = {
                "a": _experts(state, fmt.replace("{ab}", "A"), L, E,
                              (din, r), dtype, device),
                "b": _experts(state, fmt.replace("{ab}", "B"), L, E,
                              (r, dout), dtype, device)}
    if not layers:
        raise KeyError("no recognized LoRA targets in adapter state dict")
    return {"layers": layers}


def projector_from_hf(state: Mapping[str, Any], dtype=torch.float32,
                      device="cpu") -> Dict[str, Any]:
    """One ``nn.Linear`` state dict (``weight``, ``bias``; the keys may carry
    a prefix such as ``dna_rna_projector.``) -> a projector ``{kernel,
    bias}`` (the ``dna_rna_projector.bin`` / ``protein_projector.bin`` files
    the reference exports)."""
    wkey = next((k for k in state if k.endswith("weight")), None)
    bkey = next((k for k in state if k.endswith("bias")), None)
    if wkey is None or bkey is None:
        raise KeyError(f"a projector needs a weight and a bias, got "
                       f"{sorted(state)}")
    w = _tensor(state[wkey])
    return {"kernel": _one(state, wkey, tuple(w.shape[::-1]), dtype, device,
                           transpose=True),
            "bias": _one(state, bkey, (w.shape[0],), dtype, device)}
