"""Encoder + classification-head baselines, the counterpart of
``molly_tpu/baselines/model.py``.

Five model types: NT, ESM, NT+ESM, NT+NT, ESM+ESM. The [CLS] hidden state
of each frozen ESM-family backbone (``models.esm.forward_hidden``; pairs
concatenated) goes through one trainable fp32 linear head; the loss is CE,
or BCE-with-logits over multihot labels (``multi_answer``). A backbone none
of whose leaves requires grad runs under ``torch.no_grad()``, so no encoder
backward exists (XLA's dead-code elimination gives the JAX package the
same). The params keep the JAX tree (``enc1``, ``enc2``, ``head``), so
``models.convert.params_from_jax`` carries the JAX package's params across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import esm
from ..models.configs import EsmConfig
from ..utils.tree import leaves

MODEL_TYPES = ("NT", "ESM", "NT+ESM", "NT+NT", "ESM+ESM")


@dataclass(frozen=True)
class BaselineConfig:
    model_type: str = "NT"
    nt: Optional[EsmConfig] = None
    protein: Optional[EsmConfig] = None
    num_labels: int = 2
    multi_answer: bool = False  # BCE-with-logits over multihot labels

    def encoder_cfgs(self) -> Tuple[EsmConfig, Optional[EsmConfig]]:
        t = self.model_type
        if t == "NT":
            return self.nt, None
        if t == "ESM":
            return self.protein, None
        if t == "NT+ESM":
            return self.nt, self.protein
        if t == "NT+NT":
            return self.nt, self.nt
        if t == "ESM+ESM":
            return self.protein, self.protein
        raise ValueError(f"invalid model_type {t!r}")


def init_params(cfg: BaselineConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random backbones (``esm.init_params``; NT+NT and ESM+ESM get two
    independent copies, as the reference deep-copies) and a head drawn
    uniform in +-dim^-0.5, all from ``generator`` (on ``device``)."""
    c1, c2 = cfg.encoder_cfgs()
    dim = c1.hidden_size + (c2.hidden_size if c2 else 0)
    params: Dict[str, Any] = {"enc1": esm.init_params(c1, generator, device)}
    if c2 is not None:
        params["enc2"] = esm.init_params(c2, generator, device)
    bound = dim ** -0.5
    u = torch.rand((dim, cfg.num_labels), generator=generator,
                   dtype=torch.float32, device=device)
    params["head"] = {
        "kernel": u.mul_(2 * bound).sub_(bound),
        "bias": torch.zeros((cfg.num_labels,), dtype=torch.float32,
                            device=device),
    }
    return params


def _cls_embedding(enc_params, enc_cfg: EsmConfig, ids, mask):
    trains = any(t.requires_grad for t in leaves(enc_params))
    with torch.set_grad_enabled(trains and torch.is_grad_enabled()):
        h = esm.forward_hidden(enc_params, enc_cfg, ids, mask)
    return h[:, 0]  # [CLS]


def forward_logits(params, cfg: BaselineConfig, batch) -> torch.Tensor:
    """batch: ``x1``, ``mask1`` (and ``x2``, ``mask2`` for a pair) on the
    params' device -> fp32 logits [B, num_labels]."""
    c1, c2 = cfg.encoder_cfgs()
    h = _cls_embedding(params["enc1"], c1, batch["x1"], batch["mask1"])
    if c2 is not None:
        h2 = _cls_embedding(params["enc2"], c2, batch["x2"], batch["mask2"])
        h = torch.cat([h, h2], dim=-1)
    head = params["head"]
    return h.to(torch.float32) @ head["kernel"] + head["bias"]


def loss_fn(params, cfg: BaselineConfig, batch):
    """(mean loss, logits): CE over integer labels, or BCE-with-logits over
    multihot labels when ``cfg.multi_answer``."""
    logits = forward_logits(params, cfg, batch)
    labels = batch["labels"]
    if cfg.multi_answer:
        labels = labels.to(torch.float32)
        logp = F.logsigmoid(logits)
        lognp = F.logsigmoid(-logits)
        loss = -torch.mean(labels * logp + (1 - labels) * lognp)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
        loss = torch.mean(lse - tgt)
    return loss, logits
