"""Embedding and visualization tool, the counterpart of
``molly_tpu/tools/embed.py`` (the reference's embed_text.py): every sample
becomes concat(text last-real-token hidden state || mean-pooled DNA/RNA
encoder states || mean-pooled protein encoder states), saved as
``embeddings.npy`` beside a 2-D PCA projection parquet. The forward runs on
the device of the params.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..inference.engine import _as_tensor
from ..inference.server import REQUEST_KEYS
from ..models import esm, fusion, qwen3


@torch.inference_mode()
def embed_batch(params, cfg, batch) -> np.ndarray:
    """[B, H_text + H_dna + H_prot] fp32 embedding of one collated batch
    (right-padded train layout; numpy arrays or tensors)."""
    dev = params["text"]["embed"].device
    b = {k: _as_tensor(v, dev) for k, v in batch.items()
         if k in REQUEST_KEYS}
    embeds = fusion.build_inputs_embeds(params, cfg, b)
    mask = b["attention_mask"]
    hidden, _ = qwen3.forward_hidden(params["text"], cfg.text,
                                     inputs_embeds=embeds,
                                     attention_mask=mask)
    # the last real token (right-padded)
    last_idx = torch.clamp(mask.sum(dim=1) - 1, min=0)
    text_pool = hidden[torch.arange(hidden.shape[0], device=dev), last_idx]

    def pooled(enc_name, enc_cfg, tokens):
        B, G, K = tokens.shape
        flat = tokens.reshape(B * G, K)
        m = (flat != 1).to(torch.int32)
        m[:, 0] = 1
        h = esm.forward_hidden(params[enc_name], enc_cfg, flat, m)
        mf = m[..., None].to(h.dtype)
        mean = (h * mf).sum(dim=1) / torch.clamp(mf.sum(dim=1), min=1)
        return mean.reshape(B, G, -1).mean(dim=1)

    dna_pool = pooled("dna_rna", cfg.dna_rna, b["dna_rna_tokens"])
    prot_pool = pooled("protein", cfg.protein, b["protein_tokens"])
    return torch.cat([text_pool.float(), dna_pool.float(),
                      prot_pool.float()], dim=-1).cpu().numpy()


def pca_2d(x: np.ndarray) -> np.ndarray:
    """Standardize and project onto the 2 leading principal components
    (each component's sign is the SVD's choice)."""
    t = torch.as_tensor(np.asarray(x))
    mu = t.mean(dim=0, keepdim=True)
    sd = t.std(dim=0, keepdim=True, unbiased=False) + 1e-8
    z = (t - mu) / sd
    _, _, vt = torch.linalg.svd(z, full_matrices=False)
    return (z @ vt[:2].T).numpy()


def run_embedding(dataset, params, cfg, out_dir: str,
                  batch_size: int = 16) -> Dict[str, Any]:
    """Embed every sample of ``dataset`` (train-mode encoding) and write
    ``embeddings.npy`` and ``projection_2d.parquet`` (pandas, imported
    here) into ``out_dir``."""
    from ..data.collate import iterate_batches

    os.makedirs(out_dir, exist_ok=True)
    chunks = [embed_batch(params, cfg, batch)
              for batch in iterate_batches(dataset, batch_size,
                                           drop_last=False)]
    emb = np.concatenate(chunks, axis=0)
    np.save(os.path.join(out_dir, "embeddings.npy"), emb)

    proj = pca_2d(emb)
    import pandas as pd
    pd.DataFrame({"x": proj[:, 0], "y": proj[:, 1]}).to_parquet(
        os.path.join(out_dir, "projection_2d.parquet"))
    return {"n": emb.shape[0], "dim": emb.shape[1], "out_dir": out_dir}
