"""Encoder + classification-head baselines, the counterpart of
``molly_tpu/baselines``: frozen ESM-family backbones and one trainable
linear head (``model``), the classification dataset (``dataset``) and the
training CLI (``python -m molly_tpu_torch.baselines.train``)."""

from .model import (MODEL_TYPES, BaselineConfig, forward_logits, init_params,
                    loss_fn)
from .dataset import ClassificationDataset, collate
