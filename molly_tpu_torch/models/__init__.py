"""Qwen3 decoder, ESM-family encoders and the tri-modal fusion model in
PyTorch (counterparts of ``molly_tpu.models``)."""

from .configs import (ESM_PRESETS, QWEN3_PRESETS, EsmConfig, FusionConfig,
                      GenerationConfig, Qwen3Config, tiny_esm, tiny_moe,
                      tiny_qwen3)

__all__ = ["ESM_PRESETS", "QWEN3_PRESETS", "EsmConfig", "FusionConfig",
           "GenerationConfig", "Qwen3Config", "tiny_esm", "tiny_moe",
           "tiny_qwen3"]
