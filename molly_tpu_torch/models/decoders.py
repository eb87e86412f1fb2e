"""The decoder architectures the fusion model runs, found by the type of
its text configuration (``FusionConfig.text``): ``Qwen3Config`` ->
``models.qwen3``, ``DeepseekV3Config`` -> ``models.deepseek_v3``. Each
module has the same entry points: ``init_params``, ``init_cache``,
``forward_hidden``, ``logits_from_hidden``, ``embed_tokens`` and
``quantize_for_decode``. ``models.fusion``, ``inference.engine`` and the
inference CLI reach a decoder only through ``of``."""

from __future__ import annotations

from types import ModuleType

from . import deepseek_v3, qwen3
from .configs import DeepseekV3Config, Qwen3Config

_MODULES = {Qwen3Config: qwen3, DeepseekV3Config: deepseek_v3}


def of(text_cfg) -> ModuleType:
    """The model module of a text configuration."""
    module = _MODULES.get(type(text_cfg))
    if module is None:
        raise TypeError(f"no decoder for a text configuration of type "
                        f"{type(text_cfg).__name__}: one of "
                        f"{sorted(c.__name__ for c in _MODULES)}")
    return module
