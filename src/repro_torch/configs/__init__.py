"""Architecture config registry: ``get_config(arch_id)`` and ``ARCHS`` (the
port's copy of ``repro/configs``: the same ten configurations)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    LONG_CONTEXT_WINDOW,
    SHAPES,
    ModelConfig,
    ShapeSpec,
)

_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "gemma-2b": "gemma_2b",
    "llama3-405b": "llama3_405b",
    "whisper-base": "whisper_base",
    "minicpm-2b": "minicpm_2b",
    "stablelm-12b": "stablelm_12b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}

ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.get_config()
