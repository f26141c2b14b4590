"""Architecture registry: ``get_config(arch_id)`` / ``ARCH_IDS``.

The ten config modules are data copied from ``repro.configs``;
``shapes.py`` holds the dry run's four assigned shapes
(``python -m repro_torch.launch.dryrun``).
"""
from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_MODULES = {
    "mamba2-1.3b": ".mamba2_1p3b",
    "jamba-v0.1-52b": ".jamba_v0p1_52b",
    "gemma2-9b": ".gemma2_9b",
    "deepseek-7b": ".deepseek_7b",
    "llama3-8b": ".llama3_8b",
    "starcoder2-3b": ".starcoder2_3b",
    "deepseek-v2-236b": ".deepseek_v2_236b",
    "phi3.5-moe-42b-a6.6b": ".phi3p5_moe",
    "seamless-m4t-medium": ".seamless_m4t_medium",
    "pixtral-12b": ".pixtral_12b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = import_module(_MODULES[arch_id], package=__name__)
    return mod.CONFIG


from .shapes import SHAPES, ShapeSpec, applies, batch_specs, cache_dims
