"""Config registry: ``get_config(arch_id)`` and the cache length rule
(copy of ``repro.configs``).

``input_specs`` and ``make_batch`` build ``jax.ShapeDtypeStruct``s for
training and the dry run; they come with the training slice.
"""
from __future__ import annotations

import importlib

from .base import (  # noqa: F401
    SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig,
    shape_applicable,
)

ARCHS: dict[str, str] = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-76b": "internvl2_76b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-7b": "deepseek_7b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen3-8b": "qwen3_8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


def cache_alloc_len(seq_len: int) -> int:
    """Decode cache allocation: context + headroom, 128-aligned."""
    return seq_len + 128
