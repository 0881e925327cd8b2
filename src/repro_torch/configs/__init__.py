"""Config registry: ``get_config(arch_id)``, the cache length rule and
input specs (copy of ``repro.configs``).

``input_specs`` gives ``(shape, dtype)`` tuples (torch dtypes) where the
JAX package gives ``jax.ShapeDtypeStruct``s; ``make_batch`` draws the
same numpy arrays as the JAX package's for the same seed.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# input specs: (shape, dtype) tuples, nothing allocated
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``(shape, dtype)`` of every model input of this (arch, shape) cell,
    in the JAX package's key order."""
    B, S = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {
                "frames": ((B, S // 2, cfg.d_model), f32),
                "tokens": ((B, S // 2), i32),
                "loss_mask": ((B, S // 2), f32),
            }
        out = {
            "tokens": ((B, S - cfg.frontend_len), i32),
            "loss_mask": ((B, S - cfg.frontend_len), f32),
        }
        if cfg.frontend == "vision":
            out["extra_embeds"] = ((B, cfg.frontend_len, cfg.d_model), f32)
        return out

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {
                "frames": ((B, S, cfg.d_model), f32),
                "tokens": ((B, max(S // 8, 128)), i32),
            }
        out = {"tokens": ((B, S - cfg.frontend_len), i32)}
        if cfg.frontend == "vision":
            out["extra_embeds"] = ((B, cfg.frontend_len, cfg.d_model), f32)
        return out

    # decode: one new token against a cache of S
    return {"tokens": ((B,), i32), "cur_index": ((), i32)}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0) -> dict:
    """Concrete random numpy batch matching :func:`input_specs`: the JAX
    package's draws in its order, so the same arrays bit for bit."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int32 and k == "tokens":
            out[k] = rng.integers(0, cfg.vocab_size, size=shp).astype(np.int32)
        elif dtype == torch.int32:
            out[k] = np.zeros(shp, np.int32)
        elif k == "loss_mask":
            out[k] = np.ones(shp, np.float32)
        else:
            out[k] = rng.normal(size=shp).astype(np.float32)
    return out
