"""Model API for serving: build once from a ModelConfig, use everywhere.

    model = build_model(cfg)                    # refuses unported families
    params = model.init(seed, device="cuda")    # nested dict of tensors
    params = model.compute_params(params)       # matrices in compute dtype
    logits, cache = model.prefill(params, {"tokens": tokens}, s_alloc=...)
    logits, cache = model.decode(params, cache, tokens, cur_index)

The port of ``repro.models.model`` for the serving path; ``loss`` and the
training plane come with the training slice.  Entry points run on the
card unless the caller passes ``device="cpu"``, and raise without one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import transformer
from .layers import resolve_device


@dataclass
class Model:
    cfg: object                       # repro_torch.configs.ModelConfig

    # -- init ----------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda") -> dict:
        """Parameters drawn from a generator seeded with ``seed`` on
        ``device`` (``mk``'s distributions, not ``jax.random``'s numbers)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return transformer.init_params(self.cfg, gen, dev)

    def compute_params(self, values) -> dict:
        return transformer.compute_params(values, self.cfg)

    # -- serving -------------------------------------------------------------
    def prefill(self, values, batch, *, s_alloc: int,
                cache_dtype=torch.bfloat16):
        return transformer.prefill(
            values, self.cfg, batch["tokens"], s_alloc=s_alloc,
            cache_dtype=cache_dtype, extra_embeds=batch.get("extra_embeds"))

    def init_cache(self, batch_size: int, s_alloc: int, *,
                   cache_dtype=torch.bfloat16, device="cuda"):
        return transformer.init_cache(self.cfg, batch_size, s_alloc,
                                      cache_dtype, resolve_device(device))

    def decode(self, values, cache, tokens, cur_index, *, axis_name=None):
        return transformer.decode_step(values, self.cfg, cache, tokens,
                                       cur_index, axis_name=axis_name)

    # -- accounting ----------------------------------------------------------
    def param_count(self) -> int:
        """From shapes alone: no configuration is built to be counted."""
        return transformer.param_count(self.cfg)


def build_model(cfg) -> Model:
    """A :class:`Model`; ``NotImplementedError`` for a family the port does
    not run yet."""
    transformer.check_ported(cfg)
    return Model(cfg)
