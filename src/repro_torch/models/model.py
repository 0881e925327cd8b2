"""Model API: build once from a ModelConfig, use everywhere.

    model = build_model(cfg)                    # refuses unported families
    params = model.init(seed, device="cuda")    # nested dict of tensors
    loss = model.loss(params, batch)            # f32 scalar, differentiable
    params = model.compute_params(params)       # serving: matrices cast once
    logits, cache = model.prefill(params, {"tokens": tokens}, s_alloc=...)
    logits, cache = model.decode(params, cache, tokens, cur_index)

The port of ``repro.models.model`` for decoders (dense, MoE, MLA, the
vision frontend).  ``batch`` holds ``tokens`` (B, S) int and
``loss_mask`` (B, S) f32 tensors, and for the vision frontend
``extra_embeds`` (B, F, d), prepended to the token embeddings.  Entry points
run on the card unless the caller passes ``device="cpu"``, and raise
without one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import transformer
from .layers import resolve_device


def cross_entropy(logits, targets, mask, *, z_loss: float = 0.0):
    """Mean CE over masked positions; f32 logsumexp; optional z-loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


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

    # -- training ------------------------------------------------------------
    def loss(self, values, batch, *, attention=None):
        """Next-token CE of ``batch`` (logits shifted by one against the
        tokens and mask; the frontend's positions cut off first), plus the
        forward's aux loss.  ``attention``: as
        :func:`transformer.forward`'s."""
        cfg = self.cfg
        if cfg.family == "encdec":
            raise NotImplementedError("the encdec loss comes with models/"
                                      "encdec.py (ROADMAP.md Queue 1, item 20)")
        extra = batch.get("extra_embeds")
        logits, aux = transformer.forward(values, cfg, batch["tokens"],
                                          extra_embeds=extra,
                                          attention=attention)
        logits = logits[:, cfg.frontend_len if extra is not None else 0:]
        tgt, mask = batch["tokens"], batch["loss_mask"]
        return cross_entropy(logits[:, :-1], tgt[:, 1:], mask[:, 1:],
                             z_loss=cfg.z_loss) + aux

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

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared of routed
        layers), from shapes alone."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.moe is None:
            return total
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        n_moe_layers = cfg.n_layers - m.first_dense_layers
        return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert


def build_model(cfg) -> Model:
    """A :class:`Model`; ``NotImplementedError`` for a family the port does
    not run yet."""
    transformer.check_ported(cfg)
    return Model(cfg)
