"""Model API: build once from a ModelConfig, use everywhere.

    model = build_model(cfg)
    params = model.init(seed, device="cuda")    # nested dict of tensors
    loss = model.loss(params, batch)            # f32 scalar, differentiable
    params = model.compute_params(params)       # serving: matrices cast once
    logits, cache = model.prefill(params, {"tokens": tokens}, s_alloc=...)
    logits, cache = model.decode(params, cache, tokens, cur_index)

The port of ``repro.models.model``: decoders (dense, MoE, MLA, local
attention, the vision frontend), hybrid (RG-LRU and local attention) and
RWKV in ``transformer.py``, the encoder-decoder in ``encdec.py``.
``batch`` holds ``tokens`` (B, S) int and ``loss_mask`` (B, S) f32
tensors, for the vision frontend ``extra_embeds`` (B, F, d), prepended to
the token embeddings, and for encdec ``frames`` (B, S_src, d), the
encoder's input.  Entry points run on the card unless the caller passes
``device="cpu"``, and raise without one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.dist import sharding

from . import encdec, transformer
from .layers import resolve_device, torch_dtype, tree_map


def family_module(cfg):
    """The module that builds ``cfg``'s family: ``encdec`` or
    ``transformer`` (every other family)."""
    return encdec if cfg.family == "encdec" else transformer


def cross_entropy(logits, targets, mask, *, z_loss: float = 0.0):
    """Mean CE over masked positions; f32 logsumexp; optional z-loss.  On
    a mesh the logits' vocab dim is gathered first (the target's logit is
    read by index)."""
    logits = sharding.replicate_dim(logits.float(), -1)
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
        return family_module(self.cfg).init_params(self.cfg, gen, dev)

    def abstract_params(self):
        """``(values, axes)`` without allocating: every leaf a tensor on
        the ``meta`` device in ``cfg.param_dtype``, and the logical axes
        beside it (the JAX package's ``eval_shape`` and ``split``)."""
        fam = family_module(self.cfg)
        dt = torch_dtype(self.cfg.param_dtype)
        values = tree_map(lambda shape: torch.empty(shape, dtype=dt,
                                                    device="meta"),
                          fam.param_shapes(self.cfg))
        return values, fam.param_axes(self.cfg)

    def compute_params(self, values) -> dict:
        return transformer.compute_params(values, self.cfg)

    # -- training ------------------------------------------------------------
    def loss(self, values, batch, *, attention=None):
        """Next-token CE of ``batch`` (logits shifted by one against the
        tokens and mask; the frontend's positions cut off first), plus the
        forward's aux loss.  ``attention``: as
        :func:`transformer.forward`'s and :func:`encdec.forward`'s."""
        cfg = self.cfg
        if cfg.family == "encdec":
            logits, aux = encdec.forward(values, cfg, batch["frames"],
                                         batch["tokens"], attention=attention)
        else:
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
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.prefill(values, cfg, batch["frames"],
                                  batch["tokens"], s_alloc=s_alloc,
                                  cache_dtype=cache_dtype)
        return transformer.prefill(
            values, cfg, batch["tokens"], s_alloc=s_alloc,
            cache_dtype=cache_dtype, extra_embeds=batch.get("extra_embeds"))

    def init_cache(self, batch_size: int, s_alloc: int, *, s_cross: int = 0,
                   cache_dtype=torch.bfloat16, device="cuda"):
        """Zeroed caches; ``s_cross`` is the encoder memory's length
        (encdec only)."""
        dev = resolve_device(device)
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, batch_size, s_alloc, s_cross,
                                     cache_dtype, dev)
        return transformer.init_cache(self.cfg, batch_size, s_alloc,
                                      cache_dtype, dev)

    def decode(self, values, cache, tokens, cur_index, *, axis_name=None):
        return family_module(self.cfg).decode_step(
            values, self.cfg, cache, tokens, cur_index, axis_name=axis_name)

    # -- accounting ----------------------------------------------------------
    def param_count(self) -> int:
        """From shapes alone: no configuration is built to be counted."""
        return family_module(self.cfg).param_count(self.cfg)

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
    """A :class:`Model`; ``NotImplementedError`` for a family or attention
    that no configuration has (``transformer.check_ported``)."""
    transformer.check_ported(cfg)
    return Model(cfg)
