"""Faults planted under a run's timed path, for the check's own tests and
for reading what each fault does to the numbers compared.

Each is a drop-in for the entry the driver builds its timed calls from
(``make_fns`` of :func:`perfbench.harness.serve.run`, ``make_step`` of
:func:`perfbench.harness.train.run`).
"""
from __future__ import annotations

import torch

from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.train_step import make_train_step


def altered_token(model, **kw):
    """Serving: every step's logits shifted by one id, so each served token
    is the next id after the greedy one."""
    fns = make_serve_fns(model, **kw)
    prefill, decode = fns["prefill"], fns["decode"]

    def shifted(out):
        logits, cache = out
        return torch.roll(logits, 1, dims=-1), cache

    return {**fns, "prefill": lambda *a: shifted(prefill(*a)),
            "decode": lambda *a: shifted(decode(*a))}


def _clone(tree):
    return ({k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.clone())


def stale_cache(model, **kw):
    """Serving: each decode step attends over a copy of the cache and
    returns the cache as it came, so no decoded token's keys and values
    are kept for the steps after it."""
    fns = make_serve_fns(model, **kw)
    decode = fns["decode"]

    def stale(params, cache, tokens, cur_index):
        logits, _ = decode(params, _clone(cache), tokens, cur_index)
        return logits, cache

    return {**fns, "decode": stale}


def half_batch(model, opt_cfg, **kw):
    """Training: the step sees the first half of the batch's rows only
    (the mean taken over them)."""
    step = make_train_step(model, opt_cfg, **kw)

    def half(params, opt_state, batch):
        return step(params, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return half


def unchanged(model, opt_cfg, **kw):
    """Training: the step computes the loss and returns its state as it
    came."""
    def same(params, opt_state, batch):
        with torch.no_grad():
            loss = model.loss(params, batch)
        return params, opt_state, {"loss": loss}
    return same


SERVE = {"altered_token": altered_token, "stale_cache": stale_cache}
TRAIN = {"half_batch": half_batch, "unchanged": unchanged}
