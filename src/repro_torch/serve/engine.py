"""LLM serving engine: prefill and decode steps, on one card or a mesh.

The port of ``repro.serve.engine``.  NOT the CIAO store-serving plane
(``serve/store_engine.py`` in the JAX package), which serves queries;
this module serves the model.

``make_serve_fns(model, mesh, batch=..., seq_len=...)`` returns the two
step functions and the cache lengths the serve entry point uses:

  * ``prefill(params, inputs) -> (logits, cache)``: the cache is allocated
    at ``s_alloc = cache_alloc_len(seq_len)`` positions (encdec: its
    cross k/v at the encoder memory's length; ``s_cross``, 4096 for
    encdec as in the JAX package, is the length :func:`cache_shape`
    lays out and a ``Model.init_cache`` of that family takes);
  * ``decode(params, cache, tokens, cur_index) -> (logits, cache)``: the
    cache is updated in place, so steady-state decode allocates no cache
    (the counterpart of the JAX package's donated cache).

With a ``mesh`` both run with it current (``dist.sharding.use_mesh``):
the parameters are DTensors (sharded as ``param_shardings`` says, by the
caller, once), plain inputs are laid out over the batch axes
(``batch_spec``), and the model runs on DTensors (``transformer``'s mesh
path: attention on each rank's batch rows and heads under ``local_map``,
on kernel F on a card), its cache replicated DTensors
(``dist.sharding.shard_cache``); logits come back as DTensors over the
batch axes.  Decode with a ``model`` axis over 1 that divides the cache
reaches the flash-decoding stub, as the JAX package's does.

``mesh=None`` is one device.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.configs import cache_alloc_len
from repro_torch.dist import sharding as shd
from repro_torch.models.layers import tree_map


def cache_shape(model, batch: int, s_alloc: int, *, s_cross: int = 0,
                cache_dtype=torch.bfloat16) -> dict:
    """The cache's tree on the ``meta`` device: shapes and dtypes, nothing
    allocated (the JAX package's ``eval_shape`` of ``init_cache``)."""
    return model.init_cache(batch, s_alloc, s_cross=s_cross,
                            cache_dtype=cache_dtype, device="meta")


def _laid_out(x, mesh, batch: int):
    """A plain input as a DTensor over the batch axes of ``mesh``."""
    if mesh is None or shd.is_dtensor(x):
        return x
    return shd.distribute(x, shd.NamedSharding(
        mesh, shd.batch_spec(mesh, x.ndim, batch_size=batch)))


def make_serve_fns(model, mesh=None, *, batch: int, seq_len: int,
                   cache_dtype=torch.bfloat16, param_shardings=None) -> dict:
    """``param_shardings`` (``dist.sharding.param_shardings``), as the
    JAX package's ``in_shardings``: a plain parameter leaf is placed by it
    on each call; DTensor leaves go in as they are."""
    cfg = model.cfg
    s_alloc = cache_alloc_len(seq_len)
    s_cross = 4096 if cfg.family == "encdec" else 0

    def placed(params):
        if param_shardings is None:
            return params
        return tree_map(lambda x, sh: x if shd.is_dtensor(x)
                        else shd.distribute(x, sh), params, param_shardings)

    def prefill(params, inputs):
        if inputs["tokens"].shape[0] != batch:
            raise ValueError(f"prefill built for batch {batch}, got "
                             f"{inputs['tokens'].shape[0]}")
        with tracing.span("serve.prefill"):
            inputs = {k: _laid_out(v, mesh, batch) for k, v in inputs.items()}
            with shd.use_mesh(mesh):
                return model.prefill(placed(params), inputs, s_alloc=s_alloc,
                                     cache_dtype=cache_dtype)

    def decode(params, cache, tokens, cur_index):
        with tracing.span("serve.decode"):
            tokens = _laid_out(tokens, mesh, batch)
            with shd.use_mesh(mesh):
                return model.decode(placed(params), cache, tokens, cur_index)

    return {"prefill": prefill, "decode": decode, "s_alloc": s_alloc,
            "s_cross": s_cross}


def greedy_generate(model, fns, params, prompt_tokens, *, n_steps: int):
    """Batched greedy decode loop; returns int32 ``(B, n_steps)`` (a
    DTensor on a mesh).  Its prefill takes the tokens alone, as the JAX
    package's does (the vision frontend's embeddings and encdec's frames
    go through ``fns`` by hand).

    The argmax takes the first of equal maxima, as ``jnp.argmax`` does.
    """
    S = prompt_tokens.shape[1]
    logits, cache = fns["prefill"](params, {"tokens": prompt_tokens})
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    cur = S
    for _ in range(n_steps):
        out.append(tok)
        logits, cache = fns["decode"](params, cache, tok, cur)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        cur += 1
    return torch.stack(out, dim=1)
