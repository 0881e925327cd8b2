"""LLM serving engine: prefill and decode steps on one card.

The port of ``repro.serve.engine`` without a mesh.  NOT the CIAO
store-serving plane (``serve/store_engine.py`` in the JAX package), which
serves queries; this module serves the model.

``make_serve_fns(model, batch=..., seq_len=...)`` returns the two step
functions and the cache lengths the serve entry point uses:

  * ``prefill(params, inputs) -> (logits, cache)``: the cache is allocated
    at ``s_alloc = cache_alloc_len(seq_len)`` positions (encdec: its
    cross k/v at the encoder memory's length; ``s_cross``, 4096 for
    encdec as in the JAX package, is the length its ``cache_shape``
    lays out and a ``Model.init_cache`` of that family takes);
  * ``decode(params, cache, tokens, cur_index) -> (logits, cache)``: the
    cache is updated in place, so steady-state decode allocates no cache
    (the counterpart of the JAX package's donated cache).

Sharded caches and parameter layouts come with the model mesh
(ROADMAP.md Queue 1, item 14).
"""
from __future__ import annotations

import torch

from repro_torch.configs import cache_alloc_len


def make_serve_fns(model, *, batch: int, seq_len: int,
                   cache_dtype=torch.bfloat16) -> dict:
    s_alloc = cache_alloc_len(seq_len)
    s_cross = 4096 if model.cfg.family == "encdec" else 0

    def prefill(params, inputs):
        if inputs["tokens"].shape[0] != batch:
            raise ValueError(f"prefill built for batch {batch}, got "
                             f"{inputs['tokens'].shape[0]}")
        return model.prefill(params, inputs, s_alloc=s_alloc,
                             cache_dtype=cache_dtype)

    def decode(params, cache, tokens, cur_index):
        return model.decode(params, cache, tokens, cur_index)

    return {"prefill": prefill, "decode": decode, "s_alloc": s_alloc,
            "s_cross": s_cross}


def greedy_generate(model, fns, params, prompt_tokens, *, n_steps: int):
    """Batched greedy decode loop; returns int32 ``(B, n_steps)``.  Its
    prefill takes the tokens alone, as the JAX package's does (the vision
    frontend's embeddings and encdec's frames go through ``fns`` by
    hand).

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
