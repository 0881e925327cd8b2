"""The model plane for serving and training (port of ``repro.models``:
decoders, dense or MoE, with full or MLA attention, and the vision
frontend's prepended embeddings).

  * layers      — parameter specs, rmsnorm, RoPE, MLP, embeddings
  * attention   — GQA and MLA projections, flash attention (kernel F on a
    card, the plain chunked version on the CPU), decode attention (GQA,
    and MLA's absorbed form over the compressed cache)
  * moe         — top-k routing with capacity, dispatch, experts, combine
  * transformer — init, forward, prefill, decode for ``dense_attn`` and
    ``moe_attn`` blocks
  * model       — ``Model`` and ``build_model``
  * convert     — the JAX package's parameters in the port's layout
"""
