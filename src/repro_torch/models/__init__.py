"""The model plane for serving (port of ``repro.models``, dense decoders).

  * layers      — parameter specs, rmsnorm, RoPE, MLP, embeddings
  * attention   — GQA projections, flash attention (kernel F on a card,
    the plain chunked version on the CPU), decode attention
  * transformer — init, forward, prefill, decode for ``dense_attn`` blocks
  * model       — ``Model`` and ``build_model``
  * convert     — the JAX package's parameters in the port's layout
"""
