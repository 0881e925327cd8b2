"""The model plane for serving and training (port of ``repro.models``:
decoders, dense or MoE, with full, local or MLA attention and the vision
frontend's prepended embeddings; the hybrid RG-LRU family; RWKV6; the
encoder-decoder).

  * layers      — parameter specs, rmsnorm, groupnorm, RoPE, MLP,
    embeddings
  * attention   — GQA and MLA projections, flash attention (kernel F on a
    card, the plain chunked version on the CPU; causal, local, unmasked
    and cross), decode attention (GQA, and MLA's absorbed form over the
    compressed cache)
  * moe         — top-k routing with capacity, dispatch, experts, combine
  * rglru       — the RG-LRU block (recurrentgemma), its prefix scan
  * rwkv6       — RWKV6's time-mix and channel-mix
  * transformer — init, forward, prefill, decode for ``dense_attn``,
    ``moe_attn``, ``attn``, ``rec`` and ``rwkv`` blocks and patterns
  * encdec      — the encoder-decoder (seamless-m4t)
  * model       — ``Model`` and ``build_model``
  * convert     — the JAX package's parameters in the port's layout
"""
