"""CIAO on PyTorch and CUDA: the port of the JAX package ``repro``.

Same modules and names as ``repro``.  Every TPU kernel of the JAX package
is a hand-written CUDA kernel for Hopper under ``csrc/`` with a plain
PyTorch version: the client pushdown and the device-resident scan of the
paper's loop, the split path's matchers and bitvector reduce, and flash
attention for the model-serving plane (``configs``, ``models``, ``serve``,
``launch``).
"""
