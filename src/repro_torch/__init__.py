"""CIAO on PyTorch and CUDA: the port of the JAX package ``repro``.

Same modules and names as ``repro``; the two TPU kernels of the paper's
loop (client pushdown and the device-resident scan) are hand-written CUDA
kernels for Hopper under ``csrc/``, each with a plain PyTorch version.
"""
