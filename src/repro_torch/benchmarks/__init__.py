"""Benchmarks of the PyTorch/CUDA port (``python -m repro_torch.benchmarks.<name>``).

They write under ``artifacts/`` at the repository root, never a
``BENCH_*.json`` beside the JAX package's tracked artifacts.
"""
