"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their plain PyTorch versions and their wrappers.

  * fused           — single-pass pushdown: chunk -> packed clause
    bitvectors + load mask + popcounts in ONE launch (kernel A,
    ``csrc/pushdown.cu``)
  * scan_fused      — fused multi-query COUNT scan over the
    device-resident segment plane (kernel B, ``csrc/scan.cu``)
  * bitvector_ops   — AND / OR / popcount over packed rows (kernel C,
    ``csrc/bitvector_reduce.cu``)
  * substring_match — the split path's matchers: a pattern set (kernel D,
    ``csrc/substring_match.cu``) and one key-value predicate (kernel E,
    ``csrc/key_value.cu``) over a chunk
  * flash_attention — causal or unmasked GQA flash attention for the
    model's prefill (kernel F, ``csrc/flash_attention.cu``)
  * residual        — the host scanner's ``and_reduce`` hook on kernel C
  * ref             — plain versions of kernels A, C, D, E and F
  * ops             — backend dispatch (``"cuda"`` kernel / ``"torch"``
    plain)
  * cuda_build      — nvcc build at first use, ctypes loading

Each wrapper launches its kernel on a CUDA tensor and runs the plain
version on a CPU tensor; it never swaps one for the other on a card.
"""
from . import ops, ref  # noqa: F401
from .ops import clause_bitvectors  # noqa: F401
