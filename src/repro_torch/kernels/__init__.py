"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their plain PyTorch versions and their wrappers.

  * fused      — single-pass pushdown: chunk -> packed clause bitvectors
    + load mask + popcounts in ONE launch (``csrc/pushdown.cu``)
  * scan_fused — fused multi-query COUNT scan over the device-resident
    segment plane (``csrc/scan.cu``)
  * ref        — plain version of the pushdown kernel
  * ops        — backend dispatch (``"cuda"`` kernel / ``"torch"`` plain)
  * cuda_build — nvcc build at first use, ctypes loading

Each wrapper launches its kernel on a CUDA tensor and runs the plain
version on a CPU tensor; it never swaps one for the other on a card.
"""
from . import ops, ref  # noqa: F401
from .ops import clause_bitvectors  # noqa: F401
