"""Roofline terms of one step (port of ``repro.analysis.roofline``).

Per (arch x shape x mesh):
    compute_term    = device_FLOPs / PEAK_FLOPS
    memory_term     = device_bytes / HBM_BW
    collective_term = device_collective_bytes / LINK_BW

The FLOPs and bytes are the analytic model's (``analysis.flops``) divided
over the devices; the collective bytes are what one device's step issued
(``analysis.comms``), all-reduce counted twice for a ring's
reduce-scatter and all-gather phases, as in the JAX package.  The
constants are the NVIDIA H100 SXM5's, in place of the TPU v5e's of the
JAX package (197 TFLOP/s, 819 GB/s, 50 GB/s ICI).

The collective term takes every byte over NVLink.  The JAX package's
production mesh has a 16-wide model axis, wider than one 8-GPU NVLink
domain (an HGX H100 board), so part of its traffic would cross the
slower inter-node network: on such a mesh the term is a lower bound.
:class:`Roofline` and :func:`model_flops` are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# NVIDIA H100 SXM5 per-device constants (NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column)
PEAK_FLOPS = 989e12        # dense BF16 tensor-core FLOP/s (1,979 with sparsity)
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink 4, 900 GB/s total: 450 GB/s each way
# the JAX package's name for the collective bandwidth
ICI_BW = LINK_BW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    device_flops: float
    device_bytes: float
    collective_bytes: float
    model_flops_global: float      # 6·N·D (train) or 2·N_active·tokens (decode)
    n_devices: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_flops_frac: float = 0.0
    step_time_s: float = 0.0
    roofline_frac: float = 0.0
    collectives: dict = field(default_factory=dict)
    memory_per_device_gb: float = 0.0
    notes: str = ""

    def finalize(self) -> "Roofline":
        self.compute_s = self.device_flops / PEAK_FLOPS
        self.memory_s = self.device_bytes / HBM_BW
        self.collective_s = self.collective_bytes / LINK_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.dominant = max(terms, key=terms.get)
        total_flops = self.device_flops * self.n_devices
        self.useful_flops_frac = (
            self.model_flops_global / total_flops if total_flops else 0.0
        )
        # bound on step time: max of the three terms (perfect overlap);
        # roofline fraction = useful-compute time / bound.
        self.step_time_s = max(terms.values())
        useful_compute_s = self.model_flops_global / (PEAK_FLOPS * self.n_devices)
        self.roofline_frac = (
            useful_compute_s / self.step_time_s if self.step_time_s else 0.0
        )
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, n_active_params: int) -> float:
    """MODEL_FLOPS: 6·N·D for train; 2·N·new_tokens for decode; 2·N·D prefill."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    return 2.0 * n_active_params * shape.global_batch  # decode: 1 token/seq
