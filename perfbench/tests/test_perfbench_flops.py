"""The frozen FLOP and kernel-F counts against hand counts at the cells'
shapes (F's bound summed over a prefill's 28 calls, one a layer)."""
import pytest

from perfbench.harness import bench, flops
from perfbench.reference.arch import arch_from_config

PEAK = flops.PEAKS["H100"]


def test_qwen3_train_step_is_six_n_tokens_plus_attention():
    a = arch_from_config(bench.load_json("configs", "qwen3-1.7b"))
    B, S = 8, 2048
    per_layer = (2048 * 16 * 128 + 2 * 2048 * 8 * 128 + 16 * 128 * 2048
                 + 3 * 2048 * 6144)
    n = 28 * per_layer + 151936 * 2048            # layers + the tied head
    attention = 28 * 16 * (S * (S + 1) // 2) * 2 * (128 + 128)
    want = 6 * n * B * S + 3 * B * attention
    assert flops.train_step_flops(a, B, S) == pytest.approx(want, rel=1e-12)


def test_qwen3_prefill_counts_projections_attention_and_last_logits():
    a = arch_from_config(bench.load_json("configs", "qwen3-1.7b"))
    B, S = 1, 32768
    per_layer = (2048 * 16 * 128 + 2 * 2048 * 8 * 128 + 16 * 128 * 2048
                 + 3 * 2048 * 6144)
    attention = 28 * 16 * (S * (S + 1) // 2) * 2 * (128 + 128)
    want = B * (2 * S * 28 * per_layer + attention + 2 * 2048 * 151936)
    assert flops.forward_flops(a, B, S, 1) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("B,S,bound", [(1, 16384, "ops"), (1, 32768, "ops"),
                                       (8, 64, "bytes")])
def test_kernel_f_bound_by_operations_or_bytes(B, S, bound):
    a = arch_from_config(bench.load_json("configs", "qwen3-1.7b"))
    ops = B * 16 * (S * (S + 1) // 2) * 2 * (128 + 128)
    byts = 2 * B * S * (16 * 128 + 8 * 128 + 8 * 128 + 16 * 128)
    want = ops / 989e12 if bound == "ops" else byts / 3.35e12
    assert want == pytest.approx(max(ops / 989e12, byts / 3.35e12))
    assert flops.prefill_attention_bound_s(a, B, S, PEAK) == pytest.approx(28 * want,
                                                                           rel=1e-12)


def test_peaks_by_device_name():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == PEAK
    assert flops.peaks("cpu") is None
