"""f_roofline.serve: kernel F's analytic bound over F's device time in the
traced window, in percent.  The bound of each prefill's attention calls
(one a layer, summed by the architecture's
``Arch.prefill_attention_bound_s``) is the larger of their bytes (Q, K and
V read once, O written once, bf16) at HBM bandwidth and their operations
(2 (d_qk + d_v) a causal query-key pair a head) at the bf16 peak, from the
call shapes, whatever implements them.  F's device time: the kernels whose
names hold one of NAMES."""
from perfbench.harness import flops

NAMES = ("flash_kernel",)


def read(run):
    peak = flops.peaks(run.device_name)
    if run.trace is None or peak is None or not run.requests:
        return None
    f_s = run.trace.kernel_seconds(NAMES)
    if f_s <= 0:
        return None
    bound = sum(run.arch.prefill_attention_bound_s(r["batch"], r["L"], peak)
                for r in run.requests)
    return 100.0 * bound / f_s
