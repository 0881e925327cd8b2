"""attn_bwd_ms_per_step.train: device time of the kernels launched inside
the program's ``attention.backward`` spans (kernel F's backward, the
plain recompute and its gradient, every layer) over the window's train
steps, in ms.  The program's spans beside the device trace
(``perfbench.harness.program_trace``); nothing where the run holds none."""
from perfbench.harness.program_trace import Attribution


def read(run):
    p = getattr(run, "program", None)
    if p is None or p.attribution is None or not run.steps:
        return None
    return 1e3 * Attribution.through(p.attribution.device_s,
                                     "attention.backward") / len(run.steps)
