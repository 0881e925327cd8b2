"""decode_kernels_per_step.serve: device activities (kernels, copies,
fills) launched inside the program's ``serve.decode`` spans over the
window's decode steps: a count.  The program's spans beside the device
trace (``perfbench.harness.program_trace``); nothing where the run holds
none."""
from perfbench.harness.program_trace import Attribution


def read(run):
    p = getattr(run, "program", None)
    steps = sum(len(r["decode_s"]) for r in run.requests)
    if p is None or p.attribution is None or not steps:
        return None
    return Attribution.under(p.attribution.kernels, "serve.decode") / steps
