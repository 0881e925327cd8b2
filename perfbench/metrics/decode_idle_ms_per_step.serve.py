"""decode_idle_ms_per_step.serve: idle device time whose gap's middle
falls inside the program's ``serve.decode`` spans (the host in the engine's
decode step, any layer) over the window's decode steps, in ms.  The
program's spans beside the device trace
(``perfbench.harness.program_trace``); nothing where the run holds none."""
from perfbench.harness.program_trace import Attribution


def read(run):
    p = getattr(run, "program", None)
    steps = sum(len(r["decode_s"]) for r in run.requests)
    if p is None or p.attribution is None or not steps:
        return None
    return 1e3 * Attribution.under(p.attribution.idle_s, "serve.decode") / steps
