"""decode_attn_ms_per_step.serve: device time of the kernels launched
inside the program's ``layer.attention`` spans under ``serve.decode``
(``decode_attention_gqa`` and ``combine_partials``, every layer) over the
window's decode steps, in ms.  The program's spans beside the device
trace (``perfbench.harness.program_trace``); nothing where the run holds
none."""
from perfbench.harness.program_trace import Attribution


def read(run):
    p = getattr(run, "program", None)
    steps = sum(len(r["decode_s"]) for r in run.requests)
    if p is None or p.attribution is None or not steps:
        return None
    return 1e3 * Attribution.under(p.attribution.device_s,
                                   "serve.decode/layer/layer.attention") / steps
