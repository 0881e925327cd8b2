"""prefill_mfu.serve: model FLOPs of every prefill of the window (the
benchmark's frozen count, the architecture's ``Arch.forward_flops``:
projections, attention's causal pairs, the MLPs, last-position logits)
over the prefills' host-clock seconds (each ending with its token on the
host) and the card's bf16 peak, in percent."""
from perfbench.harness import flops


def read(run):
    peak = flops.peaks(run.device_name)
    if not run.requests or peak is None:
        return None
    work = sum(run.arch.forward_flops(r["batch"], r["L"], 1) for r in run.requests)
    seconds = sum(r["prefill_s"] for r in run.requests)
    return 100.0 * work / seconds / peak["bf16_flops"]
