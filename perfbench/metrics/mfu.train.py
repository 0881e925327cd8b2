"""mfu.train: model FLOPs of every train step of the window (3 forward
passes of the benchmark's frozen count, logits at every position;
recomputation not counted) over the window's seconds and the card's bf16
peak, in percent."""
from perfbench.harness import flops


def read(run):
    peak = flops.peaks(run.device_name)
    if not run.steps or peak is None:
        return None
    B, S = run.traffic["batch"], run.traffic["seq_len"]
    work = len(run.steps) * flops.train_step_flops(run.arch, B, S)
    return 100.0 * work / run.window_s / peak["bf16_flops"]
