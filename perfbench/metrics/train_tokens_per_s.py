"""train_tokens_per_s: tokens of every train step of the window, over the
window's seconds (host clock; the window closes when its last step has its
loss on the host)."""


def read(run):
    if not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
