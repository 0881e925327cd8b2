"""setup_s: process start to the window's start, host clock (loading,
weights, warm-up and, on a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
