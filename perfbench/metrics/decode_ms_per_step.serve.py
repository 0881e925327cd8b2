"""decode_ms_per_step.serve: all decode time of the window over its decode
steps, host clock, each step ending when its token is on the host."""


def read(run):
    steps = [s for r in run.requests for s in r["decode_s"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
