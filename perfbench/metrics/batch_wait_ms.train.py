"""batch_wait_ms.train: the loop's whole wait in next() on the Prefetcher
over the window's steps, host clock."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s["wait_s"] for s in run.steps) / len(run.steps)
