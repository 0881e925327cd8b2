"""batch_make_ms.train: the mean duration of the program's ``data.batch``
spans that ended in the window: the recipe batcher's work for one batch
(scan, tokenize, pack) on the prefetch thread, host clock, in ms;
nothing where the run holds no program spans."""


def read(run):
    p = getattr(run, "program", None)
    made = p.durations_s("data.batch") if p is not None else []
    return 1e3 * sum(made) / len(made) if made else None
