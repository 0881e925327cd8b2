"""batch_skip_pct.train: the share of the store's rows that the recipe's
bitvectors and zone maps let the batcher skip, in %: the store's telemetry
plane's ``row_skip_fraction`` of tenant ``recipe``
(``TelemetryPlane.record_rows``), over every segment the batcher visited
from the store's load to the window's end.  A property of the seed's plan
and data, not of the window: a segment holds about a hundred batches of
rows, so a window visits at most one or two, and a faster data path does
not move it.  Nothing where the run holds no such counts."""


def read(run):
    p = getattr(run, "program", None)
    rows = p.rows if p is not None else None
    if not rows or rows["rows_scanned"] + rows["rows_skipped"] == 0:
        return None
    return 100.0 * rows["row_skip_fraction"]
