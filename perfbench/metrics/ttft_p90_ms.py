"""ttft_p90_ms: the 90th percentile, over every request of the window, of
the time from the request's start (its prompt on the host) to its first
token on the host (linear interpolation between order statistics)."""
import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([r["ttft_s"] for r in run.requests], 90)) * 1e3
