"""serve_tokens_per_s: prompt plus output tokens of every request of the
window, over the window's seconds (host clock; the window closes when its
last request has its last token)."""


def read(run):
    if not run.requests:
        return None
    return sum(r["tokens_in"] + r["tokens_out"] for r in run.requests) / run.window_s
