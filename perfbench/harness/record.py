"""What a run records: host spans, and in a traced run the device trace.

Spans are the benchmark's own, taken on the host's monotonic clock around
its calls into each layer of the program (``prefill``, ``decode``,
``batch_wait``, ``train_step`` ...); they never overlap.  A traced run wraps the measured
window in ``torch.profiler`` (device activity only) and reduces the trace
to the union of device intervals, device time by kernel, and idle time by
the span the host was in.  A marker kernel, launched on the host clock
just before the window, ties the trace's clock to the spans'.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

import torch

#: device time by kind: (kind, marks any of which a kernel's name holds)
KINDS = (("kernel F", ("flash_kernel",)),
         ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
         ("scatter/gather/top-k", ("index", "scatter", "gather", "TopK", "topk",
                                   "sort", "Sort", "scan")))
#: idle seconds inside the profiler before the marker and after the window
PAD_S = 0.25


@dataclass
class Spans:
    items: list = field(default_factory=list)      # (name, t0_ns, t1_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.monotonic_ns()))

    def seconds(self, name: str) -> list[float]:
        return [(b - a) / 1e9 for n, a, b in self.items if n == name]


@dataclass
class Trace:
    busy_s: float
    window_s: float
    by_kernel: dict          # name -> device seconds (inside the window)
    idle_by_span: dict       # span name -> idle seconds
    aligned: bool            # the marker was found

    def kernel_seconds(self, marks) -> float:
        return sum(s for k, s in self.by_kernel.items() if any(m in k for m in marks))

    def breakdown(self) -> dict:
        kinds = {k: self.kernel_seconds(m) for k, m in KINDS}
        kinds["other"] = sum(self.by_kernel.values()) - sum(kinds.values())
        ops = [[f"kind: {k}", s] for k, s in kinds.items()]
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])
        ops += [[k[:120], s] for k, s in top[:10 - len(ops)]]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": ops, "idle_gaps": [[k, s] for k, s in gaps]}


class Tracer:
    """``with tracer.window(): ...`` profiles the block when enabled."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.marker_ns = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            time.sleep(PAD_S)
            sync(self.device)
            self.marker_ns = time.monotonic_ns()
            torch.empty(1 << 20, device=self.device).fill_(1.0)
            sync(self.device)
            yield
            sync(self.device)
            time.sleep(PAD_S)
        self.prof = prof

    def reduce(self, window: tuple[int, int], spans: Spans) -> Trace:
        """The trace inside ``window`` (host monotonic ns)."""
        events = device_events(self.prof, self.device)
        if not events:
            raise RuntimeError("the profiler recorded no device activity in "
                               "the traced window")
        fills = [e for e in events if "fill" in e[0].lower()]
        marker = min(fills, key=lambda e: e[1]) if fills else None
        aligned = marker is not None
        offset = marker[1] - self.marker_ns if aligned else 0
        w0, w1 = (window[0] + offset, window[1] + offset) if aligned else (
            min(e[1] for e in events), max(e[2] for e in events))
        by_kernel: dict = {}
        ivals = []
        for name, a, b in events:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e9
            ivals.append((a, b))
        ivals.sort()
        busy, idle = 0, {}
        cur_a, cur_b = None, None
        gaps = []
        edge = w0
        for a, b in ivals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                gaps.append((edge if cur_b is None else cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
            gaps.append((cur_b, w1))
        # the spans do not overlap: the last to start before a gap's middle
        # is the one the host was in, if it had not ended
        host = sorted((a + offset, b + offset, n) for n, a, b in spans.items)
        starts = [h[0] for h in host]
        for a, b in gaps:
            if b <= a:
                continue
            name = "unaligned"
            if aligned:
                mid = (a + b) // 2
                i = bisect.bisect_right(starts, mid) - 1
                name = host[i][2] if i >= 0 and mid < host[i][1] else "between spans"
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        return Trace(busy / 1e9, (w1 - w0) / 1e9, by_kernel, idle, aligned)


def sync(dev) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_events(prof, dev) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity of a trace (on a
    CPU device, used by the tests, of every CPU operation)."""
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if dev.type == "cuda" else DeviceType.CPU
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            if e.device_type() == kind:
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        if out:
            return out
    base = 0
    for e in prof.events():
        if e.device_type == kind:
            out.append((e.name, base + int(e.time_range.start * 1e3),
                        base + int(e.time_range.end * 1e3)))
    return out
