"""The program's own spans (``repro_torch.tracing``) beside the device trace.

:class:`ProgramTracer` is a :class:`~perfbench.harness.record.Tracer`
whose window also turns on the program's span recorder and, with a store,
reads the recipe batcher's row counts from the store's telemetry plane
(tenant ``recipe``) at the window's end; its ``reduce`` also puts down,
from the same profile, each kernel's device time, each idle gap and each
launch to the program span the host was in (:func:`attribute`).  It
returns the same :class:`~perfbench.harness.record.Trace` as the
tracer it extends, and leaves what it adds in :attr:`ProgramTracer.program`.

Clocks: the spans are on ``time.monotonic_ns``; the profiler stamps the
host's launch calls in Unix time (``time.time_ns``'s clock), and the
device's activities in Unix time as CUPTI converts them, which lay up to
0.3 ms off the host's stamps in chip runs.  :func:`clock_offset_ns`,
sampled as the window opens, maps the host's stamps onto the spans' clock
to within a microsecond.  The device's stamps are pinned to the host's
by the marker kernel: launched on an idle device, it starts within
microseconds of its launch call, so its start less its launch is the
device clock's skew, taken out of every device time.  (``Tracer.reduce``
aligns by the marker's start less ``marker_ns``, which also holds the
0.2-0.3 ms the host takes to reach the marker's launch.)  A kernel's
launch call shares the kernel's correlation id; on the CPU (the tests)
an operation's launch is its own start.
"""
from __future__ import annotations

import contextlib
import heapq
import time
from dataclasses import dataclass, field

import numpy as np

from .record import Tracer

#: spans of the data path run on the prefetch thread and launch nothing:
#: they are never the span a kernel or a gap is put down to
DATA = "data."
#: the label of kernels and gaps that fall in no program span
NO_SPAN = "(no span)"


@dataclass
class Attribution:
    """Per span path (``"serve.decode/layer/layer.attention"``):
    ``device_s`` device seconds of the kernels launched there, ``idle_s``
    idle seconds whose gap's middle fell there, ``kernels`` kernels
    launched there; :data:`NO_SPAN` for what fell in none."""
    device_s: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)

    @staticmethod
    def under(table: dict, prefix: str) -> float:
        """The sum of ``table`` over ``prefix`` and the paths below it."""
        return sum(v for p, v in table.items()
                   if p == prefix or p.startswith(prefix + "/"))

    @staticmethod
    def through(table: dict, name: str) -> float:
        """The sum of ``table`` over the paths that pass through ``name``."""
        return sum(v for p, v in table.items() if name in p.split("/"))


@dataclass
class Program:
    """What a window of the program recorded and its trace reads."""
    spans: list = field(default_factory=list)      # repro_torch.tracing.Span
    rows: dict | None = None                       # recipe tenant at the window's end
    attribution: Attribution | None = None
    bench_busy_s: float | None = None              # busy in the benchmark's step spans
    clock_offset_ns: tuple | None = None           # at the window's start and end
    clock: dict | None = None                      # the marker's launch, start, skew

    def durations_s(self, name: str) -> list[float]:
        return [(s.t1_ns - s.t0_ns) / 1e9 for s in self.spans if s.name == name]


def _sweep(spans):
    """(paths, breakpoints, owners).  Each span's path of names: its
    parent is the span open on its own thread when it started; a thread's
    root span (not :data:`DATA`) takes as parent the span that owned the
    host when it started on another thread (autograd's device thread
    under ``train.backward``).  After breakpoint ``times[k]`` the owner of
    the host, the latest-started open span that is not :data:`DATA`, is
    ``owners[k]`` (-1: none)."""
    paths: list = [None] * len(spans)
    is_open = [False] * len(spans)
    heap: list = []
    times: list = []
    owners: list = []

    def owner() -> int:
        while heap and not is_open[heap[0][2]]:
            heapq.heappop(heap)
        return heap[0][2] if heap else -1

    ends = sorted((s.t1_ns, i) for i, s in enumerate(spans))
    e = 0
    for i in sorted(range(len(spans)), key=lambda j: (spans[j].t0_ns, j)):
        s = spans[i]
        while e < len(ends) and ends[e][0] <= s.t0_ns:
            t, j = ends[e]
            e += 1
            if is_open[j]:
                is_open[j] = False
                times.append(t)
                owners.append(owner())
        if s.name.startswith(DATA):
            paths[i] = s.name
            continue
        up = s.parent if s.parent >= 0 else owner()
        paths[i] = s.name if up < 0 else f"{paths[up]}/{s.name}"
        is_open[i] = True
        heapq.heappush(heap, (-s.t0_ns, -i, i))
        times.append(s.t0_ns)
        owners.append(i)
    for t, j in ends[e:]:
        if is_open[j]:
            is_open[j] = False
            times.append(t)
            owners.append(owner())
    return paths, np.asarray(times, np.int64), np.asarray(owners, np.int64)


def _owner_at(times, owners, at) -> np.ndarray:
    k = np.searchsorted(times, at, side="right") - 1
    return np.where(k >= 0, owners[np.maximum(k, 0)], -1) if len(times) else \
        np.full(len(at), -1)


def gaps(intervals, window) -> list[tuple[int, int]]:
    """The idle gaps of the window ``(w0, w1)`` between the union of
    ``intervals`` (each already inside the window)."""
    out, edge = [], window[0]
    for a, b in sorted(intervals):
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    if window[1] > edge:
        out.append((edge, window[1]))
    return out


def attribute(kernels, spans, window) -> Attribution:
    """Put the window's device time, idle time and launches down to span
    paths.  ``kernels``: ``(launch_ns, start_ns, end_ns)`` on the spans'
    clock; ``spans``: ``repro_torch.tracing.Span``; ``window``: ``(w0,
    w1)``.  A kernel goes to the span that owned the host at its launch,
    however late it ran; a gap to the one that owned it at the gap's
    middle (:func:`_sweep` for owner and path)."""
    paths, times, owners = _sweep(spans)
    label = np.array(paths + [NO_SPAN], dtype=object)
    w0, w1 = window
    k = np.asarray(kernels, np.int64).reshape(-1, 3)
    a, b = np.maximum(k[:, 1], w0), np.minimum(k[:, 2], w1)
    inside = b > a
    k, a, b = k[inside], a[inside], b[inside]
    out = Attribution()
    who = _owner_at(times, owners, k[:, 0])
    for path, s, n in _by_label(label[who], (b - a) / 1e9):
        out.device_s[path] = s
        out.kernels[path] = n
    idle = gaps(zip(a.tolist(), b.tolist()), window)
    if idle:
        g = np.asarray(idle, np.int64)
        who = _owner_at(times, owners, (g[:, 0] + g[:, 1]) // 2)
        for path, s, _ in _by_label(label[who], (g[:, 1] - g[:, 0]) / 1e9):
            out.idle_s[path] = s
    return out


def _by_label(labels, seconds):
    """(label, seconds summed, count) of each distinct label."""
    if not len(labels):
        return []
    names, inv = np.unique(labels.astype(str), return_inverse=True)
    sums = np.bincount(inv, weights=seconds, minlength=len(names))
    counts = np.bincount(inv, minlength=len(names))
    return [(str(n), float(s), int(c)) for n, s, c in zip(names, sums, counts)]


def busy_inside(kernels, spans, names) -> float:
    """Busy device seconds (the union of ``kernels``' intervals) inside the
    benchmark's own spans named in ``names``: ``(name, t0, t1)``."""
    inside = sorted((a, b) for n, a, b in spans if n in names)
    union = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    total, j = 0, 0
    for a, b in inside:
        while j < len(union) and union[j][1] <= a:
            j += 1
        i = j
        while i < len(union) and union[i][0] < b:
            total += max(0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
    return total / 1e9


def clock_offset_ns() -> int:
    """Unix time less ``time.monotonic_ns``, sampled between two
    monotonic reads."""
    a = time.monotonic_ns()
    unix = time.time_ns()
    b = time.monotonic_ns()
    return unix - (a + b) // 2


def kernel_launches(prof, dev, offset_ns: int, marker_ns: int):
    """(kernels, clock): every device activity of the trace as
    ``(launch_ns, start_ns, end_ns)`` on the host's monotonic clock (the
    profiler's host times less ``offset_ns``, its device times less the
    marker's skew too); and the marker's launch and start after
    ``marker_ns`` and the skew (module docstring)."""
    from torch.autograd import DeviceType
    cuda = dev.type == "cuda"
    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    acts = [(e.correlation_id(), e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == kind]
    calls = ({e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU} if cuda else {})
    fills = [(a, c) for c, a, _, name in acts if "fill" in name.lower()]
    if not fills:
        raise RuntimeError("the marker is not in the trace")
    start, corr = min(fills)
    launch = calls.get(corr, start)
    skew = start - launch
    clock = {"marker_launch_ns": launch - offset_ns - marker_ns,
             "marker_start_ns": start - offset_ns - marker_ns, "device_skew_ns": skew}
    dev_off = offset_ns + skew
    out = [(calls.get(c, a) - offset_ns, a - dev_off, b - dev_off) for c, a, b, _ in acts]
    return out, clock


def recipe_rows(store) -> dict | None:
    """The recipe batcher's counts, and the plane's own skip fraction of
    them, in ``store``'s telemetry plane."""
    from repro_torch.data.pipeline import RECIPE_TENANT
    if store is None:
        return None
    t = store.telemetry.tenant(RECIPE_TENANT)
    return None if t is None else {k: t[k] for k in (
        "rows_scanned", "rows_skipped", "segments_scanned", "segments_pruned",
        "row_skip_fraction")}


class ProgramTracer(Tracer):
    """A :class:`Tracer` that also records the program's spans in its
    window, profiled or not, and reads them beside the trace (module
    docstring).  ``store``: a callable that returns the store whose recipe
    counts to read, or None."""

    #: the benchmark's own spans inside which the program's spans run
    STEP_SPANS = ("prefill", "decode", "train_step")

    def __init__(self, enabled: bool, device, store=lambda: None):
        super().__init__(enabled, device)
        self.store = store
        self.program = Program()

    @contextlib.contextmanager
    def window(self):
        from repro_torch import tracing
        with super().window():
            start = clock_offset_ns()
            tracing.enable()
            try:
                yield
            finally:
                self.program.spans = tracing.drain()
                self.program.rows = recipe_rows(self.store())
                self.program.clock_offset_ns = (start, clock_offset_ns())

    def reduce(self, window, spans):
        trace = super().reduce(window, spans)
        p = self.program
        kernels, p.clock = kernel_launches(self.prof, self.device,
                                           p.clock_offset_ns[0], self.marker_ns)
        p.attribution = attribute(kernels, p.spans, window)
        p.bench_busy_s = busy_inside(kernels, spans.items, self.STEP_SPANS)
        return trace
