"""Spans of the port's layers, on the host's monotonic clock.

``with span("layer.ffn"): ...`` marks a layer boundary.  The recorder is
one per process and off unless :func:`enable` turned it on: then
:func:`span` returns one shared object that does nothing (no allocation,
no clock read), so a span that is off costs a flag test.

While on, each finished span is kept in memory as a :class:`Span`:
``(name, t0_ns, t1_ns, parent, thread)``, times on ``time.monotonic_ns``
(the clock the benchmark's own spans use), ``parent`` the index of the
span open on the same thread when it started (``-1`` at a thread's
root), ``thread`` its ``threading.get_ident()``.  Each thread keeps its
own stack of open spans, so a span opened by autograd's device thread or
a prefetch worker is a root on that thread; relating it to a span open
on another thread is left to the reader, who knows the threads' roles.
:func:`drain` returns the finished spans in the order they started and
turns the recorder off.

Span sites (each named in ``PERF.md`` with the metric that reads it):
``serve.prefill``, ``serve.decode`` (``serve/engine.py``); ``layer``,
``layer.attention``, ``layer.ffn`` (``models/transformer.py``);
``attention.backward`` (``models/attention.py``); ``train.forward``,
``train.backward``, ``train.optimizer`` (``train/train_step.py``);
``data.batch`` (``data/pipeline.py``).  Counts are not spans: the data
path's rows go to the store's ``TelemetryPlane``.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    thread: int


class _Off:
    """The shared span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_slots: list = []              # a slot per span started: None until it ends
_lock = threading.Lock()
_local = threading.local()


class _Span:
    __slots__ = ("name", "slots", "index", "parent", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            self.slots = _slots
            self.index = len(_slots)
            _slots.append(None)
        # a span left open from before the last enable() is no parent
        top = stack[-1] if stack else None
        self.parent = top.index if top is not None and top.slots is self.slots else -1
        stack.append(self)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        _local.stack.pop()
        self.slots[self.index] = Span(self.name, self.t0, t1, self.parent,
                                      threading.get_ident())
        return False


def span(name: str):
    """A context manager that records ``name`` while the recorder is on."""
    if not _on:
        return _OFF
    return _Span(name)


def enable() -> None:
    """Start recording, from an empty record."""
    global _on, _slots
    with _lock:
        _slots = []
        _on = True


def drain() -> list[Span]:
    """The spans finished since :func:`enable`; turns the recorder off.
    Spans still open are left out; parents index the returned list."""
    global _on, _slots
    with _lock:
        slots, _slots, _on = _slots, [], False
    keep = [i for i, s in enumerate(slots) if s is not None]
    new = {old: new for new, old in enumerate(keep)}
    return [s._replace(parent=new.get(s.parent, -1))
            for s in (slots[i] for i in keep)]
