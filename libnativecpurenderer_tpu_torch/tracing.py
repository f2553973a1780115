"""Host spans of the port's layers: where a frame's host time goes.

A span is a named interval on the ``time.perf_counter_ns`` clock, opened
with ``with span(name):`` at a layer boundary of the program: the frame
pipelines (``pipeline.py``), the canvas flush (``context.execute``) and
the mesh prep (``ops/raster3d.py``).  Spans nest on one stack: each
records its parent (the span open around it when it began) and a batch
id, its own or, without one, its parent's.  Closed spans stay in memory
until :func:`reset`; :func:`totals` sums them by name and
:func:`records` lists them.

Tracing is off until ``enable(True)``.  Off, :func:`span` returns one
shared context manager that does nothing: a global read and a call, no
allocation.

``ranges(True)``, while a ``torch.profiler`` records, also opens a
``torch.profiler.record_function`` range of each span's name, so the
spans sit in the profiler's timeline beside the kernels, copies and
launch calls they issued, and each idle gap of the device can be put
down to the innermost span around it.  With ranges off no range is
made: one costs a few microseconds even when no profiler runs.

Every name starts with ``lncr.``.  Spans open and close on one thread;
the pipelines and the canvas flush run on their caller's.

    from libnativecpurenderer_tpu_torch import tracing
    tracing.reset(); tracing.enable(True)
    ... submit frames ...
    tracing.enable(False)
    tracing.totals()["lncr.pipeline.sink_wait"]   # calls, ns, self_ns
"""

from __future__ import annotations

import time

from torch.profiler import record_function

clock = time.perf_counter_ns

_on = False
_ranges = False
_stack: list = []           # the open spans, innermost last
_closed: list = []          # the spans closed since the last reset


class _Off:
    """The span of disabled tracing: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One span: ``name``; ``start`` and ``end`` in ns on :data:`clock`;
    ``parent``, the span open around it when it began (None at the top);
    ``batch``, its batch id or its parent's; ``child_ns``, the time its
    children cover."""

    __slots__ = ("name", "batch", "parent", "start", "end", "child_ns",
                 "_range")

    def __init__(self, name: str, batch=None):
        self.name = name
        self.batch = batch
        self.parent = None
        self.child_ns = 0
        self._range = None

    def __enter__(self):
        if _ranges:
            self._range = record_function(self.name)
            self._range.__enter__()
        if _stack:
            self.parent = _stack[-1]
            if self.batch is None:
                self.batch = self.parent.batch
        _stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc):
        self.end = clock()
        _stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end - self.start
        _closed.append(self)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def span(name: str, batch=None):
    """A context manager timing the block as span ``name`` of ``batch``
    (None: the parent's batch); the shared no-op when tracing is off."""
    if not _on:
        return _OFF
    return Span(name, batch)


def enable(on: bool) -> None:
    """Turn the recording of spans on or off."""
    global _on
    _on = bool(on)


def ranges(on: bool) -> None:
    """Open a profiler range beside each span from now on (``True``) or
    not; turn it on only while a ``torch.profiler`` records."""
    global _ranges
    _ranges = bool(on)


def reset() -> None:
    """Forget the closed spans; a span open now is kept when it closes."""
    _closed.clear()


def records() -> list:
    """The spans closed since the last reset, in the order they closed."""
    return list(_closed)


def totals() -> dict:
    """By span name: ``calls``, total ``ns`` and ``self_ns`` (the total
    less the time the span's children cover), over the closed spans."""
    out: dict = {}
    for s in _closed:
        t = out.get(s.name)
        if t is None:
            t = out[s.name] = {"calls": 0, "ns": 0, "self_ns": 0}
        d = s.end - s.start
        t["calls"] += 1
        t["ns"] += d
        t["self_ns"] += d - s.child_ns
    return out
