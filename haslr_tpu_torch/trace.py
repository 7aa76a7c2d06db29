"""Spans, counters and kernel launches of the port, on the profiler's clock.

Tracing is on while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``) or inside :func:`recording`;
off, :func:`span`, :func:`count` and :func:`launch` cost one check.  On:

- ``span(name)`` records its name, an id, its parent's id, ``start_ns``
  and ``end_ns`` from ``time.time_ns()`` (the clock kineto stamps host
  events with, so spans lie over the device trace) and the process CPU
  nanoseconds it took, and opens ``record_function(name)``.  A span
  opened with no span open in its thread is a root; a root holds every
  span of its tree, so one pass is one identifier.
- ``count(name, n)`` adds ``n`` (an int, or a 0-d tensor summed when it
  is read) to the open root's counters; callers count once a call.
- ``launch(...)`` records one kernel launch on the open root, with CUDA
  events around it on the launch's stream.

The last :data:`KEEP` finished roots are kept; :func:`roots`,
:func:`spans_of`, :func:`counters_of`, :func:`launches_of` and
:func:`self_ns` read them, :func:`write_jsonl` writes them out and
:func:`reset` forgets them."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time

import torch

KEEP = 256
_done: collections.deque = collections.deque(maxlen=KEEP)
_ids = itertools.count(1)
_local = threading.local()
_forced = 0
_NULL = contextlib.nullcontext()


def on() -> bool:
    return _forced > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, whether or not a profiler records."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class Span:
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "cpu_ns",
                 "root")


class Root(Span):
    __slots__ = ("spans", "counters", "launches")


class Launch:
    """One kernel launch: ``rows`` B, ``width`` R, ``band`` W, ``cells``
    Σ min(r_len, R) × W as a device scalar (None without lengths),
    ``windows`` N and ``S`` (V1); as a context around the launch, CUDA
    events ``ev0``/``ev1`` on its ``stream`` (None: no events)."""

    __slots__ = ("kernel", "rows", "width", "band", "cells", "windows", "S",
                 "stream", "ev0", "ev1")

    def __enter__(self):
        if self.stream is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)

    def __exit__(self, *exc):
        if self.stream is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
        return False


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    __slots__ = ("span", "rf", "c0")

    def __init__(self, name):
        st = _stack()
        sp = Root() if not st else Span()
        sp.name, sp.id = name, next(_ids)
        if st:
            sp.parent, sp.root = st[-1].id, st[0]
        else:
            sp.parent, sp.root = None, sp
            sp.spans, sp.counters, sp.launches = [], {}, []
        self.span = sp
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        sp = self.span
        sp.root.spans.append(sp)
        _stack().append(sp)
        self.rf.__enter__()
        # stamped inside the range: the span times the work, not the
        # range's own cost (the first in a process takes milliseconds)
        self.c0 = time.process_time_ns()
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.end_ns = time.time_ns()
        sp.cpu_ns = time.process_time_ns() - self.c0
        self.rf.__exit__(*exc)
        _stack().pop()
        if sp.root is sp:
            _done.append(sp)
        return False


def span(name: str):
    return _Open(name) if on() else _NULL


def _root():
    st = _stack() if on() else None
    return st[0] if st else None


def count(name: str, n) -> None:
    root = _root()
    if root is not None:
        root.counters.setdefault(name, []).append(n)


def launch(kernel, rows, width=0, band=0, r_lens=None, windows=0, S=0,
           stream=None):
    """A context around one launch of ``kernel`` on ``stream``, recorded
    on the open root; ``r_lens`` the launch's read lengths, for its
    cells."""
    root = _root()
    if root is None:
        return _NULL
    rec = Launch()
    rec.kernel, rec.rows, rec.width, rec.band = kernel, rows, width, band
    rec.windows, rec.S, rec.stream, rec.ev0 = windows, S, stream, None
    rec.cells = None if r_lens is None else \
        r_lens.clamp(0, width).to(torch.int64).sum() * band
    root.launches.append(rec)
    return rec


def reset() -> None:
    """Forget the finished roots."""
    _done.clear()


def roots(name: str | None = None) -> list:
    return [r for r in _done if name is None or r.name == name]


def spans_of(root: Root) -> list:
    return list(root.spans)


def counters_of(root: Root) -> dict:
    return {k: int(sum(v)) for k, v in root.counters.items()}


def launches_of(root: Root) -> list:
    return list(root.launches)


def device_ms(rec: Launch):
    """A launch's device milliseconds (waits for its end event)."""
    if rec.ev0 is None:
        return None
    rec.ev1.synchronize()
    return rec.ev0.elapsed_time(rec.ev1)


def self_ns(sp: Span) -> int:
    """``sp``'s duration less the part its child spans cover."""
    kids = sorted((c.start_ns, c.end_ns) for c in sp.root.spans
                  if c.parent == sp.id)
    covered, t = 0, sp.start_ns
    for a, b in kids:
        a = max(a, t)
        if b > a:
            covered += b - a
            t = b
    return sp.end_ns - sp.start_ns - covered


def write_jsonl(path: str, rts) -> None:
    """Each root's spans, counters and launches as JSON lines."""
    with open(path, "w") as f:
        for r in rts:
            for s in r.spans:
                f.write(json.dumps({
                    "span": s.name, "id": s.id, "parent": s.parent,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "cpu_ns": s.cpu_ns}) + "\n")
            f.write(json.dumps({"counters": counters_of(r), "root": r.id})
                    + "\n")
            for x in r.launches:
                f.write(json.dumps({
                    "launch": x.kernel, "root": r.id, "rows": x.rows,
                    "width": x.width, "band": x.band,
                    "cells": None if x.cells is None else int(x.cells),
                    "windows": x.windows, "S": x.S,
                    "device_ms": device_ms(x)}) + "\n")
