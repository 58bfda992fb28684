"""Profiling and timing utilities.

PyTorch port of ``sdfs_via_autodiff_tpu/utils/profiling.py``: a
``torch.profiler`` trace context (host and, with a card, device
activity, written as a Chrome trace), and a timing wrapper giving
time-to-tolerance, iterations and grid-point updates per second.

Beside them, the port's own span and counter recorder: ``span(name)``
(a context manager; :func:`spanned` is its decorator form) and
``count(name, n)`` at the port's layer boundaries, kept in memory while
:func:`set_recording` has it on and handed out by :func:`records`.  Off
(the default), a span is one module-global check that returns a shared
no-op object.  On, each span appends one tuple, timed by
``time.perf_counter_ns`` (the clock of ``time.perf_counter``), and,
while a ``torch.profiler`` runs, also opens a ``record_function`` of its
name, so the port's spans are ``user_annotation`` events of the trace
:func:`trace` writes, and the device work they launched falls inside
them.  The spans of one ``wc_ratio_discrete`` call share its
``sdfs.solve`` as their root.  One thread records: spans nest on a
single stack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "timed_solve", "TimedSolve", "TRACE_FILE", "span",
           "spanned", "count", "set_recording", "is_recording", "records",
           "recorded", "Record"]

TRACE_FILE = "trace.json"


class Record(NamedTuple):
    """One span (or a point count) of the recorder.  ``parent`` is 0 for
    a span opened outside every other; ``root`` is the outermost open
    span's id (a ``wc_ratio_discrete`` call's ``sdfs.solve``), its own
    for a root.
    ``start_ns``/``end_ns`` are ``time.perf_counter_ns()``; ``count`` is
    what :func:`count` gave the span, else None."""
    name: str
    id: int
    parent: int
    root: int
    start_ns: int
    end_ns: int
    count: Optional[int]


_recording = False
_records: list = []     # (name, id, parent, root, start, end, count)
_open: list = []        # the open spans, innermost last
_ids = itertools.count(1)


class _NoSpan:
    """What :func:`span` returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "count", "_rf")

    def __init__(self, name: str):
        self.name, self.count, self._rf = name, None, None

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else 0
        self.root = outer.root if outer else self.id
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _records.append((self.name, self.id, self.parent, self.root,
                         self.start, end, self.count))
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block: recorded while
    recording is on, the shared no-op otherwise."""
    if not _recording:
        return _NO_SPAN
    return _Span(name)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the count of the innermost open span named ``name``
    (a Krylov solve's iterations on its ``sdfs.krylov``); with none open,
    record ``n`` as a point record of that name."""
    if not _recording:
        return
    for s in reversed(_open):
        if s.name == name:
            s.count = n if s.count is None else s.count + n
            return
    t = time.perf_counter_ns()
    outer = _open[-1] if _open else None
    i = next(_ids)
    _records.append((name, i, outer.id if outer else 0,
                     outer.root if outer else i, t, t, n))


def set_recording(on: bool) -> bool:
    """Turn the recorder on or off; returns whether it was on."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


def is_recording() -> bool:
    return _recording


def records() -> List[Record]:
    """The records kept since the last call, in the order the spans
    closed, and clear them."""
    out = [Record(*r) for r in _records]
    _records.clear()
    return out


@contextlib.contextmanager
def recorded():
    """Record the block: yields a list that holds, once the block ends,
    the records the block made, and restores the recorder's switch.
    Where recording was on already, the block's records also stay for
    :func:`records`."""
    was = set_recording(True)
    start = len(_records)
    out: List[Record] = []
    try:
        yield out
    finally:
        set_recording(was)
        out.extend(Record(*r) for r in _records[start:])
        if not was:
            del _records[start:]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class TimedSolve:
    result: "object"            # SolveResult
    wall_seconds: float
    compile_seconds: Optional[float]
    points_per_second: float    # grid-point updates / second

    def __str__(self):
        c = (f", compile {self.compile_seconds:.2f}s"
             if self.compile_seconds is not None else "")
        return (f"{self.result} in {self.wall_seconds:.3f}s{c} "
                f"({self.points_per_second:,.0f} point-updates/s)")


def _run(solve_fn, T, x0, solve_kwargs):
    """One solve and its wall seconds, ended by a device synchronize
    where the result lives on the card."""
    t0 = time.perf_counter()
    res = solve_fn(T, x0, **solve_kwargs)
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    return res, time.perf_counter() - t0


def timed_solve(solve_fn: Callable, T: Callable, x0, *,
                warm_up: bool = True, **solve_kwargs) -> TimedSolve:
    """Run ``solve_fn(T, x0, **kwargs)`` with timing.

    ``warm_up=True`` runs the solve twice and reports the second wall
    time, with the first-minus-second as ``compile_seconds`` (the port
    compiles nothing: this is the cold run's one-time start-up, the
    kernels' build and load included); pass False to time one cold run.
    """
    compile_s = None
    if warm_up:
        _, cold = _run(solve_fn, T, x0, solve_kwargs)
    res, wall = _run(solve_fn, T, x0, solve_kwargs)
    if warm_up:
        compile_s = max(0.0, cold - wall)
    n_points = int(np.prod(tuple(x0.shape)))
    iters = max(1, int(res.iterations))
    return TimedSolve(result=res, wall_seconds=wall,
                      compile_seconds=compile_s,
                      points_per_second=n_points * iters / wall)
