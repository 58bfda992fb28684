"""Spans the harness takes around calls into the port, and the reading
of the profiler's trace.

A wrap names a port attribute (``module``, ``attr``, ``Class.method``
allowed) and a span name.  ``on="call"`` opens the span around each call
of the attribute; ``on="returned"`` around each call of the callable the
attribute returns (an operator from its factory), which keeps the
factory's attributes.  Each wrapped call opens a
``torch.profiler.record_function`` of the span's name and appends (solve
index, start, end, count) to :attr:`Spans.records`, ``count`` being what
the wrap's ``count`` function reads from the call's result.  A wrap whose
attribute is missing raises: a renamed port function must fail loudly,
not leave a metric silent.

:class:`Trace` reads a Chrome trace of ``torch.profiler``.  Device
activity (kernels, copies, sets) is attributed to a span through the
profiler's launch correlation: the host call that launched it (runtime
or driver API) lies inside the span on the same thread.  Kernel names
play no part, so a fused or renamed kernel is still counted.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Spans", "Trace", "DEVICE_CATS", "LAUNCH_CATS", "short_name"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its leading "void ", anonymous namespaces
    and its argument list (the first parenthesis that follows a name
    outside template brackets)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:width]


class Spans:
    """The installed wraps and what they recorded."""

    def __init__(self):
        self.solve = -1                       # index of the running solve
        self.records: Dict[str, list] = defaultdict(list)
        self._undo: List[Callable] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        box = {}
        with torch.profiler.record_function(name):
            yield box
        self.records[name].append((self.solve, t0, time.perf_counter(),
                                   box.get("count")))

    def _wrapped(self, fn: Callable, name: str, count: Optional[Callable]):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with self.span(name) as box:
                out = fn(*args, **kwargs)
                if count is not None:
                    box["count"] = count(out)
            return out
        return call

    def install(self, wrap: dict) -> None:
        """Install one wrap: {"module", "attr", "span", "on", "count"}."""
        owner = importlib.import_module(wrap["module"])
        path = wrap["attr"].split(".")
        for part in path[:-1]:
            owner = getattr(owner, part)
        name = path[-1]
        if not hasattr(owner, name):
            raise AttributeError(
                f"wrap target {wrap['module']}.{wrap['attr']} not found")
        original = getattr(owner, name)
        span, count = wrap["span"], wrap.get("count")
        if wrap.get("on", "call") == "call":
            new = self._wrapped(original, span, count)
        elif wrap["on"] == "returned":
            @functools.wraps(original)
            def new(*args, **kwargs):
                op = original(*args, **kwargs)
                # functools.wraps copies the operator's attributes (its
                # twin, mode, engine) onto the wrapper.
                return self._wrapped(op, span, count)
        else:
            raise ValueError(f"unknown wrap kind {wrap['on']!r}")
        setattr(owner, name, new)
        self._undo.append(lambda: setattr(owner, name, original))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def of(self, name: str, solves=None) -> list:
        """Records of span ``name`` in ``solves`` (all when None)."""
        return [r for r in self.records.get(name, ())
                if solves is None or r[0] in solves]


class Trace:
    """Device activity of a Chrome trace, attributed to spans."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launches = {}
        self.device = []          # (start_us, end_us, name, correlation)
        self.spans = defaultdict(lambda: defaultdict(list))  # name->tid->[]
        self.ops = defaultdict(list)      # tid -> host op intervals
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", "?"),
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS:
                launches[args.get("correlation")] = (e.get("tid"), ts)
                self.ops[e.get("tid")].append((ts, ts + dur, e["name"]))
            elif cat == SPAN_CAT:
                self.spans[e["name"]][e.get("tid")].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.ops[e.get("tid")].append((ts, ts + dur, e["name"]))
        self.launch = [launches.get(c) for *_, c in self.device]
        for by_tid in self.spans.values():
            for iv in by_tid.values():
                iv.sort()
        for iv in self.ops.values():
            iv.sort()

    def _inside(self, name: str, tid, ts: float) -> bool:
        iv = self.spans.get(name, {}).get(tid)
        if not iv:
            return False
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= ts <= iv[i][1]

    def count(self, name: str) -> int:
        """Spans of ``name`` in the trace."""
        return sum(len(iv) for iv in self.spans.get(name, {}).values())

    def device_seconds(self, name: str) -> float:
        """Device time of the activity launched inside spans ``name``."""
        total = 0.0
        for (t0, t1, _, _), launch in zip(self.device, self.launch):
            if launch is not None and self._inside(name, *launch):
                total += t1 - t0
        return 1e-6 * total

    def window(self, name: str):
        """(start, end) in us of the spans ``name`` (the traced solves)."""
        iv = [x for by_tid in self.spans.get(name, {}).values() for x in by_tid]
        if not iv:
            return None
        return min(a for a, _ in iv), max(b for _, b in iv)

    def busy(self, start: float, end: float):
        """(busy seconds, idle gaps as (start, end) us) of the device in
        [start, end]: the union of activity intervals, so overlapping
        kernels count once."""
        iv = sorted((max(a, start), min(b, end)) for a, b, *_ in self.device
                    if b > start and a < end)
        busy, gaps, at = 0.0, [], start
        for a, b in iv:
            if a > at:
                gaps.append((at, a))
            if b > at:
                busy += b - max(a, at)
                at = b
        if end > at:
            gaps.append((at, end))
        return 1e-6 * busy, gaps

    def top_device_ops(self, start: float, end: float, n: int = 10):
        """The ``n`` device operations (by name) that took most time, each
        name without its argument list and cut to 160 characters."""
        tot = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > start and a < end:
                tot[name] += 1e-6 * (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [(short_name(k), v) for k, v in top]

    def idle_by_host(self, gaps, tid, n: int = 10):
        """Idle seconds summed by what host thread ``tid`` was doing at
        each gap's midpoint (the innermost harness span open there, and
        the innermost host op), the ``n`` largest.  Host intervals nest
        on a thread, so one sweep with a stack finds the innermost."""
        events = sorted([(a, b, name, True)
                         for name, by_tid in self.spans.items()
                         for a, b in by_tid.get(tid, ())]
                        + [(a, b, name, False)
                           for a, b, name in self.ops.get(tid, ())])
        tot = defaultdict(float)
        stack, i = [], 0
        for a, b in sorted(gaps):
            t = 0.5 * (a + b)
            while i < len(events) and events[i][0] <= t:
                while stack and stack[-1][1] < events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            open_ = [e for e in stack if e[0] <= t <= e[1]]
            span = next((e[2] for e in reversed(open_) if e[3]),
                        "outside spans")
            op = next((e[2] for e in reversed(open_) if not e[3]), None)
            tot[span + (f" > {op}" if op else "")] += 1e-6 * (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]
