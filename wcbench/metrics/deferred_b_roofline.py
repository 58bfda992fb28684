"""Share of its roofline that B3, the deferred pass B, reaches inside a
solve: its least time at the cell's view (``wcbench/kernel_work.py``)
over the device milliseconds per application launched inside the port's
``sdfs.primal.b`` spans, in the profiled solve.  Read only where every
application of the solve ran the deferred configuration (the port's
``sdfs.primal.deferred`` count equals its ``sdfs.primal`` spans);
otherwise, and on a port without those spans, silent.  Loading this
reader switches the port's span recorder on (``host_syncs.py``)."""

from wcbench.kernel_work import deferred_b_bound_ms, gcy_view
from wcbench.metrics.host_syncs import record, spans

LAYER = "Primal operator and kernels"
UNIT = "%"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ()

record()


def share(run, span: str, bound_of):
    """100 x ``bound_of(view)`` ms over the device ms per ``span`` of
    the profiled solve, or None."""
    if run.trace is None or not run.traced:
        return None
    deferred = spans(run, "sdfs.primal.deferred", run.traced)
    primal = spans(run, "sdfs.primal", run.traced)
    n_deferred = sum(c or 0 for v in deferred.values() for *_, c in v)
    n_primal = sum(len(v) for v in primal.values())
    if not n_primal or n_deferred != n_primal:
        return None
    n = run.trace.count(span)
    s = run.trace.device_seconds(span)
    if not n or s <= 0:
        return None
    view = gcy_view(run.cell.config["shapes"])
    return 100.0 * bound_of(view) / (1e3 * s / n)


def read(run):
    return share(run, "sdfs.primal.b", deferred_b_bound_ms)
