"""Device milliseconds per crossing of the six-state natural layout: the
device time launched inside the port's ``sdfs.layout`` spans (the
permute into the operator's 4-D view or out of it, with the copy it
forces, on every primal application and every tangent matvec) over the
count of those spans, in the profiled solve.  Loading this reader
switches the port's span recorder on (``host_syncs.py``); a port
without the span leaves the metric silent."""

from wcbench.metrics.host_syncs import record

LAYER = "Six-state layout"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ()

record()


def read(run):
    if run.trace is None:
        return None
    n = run.trace.count("sdfs.layout")
    s = run.trace.device_seconds("sdfs.layout")
    return 1e3 * s / n if n and s > 0 else None
