"""Share of its roofline that B2 deferred, pass C with the deferred c2
factor, reaches inside a solve: its least time at the cell's view
(``wcbench/kernel_work.py``) over the device milliseconds per
application launched inside the port's ``sdfs.primal.c`` spans, in the
profiled solve; read as ``deferred_b_roofline`` is."""

from wcbench.kernel_work import deferred_c_bound_ms
from wcbench.metrics.deferred_b_roofline import share
from wcbench.metrics.host_syncs import record

LAYER = "Primal operator and kernels"
UNIT = "%"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ()

record()


def read(run):
    return share(run, "sdfs.primal.c", deferred_c_bound_ms)
