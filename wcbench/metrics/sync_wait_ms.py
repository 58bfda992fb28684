"""Host milliseconds per solve blocked in the port's ``sdfs.sync`` spans
(the solver loops' reads of device values): near a solve's wall time the
device sets the pace, near zero the host does.  Solves of the window
that were not profiled.  Loading this reader switches the port's span
recorder on (``host_syncs.py``)."""

from wcbench.metrics.host_syncs import ms_per_solve, record

LAYER = "Host-device sync"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "program_span"
WRAPS = ()

record()


def read(run):
    return ms_per_solve(run, "sdfs.sync")
