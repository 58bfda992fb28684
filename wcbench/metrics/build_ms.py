"""Host milliseconds per solve inside the port's ``sdfs.build`` span
(discretization, operand algebra, upload to the card and the twin),
over the solves of the window that were not profiled.  Loading this
reader switches the port's span recorder on (``host_syncs.py``)."""

from wcbench.metrics.host_syncs import ms_per_solve, record

LAYER = "Driver and host algebra"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "program_span"
WRAPS = ()

record()


def read(run):
    return ms_per_solve(run, "sdfs.build")
