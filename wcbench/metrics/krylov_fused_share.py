"""Share of the BiCGStab iterations that ran as the port's fused passes
(``solvers/krylov.bicgstab_fused``): the port's ``sdfs.krylov.fused``
counts over its ``sdfs.krylov`` counts, over every solve of the window.
A port without the fused passes records no ``sdfs.krylov.fused`` and
leaves the metric silent.  Loading this reader switches the port's span
recorder on (``host_syncs.py``)."""

from wcbench.metrics.host_syncs import record, spans

LAYER = "Krylov"
UNIT = "ratio"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ()

record()


def _total(per: dict) -> int:
    return sum(c or 0 for v in per.values() for *_, c in v)


def read(run):
    fused = spans(run, "sdfs.krylov.fused")
    if not fused:
        return None
    total = _total(spans(run, "sdfs.krylov"))
    return _total(fused) / total if total else None
