"""Share of Newton's tangent matvecs that ran as the port's fused chain
(``kernels/tangent_two_phase.TwoPhaseTangent``: on a card, the tangent
passes): the port's ``sdfs.tangent.fused`` counts over its
``sdfs.tangent.matvec`` spans, over every solve of the window.  A port
without the fused chain records no ``sdfs.tangent.fused`` and leaves the
metric silent.  Loading this reader switches the port's span recorder on
(``host_syncs.py``)."""

from wcbench.metrics.host_syncs import record, spans

LAYER = "Tangent"
UNIT = "ratio"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ()

record()


def read(run):
    fused = spans(run, "sdfs.tangent.fused")
    if not fused:
        return None
    matvecs = sum(len(v) for v in spans(run, "sdfs.tangent.matvec").values())
    n = sum(c or 0 for v in fused.values() for *_, c in v)
    return n / matvecs if matvecs else None
