"""Host microseconds per application of the primal operator: the
port's ``sdfs.primal`` spans (the enqueue of one application's kernels
and what the operator does around them), over the solves of the window
that were not profiled; ``primal_apply_ms`` is the same application's
device time.  Loading this reader switches the port's span recorder on
(``host_syncs.py``)."""

from wcbench.metrics.host_syncs import record, spans

LAYER = "Primal operator and kernels"
UNIT = "us"
MOVES = "solve_s"
SOURCE = "program_span"
WRAPS = ()

record()


def read(run):
    per = spans(run, "sdfs.primal", run.untraced)
    iv = [t1 - t0 for v in per.values() for t0, t1, _ in v]
    return 1e-3 * sum(iv) / len(iv) if iv else None
