"""Blocking host reads per solve: the port's ``sdfs.sync`` spans (each
read of a device value by the solver loops' host side, ``solvers/
krylov.host_read``), over every solve of the window.

Loading this reader switches the port's span recorder on
(``utils/profiling.set_recording``): the harness loads readers only
under ``--trace 1``, so the timed ``--trace 0`` runs record nothing.  A
port without the recorder leaves the metric silent.  :func:`spans`, which
the other readers of the port's spans share, assigns the port's records
to the window's solves by containment in the harness's ``wcbench.solve``
spans (one clock: ``time.perf_counter``)."""

import bisect

LAYER = "Host-device sync"
UNIT = "count"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ()


def _profiling():
    from sdfs_via_autodiff_tpu_torch.utils import profiling
    return profiling if hasattr(profiling, "set_recording") else None


def record() -> None:
    """Switch the port's recorder on, where the port has one."""
    profiling = _profiling()
    if profiling is not None:
        profiling.set_recording(True)


record()


def spans(run, name: str, solves=None) -> dict:
    """{solve index: [(start_ns, end_ns, count)]} of the port's records
    named ``name`` inside the window's ``solves`` (all when None).  The
    port's records are taken once a run and kept on it."""
    got = getattr(run, "port_records", None)
    if got is None:
        profiling = _profiling()
        got = run.port_records = (profiling.records() if profiling else [])
    windows = sorted((1e9 * t0, 1e9 * t1, s)
                     for s, t0, t1, _ in run.spans.of("wcbench.solve",
                                                      solves))
    starts = [w[0] for w in windows]
    out = {}
    for r in got:
        if r.name != name:
            continue
        i = bisect.bisect_right(starts, r.start_ns) - 1
        if i >= 0 and r.end_ns <= windows[i][1]:
            out.setdefault(windows[i][2], []).append(
                (r.start_ns, r.end_ns, r.count))
    return out


def ms_per_solve(run, name: str):
    """Host ms per unprofiled solve inside the port's spans ``name``."""
    per = spans(run, name, run.untraced)
    ms = [1e-6 * sum(t1 - t0 for t0, t1, _ in v) for v in per.values()]
    return sum(ms) / len(ms) if ms else None


def read(run):
    per = spans(run, "sdfs.sync")
    return (sum(len(v) for v in per.values()) / len(run.solves)
            if per else None)
