"""Idle share of the card over the profiled solve: one less the union of
its device activity intervals (kernels, copies, sets; overlapping ones
count once) over the solve's wall time."""

LAYER = "Device"
UNIT = "%"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ()


def read(run):
    if run.trace is None:
        return None
    window = run.trace.window("wcbench.solve")
    if window is None or not run.trace.device:
        return None
    busy, _ = run.trace.busy(*window)
    return 100.0 * (1.0 - busy / (1e-6 * (window[1] - window[0])))
