"""Device milliseconds per linearized matvec of Newton's tangent: the
device time launched inside the matvecs less that of the builds (the
first matvec of a Newton step builds the tape), over the matvecs of the
profiled solve."""

LAYER = "Tangent"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ({"module": "sdfs_via_autodiff_tpu_torch.ops.tangent",
          "attr": "Linearization.__call__", "span": "port.tangent.matvec",
          "on": "call"},
         {"module": "sdfs_via_autodiff_tpu_torch.ops.tangent",
          "attr": "Linearization.build", "span": "port.tangent.build",
          "on": "call"})


def read(run):
    if run.trace is None:
        return None
    n = run.trace.count("port.tangent.matvec")
    if not n:
        return None
    s = (run.trace.device_seconds("port.tangent.matvec")
         - run.trace.device_seconds("port.tangent.build"))
    return 1e3 * s / n if s > 0 else None
