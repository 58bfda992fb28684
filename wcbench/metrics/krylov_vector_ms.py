"""Device milliseconds per BiCGStab iteration of the Krylov layer's own
work: the device time launched inside the harness's ``port.krylov``
wraps (``fixed_point.bicgstab_mixed``) less that launched inside its
``port.tangent.matvec`` wraps (the matvecs, with the Newton step's
tangent build that the first of them runs), over the iterations those
Krylov solves returned, in the profiled solve."""

LAYER = "Krylov"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ({"module": "sdfs_via_autodiff_tpu_torch.solvers.fixed_point",
          "attr": "bicgstab_mixed", "span": "port.krylov", "on": "call",
          "count": lambda out: int(out[1])},
         {"module": "sdfs_via_autodiff_tpu_torch.ops.tangent",
          "attr": "Linearization.__call__", "span": "port.tangent.matvec",
          "on": "call"})


def read(run):
    if run.trace is None:
        return None
    n = sum(c or 0 for *_, c in run.spans.of("port.krylov", run.traced))
    s = (run.trace.device_seconds("port.krylov")
         - run.trace.device_seconds("port.tangent.matvec"))
    return 1e3 * s / n if n and s > 0 else None
