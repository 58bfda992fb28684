"""Device milliseconds per application of the primal operator (the tiled
tier's kernels and what the operator launches around them), over the
applications of the profiled solve."""

LAYER = "Primal operator and kernels"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = tuple({"module": "sdfs_via_autodiff_tpu_torch.drivers", "attr": f,
               "span": "port.primal", "on": "returned"}
              for f in ("make_tiled_T_log_ssy", "make_tiled_T_log_gcy"))


def read(run):
    if run.trace is None:
        return None
    n = run.trace.count("port.primal")
    s = run.trace.device_seconds("port.primal")
    return 1e3 * s / n if n and s > 0 else None
