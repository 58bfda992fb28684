"""Share of the card's least time for one application of the operator
(``wcbench/roofline.py``: the work the grid needs, whatever implements
it) in the device time one application took (``primal_apply_ms``)."""

LAYER = "Primal operator and kernels"
UNIT = "%"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = tuple({"module": "sdfs_via_autodiff_tpu_torch.drivers", "attr": f,
               "span": "port.primal", "on": "returned"}
              for f in ("make_tiled_T_log_ssy", "make_tiled_T_log_gcy"))


def read(run):
    from wcbench.roofline import operator_bound_ms
    dev = run.device
    if run.trace is None or "sm_count" not in dev:
        return None
    n = run.trace.count("port.primal")
    s = run.trace.device_seconds("port.primal")
    if not n or s <= 0:
        return None
    bound = operator_bound_ms(run.cell.config["shapes"], dev["sm_count"],
                              dev["sm_clock_max_mhz"])
    return 100.0 * bound / (1e3 * s / n)
