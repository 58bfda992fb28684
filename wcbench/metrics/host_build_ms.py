"""Host wall milliseconds per solve from the driver call to the operator
built: discretization, operand build and the tiled factory, read from
the harness's spans around the solve and around the factory.  Solves of
the window that were not profiled."""

LAYER = "Driver and host algebra"
UNIT = "ms"
MOVES = "solve_s"
SOURCE = "program_span"
WRAPS = tuple({"module": "sdfs_via_autodiff_tpu_torch.drivers", "attr": f,
               "span": "port.build", "on": "call"}
              for f in ("make_tiled_T_log_ssy", "make_tiled_T_log_gcy"))


def read(run):
    starts = {s: t0 for s, t0, _, _ in run.spans.of("wcbench.solve",
                                                    run.untraced)}
    built = {}
    for s, _, t1, _ in run.spans.of("port.build", run.untraced):
        built.setdefault(s, t1)
    ms = [1e3 * (built[s] - starts[s]) for s in built if s in starts]
    return sum(ms) / len(ms) if ms else None
