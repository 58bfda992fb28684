"""Outer solver iterations per solve (Newton steps or SA iterations):
``SolveResult.iterations`` of every solve of the window.  The span
around the driver's ``solve`` labels the breakdown's idle gaps."""

LAYER = "Outer solver"
UNIT = "count"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ({"module": "sdfs_via_autodiff_tpu_torch.drivers", "attr": "solve",
          "span": "port.solver", "on": "call"},)


def read(run):
    its = [s["iterations"] for s in run.solves]
    return sum(its) / len(its) if its else None
