"""BiCGStab iterations per solve, summed over its Newton steps: the
iteration count each inner solve returns, over every solve of the
window."""

LAYER = "Krylov"
UNIT = "count"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ({"module": "sdfs_via_autodiff_tpu_torch.solvers.fixed_point",
          "attr": "bicgstab_mixed", "span": "port.krylov", "on": "call",
          "count": lambda out: int(out[1])},)


def read(run):
    per = {}
    for s, _, _, n in run.spans.of("port.krylov"):
        per[s] = per.get(s, 0) + n
    return sum(per.values()) / len(run.solves) if per else None
