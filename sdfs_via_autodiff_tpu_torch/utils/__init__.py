from .checkpoint import save_solution, load_solution, SolutionCheckpoint
from .spectral import (power_iteration, existence_check,
                       stability_decomposition, stability_exponent_mc,
                       stability_exponent_transient,
                       stability_exponent_constant_vol)
from .profiling import trace, timed_solve, TimedSolve

__all__ = ["save_solution", "load_solution", "SolutionCheckpoint",
           "power_iteration", "existence_check", "stability_decomposition",
           "stability_exponent_mc", "stability_exponent_transient",
           "stability_exponent_constant_vol", "trace", "timed_solve",
           "TimedSolve"]
