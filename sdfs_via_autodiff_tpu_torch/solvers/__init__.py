from .result import SolveResult
from .fixed_point import successive_approx, newton_solver, DEFAULT_TOL, DEFAULT_MAX_ITER
from .krylov import bicgstab_mixed
from .anderson import anderson_solver
from .api import SOLVERS, solve, solver

__all__ = [
    "SolveResult", "successive_approx", "newton_solver", "bicgstab_mixed",
    "anderson_solver",
    "SOLVERS", "solve", "solver", "DEFAULT_TOL", "DEFAULT_MAX_ITER",
]
