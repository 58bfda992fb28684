from .result import SolveResult
from .fixed_point import successive_approx, newton_solver, DEFAULT_TOL, DEFAULT_MAX_ITER
from .krylov import bicgstab_mixed, gmres
from .anderson import anderson_solver
from .gradient import gradient_solver
from .api import SOLVERS, solve, solver
from .implicit import implicit_fixed_point, implicit_sensitivity

__all__ = [
    "SolveResult", "successive_approx", "newton_solver", "bicgstab_mixed",
    "gmres", "anderson_solver", "gradient_solver",
    "SOLVERS", "solve", "solver", "DEFAULT_TOL", "DEFAULT_MAX_ITER",
    "implicit_fixed_point", "implicit_sensitivity",
]
