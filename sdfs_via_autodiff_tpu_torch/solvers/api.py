"""Solver registry and front-end (port of ``solvers/api.py``).

One entry point, :func:`solve`, returning a :class:`SolveResult`, and the
reference-compatible :func:`solver` shim, which falls back to successive
approximation on an unknown algorithm name.
"""

from __future__ import annotations

import warnings
from typing import Callable

from .anderson import anderson_solver
from .fixed_point import newton_solver, successive_approx
from .gradient import gradient_solver
from .result import SolveResult

__all__ = ["SOLVERS", "solve", "solver"]

SOLVERS = {
    "successive_approx": successive_approx,
    "sa": successive_approx,               # short alias
    "newton": newton_solver,
    "anderson": anderson_solver,
    "gd": gradient_solver,
}


def solve(T: Callable, x0, *, method: str = "newton", **kwargs) -> SolveResult:
    """Solve for a fixed point of ``T`` starting from ``x0``.

    ``method`` is one of ``SOLVERS``; extra keyword arguments are forwarded
    to the chosen solver (e.g. ``tol``, ``max_iter``, ``inner``,
    ``history_size``).
    """
    if method not in SOLVERS:
        raise ValueError(
            f"unknown method {method!r}; available: {sorted(SOLVERS)}")
    return SOLVERS[method](T, x0, **kwargs)


def solver(f: Callable, x_init, algorithm: str = "newton",
           verbose: bool = True):
    """Reference-compatible front end: returns only the fixed point,
    falling back to successive approximation with a warning when the
    algorithm name is unknown."""
    if algorithm not in SOLVERS:
        warnings.warn(
            f"Algorithm {algorithm} not found. "
            "Falling back to successive approximation.", stacklevel=2)
        algorithm = "successive_approx"
    if algorithm == "gd":                  # takes no ``verbose``
        return SOLVERS[algorithm](f, x_init).x
    return SOLVERS[algorithm](f, x_init, verbose=verbose).x
