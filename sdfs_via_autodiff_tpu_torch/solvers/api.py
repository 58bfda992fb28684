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
from .result import SolveResult

__all__ = ["SOLVERS", "solve", "solver"]

SOLVERS = {
    "successive_approx": successive_approx,
    "sa": successive_approx,               # short alias
    "newton": newton_solver,
    "anderson": anderson_solver,
}

# Methods of the JAX package that later slices port.
_NOT_PORTED = {"gd": "ROADMAP queue A item 3 (gradient_solver)"}


def _lookup(method: str) -> Callable:
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet; it lands with "
            f"{_NOT_PORTED[method]}")
    return SOLVERS[method]


def solve(T: Callable, x0, *, method: str = "newton", **kwargs) -> SolveResult:
    """Solve for a fixed point of ``T`` starting from ``x0``.

    ``method`` is one of ``SOLVERS``; extra keyword arguments are forwarded
    to the chosen solver (e.g. ``tol``, ``max_iter``, ``inner_tol``).
    """
    if method not in SOLVERS and method not in _NOT_PORTED:
        raise ValueError(
            f"unknown method {method!r}; available: {sorted(SOLVERS)}")
    return _lookup(method)(T, x0, **kwargs)


def solver(f: Callable, x_init, algorithm: str = "newton",
           verbose: bool = True):
    """Reference-compatible front end: returns only the fixed point,
    falling back to successive approximation with a warning when the
    algorithm name is unknown."""
    if algorithm not in SOLVERS and algorithm not in _NOT_PORTED:
        warnings.warn(
            f"Algorithm {algorithm} not found. "
            "Falling back to successive approximation.", stacklevel=2)
        algorithm = "successive_approx"
    return _lookup(algorithm)(f, x_init, verbose=verbose).x
