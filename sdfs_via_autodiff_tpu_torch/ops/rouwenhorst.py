"""Pure-Python/NumPy Rouwenhorst discretization of Gaussian AR(1) processes.

The reference delegates to ``quantecon.rouwenhorst`` (reference
``code/ssy/discrete/ssy_wc_ratio.py:48-50,63`` and
``code/gcy/discrete/gcy_wc_ratio.py:65-68,97,115``) with the modern
``rouwenhorst(n, rho, sigma, mu)`` semantics: discretize

    y' = mu + rho * y + sigma * eps,    eps ~ N(0, 1)

on an ``n``-point grid.  We implement it from the exact binomial
construction (Rouwenhorst 1995; Kopecky–Suen 2010):

* ``p = q = (1 + rho) / 2``
* transition matrix built by the standard recursive embedding
* states equally spaced on ``mu/(1-rho) ± sigma*sqrt((n-1)/(1-rho^2))``

Key structural fact exploited by the TPU operators: the transition matrix
depends only on ``rho`` (not on ``sigma`` or ``mu``), so families of chains
that share ``rho`` — e.g. the volatility-dependent z-chains in SSY/GCY —
share a single transition matrix while only the state ladder is scaled and
shifted.  ``rouwenhorst_ladder`` exposes that decomposition.

Construction runs on host in float64 (it is setup-time work, O(n^2)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["rouwenhorst", "rouwenhorst_P", "rouwenhorst_ladder", "stationary_distribution"]


def rouwenhorst_P(n: int, rho: float) -> np.ndarray:
    """Return the n-state Rouwenhorst transition matrix for persistence rho.

    Exact recursive construction with p = q = (1 + rho)/2; rows sum to 1.
    """
    if n < 1:
        raise ValueError("n must be >= 1")
    p = (1.0 + rho) / 2.0
    if n == 1:
        return np.ones((1, 1))
    P = np.array([[p, 1 - p], [1 - p, p]])
    for m in range(3, n + 1):
        Z = np.zeros((m, m))
        Z[:m - 1, :m - 1] += p * P
        Z[:m - 1, 1:] += (1 - p) * P
        Z[1:, :m - 1] += (1 - p) * P
        Z[1:, 1:] += p * P
        Z[1:m - 1, :] /= 2.0
        P = Z
    return P


def rouwenhorst_ladder(n: int, rho: float) -> np.ndarray:
    """Unit ladder u with states = mu/(1-rho) + sigma * u.

    u = linspace(-1, 1, n) * sqrt((n-1) / (1 - rho^2)).
    """
    if n == 1:
        return np.zeros(1)
    span = np.sqrt((n - 1) / (1.0 - rho**2))
    return np.linspace(-span, span, n)


def rouwenhorst(n: int, rho: float, sigma: float, mu: float = 0.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Discretize y' = mu + rho*y + sigma*eps on n states.

    Returns ``(state_values, P)`` with ``state_values`` shape (n,) and ``P``
    shape (n, n) (row-stochastic).  Matches ``quantecon.rouwenhorst`` with
    the post-0.7 ``(n, rho, sigma, mu)`` signature used (implicitly) by the
    reference.
    """
    if abs(rho) >= 1:
        raise ValueError("rouwenhorst requires |rho| < 1")
    states = mu / (1.0 - rho) + sigma * rouwenhorst_ladder(n, rho)
    return states, rouwenhorst_P(n, rho)


def stationary_distribution(P: np.ndarray) -> np.ndarray:
    """Stationary distribution of a row-stochastic matrix (left Perron vector).

    For Rouwenhorst chains this equals Binomial(n-1, 1/2) exactly; computed
    here generically via the eigenproblem for use as a test oracle.
    """
    vals, vecs = np.linalg.eig(P.T)
    i = int(np.argmin(np.abs(vals - 1.0)))
    pi = np.real(vecs[:, i])
    pi = np.abs(pi)
    return pi / pi.sum()
