"""Tauchen (1986) discretization of Gaussian AR(1) processes.

Companion to :mod:`.rouwenhorst` (the BASELINE north star names both).
Discretizes y' = mu + rho*y + sigma*eps on an equally spaced grid spanning
``m_std`` unconditional standard deviations, with transition probabilities
from the normal CDF over half-open cells (edges take the tails).

Like Rouwenhorst, the transition matrix depends only on (n, rho, m_std) —
not on sigma or mu — because states scale linearly with sigma and shift by
mu/(1-rho): the operators' shared-transition-matrix factorization applies
unchanged (``tauchen_P`` + ``tauchen_ladder``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["tauchen", "tauchen_P", "tauchen_ladder"]


def _norm_cdf(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def tauchen_ladder(n: int, rho: float, m_std: float = 3.0) -> np.ndarray:
    """Unit ladder: states = mu/(1-rho) + sigma * ladder."""
    if n == 1:
        return np.zeros(1)
    span = m_std / math.sqrt(1.0 - rho**2)
    return np.linspace(-span, span, n)


def tauchen_P(n: int, rho: float, m_std: float = 3.0) -> np.ndarray:
    """Transition matrix on the unit ladder (sigma = 1 w.l.o.g.)."""
    if n == 1:
        return np.ones((1, 1))
    y = tauchen_ladder(n, rho, m_std)
    mid = (y[None, :-1] + y[None, 1:]) / 2.0        # cell boundaries
    z = mid - rho * y[:, None]                       # standardized edges
    cdf = _norm_cdf(z)
    P = np.empty((n, n))
    P[:, 0] = cdf[:, 0]
    P[:, 1:-1] = cdf[:, 1:] - cdf[:, :-1]
    P[:, -1] = 1.0 - cdf[:, -1]
    return P


def tauchen(n: int, rho: float, sigma: float, mu: float = 0.0,
            m_std: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """Discretize y' = mu + rho*y + sigma*eps; returns (states, P)."""
    if abs(rho) >= 1:
        raise ValueError("tauchen requires |rho| < 1")
    states = mu / (1.0 - rho) + sigma * tauchen_ladder(n, rho, m_std)
    return states, tauchen_P(n, rho, m_std)
