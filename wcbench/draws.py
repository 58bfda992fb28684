"""The parameter points a run solves at, from its seed.

A traffic mix names the parameters it varies and the relative half-width
of each (``"vary": {"gamma": 0.14, "psi": 0.14}``); every other parameter
stays at the configuration's published value.  The points come from one
fixed sequence, the Halton sequence (bases 2, 3, 5, ... in the order the
mix lists the parameters) from its first point on, in blocks of
:data:`BLOCK` (or the mix's ``"block"``); the seed only shuffles the
order within each block.  So every run solves the same set of points up
to its last, partial block, whatever its seed: the seed changes the order
and not the work.  Where a solve's cost varies from point to point (SA's
iteration count follows theta), a short block keeps that last block's
share of the window small.  The points never repeat, so nothing a
program keeps from one call helps the next.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["BLOCK", "PRIMES", "halton", "points"]

BLOCK = 2
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19)


def halton(k: int, base: int) -> float:
    """The radical inverse of k >= 1 in ``base``."""
    x, f = 0.0, 1.0 / base
    while k:
        k, digit = divmod(k, base)
        x += digit * f
        f /= base
    return x


def points(published: Dict[str, float], vary: Dict[str, float],
           seed: int, block: int = BLOCK) -> Iterator[Dict[str, float]]:
    """Endless parameter dicts: ``published`` with each key of ``vary``
    drawn within +- that fraction of its published value."""
    names = list(vary)
    if len(names) > len(PRIMES):
        raise ValueError(f"at most {len(PRIMES)} varied parameters")
    for n in names:
        if n not in published:
            raise KeyError(f"traffic varies {n!r}, which the configuration "
                           "does not have")
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    start = 1
    while True:
        for k in start + rng.permutation(block):
            p = dict(published)
            for name, base in zip(names, PRIMES):
                u = halton(int(k), base)
                p[name] = float(published[name]
                                * (1.0 + vary[name] * (2.0 * u - 1.0)))
            yield p
        start += block
