"""Schorfheide–Song–Yaron (SSY) long-run-risk model.

State vector (4 states): ``x = (h_lam, h_c, h_z, z)``, with dynamics

    h_lam' = rho_lam * h_lam + s_lam * eta
    h_c'   = rho_c   * h_c   + s_c   * eta
    h_z'   = rho_z   * h_z   + s_z   * eta
    z'     = rho     * z     + sigma_z * eta,   sigma_z = phi_z * exp(h_z)

and volatilities ``sigma_c = phi_c * exp(h_c)``.  Consumption growth is
``g_c = mu_c + z + sigma_c * xi``.  All shocks are IID N(0, 1).

Parameter names, defaults (Table VII calibration) and the packed-tuple order
match the reference implementation (reference ``code/ssy/ssy_model.py:57-81``);
the derived Epstein–Zin exponent is ``theta = (1 - gamma) / (1 - 1/psi)``
(about -16.02 at the default calibration).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

__all__ = ["SSY", "ssy_loglinear_factory"]


@dataclasses.dataclass(frozen=True)
class SSY:
    """SSY parameter container (immutable).

    Defaults follow reference ``code/ssy/ssy_model.py:57-71``; note the
    rescalings ``phi_z -> phi_z * sigma_bar * sqrt(1 - rho^2)`` and
    ``phi_c -> phi_c * sigma_bar`` baked into the defaults.
    """

    beta: float = 0.999
    gamma: float = 8.89
    psi: float = 1.97
    rho: float = 0.987
    rho_z: float = 0.992
    rho_c: float = 0.991
    rho_lam: float = 0.959
    s_z: float = math.sqrt(0.0039)
    s_c: float = math.sqrt(0.0096)
    s_lam: float = 0.0004
    mu_c: float = 0.0016
    phi_z: float = 0.215 * 0.0035 * math.sqrt(1 - 0.987**2)
    phi_c: float = 1.00 * 0.0035

    @property
    def theta(self) -> float:
        return (1 - self.gamma) / (1 - 1 / self.psi)

    @property
    def params(self) -> Tuple[float, ...]:
        """Packed parameter tuple in the reference order
        (beta, gamma, psi, mu_c, rho, phi_z, phi_c, rho_z, rho_c, rho_lam,
        s_z, s_c, s_lam) — reference ``code/ssy/ssy_model.py:81``."""
        return (
            self.beta, self.gamma, self.psi, self.mu_c, self.rho,
            self.phi_z, self.phi_c, self.rho_z, self.rho_c, self.rho_lam,
            self.s_z, self.s_c, self.s_lam,
        )

    # Stationary standard deviations of the three h processes and the
    # (max-volatility) z process; used by grid builders.
    def h_stationary_std(self) -> Tuple[float, float, float]:
        out = []
        for s, r in ((self.s_lam, self.rho_lam), (self.s_c, self.rho_c),
                     (self.s_z, self.rho_z)):
            out.append(s / math.sqrt(1 - r**2))
        return tuple(out)


def ssy_loglinear_factory(model: SSY):
    """Campbell–Shiller-style log-linear closed-form approximation of the
    SSY log wealth-consumption ratio.

    Solves the scalar fixed point ``q_bar`` with Brent's method and returns a
    vectorised evaluator ``f(x) -> A0 + A_hlam*h_lam + A_hc*s_c + A_hz*s_z
    + A_z*z`` where ``s_c``/``s_z`` are the local variance proxies.  Used for
    warm starts and as a validation oracle.

    Parity target: reference ``code/ssy/ssy_model.py:88-156``.
    """
    from scipy.optimize import brentq

    m = model
    beta, gamma, psi = m.beta, m.gamma, m.psi
    mu_c, rho = m.mu_c, m.rho
    phi_z, phi_c = m.phi_z, m.phi_c
    rho_z, rho_c, rho_lam = m.rho_z, m.rho_c, m.rho_lam
    s_z, s_c, s_lam = m.s_z, m.s_c, m.s_lam
    theta = m.theta

    s_wc = 2 * phi_c**2 * s_c
    s_wx = 2 * phi_z**2 * s_z

    def k1(x):
        return np.exp(x) / (1 + np.exp(x))

    def k0(x):
        return np.log(1 + np.exp(x)) - k1(x) * x

    def A1(x):
        return (1 - 1 / psi) / (1 - k1(x) * rho)

    def Alam(x):
        return rho_lam / (1 - k1(x) * rho_lam)

    def Az(x):
        return (theta / 2) * (k1(x) * A1(x)) ** 2 / (1 - k1(x) * rho_z)

    def Ac(x):
        return (theta / 2) * (1 - 1 / psi) ** 2 / (1 - k1(x) * rho_c)

    def A0(x):
        return (
            np.log(beta) + k0(x) + mu_c * (1 - 1 / psi)
            + k1(x) * Az(x) * phi_z**2 * (1 - rho_z)
            + k1(x) * Ac(x) * phi_c**2 * (1 - rho_c)
            + (theta / 2) * (
                (k1(x) * Alam(x) + 1) ** 2 * s_lam**2
                + (k1(x) * Az(x) * s_wx) ** 2
                + (k1(x) * Ac(x) * s_wc) ** 2
            )
        ) / (1 - k1(x))

    def q_resid(x):
        return x - A0(x) - Ac(x) * phi_c**2 - Az(x) * phi_z**2

    q_bar = brentq(q_resid, -20, 20)
    c_z = A1(q_bar)
    c_hlam = Alam(q_bar)
    c_hz = Az(q_bar)
    c_hc = Ac(q_bar)
    c_0 = A0(q_bar)

    def wc_loglinear(x):
        """Evaluate the log-linear log-W/C at state(s) ``x``.

        ``x`` is array-like with leading axis (h_lam, h_c, h_z, z); trailing
        axes broadcast, so a (4,) point or a (4, N) batch both work.
        """
        x = np.asarray(x)
        h_lam, h_c, h_z, z = x[0], x[1], x[2], x[3]
        sz_local = h_z * 2 * phi_z**2 + phi_z**2
        sc_local = h_c * 2 * phi_c**2 + phi_c**2
        return c_0 + c_hlam * h_lam + c_hc * sc_local + c_hz * sz_local + c_z * z

    wc_loglinear.coefficients = dict(
        A0=c_0, A_hlam=c_hlam, A_hc=c_hc, A_hz=c_hz, A_z=c_z, q_bar=q_bar
    )
    return wc_loglinear
