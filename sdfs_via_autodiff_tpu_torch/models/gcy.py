"""Gomez-Cram–Yaron (GCY, 2020) long-run-risk model with inflation states.

State vector (6 states): ``x = (h_lam, h_c, h_z, h_zpi, z, z_pi)``, dynamics

    z'     = rho * z + rho_pi * z_pi + sigma_z * eta0
    z_pi'  = rho_pipi * z_pi + sigma_zpi * eta1
    h_z'   = rho_z * h_z + s_z * eta2
    h_c'   = rho_c * h_c + s_c * eta3
    h_zpi' = rho_zpi * h_zpi + s_zpi * eta4
    h_lam' = rho_lam * h_lam + s_lam * eta5

with ``sigma_z = phi_z * exp(h_z)``, ``sigma_zpi = phi_zpi * exp(h_zpi)``.
Consumption growth: ``g_c' = mu_c + z + sigma_c * xi`` with
``sigma_c = phi_c * exp(h_c)`` — current-period z and stochastic
volatility, exactly as the operators' kappa consumes them
(``operators/continuous_gcy._log_kappa_gcy``,
``operators/discrete_gcy._gcy_factors``).

Parameter names/defaults and the packed-tuple order match the reference
(reference ``code/gcy/gcy_model.py:45-75``); theta is about -36.03 at the
default calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["GCY", "gcy_loglinear_factory"]


@dataclasses.dataclass(frozen=True)
class GCY:
    """GCY parameter container (immutable).

    Defaults follow reference ``code/gcy/gcy_model.py:45-63``.
    """

    beta: float = 0.9987
    psi: float = 1.5
    gamma: float = 13.01
    rho_lam: float = 0.981
    s_lam: float = 0.12 * 0.0015
    mu_c: float = 0.0016
    phi_c: float = 0.0015
    rho: float = 0.983
    rho_pi: float = -0.0075
    phi_z: float = 0.13 * 0.0015
    rho_c: float = 0.992
    s_c: float = 0.104
    rho_z: float = 0.980
    s_z: float = 0.09
    rho_pipi: float = 0.985
    phi_zpi: float = 0.08 * 0.0015
    rho_zpi: float = 0.970
    s_zpi: float = 0.271

    @property
    def theta(self) -> float:
        return (1 - self.gamma) / (1 - 1 / self.psi)

    @property
    def params(self) -> Tuple[float, ...]:
        """Packed tuple in the reference order (beta, psi, gamma, rho_lam,
        s_lam, mu_c, phi_c, rho, rho_pi, phi_z, rho_c, s_c, rho_z, s_z,
        rho_pipi, phi_zpi, rho_zpi, s_zpi) — reference
        ``code/gcy/gcy_model.py:72-75``."""
        return (
            self.beta, self.psi, self.gamma,
            self.rho_lam, self.s_lam, self.mu_c, self.phi_c, self.rho,
            self.rho_pi, self.phi_z, self.rho_c, self.s_c, self.rho_z,
            self.s_z, self.rho_pipi, self.phi_zpi, self.rho_zpi, self.s_zpi,
        )


def gcy_loglinear_factory(model: GCY):
    """Log-linear closed-form approximation of the GCY log W/C ratio,
    with the extra inflation-expectation terms (A_pi, A_zpi).

    Parity target: reference ``code/gcy/gcy_model.py:80-159``.
    """
    from scipy.optimize import brentq

    m = model
    beta, psi, gamma = m.beta, m.psi, m.gamma
    rho_lam, s_lam, mu_c, phi_c, rho = m.rho_lam, m.s_lam, m.mu_c, m.phi_c, m.rho
    rho_pi, phi_z, rho_c, s_c = m.rho_pi, m.phi_z, m.rho_c, m.s_c
    rho_z, s_z = m.rho_z, m.s_z
    rho_pipi, phi_zpi, rho_zpi, s_zpi = m.rho_pipi, m.phi_zpi, m.rho_zpi, m.s_zpi
    theta = m.theta

    s_wc = 2 * phi_c**2 * s_c
    s_wx = 2 * phi_z**2 * s_z
    s_wxpi = 2 * phi_zpi**2 * s_zpi

    def k1(x):
        return np.exp(x) / (1 + np.exp(x))

    def k0(x):
        return np.log(1 + np.exp(x)) - k1(x) * x

    def A1(x):
        return (1 - 1 / psi) / (1 - k1(x) * rho)

    def Alam(x):
        return rho_lam / (1 - k1(x) * rho_lam)

    def Api(x):
        return k1(x) * (1 - 1 / psi) * rho_pi / ((1 - k1(x) * rho) * (1 - k1(x) * rho_pipi))

    def Az(x):
        return (theta / 2) * (k1(x) * A1(x)) ** 2 / (1 - k1(x) * rho_z)

    def Azpi(x):
        return (theta / 2) * (k1(x) * Api(x)) ** 2 / (1 - k1(x) * rho_zpi)

    def Ac(x):
        return (theta / 2) * (1 - 1 / psi) ** 2 / (1 - k1(x) * rho_c)

    def A0(x):
        return (
            np.log(beta) + k0(x) + mu_c * (1 - 1 / psi)
            + k1(x) * Az(x) * phi_z**2 * (1 - rho_z)
            + k1(x) * Ac(x) * phi_c**2 * (1 - rho_c)
            + k1(x) * Azpi(x) * phi_zpi**2 * (1 - rho_zpi)
            + (theta / 2) * (
                (k1(x) * Alam(x) + 1) ** 2 * s_lam**2
                + (k1(x) * Az(x) * s_wx) ** 2
                + (k1(x) * Ac(x) * s_wc) ** 2
                + (k1(x) * Azpi(x) * s_wxpi) ** 2
            )
        ) / (1 - k1(x))

    def q_resid(x):
        return (x - A0(x) - Ac(x) * phi_c**2 - Az(x) * phi_z**2
                - Azpi(x) * phi_zpi**2)

    q_bar = brentq(q_resid, -20, 20)
    c_z = A1(q_bar)
    c_zpi = Api(q_bar)
    c_hlam = Alam(q_bar)
    c_hz = Az(q_bar)
    c_hc = Ac(q_bar)
    c_hzpi = Azpi(q_bar)
    c_0 = A0(q_bar)

    def wc_loglinear(x):
        """Evaluate at state(s) ``x`` with leading axis
        (h_lam, h_c, h_z, h_zpi, z, z_pi); trailing axes broadcast."""
        x = np.asarray(x)
        h_lam, h_c, h_z, h_zpi, z, z_pi = (x[i] for i in range(6))
        sz_local = h_z * 2 * phi_z**2 + phi_z**2
        sc_local = h_c * 2 * phi_c**2 + phi_c**2
        szpi_local = h_zpi * 2 * phi_zpi**2 + phi_zpi**2
        return (c_0 + c_hlam * h_lam + c_hc * sc_local + c_hz * sz_local
                + c_z * z + c_hzpi * szpi_local + c_zpi * z_pi)

    wc_loglinear.coefficients = dict(
        A0=c_0, A_hlam=c_hlam, A_hc=c_hc, A_hz=c_hz, A_hzpi=c_hzpi,
        A_z=c_z, A_zpi=c_zpi, q_bar=q_bar,
    )
    return wc_loglinear
