"""de Groot-style recursive utility: the alternative specification.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/degroot.py``.  The
companion paper analyzes the de Groot (2018) / de
Groot-Richter-Vyshnevskyi (2021) aggregator, which moves preference
shocks into a *state-dependent discount factor* ``a_t = h(X_t)``:

    V = [ (1 - a beta) C^(1-1/psi)
          + a beta { R_{1-gamma}(V') }^(1-1/psi) ]^(1/(1-1/psi)).

With ``g := (V/C)^(1-gamma)`` the stationary Markov solution solves

    g(x) = (T~ g)(x) = ( 1 - h(x) beta
                         + h(x) beta * (K~ g)(x)^(1/theta) )^theta,

    (K~ g)(x) = E_x[ g(X') exp((1-gamma) g_c) ],

where ``K~`` is the factored per-axis chain of the standard operator
with the preference-shock tilt removed (plain ``Q_lam`` in place of
``B_lam``).  Existence and uniqueness: ``S~ = ln beta + ln sup h +
ln r(K~)/theta < 0``, free of the preference-shock growth rate.

At ``h == 1`` with no preference shocks (s_lam = 0) the solution maps to
the standard fixed point in closed form: ``g* = ((1 - beta) w*)^theta``.

The chain runs eagerly (the JAX package runs it through XLA einsums, no
Pallas kernel), in float64 unless ``dtype`` says otherwise, on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import transparent
from ..models.gcy import GCY
from ..models.ssy import SSY
from ..ops.contract import lse_matmul
from ..ops.tangent import linearizable

__all__ = ["T_degroot_factory", "T_degroot_continuous_factory",
           "existence_check_degroot", "DeGrootExistenceReport"]


def _check_transcendentals(transcendentals: str) -> None:
    """The JAX package's ``transcendentals`` picks the TPU's software
    exp/log; the port runs CUDA's (or the CPU's) own, which is
    ``"accurate"``.  Any other value raises."""
    if transcendentals != "accurate":
        raise ValueError(
            f"transcendentals={transcendentals!r}: only 'accurate' is "
            "ported (the TPU's software transcendentals are not; "
            "ROADMAP 'Do not port')")


def _K_tilde(model, disc, transcendentals: str = "accurate", dtype=None,
             device="cuda"):
    """The untilted-lambda expectation chain K~ and the grid shape.

    Returns ``(apply_K, apply_K_log, shapes)``: the w-space chain and its
    per-axis log-sum-exp twin ``ln K~ exp(ell)`` (a single global shift
    overflows float32 on wide grids; ``ops/contract.py``).
    """
    _check_transcendentals(transcendentals)
    dev = resolve_device(device)
    dtype = dtype or torch.float64
    cast = lambda a: a.to(device=dev, dtype=dtype)
    if isinstance(model, SSY):
        from .discrete_ssy import _hw_theta_factored, _ssy_factors
        _, A2, A3 = _ssy_factors(model, disc)
        log_A2, log_A3 = torch.log(A2), torch.log(A3)
        Ql, Qc, Qhz, zP, A2, A3, log_A2, log_A3 = map(
            cast, (disc.h_lam_Q, disc.h_c_Q, disc.h_z_Q, disc.z_P, A2, A3,
                   log_A2, log_A3))

        def apply_K(v):                        # v: (l, k, i, j)
            # the canonical chain with plain Q_lam in place of B_lam
            return _hw_theta_factored(v, Ql, Qc, Qhz, zP, A2, A3)

        def apply_K_log(a, tape=None):         # a = ln g
            a = lse_matmul(Ql, a, "lm,mkij->lkij", 0, tape=tape)
            a = lse_matmul(Qc, a, "km,lmij->lkij", 1, tape=tape)
            a = lse_matmul(Qhz, a, "im,lkmj->lkij", 2, tape=tape)
            a = lse_matmul(zP, a, "jm,lkim->lkij", 3, tape=tape)
            return (a + log_A2[None, :, None, None]
                    + log_A3[None, None, :, :])

        return apply_K, apply_K_log, disc.shapes
    if isinstance(model, GCY):
        from .discrete_gcy import (_CHAIN, _gcy_factors,
                                   _hw_theta_factored_gcy)
        _, A2, A3 = _gcy_factors(model, disc)
        log_A2, log_A3 = torch.log(A2), torch.log(A3)
        factors = [cast(a) for a in (disc.h_lam_Q, disc.h_c_Q, disc.h_z_Q,
                                     disc.h_zpi_Q, disc.z_pi_P, disc.z_P)]
        A2, A3, log_A2, log_A3 = map(cast, (A2, A3, log_A2, log_A3))

        def apply_K(v):                        # v: (z, z_pi, h_z, h_c, h_zpi, h_lam)
            # the canonical chain with plain Q_lam in place of B_lam
            return _hw_theta_factored_gcy(v, factors, A2, A3)

        def apply_K_log(a, tape=None):
            for M, (subs, axis) in zip(factors, _CHAIN):
                a = lse_matmul(M, a, subs, axis, tape=tape)
            return (a + log_A2[None, None, None, :, None, None]
                    + log_A3[:, :, :, None, :, None])

        return apply_K, apply_K_log, disc.shapes
    raise TypeError(f"unsupported model {type(model).__name__}")


def _h_array(h, shapes, beta, dtype, device):
    """h broadcast over the grid, checked to lie in (0, 1/beta)."""
    if h is None:
        h = 1.0
    h = torch.broadcast_to(torch.as_tensor(h, dtype=dtype, device=device),
                           shapes)
    hmax, hmin = float(h.max()), float(h.min())
    if hmax * beta >= 1.0 or hmin <= 0.0:
        raise ValueError(
            f"h must take values in (0, 1/beta) = (0, {1/beta:.6f}); "
            f"got range [{hmin:.6f}, {hmax:.6f}]")
    return h


def _degroot_T(model, h, space, dtype, apply_K, apply_K_log, shapes,
               device):
    """The de Groot outer map over a prepared K~ chain (shared by the
    discrete and continuous factories)."""
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    theta, beta = model.theta, model.beta
    dev = resolve_device(device)
    wdtype = dtype or torch.float64
    theta_c = torch.tensor(theta, dtype=wdtype, device=dev)
    hb = _h_array(h, shapes, beta, wdtype, dev) * beta

    if space == "w":
        @transparent
        def T(g):
            k = apply_K(g)
            return (1.0 - hb + hb * k ** (1.0 / theta)) ** theta
    else:
        @linearizable
        def T(ell, tape=None):
            k_log = apply_K_log(ell, tape)
            e = hb * torch.exp(k_log / theta_c)
            q = 1.0 - hb + e
            if tape is not None:
                tape.scale(e / q)
            return theta_c * torch.log(q)
    return T


def T_degroot_factory(model, disc, *, h=None, space: str = "w",
                      dtype=None, transcendentals: str = "accurate",
                      device="cuda") -> Callable:
    """Build the de Groot fixed-point operator T~ on the discretized grid.

    ``h``: None (constant discount a = 1, the de Groot 2018 case), a
    scalar, or an array or tensor over the grid (state-dependent
    discounting: how this specification carries preference shocks);
    values must lie in ``(0, 1/beta)``.

    ``space="w"`` iterates on g directly (float64 parity tier);
    ``space="log"`` on ln g with the expectation chain contracted by
    per-axis log-sum-exp shifts (exact for any dynamic range of ln g,
    which reaches ~e^100 scales at production calibrations).
    ``transcendentals`` accepts only ``"accurate"``.
    """
    apply_K, apply_K_log, shapes = _K_tilde(model, disc, transcendentals,
                                            dtype, device)
    return _degroot_T(model, h, space, dtype, apply_K, apply_K_log,
                      shapes, device)


@dataclasses.dataclass
class DeGrootExistenceReport:
    spectral_radius: float          # r(K~)
    S_alt: float                    # ln beta + ln sup h + ln r(K~)/theta
    exists_unique: bool
    iterations: int

    def __repr__(self):
        return (f"DeGrootExistenceReport(r(K~)={self.spectral_radius:.6g}, "
                f"S_alt={self.S_alt:.6f}, "
                f"exists_unique={self.exists_unique})")


def existence_check_degroot(model, disc=None, *, grids=None,
                            quad_degree: int = 5, h=None,
                            tol: float = 1e-10,
                            device="cuda") -> DeGrootExistenceReport:
    """The alternative specification's condition
    S~ = ln beta + ln(sup h) + ln r(K~)/theta < 0, in float64 on
    ``device``.  Unlike the standard condition, the preference-shock
    *growth rate* never enters: only the discount's maximum level.

    Pass ``disc`` for the discretized chain or ``grids`` (and
    ``quad_degree``) for the continuous quadrature chain, as
    :func:`..utils.spectral.existence_check`.
    """
    from ..utils.spectral import power_iteration

    if (disc is None) == (grids is None):
        raise ValueError("pass exactly one of disc or grids")
    if grids is not None:
        apply_K, _, shapes = _K_tilde_continuous(model, grids, quad_degree,
                                                 device=device)
    else:
        apply_K, _, shapes = _K_tilde(model, disc, device=device)
    a_bar = (1.0 if h is None
             else float(torch.as_tensor(h, dtype=torch.float64).max()))
    r, it = power_iteration(apply_K, shapes, tol=tol, device=device)
    S_alt = (float(np.log(model.beta)) + float(np.log(a_bar))
             + float(np.log(r)) / model.theta)
    return DeGrootExistenceReport(spectral_radius=r, S_alt=S_alt,
                                  exists_unique=bool(S_alt < 0),
                                  iterations=it)


def _K_tilde_continuous(model, grids, degree,
                        transcendentals: str = "accurate", dtype=None,
                        device="cuda"):
    """Continuous (quadrature + interp="pre") untilted-lambda chain, with
    the ``(apply_K, apply_K_log, shapes)`` contract of
    :func:`_K_tilde`."""
    _check_transcendentals(transcendentals)
    dev = resolve_device(device)
    dtype = dtype or torch.float64
    cast = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype)
    shapes = tuple(len(g) for g in grids)
    if isinstance(model, SSY):
        from .continuous_ssy import _factored_arrays_ssy
        arrs = _factored_arrays_ssy(model, grids, degree, None,
                                    tilt_lambda=False)
        kappa = torch.exp(arrs["log_A2"][:, None] + arrs["log_A3"][None, :])
        P_lam, P_c, P_hz, P_z, log_A2, log_A3, kappa = map(
            cast, (arrs["P_lam"], arrs["P_c"], arrs["P_hz"], arrs["P_z"],
                   arrs["log_A2"], arrs["log_A3"], kappa))

        def apply_K(g):                        # g: (l, k, i, j)
            u = torch.einsum("lL,LKIJ->lKIJ", P_lam, g)
            u = torch.einsum("kK,lKIJ->lkIJ", P_c, u)
            u = torch.einsum("iI,lkIJ->lkiJ", P_hz, u)
            u = torch.einsum("ijJ,lkiJ->lkij", P_z, u)
            return kappa[None, :, None, :] * u

        def apply_K_log(a, tape=None):         # a = ln g
            a = lse_matmul(P_lam, a, "lL,LKIJ->lKIJ", 0, tape=tape)
            a = lse_matmul(P_c, a, "kK,lKIJ->lkIJ", 1, tape=tape)
            a = lse_matmul(P_hz, a, "iI,lkIJ->lkiJ", 2, tape=tape)
            a = lse_matmul(P_z, a, "ijJ,lkiJ->lkij", 3, tape=tape)
            return (a + log_A2[None, :, None, None]
                    + log_A3[None, None, None, :])

        return apply_K, apply_K_log, shapes
    if isinstance(model, GCY):
        from .continuous_gcy import _factored_arrays_gcy
        arrs = _factored_arrays_gcy(model, grids, degree, None,
                                    tilt_lambda=False)
        kappa = torch.exp(arrs["log_A2"][:, None] + arrs["log_A3"][None, :])
        (P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z, log_A2, log_A3,
         kappa) = map(cast, (arrs["P_lam"], arrs["P_c"], arrs["P_hz"],
                             arrs["P_hzpi"], arrs["P_zpi"], arrs["P_z"],
                             arrs["log_A2"], arrs["log_A3"], kappa))

        def apply_K(g):                        # g: (l, k, i, y, j, b)
            u = torch.einsum("lL,LKIYJB->lKIYJB", P_lam, g)
            u = torch.einsum("kK,lKIYJB->lkIYJB", P_c, u)
            u = torch.einsum("iI,lkIYJB->lkiYJB", P_hz, u)
            u = torch.einsum("yY,lkiYJB->lkiyJB", P_hzpi, u)
            u = torch.einsum("ybB,lkiyJB->lkiyJb", P_zpi, u)
            u = torch.einsum("ijbJ,lkiyJb->lkiyjb", P_z, u)
            return kappa[None, :, None, None, :, None] * u

        def apply_K_log(a, tape=None):
            a = lse_matmul(P_lam, a, "lL,LKIYJB->lKIYJB", 0, tape=tape)
            a = lse_matmul(P_c, a, "kK,lKIYJB->lkIYJB", 1, tape=tape)
            a = lse_matmul(P_hz, a, "iI,lkIYJB->lkiYJB", 2, tape=tape)
            a = lse_matmul(P_hzpi, a, "yY,lkiYJB->lkiyJB", 3, tape=tape)
            a = lse_matmul(P_zpi, a, "ybB,lkiyJB->lkiyJb", 5, tape=tape)
            a = lse_matmul(P_z, a, "ijbJ,lkiyJb->lkiyjb", 4, tape=tape)
            return (a + log_A2[None, :, None, None, None, None]
                    + log_A3[None, None, None, None, :, None])

        return apply_K, apply_K_log, shapes
    raise TypeError(f"unsupported model {type(model).__name__}")


def T_degroot_continuous_factory(model, grids, *, h=None,
                                 quad_degree: int = 5, space: str = "w",
                                 dtype=None,
                                 transcendentals: str = "accurate",
                                 device="cuda") -> Callable:
    """Continuous-state T~ on uniform grids (quadrature + interp="pre"),
    with :func:`T_degroot_factory`'s semantics: the factored
    per-dimension Gauss-Hermite expectation chain with the lambda tilt
    removed, then the de Groot outer map with discount field ``h``
    (None, a scalar, or an array over the grid, values in (0, 1/beta)).
    ``space="log"`` contracts by per-axis log-sum-exp."""
    apply_K, apply_K_log, shapes = _K_tilde_continuous(
        model, grids, quad_degree, transcendentals, dtype, device)
    return _degroot_T(model, h, space, dtype, apply_K, apply_K_log,
                      shapes, device)
