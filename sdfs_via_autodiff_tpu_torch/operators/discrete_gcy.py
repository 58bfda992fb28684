"""Discrete (tensor-grid Markov chain) Koopmans operator for the GCY model.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/discrete_gcy.py``, the
six-state analogue of :mod:`.discrete_ssy`: ``H w^theta`` is a chain of
six per-axis contractions.

State order in w:

    w[i_z, i_z_pi, i_h_z, i_h_c, i_h_zpi, i_h_lam]

Discretization structure:

* independent chains for h_z, h_c, h_zpi, h_lam;
* z_pi chains conditional on h_zpi: z_pi_states[i_h_zpi, i_z_pi];
* z chains conditional on (z_pi, h_z, h_zpi) including the mean shift
  rho_pi * z_pi: z_states[i_z_pi, i_h_z, i_h_zpi, i_z].

All conditional chains share persistence, hence share one transition
matrix each (``z_pi_P``, ``z_P``); only the state ladders are scaled or
shifted.  The discretization is host float64; the factories cast to the
working dtype on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import transparent
from ..models.gcy import GCY
from ..ops.contract import lse_matmul, normalize_rows_log
from ..ops.tangent import linearizable, log1p_epilogue
from ..ops.rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
from ..ops.tauchen import tauchen, tauchen_P, tauchen_ladder
from ..utils.profiling import spanned

__all__ = ["GCYDiscretization", "discretize_gcy", "T_gcy_factory",
           "dense_H_gcy", "gcy_loglinear_parts"]


@dataclasses.dataclass(frozen=True)
class GCYDiscretization:
    """Discrete representation of the GCY state space (host float64)."""

    shapes: Tuple[int, int, int, int, int, int]   # (n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam)
    h_z_states: torch.Tensor
    h_z_Q: torch.Tensor
    h_c_states: torch.Tensor
    h_c_Q: torch.Tensor
    h_zpi_states: torch.Tensor
    h_zpi_Q: torch.Tensor
    h_lam_states: torch.Tensor
    h_lam_Q: torch.Tensor
    z_pi_states: torch.Tensor   # (n_h_zpi, n_z_pi)
    z_pi_P: torch.Tensor        # (n_z_pi, n_z_pi), shared over i_h_zpi
    z_states: torch.Tensor      # (n_z_pi, n_h_z, n_h_zpi, n_z)
    z_P: torch.Tensor           # (n_z, n_z), shared over conditioning states
    sigma_z_states: torch.Tensor
    sigma_c_states: torch.Tensor
    sigma_zpi_states: torch.Tensor

    @property
    def z_pi_Q(self) -> torch.Tensor:
        """(n_h_zpi, n_z_pi, n_z_pi) family (the reference's layout)."""
        return self.z_pi_P.expand((self.shapes[4],) + tuple(self.z_pi_P.shape))

    @property
    def z_Q(self) -> torch.Tensor:
        """(n_z_pi, n_h_z, n_h_zpi, n_z, n_z) family (the reference's
        layout)."""
        n_z, n_z_pi, n_h_z, _, n_h_zpi, _ = self.shapes
        return self.z_P.expand((n_z_pi, n_h_z, n_h_zpi)
                               + tuple(self.z_P.shape))


@spanned("sdfs.build.discretize")
def discretize_gcy(model: GCY, shapes: Tuple[int, ...],
                   dtype: torch.dtype = torch.float64,
                   method: str = "rouwenhorst") -> GCYDiscretization:
    """Discretization of the six GCY states, built in host float64 and
    cast to ``dtype`` (on the CPU).

    method="rouwenhorst" or "tauchen" (the same shared-matrix structure,
    Tauchen's construction)."""
    n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam = shapes
    m = model
    if method == "rouwenhorst":
        chain, chain_P, chain_ladder = rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
    elif method == "tauchen":
        chain, chain_P, chain_ladder = tauchen, tauchen_P, tauchen_ladder
    else:
        raise ValueError(f"unknown discretization method {method!r}")

    h_z_states, h_z_Q = chain(n_h_z, m.rho_z, m.s_z)
    h_c_states, h_c_Q = chain(n_h_c, m.rho_c, m.s_c)
    h_zpi_states, h_zpi_Q = chain(n_h_zpi, m.rho_zpi, m.s_zpi)
    h_lam_states, h_lam_Q = chain(n_h_lam, m.rho_lam, m.s_lam)

    sigma_z_states = m.phi_z * np.exp(h_z_states)
    sigma_c_states = m.phi_c * np.exp(h_c_states)
    sigma_zpi_states = m.phi_zpi * np.exp(h_zpi_states)

    # z_pi' = rho_pipi*z_pi + sigma_zpi*eta: ladder scaled per h_zpi state.
    zpi_ladder = chain_ladder(n_z_pi, m.rho_pipi)
    z_pi_states = sigma_zpi_states[:, None] * zpi_ladder[None, :]
    z_pi_P = chain_P(n_z_pi, m.rho_pipi)

    # z' = rho*z + rho_pi*z_pi + sigma_z*eta: ladder scaled by sigma_z[i_h_z]
    # and mean-shifted by rho_pi*z_pi/(1-rho) per (i_h_zpi, i_z_pi).
    z_ladder = chain_ladder(n_z, m.rho)
    centers = (m.rho_pi / (1.0 - m.rho)) * z_pi_states      # (n_h_zpi, n_z_pi)
    spread = sigma_z_states[:, None] * z_ladder[None, :]    # (n_h_z, n_z)
    # target layout: (i_z_pi, i_h_z, i_h_zpi, i_z)
    z_states = (centers.T[:, None, :, None] + spread[None, :, None, :])
    z_P = chain_P(n_z, m.rho)

    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
    return GCYDiscretization(
        shapes=tuple(shapes),
        h_z_states=cast(h_z_states), h_z_Q=cast(h_z_Q),
        h_c_states=cast(h_c_states), h_c_Q=cast(h_c_Q),
        h_zpi_states=cast(h_zpi_states), h_zpi_Q=cast(h_zpi_Q),
        h_lam_states=cast(h_lam_states), h_lam_Q=cast(h_lam_Q),
        z_pi_states=cast(z_pi_states), z_pi_P=cast(z_pi_P),
        z_states=cast(z_states), z_P=cast(z_P),
        sigma_z_states=cast(sigma_z_states),
        sigma_c_states=cast(sigma_c_states),
        sigma_zpi_states=cast(sigma_zpi_states),
    )


def _gcy_factors(model: GCY, disc: GCYDiscretization):
    """Per-axis factors of H (host float64): B_lam (the h_lam transition
    with the payoff folded), A2 over current h_c, A3 over current
    (z, z_pi, h_z, h_zpi)."""
    theta, gamma = model.theta, model.gamma
    # B_lam[i_h_lam, j_h_lam] = Q_lam * exp(theta * h_lam')
    B_lam = disc.h_lam_Q * torch.exp(theta * disc.h_lam_states)[None, :]
    A2 = torch.exp(0.5 * ((1 - gamma) * disc.sigma_c_states) ** 2)
    # z_states has layout (i_z_pi, i_h_z, i_h_zpi, i_z) -> i_z first.
    A3 = torch.exp((1 - gamma) * (model.mu_c
                                  + disc.z_states.permute(3, 0, 1, 2)))
    return B_lam, A2, A3


# Axis labels: a=z, b=z_pi, c=h_z, d=h_c, e=h_zpi, l=h_lam; capital =
# next-period index.  (subscripts, contracted axis of the field) in
# chain order.
_CHAIN = (("lL,ABCDEL->ABCDEl", 5), ("dD,ABCDEl->ABCdEl", 3),
          ("cC,ABCdEl->ABcdEl", 2), ("eE,ABcdEl->ABcdel", 4),
          ("bB,ABcdel->Abcdel", 1), ("aA,Abcdel->abcdel", 0))


def _hw_theta_factored_gcy(v, factors, A2, A3):
    """(H v) for v = w^theta: the six per-axis contractions of
    :data:`_CHAIN` (``factors`` in chain order, the h_lam one first),
    then the current-state tilt A2 (h_c) and A3 (z, z_pi, h_z, h_zpi)."""
    for M, (subs, _) in zip(factors, _CHAIN):
        v = torch.einsum(subs, M, v)
    return (A2[None, None, None, :, None, None]
            * A3[:, :, :, None, :, None] * v)


def T_gcy_factory(model: GCY,
                  disc: GCYDiscretization,
                  *,
                  space: str = "w",
                  baseline: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None,
                  device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Koopmans operator T for the discretized GCY model as a chain of six
    per-axis contractions.

    space="w":   T maps w -> T(w)                  (float64 parity path)
    space="log": T maps log w -> log T(w)          (float32-safe path)

    baseline="loglinear" (log space only): the baseline-normalized
    variant, see :func:`_T_gcy_normalized`.

    ``dtype=None`` keeps float64.  ``device`` is where the operator's
    arrays live and where its input must live.
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if baseline not in (None, "loglinear"):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline and space != "log":
        raise ValueError("baseline normalization requires space='log'")
    dev = resolve_device(device)
    if baseline:
        return _T_gcy_normalized(model, disc, dtype=dtype, device=dev)
    dtype = dtype or torch.float64
    beta, theta = model.beta, model.theta
    B_lam, A2, A3 = _gcy_factors(model, disc)
    cast = lambda a: a.to(device=dev, dtype=dtype)
    factors = tuple(map(cast, (B_lam, disc.h_c_Q, disc.h_z_Q, disc.h_zpi_Q,
                               disc.z_pi_P, disc.z_P)))
    A2, A3 = cast(A2), cast(A3)

    if space == "w":
        @transparent
        def T(w):
            hwt = _hw_theta_factored_gcy(w ** theta, factors, A2, A3)
            return 1.0 + beta * hwt ** (1.0 / theta)
        return T

    log_A2 = torch.log(A2)
    log_A3 = torch.log(A3)

    @linearizable
    def T(ell, tape=None):
        # Per-axis log-sum-exp contractions (float32-safe at any range).
        a = theta * ell
        if tape is not None:
            tape.scale(theta)
        for M, (subs, axis) in zip(factors, _CHAIN):
            a = lse_matmul(M, a, subs, axis, tape=tape)
        log_hwt = (a + log_A2[None, None, None, :, None, None]
                   + log_A3[:, :, :, None, :, None])
        return log1p_epilogue(log_hwt, theta, beta, tape)
    return T


def dense_H_gcy(model: GCY, disc: GCYDiscretization, *,
                device="cuda") -> torch.Tensor:
    """Dense (N, N) single-index H, float64, for tiny grids (cross-check
    path)."""
    dev = resolve_device(device)
    B_lam, A2, A3 = _gcy_factors(model, disc)
    H12 = torch.einsum("aA,bB,cC,dD,eE,lL,d,abce->abcdelABCDEL",
                       disc.z_P, disc.z_pi_P, disc.h_z_Q, disc.h_c_Q,
                       disc.h_zpi_Q, B_lam, A2, A3)
    n = int(np.prod(disc.shapes))
    return H12.reshape(n, n).to(dev)


def gcy_loglinear_parts(model: GCY, disc: GCYDiscretization) -> dict:
    """Separable components of the GCY log-linear closed form evaluated on
    the discretized grid (host float64 numpy); ``ell0`` is the full 6-D
    field, the standard warm start."""
    parts = _loglinear_terms(model, disc)
    parts["ell0"] = _ell0(parts, "cpu", torch.float64).numpy()
    return parts


def gcy_loglinear_start(model: GCY, disc: GCYDiscretization, *, device,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``gcy_loglinear_parts(model, disc)["ell0"]`` cast to ``dtype``,
    formed on ``device`` from the separable terms (the host forms no 6-D
    field)."""
    return _ell0(_loglinear_terms(model, disc), device, dtype)


def _ell0(parts: dict, device, dtype: torch.dtype) -> torch.Tensor:
    """ell0 on the (a, b, c, d, e, l) grid: the terms summed in float64
    on ``device``, then cast to ``dtype``."""
    lift = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.float64, device=device)
    psi_z, psi_pi = lift(parts["psi_z"]), lift(parts["psi_pi"])
    ell0 = (parts["co"]["A0"]
            + psi_z.permute(3, 0, 1, 2)[:, :, :, None, :, None]
            + psi_pi.T[None, :, None, None, :, None]
            + lift(parts["phi_c_"])[None, None, :, None, None, None]
            + lift(parts["phi_d"])[None, None, None, :, None, None]
            + lift(parts["phi_e"])[None, None, None, None, :, None]
            + lift(parts["phi_l"])[None, None, None, None, None, :])
    return ell0.to(dtype)


def gcy_loglinear_column_span(model: GCY, disc: GCYDiscretization) -> float:
    """The largest span of ``ell0`` within a column group of the tiled
    view (a (h_c, h_lam) row: the terms in h_c and h_lam are constant
    there), from the (z, z_pi, h_z, h_zpi) terms alone."""
    p = _loglinear_terms(model, disc)
    group = (p["psi_z"].transpose(3, 0, 1, 2)
             + p["psi_pi"].T[None, :, None, :]
             + p["phi_c_"][None, None, :, None]
             + p["phi_e"][None, None, None, :])
    return float(group.max() - group.min())


def _loglinear_terms(model: GCY, disc: GCYDiscretization) -> dict:
    """:func:`gcy_loglinear_parts` without ``ell0``."""
    from ..models.gcy import gcy_loglinear_factory

    m = model
    co = gcy_loglinear_factory(model).coefficients
    h_lam = disc.h_lam_states.numpy()
    h_c = disc.h_c_states.numpy()
    h_z = disc.h_z_states.numpy()
    h_zpi = disc.h_zpi_states.numpy()
    zpi = disc.z_pi_states.numpy()                      # (e, b)
    # z_states layout (b, c, e, a) = (i_z_pi, i_h_z, i_h_zpi, i_z)
    zst = disc.z_states.numpy()

    phi_l = co["A_hlam"] * h_lam
    phi_d = co["A_hc"] * (h_c * 2 * m.phi_c**2 + m.phi_c**2)
    phi_c_ = co["A_hz"] * (h_z * 2 * m.phi_z**2 + m.phi_z**2)
    phi_e = co["A_hzpi"] * (h_zpi * 2 * m.phi_zpi**2 + m.phi_zpi**2)
    psi_pi = co["A_zpi"] * zpi                          # (e, b)
    psi_z = co["A_z"] * zst                             # (b, c, e, a)
    return dict(co=co, h_lam=h_lam, h_c=h_c, h_z=h_z, h_zpi=h_zpi,
                phi_l=phi_l, phi_d=phi_d, phi_c_=phi_c_, phi_e=phi_e,
                psi_pi=psi_pi, psi_z=psi_z)


# Per-axis chain of the normalized GCY operator (labels as in _CHAIN; the
# coupled baseline terms ride the z_pi and z contractions as conditioning
# batch axes).
_NORMALIZED_GCY_CHAIN = (
    ("lL,ABCDEL->ABCDEl", 5), ("dD,ABCDEl->ABCdEl", 3),
    ("ABEcC,ABCdEl->ABcdEl", 2), ("ABceE,ABcdEl->ABcdel", 4),
    ("AcebB,ABcdel->Abcdel", 1), ("bceaA,Abcdel->abcdel", 0))


def _T_gcy_normalized(model: GCY, disc: GCYDiscretization, *, dtype=None,
                      device):
    """Log-space GCY operator with the log-linear baseline folded in.

    The six-state analogue of ``discrete_ssy._T_ssy_normalized``: the
    separable log-linear approximation ell0 distributes into the
    per-axis factors with exact telescoping across the coupled terms
    (z_pi couples (h_zpi, z_pi); z couples (z_pi, h_z, h_zpi, z)).  The
    factors are assembled in log space in host float64 and row-normalized
    before the only exp; float32 runs the deep windows (W = 80, three
    passes).
    """
    dtype = dtype or torch.float64
    deep = 80.0 if dtype == torch.float32 else 0.0
    theta, beta, gamma = model.theta, model.beta, model.gamma
    t = theta
    parts = gcy_loglinear_parts(model, disc)
    h_lam = parts["h_lam"]
    phi_l, phi_d, phi_c_, phi_e = (parts["phi_l"], parts["phi_d"],
                                   parts["phi_c_"], parts["phi_e"])
    psi_pi, psi_z = parts["psi_pi"], parts["psi_z"]
    zst = disc.z_states.numpy()                         # (b, c, e, a)

    with np.errstate(divide="ignore"):
        lQlam, lQc, lQhz, lQhzpi, lzpiP, lzP = (
            np.log(P.numpy()) for P in (disc.h_lam_Q, disc.h_c_Q,
                                        disc.h_z_Q, disc.h_zpi_Q,
                                        disc.z_pi_P, disc.z_P))

    logM1 = lQlam + t * (h_lam + phi_l)[None, :] - t * phi_l[:, None]
    logM2 = lQc + t * (phi_d[None, :] - phi_d[:, None])
    # M3[A,B,E,c,C]: contract next-h_z at fixed (A,B,E); psi_z's
    # C-dependence folds here, rescaled by the current-c slice.
    psz_ABEC = psi_z.transpose(3, 0, 2, 1)              # (A, B, E, C)
    logM3 = (lQhz[None, None, None, :, :]
             + t * (phi_c_[None, None, None, None, :]
                    - phi_c_[None, None, None, :, None]
                    + psz_ABEC[:, :, :, None, :]
                    - psz_ABEC[:, :, :, :, None]))
    # M4[A,B,c,e,E]: contract next-h_zpi; folds phi_e and the
    # E-dependence of psi_pi and psi_z.
    psz_ABCE = psi_z.transpose(3, 0, 1, 2)              # (A, B, C, E)
    psipi_BE = psi_pi.T                                  # (B, E)
    logM4 = (lQhzpi[None, None, None, :, :]
             + t * (phi_e[None, None, None, None, :]
                    - phi_e[None, None, None, :, None]
                    + psipi_BE[None, :, None, None, :]
                    - psipi_BE[None, :, None, :, None]
                    + psz_ABCE[:, :, :, None, :]
                    - psz_ABCE[:, :, :, :, None]))
    # M5[A,c,e,b,B]: contract next-z_pi; folds the B-dependence of psi_pi
    # and psi_z.
    psz_ACEB = psi_z.transpose(3, 1, 2, 0)              # (A, C, E, B)
    logM5 = (lzpiP[None, None, None, :, :]
             + t * (psipi_BE.T[None, None, :, None, :]
                    - psipi_BE.T[None, None, :, :, None]
                    + psz_ACEB[:, :, :, None, :]
                    - psz_ACEB[:, :, :, :, None]))
    # M6[b,c,e,a,A]: contract next-z; folds psi_z's A-dependence.
    logM6 = (lzP[None, None, None, :, :]
             + t * (psi_z[:, :, :, None, :] - psi_z[:, :, :, :, None]))

    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)
    steps = []
    for logM, (subs, ax) in zip((logM1, logM2, logM3, logM4, logM5, logM6),
                                _NORMALIZED_GCY_CHAIN):
        Mn, ls = normalize_rows_log(logM, subs, ax)
        steps.append((cast(Mn), cast(ls), subs, ax))
    A2 = np.exp(0.5 * ((1 - gamma) * disc.sigma_c_states.numpy()) ** 2)
    log_A2 = cast(np.log(A2))[None, None, None, :, None, None]
    log_A3 = cast((1 - gamma) * (model.mu_c + zst.transpose(3, 0, 1, 2))
                  )[:, :, :, None, :, None]              # (a, b, c, e)
    ell0_t = cast(parts["ell0"])
    t_c = torch.tensor(theta, dtype=dtype, device=device)

    def primal(ell, tape=None):
        a = t_c * (ell - ell0_t)
        if tape is not None:
            tape.scale(t_c)
        for M, ls, subs, ax in steps:
            a = lse_matmul(M, a, subs, ax, deep_window=deep,
                           deep_passes=3, tape=tape) + ls
        log_hwt = t_c * ell0_t + a + log_A2 + log_A3
        return log1p_epilogue(log_hwt, t_c, beta, tape)

    T = linearizable(primal)
    T.baseline_log_w = ell0_t
    return T
