"""Discrete (tensor-grid Markov chain) Koopmans operator for the SSY model.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/discrete_ssy.py``.
``H w^theta`` is a chain of per-axis contractions (skinny matmuls):
O(N * sum(n_axis)) FLOPs and O(N) memory instead of the O(N^2) broadcast
product tensor.

Two operator spaces:

* ``space="w"``: iterate on w directly (needs float64: w^theta ~ 1e-47
  underflows float32 at theta ~ -16).
* ``space="log"``: iterate on l = log(w) through per-axis log-sum-exp
  contractions (:func:`..ops.contract.lse_matmul`); ``baseline=
  "loglinear"`` folds the log-linear solution into the factors
  (:func:`_T_ssy_normalized`).

The discretization is host float64; the factories cast to the working
dtype on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import transparent
from ..models.ssy import SSY
from ..ops.contract import lse_matmul, normalize_rows_log
from ..ops.tangent import linearizable, log1p_epilogue
from ..ops.rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
from ..ops.tauchen import tauchen, tauchen_P, tauchen_ladder
from ..utils.profiling import spanned

__all__ = ["SSYDiscretization", "discretize_ssy", "T_ssy_factory",
           "dense_H_ssy"]


@dataclasses.dataclass(frozen=True)
class SSYDiscretization:
    """Discrete representation of the SSY state space (host float64).

    Index convention: h_lam[l], h_c[k], h_z[i], and z[i, j] — the z grid
    depends on the current h_z index i through sigma_z = phi_z *
    exp(h_z[i]).  The z transition matrix depends only on the persistence,
    so ``z_P`` stores the one matrix every volatility state shares.
    """

    shapes: Tuple[int, int, int, int]
    h_lam_states: torch.Tensor
    h_lam_Q: torch.Tensor
    h_c_states: torch.Tensor
    h_c_Q: torch.Tensor
    h_z_states: torch.Tensor
    h_z_Q: torch.Tensor
    z_states: torch.Tensor      # (n_h_z, n_z)
    z_P: torch.Tensor           # (n_z, n_z) shared across volatility states
    sigma_c_states: torch.Tensor
    sigma_z_states: torch.Tensor

    @property
    def z_Q(self) -> torch.Tensor:
        """Full (n_h_z, n_z, n_z) family (the reference's return layout)."""
        return self.z_P.expand((self.shapes[2],) + tuple(self.z_P.shape))


@spanned("sdfs.build.discretize")
def discretize_ssy(model: SSY, shapes: Tuple[int, int, int, int],
                   dtype: torch.dtype = torch.float64,
                   method: str = "rouwenhorst") -> SSYDiscretization:
    """Discretization of the four SSY states, built in host float64 and
    cast to ``dtype`` (on the CPU; the factories move what they use).

    method="rouwenhorst": one chain per h process; for z, a
    volatility-dependent family z_states[i, :] = sigma_z[i] * ladder(rho)
    sharing one transition matrix.  method="tauchen" swaps in the Tauchen
    (1986) construction with the same shared-matrix structure.
    """
    n_h_lam, n_h_c, n_h_z, n_z = shapes
    m = model
    if method == "rouwenhorst":
        chain, chain_P, chain_ladder = rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
    elif method == "tauchen":
        chain, chain_P, chain_ladder = tauchen, tauchen_P, tauchen_ladder
    else:
        raise ValueError(f"unknown discretization method {method!r}")

    h_lam_states, h_lam_Q = chain(n_h_lam, m.rho_lam, m.s_lam)
    h_c_states, h_c_Q = chain(n_h_c, m.rho_c, m.s_c)
    h_z_states, h_z_Q = chain(n_h_z, m.rho_z, m.s_z)

    sigma_z_states = m.phi_z * np.exp(h_z_states)
    sigma_c_states = m.phi_c * np.exp(h_c_states)

    z_ladder = chain_ladder(n_z, m.rho)
    z_states = sigma_z_states[:, None] * z_ladder[None, :]
    z_P = chain_P(n_z, m.rho)

    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
    return SSYDiscretization(
        shapes=tuple(shapes),
        h_lam_states=cast(h_lam_states), h_lam_Q=cast(h_lam_Q),
        h_c_states=cast(h_c_states), h_c_Q=cast(h_c_Q),
        h_z_states=cast(h_z_states), h_z_Q=cast(h_z_Q),
        z_states=cast(z_states), z_P=cast(z_P),
        sigma_c_states=cast(sigma_c_states),
        sigma_z_states=cast(sigma_z_states),
    )


def _ssy_factors(model: SSY, disc: SSYDiscretization):
    """Per-axis factors of H (host float64).  A1 folds into the h_lam
    transition matrix."""
    theta = model.theta
    gamma = model.gamma
    # B_lam[l, lp] = Q_lam[l, lp] * exp(theta * h_lam[lp])
    B_lam = disc.h_lam_Q * torch.exp(theta * disc.h_lam_states)[None, :]
    A2 = torch.exp(0.5 * ((1 - gamma) * disc.sigma_c_states) ** 2)     # (k,)
    A3 = torch.exp((1 - gamma) * (model.mu_c + disc.z_states))         # (i, j)
    return B_lam, A2, A3


def _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3):
    """Chain of per-axis contractions: (H v)[l,k,i,j] for v = w^theta."""
    u = torch.einsum("lm,mkij->lkij", B_lam, v)     # contract next-h_lam
    u = torch.einsum("km,lmij->lkij", Qc, u)        # contract next-h_c
    u = torch.einsum("im,lkmj->lkij", Qhz, u)       # contract next-h_z
    u = torch.einsum("jm,lkim->lkij", zP, u)        # contract next-z
    return A2[None, :, None, None] * A3[None, None, :, :] * u


def T_ssy_factory(model: SSY,
                  disc: SSYDiscretization,
                  *,
                  space: str = "w",
                  baseline: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None,
                  device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the Koopmans operator T for the discretized SSY model.

    T(w) = 1 + beta * (H w^theta)^(1/theta) on the (l, k, i, j) tensor
    grid, computed by factored per-axis contractions.

    space="w":   T maps w -> T(w)                  (float64 parity path)
    space="log": T maps log w -> log T(w)          (float32-safe path)

    baseline="loglinear" (log space only) folds the separable log-linear
    approximation ell0 into the transition factors so the contraction
    runs on the residual theta*(ell - ell0) (:func:`_T_ssy_normalized`);
    the returned T exposes ``T.baseline_log_w``.

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
        return _T_ssy_normalized(model, disc, dtype=dtype, device=dev)
    dtype = dtype or torch.float64
    beta, theta = model.beta, model.theta
    B_lam, A2, A3 = _ssy_factors(model, disc)
    cast = lambda a: a.to(device=dev, dtype=dtype)
    B_lam, A2, A3, Qc, Qhz, zP = map(cast, (B_lam, A2, A3, disc.h_c_Q,
                                            disc.h_z_Q, disc.z_P))

    if space == "w":
        @transparent
        def T(w):
            v = w ** theta
            hwt = _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3)
            return 1.0 + beta * hwt ** (1.0 / theta)
        return T

    log_A2 = torch.log(A2)
    log_A3 = torch.log(A3)

    @linearizable
    def T(ell, tape=None):
        # Per-axis log-sum-exp contractions: exact for any dynamic range
        # of theta*ell (see ops/contract.py).
        a = theta * ell
        if tape is not None:
            tape.scale(theta)
        a = lse_matmul(B_lam, a, "lm,mkij->lkij", 0, tape=tape)
        a = lse_matmul(Qc, a, "km,lmij->lkij", 1, tape=tape)
        a = lse_matmul(Qhz, a, "im,lkmj->lkij", 2, tape=tape)
        a = lse_matmul(zP, a, "jm,lkim->lkij", 3, tape=tape)
        log_hwt = (a + log_A2[None, :, None, None]
                   + log_A3[None, None, :, :])
        return log1p_epilogue(log_hwt, theta, beta, tape)
    return T


def dense_H_ssy(model: SSY, disc: SSYDiscretization, *,
                device="cuda") -> torch.Tensor:
    """Materialize H as a dense (N, N) float64 matrix.

    Only for small grids: validates the factored contraction against a
    plain matmul ``1 + beta*(H @ w^theta)^(1/theta)``.
    """
    dev = resolve_device(device)
    B_lam, A2, A3 = _ssy_factors(model, disc)
    H8 = torch.einsum("lL,kK,iI,jJ,k,ij->lkijLKIJ",
                      B_lam, disc.h_c_Q, disc.h_z_Q, disc.z_P, A2, A3)
    n = int(np.prod(disc.shapes))
    return H8.reshape(n, n).to(dev)


def _log_probs(P) -> np.ndarray:
    """log of a transition matrix in host float64; corner probabilities
    that underflowed are -inf (exp restores an exact 0)."""
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(P, np.float64))


def _ssy_normalized_arrays(model: SSY, disc: SSYDiscretization) -> dict:
    """Host-float64 assembly of the baseline-normalized operator factors.

    Shared by the normalized operator (:func:`_T_ssy_normalized`) and the
    two-phase operand set (``operators/two_phase.py``).  Returns numpy
    arrays: folded transition factors M1 (l), M2 (k), M3 (j', i, i'),
    M4 (i, j, j') and their logs, the kappa terms log_A2 (k) and
    log_A3 (i, j), and the separable baseline components
    (A0, phi_l, phi_k, phi_i, psi_ij, A_z) with
    ell0 = A0 + phi_l + phi_k + (phi_i + psi_ij).
    """
    from ..models.ssy import ssy_loglinear_factory

    theta, gamma = model.theta, model.gamma
    co = ssy_loglinear_factory(model).coefficients
    h_lam, h_c, h_z, z_states = (np.asarray(a, np.float64) for a in (
        disc.h_lam_states, disc.h_c_states, disc.h_z_states,
        disc.z_states))

    phi_l = co["A_hlam"] * h_lam
    phi_k = co["A_hc"] * (h_c * 2 * model.phi_c**2 + model.phi_c**2)
    phi_i = co["A_hz"] * (h_z * 2 * model.phi_z**2 + model.phi_z**2)
    psi_ij = co["A_z"] * z_states                       # (i, j)

    B_log = _log_probs(disc.h_lam_Q) + theta * h_lam[None, :]   # A1 folded
    logM1 = B_log + theta * (phi_l[None, :] - phi_l[:, None])
    logM2 = (_log_probs(disc.h_c_Q)
             + theta * (phi_k[None, :] - phi_k[:, None]))
    # M3[j, i, ip] = Qhz[i, ip] * exp(theta*(phi_i[ip] - phi_i[i]
    #                                + psi[ip, j] - psi[i, j]))
    logM3 = (_log_probs(disc.h_z_Q)[None, :, :]
             + theta * (phi_i[None, None, :] - phi_i[None, :, None]
                        + psi_ij.T[:, None, :] - psi_ij.T[:, :, None]))
    # M4[i, j, jp] = zP[j, jp] * exp(theta*(psi[i, jp] - psi[i, j]))
    logM4 = (_log_probs(disc.z_P)[None, :, :]
             + theta * (psi_ij[:, None, :] - psi_ij[:, :, None]))

    A2 = np.exp(0.5 * ((1 - gamma)
                       * np.asarray(disc.sigma_c_states, np.float64)) ** 2)
    return dict(M1=np.exp(logM1), M2=np.exp(logM2), M3=np.exp(logM3),
                M4=np.exp(logM4), log_A2=np.log(A2),
                log_A3=(1 - gamma) * (model.mu_c + z_states),
                logM1=logM1, logM2=logM2, logM3=logM3, logM4=logM4,
                A0=float(co["A0"]), phi_l=phi_l, phi_k=phi_k, phi_i=phi_i,
                psi_ij=psi_ij, A_z=float(co["A_z"]))


# Per-axis chain of the normalized SSY operator: subscripts and the
# contracted axis of the field.
_NORMALIZED_SSY_CHAIN = (("lm,mkij->lkij", 0), ("km,lmij->lkij", 1),
                         ("jim,lkmj->lkij", 2), ("ijm,lkim->lkij", 3))


def _T_ssy_normalized(model: SSY, disc: SSYDiscretization, *, dtype=None,
                      device):
    """Log-space operator with the log-linear baseline folded in.

    With ell0 the separable log-linear approximation of log w*, the
    folded kernel H~(x, x') = H(x, x') exp(theta (ell0(x') - ell0(x)))
    satisfies sum_x' H~(x, x') e^{theta delta(x')} = e^{-theta ell0(x)}
    (H w^theta)(x) for delta = ell - ell0: exact, only reconditioned, so
    every intermediate is O(e^{theta delta}).  The factors are assembled
    in log space in host float64 and row-normalized before the only exp
    (:func:`..ops.contract.normalize_rows_log`); float32 runs the deep
    windows (W = 80, three passes) for ladder-corner rows whose whole
    mass sits below the single window.
    """
    dtype = dtype or torch.float64
    deep = 80.0 if dtype == torch.float32 else 0.0
    theta, beta = model.theta, model.beta
    arrs = _ssy_normalized_arrays(model, disc)
    ell0 = (arrs["A0"] + arrs["phi_l"][:, None, None, None]
            + arrs["phi_k"][None, :, None, None]
            + arrs["phi_i"][None, None, :, None]
            + arrs["psi_ij"][None, None, :, :])
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)
    steps = []
    for key, (subs, ax) in zip(("logM1", "logM2", "logM3", "logM4"),
                               _NORMALIZED_SSY_CHAIN):
        Mn, ls = normalize_rows_log(arrs[key], subs, ax)
        steps.append((cast(Mn), cast(ls), subs, ax))
    ell0_t = cast(ell0)
    log_A2 = cast(arrs["log_A2"])[None, :, None, None]
    log_A3 = cast(arrs["log_A3"])[None, None, :, :]
    theta_c = torch.tensor(theta, dtype=dtype, device=device)

    def primal(ell, tape=None):
        a = theta_c * (ell - ell0_t)
        if tape is not None:
            tape.scale(theta_c)
        for M, ls, subs, ax in steps:
            a = lse_matmul(M, a, subs, ax, deep_window=deep,
                           deep_passes=3, tape=tape) + ls
        log_hwt = theta_c * ell0_t + a + log_A2 + log_A3
        return log1p_epilogue(log_hwt, theta_c, beta, tape)

    T = linearizable(primal)
    T.baseline_log_w = ell0_t
    return T
