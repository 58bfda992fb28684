"""Discrete (tensor-grid Markov chain) Koopmans operator for the SSY model.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/discrete_ssy.py``.
``H w^theta`` is a chain of per-axis contractions (skinny matmuls):
O(N * sum(n_axis)) FLOPs and O(N) memory instead of the O(N^2) broadcast
product tensor.

Two operator spaces:

* ``space="w"``: iterate on w directly (needs float64: w^theta ~ 1e-47
  underflows float32 at theta ~ -16).
* ``space="log"``: iterate on l = log(w) through per-axis log-sum-exp
  contractions (:func:`..ops.contract.lse_matmul`).

The discretization is host float64; the factories cast to the working
dtype on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.ssy import SSY
from ..ops.contract import lse_matmul
from ..ops.rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
from ..ops.tauchen import tauchen, tauchen_P, tauchen_ladder

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


def discretize_ssy(model: SSY, shapes: Tuple[int, int, int, int],
                   method: str = "rouwenhorst") -> SSYDiscretization:
    """Discretization of the four SSY states, host float64.

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

    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64))
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

    ``dtype=None`` keeps float64.  ``device`` is where the operator's
    arrays live and where its input must live.
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if baseline not in (None, "loglinear"):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline:
        raise NotImplementedError(
            "baseline='loglinear' (the normalized tier) is not ported yet; "
            "it lands with ROADMAP queue A item 2")
    dev = resolve_device(device)
    dtype = dtype or torch.float64
    beta, theta = model.beta, model.theta
    B_lam, A2, A3 = _ssy_factors(model, disc)
    cast = lambda a: a.to(device=dev, dtype=dtype)
    B_lam, A2, A3, Qc, Qhz, zP = map(cast, (B_lam, A2, A3, disc.h_c_Q,
                                            disc.h_z_Q, disc.z_P))

    if space == "w":
        def T(w):
            v = w ** theta
            hwt = _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3)
            return 1.0 + beta * hwt ** (1.0 / theta)
        return T

    log_A2 = torch.log(A2)
    log_A3 = torch.log(A3)

    def T(ell):
        # Per-axis log-sum-exp contractions: exact for any dynamic range
        # of theta*ell (see ops/contract.py).
        a = theta * ell
        a = lse_matmul(B_lam, a, "lm,mkij->lkij", 0)
        a = lse_matmul(Qc, a, "km,lmij->lkij", 1)
        a = lse_matmul(Qhz, a, "im,lkmj->lkij", 2)
        a = lse_matmul(zP, a, "jm,lkim->lkij", 3)
        log_hwt = (a + log_A2[None, :, None, None]
                   + log_A3[None, None, :, :])
        return torch.log1p(beta * torch.exp(log_hwt / theta))
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
