"""Continuous-state Koopmans operator for the SSY model.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/continuous_ssy.py``
for its factored path: quadrature + ``interp="pre"`` (interpolate
g = w^theta), where the tensor-product Gauss-Hermite expectation
factorizes into per-axis contraction matrices (see
:mod:`.continuous_common`).  State grids (h_lam, h_c, h_z, z).

``space="w"`` iterates on w (float64 parity path); ``space="log"`` on
log w through per-axis log-sum-exp contractions, optionally with a
separable baseline folded into the matrices.

Interpolation spaces (``interp``): "pre" interpolates g = w^theta (the
factored path above); "post" interpolates w, then raises it to theta (the
reference's semantics); "loglin" interpolates log w.  "post" and
"loglin" in log space run the node chain (:mod:`.post_interp`); the
pointwise corner gather (``engine="gather"``,
:func:`.continuous_common.make_gather_T`) serves every combination.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import transparent
from ..models.ssy import SSY, ssy_loglinear_factory
from ..ops.contract import lse_matmul
from ..ops.tangent import linearizable, log1p_epilogue
from ..ops.grids import build_grid_ssy
from ..ops.quadrature import gauss_hermite_normal, tensor_quadrature_normal
from .continuous_common import (expectation_matrix, make_gather_T, mc_draws,
                                normalize_expectation_matrix,
                                warn_if_f32_range_unsafe)

__all__ = ["next_state_ssy", "T_ssy_continuous_factory", "build_grid_ssy"]

_F64 = torch.float64


def next_state_ssy(model: SSY, x: torch.Tensor,
                   shocks: torch.Tensor) -> torch.Tensor:
    """One step of the four SSY state processes.

    ``x`` has leading axis (h_lam, h_c, h_z, z); ``shocks`` is (4, N) (or
    broadcastable).
    """
    m = model
    h_lam, h_c, h_z, z = x[0], x[1], x[2], x[3]
    sigma_z = m.phi_z * torch.exp(h_z)
    return torch.stack([
        m.rho_lam * h_lam + m.s_lam * shocks[0],
        m.rho_c * h_c + m.s_c * shocks[1],
        m.rho_z * h_z + m.s_z * shocks[2],
        m.rho * z + sigma_z * shocks[3],
    ])


def _log_kappa_ssy(model: SSY, h_c, z):
    """log kappa(h_c, z) = (1-gamma)(mu_c+z) + (1/2)(1-gamma)^2 sigma_c^2,
    sigma_c = phi_c*exp(h_c)."""
    sigma_c = model.phi_c * torch.exp(h_c)
    return ((1 - model.gamma) * (model.mu_c + z)
            + 0.5 * (1 - model.gamma) ** 2 * sigma_c ** 2)


def _host_grids(grids) -> tuple:
    """The grids as float64 CPU tensors (host algebra runs there)."""
    return tuple(torch.as_tensor(g).detach().to(device="cpu", dtype=_F64)
                 for g in grids)


def _gauss_hermite(degree: int):
    eta, omega = gauss_hermite_normal(degree)
    return torch.as_tensor(eta, dtype=_F64), torch.as_tensor(omega,
                                                             dtype=_F64)


def _factored_arrays_ssy(model, grids, degree, baseline=None,
                         tilt_lambda=True) -> dict:
    """Expectation matrices + baseline components of the factored
    operator, host float64.

    Returns P_lam (l), P_c (k), P_hz (i), P_z (i, j, j'), the split kappa
    terms log_A2 (k) / log_A3 (j) with log kappa(h_c, z) = log_A2[k] +
    log_A3[j], and — when a baseline is folded — the separable components
    (A0, phi_l, phi_k, phi_i, phi_j).
    """
    theta = model.theta
    m = model
    h_lam_grid, h_c_grid, h_z_grid, z_grid = _host_grids(grids)
    eta, omega = _gauss_hermite(degree)

    P_lam = expectation_matrix(h_lam_grid, m.rho_lam * h_lam_grid, m.s_lam,
                               eta, omega,
                               payoff=(lambda xn: torch.exp(theta * xn))
                               if tilt_lambda else None)
    P_c = expectation_matrix(h_c_grid, m.rho_c * h_c_grid, m.s_c, eta, omega)
    P_hz = expectation_matrix(h_z_grid, m.rho_z * h_z_grid, m.s_z, eta, omega)
    sigma_z = m.phi_z * torch.exp(h_z_grid)
    # z' = rho*z + sigma_z(h_z)*eta depends on (h_z, z): P_z[i, j, j'].
    P_z = expectation_matrix(z_grid,
                             (m.rho * z_grid).expand(len(h_z_grid),
                                                     len(z_grid)),
                             sigma_z[:, None], eta, omega)
    # log kappa(h_c, z) splits into a row (h_c) and a column (z) part.
    sigma_c = m.phi_c * torch.exp(h_c_grid)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2               # (k,)
    log_A3 = (1 - m.gamma) * (m.mu_c + z_grid)                     # (j,)

    ell0_parts = None
    if baseline is not None:
        # Fold a separable baseline into the expectation matrices: the
        # chain then works on theta*(ell - ell0), keeping wide-range grids
        # inside f32.  baseline is "loglinear" (closed form) or
        # (const, [per-axis profiles]).  Exact telescoping.
        if isinstance(baseline, str) and baseline == "loglinear":
            co = ssy_loglinear_factory(m).coefficients
            hl, hc, hz, zg = (g.numpy() for g in (h_lam_grid, h_c_grid,
                                                  h_z_grid, z_grid))
            const0 = co["A0"]
            phi_l = co["A_hlam"] * hl
            phi_k = co["A_hc"] * (hc * 2 * m.phi_c**2 + m.phi_c**2)
            phi_i = co["A_hz"] * (hz * 2 * m.phi_z**2 + m.phi_z**2)
            phi_j = co["A_z"] * zg
        else:
            const0, (phi_l, phi_k, phi_i, phi_j) = baseline
            phi_l, phi_k, phi_i, phi_j = (np.asarray(p_, np.float64)
                                          for p_ in (phi_l, phi_k, phi_i,
                                                     phi_j))
        P_lam = torch.as_tensor(normalize_expectation_matrix(
            P_lam, phi_l, phi_l, theta))
        P_c = torch.as_tensor(normalize_expectation_matrix(
            P_c, phi_k, phi_k, theta))
        P_hz = torch.as_tensor(normalize_expectation_matrix(
            P_hz, phi_i, phi_i, theta))
        P_z = torch.as_tensor(normalize_expectation_matrix(
            P_z, phi_j, np.broadcast_to(phi_j, P_z.shape[:-1]), theta))
        ell0_parts = (const0, phi_l, phi_k, phi_i, phi_j)

    return dict(P_lam=P_lam, P_c=P_c, P_hz=P_hz, P_z=P_z,
                log_A2=log_A2, log_A3=log_A3, ell0_parts=ell0_parts)


def _factored_T(model, grids, degree, space, dtype, baseline=None, *,
                device="cuda"):
    """Factored per-axis contraction operator (quadrature + interp="pre").

    Per-dimension expectation matrices from 1-D Gauss-Hermite rules —
    exactly equivalent to the tensor-product rule by separability of the
    multilinear basis.  Axis labels: l=h_lam, k=h_c, i=h_z, j=z.
    """
    dev = resolve_device(device)
    dtype = dtype or _F64
    beta, theta = model.beta, model.theta
    arrs = _factored_arrays_ssy(model, grids, degree, baseline)
    log_kappa = arrs["log_A2"][:, None] + arrs["log_A3"][None, :]  # (k, j)
    ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_j = arrs["ell0_parts"]
        ell0 = torch.as_tensor(
            const0 + phi_l[:, None, None, None] + phi_k[None, :, None, None]
            + phi_i[None, None, :, None] + phi_j[None, None, None, :])
    cast = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype)
    P_lam, P_c, P_hz, P_z, log_kappa = map(
        cast, (arrs["P_lam"], arrs["P_c"], arrs["P_hz"], arrs["P_z"],
               log_kappa))
    if ell0 is not None:
        ell0 = cast(ell0)

    def apply_K(g):
        u = torch.einsum("lL,LKIJ->lKIJ", P_lam, g)
        u = torch.einsum("kK,lKIJ->lkIJ", P_c, u)
        u = torch.einsum("iI,lkIJ->lkiJ", P_hz, u)
        u = torch.einsum("ijJ,lkiJ->lkij", P_z, u)
        return u

    if space == "w":
        kappa = torch.exp(log_kappa)

        @transparent
        def T(w):
            kg = kappa[None, :, None, :] * apply_K(w ** theta)
            return 1.0 + beta * kg ** (1.0 / theta)
        return T

    @linearizable
    def T(ell, tape=None):
        a = theta * (ell if ell0 is None else ell - ell0)
        if tape is not None:
            tape.scale(theta)
        a = lse_matmul(P_lam, a, "lL,LKIJ->lKIJ", 0, tape=tape)
        a = lse_matmul(P_c, a, "kK,lKIJ->lkIJ", 1, tape=tape)
        a = lse_matmul(P_hz, a, "iI,lkIJ->lkiJ", 2, tape=tape)
        a = lse_matmul(P_z, a, "ijJ,lkiJ->lkij", 3, tape=tape)
        if ell0 is not None:
            a = a + theta * ell0
        log_kg = a + log_kappa[None, :, None, :]
        return log1p_epilogue(log_kg, theta, beta, tape)

    if ell0 is not None:
        T.baseline_log_w = ell0
    return T


def T_ssy_continuous_factory(model: SSY,
                             grids: Sequence[torch.Tensor],
                             *,
                             method: str = "quadrature",
                             interp: str = "pre",
                             space: str = "w",
                             quad_degree: int = 5,
                             mc_draw_size: int = 2000,
                             seed: int = 1234,
                             batch_size: Optional[int] = None,
                             baseline=None,
                             dtype: Optional[torch.dtype] = None,
                             engine: str = "auto",
                             device="cuda") -> Callable:
    """Build the continuous-state SSY operator T on ``device``.

    method="quadrature" uses degree-``quad_degree`` Gauss-Hermite per
    dimension; "monte_carlo" uses ``mc_draw_size`` joint draws of a
    ``torch.Generator`` seeded with ``seed`` (:func:`.continuous_common.
    mc_draws`).  quadrature + interp="pre" dispatches to the factored
    contraction path, in ``dtype`` (float64 when None); post/loglin in
    log space dispatch to the node chain (per-node basis matmuls and a
    streaming log-sum-exp, :func:`.post_interp.make_node_chain_T_ssy`)
    unless ``engine="gather"`` forces the pointwise corner gather, which
    also serves the remaining combinations, over batches of
    ``batch_size`` states, in the grids' dtype.  ``baseline``
    ("loglinear" or ``(const, profiles)``) folds a separable baseline
    into the factored log-space operator, which then carries
    ``T.baseline_log_w``.
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if space == "log" and baseline is None:
        warn_if_f32_range_unsafe(model, grids, ssy_loglinear_factory,
                                 dtype or _F64)
    if baseline is not None and not (
            (isinstance(baseline, str) and baseline == "loglinear")
            or (isinstance(baseline, tuple) and len(baseline) == 2)):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline is not None and not (method == "quadrature"
                                     and interp == "pre" and space == "log"):
        raise ValueError("baseline normalization requires quadrature + "
                         "interp='pre' + space='log'")
    if engine not in ("auto", "node_chain", "gather"):
        raise ValueError(f"unknown engine {engine!r}")
    if interp not in ("post", "pre", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    if method not in ("quadrature", "monte_carlo"):
        raise ValueError(f"unknown method {method!r}")
    if method == "quadrature" and interp == "pre" and engine == "auto":
        return _factored_T(model, grids, quad_degree, space, dtype, baseline,
                           device=device)
    if interp in ("post", "loglin") and space == "log" and engine != "gather":
        from .post_interp import make_node_chain_T_ssy, ssy_quadrature_nodes
        if method == "quadrature":
            nodes, logw = ssy_quadrature_nodes(quad_degree)
        else:
            nodes = mc_draws(4, mc_draw_size, seed).numpy()
            logw = np.full(mc_draw_size, -np.log(float(mc_draw_size)))
        return make_node_chain_T_ssy(model, grids, nodes, logw,
                                     interp=interp, dtype=dtype,
                                     device=device)
    if engine == "node_chain":
        raise ValueError("engine='node_chain' requires interp='post' or "
                         "'loglin' with space='log'")
    if method == "quadrature":
        nodes, weights = tensor_quadrature_normal([quad_degree] * 4)
        shocks, weights = torch.as_tensor(nodes), torch.as_tensor(weights)
    else:
        shocks, weights = mc_draws(4, mc_draw_size, seed), None
    return make_gather_T(
        lambda x, s: next_state_ssy(model, x, s),
        lambda x: _log_kappa_ssy(model, x[1], x[3]),
        grids, shocks, weights, interp, space, batch_size, model.beta,
        model.theta, device=device)
