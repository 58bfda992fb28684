"""Continuous-state Koopmans operator for the GCY model.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/continuous_gcy.py``
for its factored path: quadrature + ``interp="pre"``, where the
tensor-product Gauss-Hermite expectation factorizes into per-axis
expectation matrices (see :mod:`.continuous_common`), with conditional
matrices for z (conditioned on h_z and z_pi) and z_pi (conditioned on
h_zpi).  State grids (h_lam, h_c, h_z, h_zpi, z, z_pi), the reference
continuous layer's axis order.

``space="w"`` iterates on w (float64 parity path); ``space="log"`` on
log w through per-axis log-sum-exp contractions, optionally with a
separable baseline folded into the matrices.  "post" and "loglin" in log
space run the node chain (:func:`.post_interp.make_node_chain_T_gcy`);
the pointwise corner gather (``engine="gather"``) serves every
combination, as in the SSY factory.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..models.gcy import GCY, gcy_loglinear_factory
from ..ops.contract import lse_matmul
from ..ops.grids import build_grid_gcy
from ..ops.quadrature import tensor_quadrature_normal
from .continuous_common import (expectation_matrix, make_gather_T, mc_draws,
                                normalize_expectation_matrix,
                                warn_if_f32_range_unsafe)
from .continuous_ssy import _gauss_hermite, _host_grids

__all__ = ["next_state_gcy", "T_gcy_continuous_factory", "build_grid_gcy"]

_F64 = torch.float64


def next_state_gcy(model: GCY, x: torch.Tensor,
                   shocks: torch.Tensor) -> torch.Tensor:
    """One step of the six GCY state processes.

    ``x`` has leading axis (h_lam, h_c, h_z, h_zpi, z, z_pi); ``shocks``
    is (6, N) (or broadcastable).
    """
    m = model
    h_lam, h_c, h_z, h_zpi, z, z_pi = (x[i] for i in range(6))
    sigma_z = m.phi_z * torch.exp(h_z)
    sigma_zpi = m.phi_zpi * torch.exp(h_zpi)
    return torch.stack([
        m.rho_lam * h_lam + m.s_lam * shocks[0],
        m.rho_c * h_c + m.s_c * shocks[1],
        m.rho_z * h_z + m.s_z * shocks[2],
        m.rho_zpi * h_zpi + m.s_zpi * shocks[3],
        m.rho * z + m.rho_pi * z_pi + sigma_z * shocks[4],
        m.rho_pipi * z_pi + sigma_zpi * shocks[5],
    ])


def _log_kappa_gcy(model: GCY, h_c, z):
    """log kappa = (1-gamma)(mu_c+z) + (1/2)(1-gamma)^2 sigma_c^2 with
    sigma_c = phi_c*exp(h_c)."""
    sigma_c = model.phi_c * torch.exp(torch.as_tensor(h_c, dtype=_F64))
    return ((1 - model.gamma) * (model.mu_c + torch.as_tensor(z, dtype=_F64))
            + 0.5 * (1 - model.gamma) ** 2 * sigma_c ** 2)


def _loglinear_profiles(model: GCY, grids) -> tuple:
    """(const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b): the log-linear
    solution's separable components on the (host float64) grids."""
    m = model
    co = gcy_loglinear_factory(m).coefficients
    hl, hc, hz, hy, zg, bg = (g.numpy() for g in grids)
    return (co["A0"],
            co["A_hlam"] * hl,
            co["A_hc"] * (hc * 2 * m.phi_c**2 + m.phi_c**2),
            co["A_hz"] * (hz * 2 * m.phi_z**2 + m.phi_z**2),
            co["A_hzpi"] * (hy * 2 * m.phi_zpi**2 + m.phi_zpi**2),
            co["A_z"] * zg,
            co["A_zpi"] * bg)


def _baseline_parts(model: GCY, grids, baseline) -> tuple:
    """The separable baseline (const0, phi_l, ..., phi_b) of
    ``baseline`` ("loglinear" or ``(const, [six profiles])``), numpy
    float64."""
    if isinstance(baseline, str) and baseline == "loglinear":
        return _loglinear_profiles(model, grids)
    const0, profs = baseline
    return (const0,) + tuple(np.asarray(p_, np.float64) for p_ in profs)


def _factored_arrays_gcy(model, grids, degree, baseline=None,
                         tilt_lambda=True) -> dict:
    """Expectation matrices + baseline components of the factored GCY
    operator (quadrature + interp="pre"), host float64.

    Axis labels: l=h_lam, k=h_c, i=h_z, y=h_zpi, j=z, b=z_pi; capitals
    are next-period indices.  Returns P_lam (l), P_c (k), P_hz (i),
    P_hzpi (y), the conditioned P_zpi (y, b, B) and P_z (i, j, b, J), the
    split kappa terms log_A2 (k) / log_A3 (j), and — when a baseline is
    folded — the separable components (const0, phi_l, ..., phi_b).
    """
    theta = model.theta
    m = model
    hg = _host_grids(grids)
    h_lam_grid, h_c_grid, h_z_grid, h_zpi_grid, z_grid, z_pi_grid = hg
    eta, omega = _gauss_hermite(degree)

    P_lam = expectation_matrix(h_lam_grid, m.rho_lam * h_lam_grid, m.s_lam,
                               eta, omega,
                               payoff=(lambda xn: torch.exp(theta * xn))
                               if tilt_lambda else None)
    P_c = expectation_matrix(h_c_grid, m.rho_c * h_c_grid, m.s_c, eta, omega)
    P_hz = expectation_matrix(h_z_grid, m.rho_z * h_z_grid, m.s_z, eta, omega)
    P_hzpi = expectation_matrix(h_zpi_grid, m.rho_zpi * h_zpi_grid, m.s_zpi,
                                eta, omega)
    sigma_z = m.phi_z * torch.exp(h_z_grid)          # (i,)
    sigma_zpi = m.phi_zpi * torch.exp(h_zpi_grid)    # (y,)
    # z_pi' = rho_pipi*z_pi + sigma_zpi(h_zpi)*eta: P_zpi[y, b, B]
    P_zpi = expectation_matrix(
        z_pi_grid,
        (m.rho_pipi * z_pi_grid).expand(len(h_zpi_grid), len(z_pi_grid)),
        sigma_zpi[:, None], eta, omega)
    # z' = rho*z + rho_pi*z_pi + sigma_z(h_z)*eta: P_z[i, j, b, J]
    mean_z = (m.rho * z_grid[None, :, None]
              + m.rho_pi * z_pi_grid[None, None, :])
    mean_z = mean_z.expand(len(h_z_grid), len(z_grid), len(z_pi_grid))
    P_z = expectation_matrix(z_grid, mean_z, sigma_z[:, None, None],
                             eta, omega)
    # log kappa(h_c, z) splits into a row (h_c) and a column (z) part.
    sigma_c = m.phi_c * torch.exp(h_c_grid)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2               # (k,)
    log_A3 = (1 - m.gamma) * (m.mu_c + z_grid)                     # (j,)

    ell0_parts = None
    if baseline is not None:
        # Fold a separable baseline into the expectation matrices (the
        # conditioned P_z/P_zpi rescale over their last two axes).  The
        # chain then works on theta*(ell - ell0): required for float32,
        # where theta*(log-w range) ~ 200 on the reference's grids.  The
        # coarse-solve profiles are strongly preferred for GCY (the
        # closed form is ~4 log units off at corners).
        parts = _baseline_parts(m, hg, baseline)
        const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = parts
        norm = lambda P, nxt, cur: torch.as_tensor(
            normalize_expectation_matrix(P, nxt, cur, theta))
        P_lam = norm(P_lam, phi_l, phi_l)
        P_c = norm(P_c, phi_k, phi_k)
        P_hz = norm(P_hz, phi_i, phi_i)
        P_hzpi = norm(P_hzpi, phi_y, phi_y)
        # P_zpi[y, b, B]: current index is b (axis -2).
        P_zpi = norm(P_zpi, phi_b, np.broadcast_to(phi_b, P_zpi.shape[:-1]))
        # P_z[i, j, b, J]: current index is j (axis 1 of the batch).
        P_z = norm(P_z, phi_j,
                   np.broadcast_to(phi_j[None, :, None], P_z.shape[:-1]))
        ell0_parts = parts

    return dict(P_lam=P_lam, P_c=P_c, P_hz=P_hz, P_hzpi=P_hzpi,
                P_zpi=P_zpi, P_z=P_z, log_A2=log_A2, log_A3=log_A3,
                ell0_parts=ell0_parts)


def _ell0_field(parts) -> torch.Tensor:
    """The 6-D baseline field const0 + phi_l + ... + phi_b (float64)."""
    const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = parts
    return torch.as_tensor(
        const0
        + phi_l[:, None, None, None, None, None]
        + phi_k[None, :, None, None, None, None]
        + phi_i[None, None, :, None, None, None]
        + phi_y[None, None, None, :, None, None]
        + phi_j[None, None, None, None, :, None]
        + phi_b[None, None, None, None, None, :])


def _factored_T(model, grids, degree, space, dtype, baseline=None, *,
                device="cuda"):
    """Factored contraction operator (quadrature + interp="pre").

    The z_pi contraction runs *before* the z contraction so intermediates
    stay O(N) despite z' conditioning on the current z_pi.
    """
    dev = resolve_device(device)
    dtype = dtype or _F64
    beta, theta = model.beta, model.theta
    arrs = _factored_arrays_gcy(model, grids, degree, baseline)
    log_kappa = arrs["log_A2"][:, None] + arrs["log_A3"][None, :]  # (k, j)
    ell0 = (None if arrs["ell0_parts"] is None
            else _ell0_field(arrs["ell0_parts"]))
    cast = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype)
    P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z, log_kappa = map(
        cast, (arrs["P_lam"], arrs["P_c"], arrs["P_hz"], arrs["P_hzpi"],
               arrs["P_zpi"], arrs["P_z"], log_kappa))
    if ell0 is not None:
        ell0 = cast(ell0)
    expand = (None, slice(None), None, None, slice(None), None)  # (k, j)

    def apply_K(g):
        u = torch.einsum("lL,LKIYJB->lKIYJB", P_lam, g)
        u = torch.einsum("kK,lKIYJB->lkIYJB", P_c, u)
        u = torch.einsum("iI,lkIYJB->lkiYJB", P_hz, u)
        u = torch.einsum("yY,lkiYJB->lkiyJB", P_hzpi, u)
        u = torch.einsum("ybB,lkiyJB->lkiyJb", P_zpi, u)   # next-z_pi first
        u = torch.einsum("ijbJ,lkiyJb->lkiyjb", P_z, u)    # then next-z
        return u

    if space == "w":
        kappa = torch.exp(log_kappa)

        def T(w):
            kg = kappa[expand] * apply_K(w ** theta)
            return 1.0 + beta * kg ** (1.0 / theta)
        return T

    def T(ell):
        a = theta * (ell if ell0 is None else ell - ell0)
        a = lse_matmul(P_lam, a, "lL,LKIYJB->lKIYJB", 0)
        a = lse_matmul(P_c, a, "kK,lKIYJB->lkIYJB", 1)
        a = lse_matmul(P_hz, a, "iI,lkIYJB->lkiYJB", 2)
        a = lse_matmul(P_hzpi, a, "yY,lkiYJB->lkiyJB", 3)
        a = lse_matmul(P_zpi, a, "ybB,lkiyJB->lkiyJb", 5)
        a = lse_matmul(P_z, a, "ijbJ,lkiyJb->lkiyjb", 4)
        if ell0 is not None:
            a = a + theta * ell0
        log_kg = a + log_kappa[expand]
        return torch.log1p(beta * torch.exp(log_kg / theta))

    if ell0 is not None:
        T.baseline_log_w = ell0
    return T


def T_gcy_continuous_factory(model: GCY,
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
    """Build the continuous-state GCY operator T on ``device`` (see the
    SSY factory for the method/interp/space/engine semantics).

    quadrature + interp="pre" (degree-``quad_degree`` Gauss-Hermite per
    dimension) dispatches to the factored contraction path, in ``dtype``
    (float64 when None); post/loglin in log space to the node chain
    (:func:`.post_interp.make_node_chain_T_gcy`) unless
    ``engine="gather"``; the pointwise gather serves the rest.  At six
    states a d-degree tensor quadrature has d^6 joint nodes, so Monte
    Carlo draws (``mc_draw_size`` of a generator seeded with ``seed``)
    are the practical expectation for post/loglin.  ``baseline``
    ("loglinear" or ``(const, profiles)``) folds a separable baseline
    into the factored log-space operator, which then carries
    ``T.baseline_log_w``; it is effectively required for float32
    (theta*(log-w range) ~ 200 on these grids).
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if space == "log" and baseline is None:
        warn_if_f32_range_unsafe(model, grids, gcy_loglinear_factory,
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
        from .post_interp import gcy_quadrature_nodes, make_node_chain_T_gcy
        if method == "quadrature":
            nodes, logw = gcy_quadrature_nodes(quad_degree)
        else:
            nodes = mc_draws(6, mc_draw_size, seed).numpy()
            logw = np.full(mc_draw_size, -np.log(float(mc_draw_size)))
        return make_node_chain_T_gcy(model, grids, nodes, logw,
                                     interp=interp, dtype=dtype,
                                     device=device)
    if engine == "node_chain":
        raise ValueError("engine='node_chain' requires interp='post' or "
                         "'loglin' with space='log'")
    if method == "quadrature":
        nodes, weights = tensor_quadrature_normal([quad_degree] * 6)
        shocks, weights = torch.as_tensor(nodes), torch.as_tensor(weights)
    else:
        shocks, weights = mc_draws(6, mc_draw_size, seed), None
    return make_gather_T(
        lambda x, s: next_state_gcy(model, x, s),
        lambda x: _log_kappa_gcy(model, x[1], x[4]),
        grids, shocks, weights, interp, space, batch_size, model.beta,
        model.theta, device=device)
