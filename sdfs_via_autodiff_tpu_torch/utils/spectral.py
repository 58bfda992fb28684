"""Matrix-free spectral checks for existence and uniqueness.

PyTorch port of ``sdfs_via_autodiff_tpu/utils/spectral.py``.  The fixed
point exists and is unique iff beta * r(H)^(1/theta) < 1
(Stachurski-Zhang 2022).  r(H) comes from power iteration through the
*factored* operator: H is nonnegative and irreducible, so the Perron
root is reached from a positive start, and the condition is checkable
at any grid size on the card.

The power iteration reads its stop condition on the host once every
:data:`~..solvers.krylov.SYNC_EVERY` iterations and reports the
eigenvalue and count of the first iteration that met it, as the JAX
package's ``lax.while_loop`` does.  The Monte Carlo exponent draws its
shocks from a ``torch.Generator`` seeded with ``seed`` on the solve's
device (not JAX's PRNG stream: the two agree in distribution), in
chunks of :data:`MC_CHUNK` steps that replay a captured CUDA graph on
the card (:func:`.graphs.run_chunks`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..models.gcy import GCY
from ..models.ssy import SSY
from .graphs import run_chunks

__all__ = ["power_iteration", "existence_check", "stability_decomposition",
           "stability_exponent_mc", "stability_exponent_transient",
           "stability_exponent_constant_vol", "ExistenceReport",
           "StabilityDecomposition"]

# Steps per chunk of the Monte Carlo exponent (one draw of the chunk's
# shocks, one captured CUDA graph).
MC_CHUNK = 250


def power_iteration(apply_H: Callable, shape, *, tol: float = 1e-10,
                    max_iter: int = 5000, dtype: torch.dtype = torch.float64,
                    device="cuda"):
    """Dominant eigenvalue of a nonnegative linear operator.

    ``apply_H`` maps a tensor of ``shape`` on ``device`` to the same
    shape.  Returns (eigenvalue, iterations) as Python numbers: the
    first iteration k with |lam_k - lam_{k-1}| <= tol * |lam_k| (lam_0 =
    1; a NaN stops too) or ``max_iter``.  Sup-norm normalization keeps
    the iterate O(1); the estimate is the normalization factor.
    """
    # Imported here: the solvers import this package's recorder.
    from ..solvers.krylov import SYNC_EVERY
    dev = resolve_device(device)
    v = torch.ones(shape, dtype=dtype, device=dev)
    lam = torch.ones((), dtype=dtype, device=dev)
    lam_stop = lam
    it_stop = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter:
        for _ in range(min(SYNC_EVERY, max_iter - it)):
            w = apply_H(v)
            lam_new = torch.amax(torch.abs(w))
            v = w / lam_new
            it += 1
            # The loop runs while |d| > tol |lam|, so a NaN stops it.
            stop = ~(torch.abs(lam_new - lam) > tol * torch.abs(lam_new))
            first = stop & ~done
            lam_stop = torch.where(first, lam_new, lam_stop)
            it_stop = torch.where(first, it, it_stop)
            done = done | stop
            lam = lam_new
        if bool(done):                        # one host read per chunk
            return float(lam_stop), int(it_stop)
    return float(lam), max_iter


@dataclasses.dataclass
class ExistenceReport:
    spectral_radius: float
    theta: float
    beta: float
    stability_exponent: float     # beta * r(H)^(1/theta)
    exists_unique: bool
    iterations: int

    def __repr__(self):
        return (f"ExistenceReport(r(H)={self.spectral_radius:.6g}, "
                f"beta*r^(1/theta)={self.stability_exponent:.6f}, "
                f"exists_unique={self.exists_unique})")


def _discrete_H(model, disc, dev):
    """(apply_H, shape) of the discretized chain's H on ``dev``."""
    if isinstance(model, SSY):
        from ..operators.discrete_ssy import _hw_theta_factored, _ssy_factors
        B_lam, A2, A3 = (a.to(dev) for a in _ssy_factors(model, disc))
        Qc, Qhz, zP = (a.to(dev) for a in (disc.h_c_Q, disc.h_z_Q,
                                            disc.z_P))
        return (lambda v: _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3),
                disc.shapes)
    if isinstance(model, GCY):
        from ..operators.discrete_gcy import (_gcy_factors,
                                              _hw_theta_factored_gcy)
        B_lam, A2, A3 = (a.to(dev) for a in _gcy_factors(model, disc))
        factors = [a.to(dev) for a in (B_lam, disc.h_c_Q, disc.h_z_Q,
                                       disc.h_zpi_Q, disc.z_pi_P,
                                       disc.z_P)]
        return (lambda v: _hw_theta_factored_gcy(v, factors, A2, A3),
                disc.shapes)
    raise TypeError(f"unsupported model {type(model).__name__}")


def existence_check(model, disc=None, grids=None, *, tol=1e-10,
                    quad_degree: int = 5, device="cuda") -> ExistenceReport:
    """Check beta * r(H)^(1/theta) < 1 for a discretized (``disc``) or
    continuous (``grids``: the factored quadrature, pre-interp chain)
    SSY/GCY model, in float64 on ``device``."""
    if (disc is None) == (grids is None):
        raise ValueError("pass exactly one of disc or grids")
    dev = resolve_device(device)
    if disc is not None:
        apply_H, shape = _discrete_H(model, disc, dev)
    else:
        # The linear part of the factored pre-interp operator:
        # T(w) = 1 + beta (H w^theta)^(1/theta), so feeding
        # w = v^(1/theta) recovers H v.
        if isinstance(model, SSY):
            from ..operators.continuous_ssy import T_ssy_continuous_factory
            factory = T_ssy_continuous_factory
        elif isinstance(model, GCY):
            from ..operators.continuous_gcy import T_gcy_continuous_factory
            factory = T_gcy_continuous_factory
        else:
            raise TypeError(f"unsupported model {type(model).__name__}")
        T = factory(model, grids, interp="pre", space="w",
                    quad_degree=quad_degree, device=dev)
        theta, beta = model.theta, model.beta

        def apply_H(v):
            return ((T(v ** (1.0 / theta)) - 1.0) / beta) ** theta
        shape = tuple(len(g) for g in grids)

    lam, it = power_iteration(apply_H, shape, tol=tol, device=dev)
    expo = model.beta * lam ** (1.0 / model.theta)
    return ExistenceReport(spectral_radius=lam, theta=model.theta,
                           beta=model.beta, stability_exponent=expo,
                           exists_unique=bool(expo < 1.0), iterations=it)


@dataclasses.dataclass
class StabilityDecomposition:
    """Companion-paper decomposition of the (log) stability exponent."""
    S: float               # ln beta + S_lambda + (1 - 1/psi) * S_c
    ln_beta: float
    S_lambda: float        # (1/theta) ln r(B_lambda)
    S_c: float             # (1/(1-gamma)) ln r(M_c)
    coefficient: float     # 1 - 1/psi
    S_direct: float        # ln(beta) + (1/theta) ln r(H), full chain
    exists_unique: bool    # S < 0

    def __repr__(self):
        return (f"StabilityDecomposition(S={self.S:.8f} = ln_beta "
                f"{self.ln_beta:.6f} + S_lambda {self.S_lambda:.6f} + "
                f"{self.coefficient:.4f}*S_c ({self.S_c:.6f}); "
                f"direct {self.S_direct:.8f}; "
                f"exists_unique={self.exists_unique})")


def stability_decomposition(model, disc, *, tol: float = 1e-12,
                            device="cuda") -> StabilityDecomposition:
    """Decompose the stability exponent S = ln(beta * r(H)^(1/theta)) as

        S = ln beta + S_lambda + (1 - 1/psi) * S_c

    (the companion paper's decomposition under independence of
    preference shocks and consumption).  On the discretized chain H is
    exactly the Kronecker product of the lambda-tilted chain B_lambda and
    the consumption-tilted chain M_c, so r(H) = r(B_lambda) r(M_c) and
    ``S`` agrees with ``S_direct`` to power-iteration tolerance.
    S_lambda = ln(r(B_lambda))/theta (a dense eigenvalue on the host) and
    S_c = ln(r(M_c))/(1-gamma) (power iteration on ``device``).
    """
    theta, beta, gamma, psi = (model.theta, model.beta, model.gamma,
                               model.psi)
    dev = resolve_device(device)
    if isinstance(model, SSY):
        from ..operators.discrete_ssy import _ssy_factors
        B_lam, A2, A3 = _ssy_factors(model, disc)
        Qc, Qhz, zP, A2, A3 = (a.to(dev) for a in (disc.h_c_Q, disc.h_z_Q,
                                                   disc.z_P, A2, A3))

        def apply_Mc(v):                      # v: (h_c, h_z, z)
            u = torch.einsum("km,mij->kij", Qc, v)
            u = torch.einsum("im,kmj->kij", Qhz, u)
            u = torch.einsum("jm,kim->kij", zP, u)
            return A2[:, None, None] * A3[None, :, :] * u

        mc_shape = disc.shapes[1:]            # (n_hc, n_hz, n_z)
    elif isinstance(model, GCY):
        from ..operators.discrete_gcy import _gcy_factors
        B_lam, A2, A3 = _gcy_factors(model, disc)
        Qc, Qhz, Qhzpi, zpiP, zP, A2, A3 = (
            a.to(dev) for a in (disc.h_c_Q, disc.h_z_Q, disc.h_zpi_Q,
                                disc.z_pi_P, disc.z_P, A2, A3))

        def apply_Mc(v):                      # v: (z, z_pi, h_z, h_c, h_zpi)
            u = torch.einsum("dD,ABCDE->ABCdE", Qc, v)
            u = torch.einsum("cC,ABCdE->ABcdE", Qhz, u)
            u = torch.einsum("eE,ABcdE->ABcde", Qhzpi, u)
            u = torch.einsum("bB,ABcde->Abcde", zpiP, u)
            u = torch.einsum("aA,Abcde->abcde", zP, u)
            return (A2[None, None, None, :, None]
                    * A3[:, :, :, None, :] * u)

        mc_shape = disc.shapes[:-1]           # all axes but h_lam
    else:
        raise TypeError(f"unsupported model {type(model).__name__}")

    # The preference-shock channel: B_lambda is small (n_lam x n_lam).
    r_lam = float(np.max(np.abs(np.linalg.eigvals(B_lam.numpy()))))
    S_lam = float(np.log(r_lam) / theta)

    r_c, _ = power_iteration(apply_Mc, mc_shape, tol=tol, device=dev)
    S_c = float(np.log(r_c) / (1.0 - gamma))

    coeff = 1.0 - 1.0 / psi
    S = float(np.log(beta)) + S_lam + coeff * S_c

    rep = existence_check(model, disc, tol=tol, device=dev)
    S_direct = float(np.log(rep.stability_exponent))

    return StabilityDecomposition(
        S=S, ln_beta=float(np.log(beta)), S_lambda=S_lam, S_c=S_c,
        coefficient=coeff, S_direct=S_direct, exists_unique=bool(S < 0))


def stability_exponent_mc(model, *, T: int = 100_000, N: int = 10_000,
                          seed: int = 0, dtype: torch.dtype = torch.float64,
                          device="cuda"):
    """Monte Carlo estimate of the stability exponent S: the companion
    paper's path-simulation estimator (T = 100,000 and N = 10,000 there),
    with the consumption shock integrated out analytically.

    Estimates both channels from N simulated state paths of length T:

        S_lambda_hat = (1/(T theta))   ln (1/N) sum_n exp(theta * sum_t h_lam)
        S_c_hat      = mu_c + (1/(T(1-gamma))) ln (1/N) sum_n
                       exp((1-gamma) sum_t z + (1-gamma)^2/2 sum_t sigma_c^2)

    and returns ``dict(S, S_lambda, S_c, T, N)`` with
    S = ln beta + S_lambda + (1 - 1/psi) S_c: the *continuous*
    dynamics' exponent, which cross-checks
    :func:`stability_decomposition` up to discretization, O(1/T) and
    Monte Carlo error.

    Shocks come from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, drawn :data:`MC_CHUNK` steps at a time.  The loop never
    reads back to the host; on a CUDA device the chunks after the first
    replay a captured CUDA graph (bitwise the loop's result).

    CAVEAT (why the spectral route is the production check): a sample
    average of exp(a * sum_t X_t) is consistent only if N grows
    exponentially with Var(a * sum X).  At the headline SSY calibration
    theta * sum h_lam has std ~ 22 at T = 20,000, so this estimator (the
    paper's construction) understates |S_lambda| there.  Use it where
    the tilted sum's std is moderate.
    """
    if isinstance(model, SSY):
        from ..operators.continuous_ssy import next_state_ssy as _step
        dim, iz = 4, 3
    else:
        from ..operators.continuous_gcy import next_state_gcy as _step
        dim, iz = 6, 4
    theta, gamma, psi, beta = (model.theta, model.gamma, model.psi,
                               model.beta)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x = torch.zeros((dim, N), dtype=dtype, device=dev)
    s_lam, s_z, s_sig2 = (torch.zeros(N, dtype=dtype, device=dev)
                          for _ in range(3))
    chunk = max(1, min(MC_CHUNK, T))
    eps = torch.empty((chunk, dim, N), dtype=dtype, device=dev)

    def steps(n):
        def run():
            y, a, b, c = x, s_lam, s_z, s_sig2
            for t in range(n):
                # z and sigma_c^2 enter as time-(t-1) states.
                b = b + y[iz]
                c = c + (model.phi_c * torch.exp(y[1])) ** 2
                y = _step(model, y, eps[t])
                a = a + y[0]                      # h_lam at time t
            for dst, src in ((x, y), (s_lam, a), (s_z, b), (s_sig2, c)):
                dst.copy_(src)
        return run

    def draw(_c, n=chunk):
        eps[:n].normal_(generator=gen)

    full, rest = divmod(T, chunk)
    run_chunks(steps(chunk), full, before=draw, graphs=dev.type == "cuda")
    if rest:
        draw(full, rest)
        steps(rest)()
    logN = math.log(float(N))
    S_lam = float((torch.logsumexp(theta * s_lam, 0) - logN) / (T * theta))
    S_c = model.mu_c + float(
        (torch.logsumexp((1 - gamma) * s_z
                         + 0.5 * (1 - gamma) ** 2 * s_sig2, 0) - logN)
        / (T * (1 - gamma)))
    S = float(np.log(beta)) + S_lam + (1 - 1 / psi) * S_c
    return dict(S=S, S_lambda=S_lam, S_c=S_c, T=T, N=N)


def stability_exponent_transient(*, beta: float, gamma: float, psi: float,
                                 mu_c: float, sigma_c: float,
                                 s_lam: float, rho_lam: float
                                 ) -> StabilityDecomposition:
    """Closed-form stability exponent for the purely-transient benchmark
    (companion paper Proposition p:ar1): ``g_c = mu_c + sigma_c xi``
    IID, preference shocks AR(1).

        S_lambda = theta s_lam^2 / (2 (1 - rho_lam)^2)
        S_c      = mu_c + (1 - gamma) sigma_c^2 / 2
        S        = ln beta + S_lambda + (1 - 1/psi) S_c
    """
    theta = (1.0 - gamma) / (1.0 - 1.0 / psi)
    S_lam = theta * s_lam**2 / (2.0 * (1.0 - rho_lam)**2)
    S_c = mu_c + 0.5 * (1.0 - gamma) * sigma_c**2
    coeff = 1.0 - 1.0 / psi
    S = math.log(beta) + S_lam + coeff * S_c
    return StabilityDecomposition(S=S, ln_beta=math.log(beta),
                                  S_lambda=S_lam, S_c=S_c,
                                  coefficient=coeff, S_direct=S,
                                  exists_unique=bool(S < 0.0))


def stability_exponent_constant_vol(*, beta: float, gamma: float,
                                    psi: float, mu_c: float,
                                    sigma_c: float, sigma: float,
                                    rho: float, s_lam: float,
                                    rho_lam: float
                                    ) -> StabilityDecomposition:
    """Closed-form stability exponent for the constant-volatility
    long-run-risk benchmark (Bansal-Yaron dynamics): ``g_c = mu_c + z +
    sigma_c xi`` with ``z' = rho z + sigma eta``.  Relative to the
    purely-transient case the consumption channel gains the long-run
    term ``sigma^2 / (1 - rho)^2``:

        S_c = mu_c + (1 - gamma)(sigma_c^2 + sigma^2/(1-rho)^2) / 2.
    """
    theta = (1.0 - gamma) / (1.0 - 1.0 / psi)
    S_lam = theta * s_lam**2 / (2.0 * (1.0 - rho_lam)**2)
    S_c = mu_c + 0.5 * (1.0 - gamma) * (sigma_c**2
                                        + sigma**2 / (1.0 - rho)**2)
    coeff = 1.0 - 1.0 / psi
    S = math.log(beta) + S_lam + coeff * S_c
    return StabilityDecomposition(S=S, ln_beta=math.log(beta),
                                  S_lambda=S_lam, S_c=S_c,
                                  coefficient=coeff, S_direct=S,
                                  exists_unique=bool(S < 0.0))
