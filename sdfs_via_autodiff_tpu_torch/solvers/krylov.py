"""Matrix-free Krylov solvers with float64 reductions.

Port of ``solvers/krylov.py`` (BiCGStab) and of the restarted GMRES the
JAX package's Newton solver takes from ``jax.scipy.sparse.linalg``.

Every VECTOR stays in the iterate dtype (float32 matvecs and state — the
expensive part) while every REDUCTION and recurrence scalar is float64: at
10^7-point grids a float32 dot product carries O(sqrt(N) * eps) ~ 1e-4
relative noise, which BiCGStab's scalar ratios amplify until rho/omega
collapse and the inner solve returns a zero step.

The JAX loop is one device ``lax.while_loop``.  Here the loop is Python,
and it reads its stop condition on the host once every
:data:`SYNC_EVERY` iterations: inside a chunk each iteration evaluates
the condition on the device and, once it fails, ``torch.where`` freezes
the state, so the result and the iteration count equal those of a check
after every iteration.  Every blocking read of a device value by the
host in these loops and in ``fixed_point.py`` goes through
:func:`host_read`, a ``sdfs.sync`` span (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import count, span, spanned
from .sharding import LOCAL, Reductions

__all__ = ["SYNC_EVERY", "bicgstab_mixed", "gmres", "host_read"]

# Iterations between host reads of a solver loop's stop condition (also
# used by ``fixed_point._iterate``).
SYNC_EVERY = 8


def host_read(convert: Callable, value):
    """``convert(value)`` (``bool``, ``int``, ``float``, a copy to the
    host) for a device ``value``: a blocking read, in a ``sdfs.sync``
    span whose length is the time the host waits for the device."""
    with span("sdfs.sync"):
        return convert(value)


@spanned("sdfs.krylov")
def bicgstab_mixed(matvec: Callable, b, *, atol=0.0,
                   maxiter: Optional[int] = 50,
                   x0=None,
                   red: Reductions = LOCAL) -> Tuple[torch.Tensor, int]:
    """Solve ``A x = b`` (A = ``matvec``) by BiCGStab with float64
    recurrence scalars over iterate-dtype vectors.

    Returns ``(x, iterations)``.  ``atol`` (a float or a 0-d tensor, which
    may be ``inf`` to skip the solve) is the absolute target on
    ||b - A x||_2, evaluated on the recursive residual.  ``maxiter`` must
    bound the loop (None is rejected).  ``red`` takes the dot products
    (all-reduced over the shards of a sharded iterate).
    """
    if maxiter is None:
        raise ValueError("bicgstab_mixed requires an explicit maxiter")
    vdtype = b.dtype
    shape = b.shape
    dev = b.device
    f64 = torch.float64
    down = lambda s: s.to(vdtype)

    bf = b.reshape(-1)
    if x0 is None:
        x = torch.zeros_like(bf)
        r = bf
    else:
        x = x0.to(vdtype).reshape(-1)
        r = bf - matvec(x0).reshape(-1)
    r_hat = r                                  # shadow residual (fixed)
    one = torch.ones((), dtype=f64, device=dev)
    atol2 = torch.as_tensor(atol, dtype=f64, device=dev) ** 2
    # Breakdown floors, relative to the initial residual scale.
    rho0 = red.dot64(r, r)
    tiny = torch.clamp(rho0, min=1.0) * 1e-28

    def cond(state):
        _, r, _, _, _, _, _, it, ok = state
        rnorm2 = red.dot64(r, r)
        return ((rnorm2 > atol2) & (it < maxiter) & ok
                & torch.isfinite(rnorm2))

    def body(state):
        x, r, p, v, rho, alpha, omega, it, ok = state
        rho_new = red.dot64(r_hat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + down(beta) * (p - down(omega) * v)
        v_new = matvec(p_new.reshape(shape)).reshape(-1)
        rv = red.dot64(r_hat, v_new)
        alpha_new = rho_new / rv
        s = r - down(alpha_new) * v_new
        x_half = x + down(alpha_new) * p_new
        t = matvec(s.reshape(shape)).reshape(-1)
        tt = red.dot64(t, t)
        omega_new = red.dot64(t, s) / tt
        x_full = x_half + down(omega_new) * s
        r_full = s - down(omega_new) * t
        # Three-way outcome, in priority order:
        # (1) the alpha scalars are degenerate -> freeze at the pre-step
        #     state and stop;
        # (2) the half step already converged, or the omega scalars are
        #     degenerate -> take the half step, whose residual s is
        #     well-defined, and stop;
        # (3) healthy -> full BiCGStab update.
        bad_a = ((rho_new.abs() <= tiny) | (rv.abs() <= tiny)
                 | ~torch.isfinite(beta) | ~torch.isfinite(alpha_new))
        half = ((red.dot64(s, s) <= atol2) | (tt <= tiny)
                | ~torch.isfinite(omega_new))

        def pick(full_, half_, old):
            return torch.where(bad_a, old, torch.where(half, half_, full_))
        return (pick(x_full, x_half, x), pick(r_full, s, r),
                pick(p_new, p_new, p), pick(v_new, v_new, v),
                pick(rho_new, rho_new, rho),
                pick(alpha_new, alpha_new, alpha),
                pick(omega_new, omega, omega),
                it + 1, ~(bad_a | half))

    z = torch.zeros_like(bf)
    state = (x, r, z, z, one, one, one,
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.ones((), dtype=torch.bool, device=dev))
    while host_read(bool, cond(state)):        # one host read per chunk
        for _ in range(SYNC_EVERY):
            run = cond(state)
            state = tuple(torch.where(run, new, old)
                          for new, old in zip(body(state), state))
    n = host_read(int, state[7])
    count("sdfs.krylov", n)
    return state[0].reshape(shape), n


@spanned("sdfs.krylov")
def gmres(matvec: Callable, b, *, tol: float = 1e-5, atol=0.0,
          restart: int = 20,
          maxiter: Optional[int] = None,
          red: Reductions = LOCAL) -> Tuple[torch.Tensor, int]:
    """Solve ``A x = b`` (A = ``matvec``) by restarted GMRES from x = 0.

    The contract of ``jax.scipy.sparse.linalg.gmres`` (its default
    "batched" form): stop when ||b - A x||_2 <= max(tol * ||b||_2, atol);
    each cycle builds a Krylov basis of ``restart`` vectors (fewer on
    breakdown), solves the small least-squares problem for the
    correction and recomputes the true residual with one more matvec;
    ``maxiter`` counts restart cycles (None means ``10 * b.numel()``).

    The basis vectors stay in ``b``'s dtype; the Arnoldi process is
    modified Gram-Schmidt with float64 dot products, the Hessenberg
    matrix is float64 and its least-squares problem is solved on the host
    (numpy, minimum norm, so a basis cut short by a breakdown gives zero
    weights to its null vectors).  The host reads the stop condition once
    per cycle and the Hessenberg matrix once per cycle.  ``atol`` may be
    a 0-d tensor (``inf`` skips the solve).  Returns ``(x, n)`` with
    ``n`` the number of Arnoldi steps (matvecs of the bases).  ``red``
    takes the dot products and the element count.
    """
    vdtype, shape, dev = b.dtype, b.shape, b.device
    f64 = torch.float64
    n = red.numel(b)
    restart = min(int(restart), n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    eps = torch.finfo(vdtype).eps
    flat_mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    norm64 = lambda v: torch.sqrt(red.dot64(v, v))

    bf = b.reshape(-1)
    x, r = torch.zeros_like(bf), bf
    target = torch.maximum(tol * norm64(bf),
                           torch.as_tensor(atol, dtype=f64, device=dev))
    rnorm = norm64(r)
    steps = cycles = 0
    while cycles < maxiter and host_read(bool, rnorm > target):
        use = rnorm > eps
        V = [torch.where(use, r / rnorm.to(vdtype), torch.zeros_like(r))]
        H = torch.zeros((restart + 1, restart), dtype=f64, device=dev)
        for k in range(restart):
            w = flat_mv(V[k])
            w_norm0 = norm64(w)
            for j in range(k + 1):               # modified Gram-Schmidt
                h = red.dot64(V[j], w)
                H[j, k] = h
                w = w - h.to(vdtype) * V[j]
            w_norm = norm64(w)
            # Breakdown (an invariant subspace): the next vector is zero,
            # and so are the rest of this cycle's.
            live = w_norm > eps * w_norm0
            H[k + 1, k] = torch.where(live, w_norm, torch.zeros_like(w_norm))
            V.append(torch.where(live, w / w_norm.to(vdtype),
                                 torch.zeros_like(w)))
            steps += 1
        e1 = np.zeros(restart + 1)
        e1[0] = host_read(float, rnorm)
        y = np.linalg.lstsq(host_read(lambda h: h.cpu().numpy(), H), e1,
                            rcond=None)[0]
        for j in range(restart):
            x = x + float(y[j]) * V[j]
        r = bf - flat_mv(x)
        rnorm = norm64(r)
        cycles += 1
    count("sdfs.krylov", steps)
    return x.reshape(shape), steps
