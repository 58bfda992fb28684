"""Node-chain form of the post-power interpolation operators.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/post_interp.py``.  The
reference's continuous operator interpolates w *first* and applies the
theta-power afterwards (``interp="post"``; ``"loglin"`` interpolates
log w).  The power between interpolation and expectation blocks the
per-axis expectation-matrix factorization of the "pre" path
(:mod:`.continuous_common`), but multilinear interpolation at a *fixed*
shock node eta_q is a linear map of the field, and because each state
dimension's successor is driven by its own component of eta_q, that map
factorizes per axis,

    interp(g)(x'(x, eta_q)) = [B_1[q] x B_2[q] x B_3[q] x B_4[q]] g,

with B_d[q][i, k] = b_k(mu_d(x_i) + sigma_d(x) * eta_q[d]) the hat-basis
matrix of axis d at node q (the z-axis matrix carries the h_z
conditioning of sigma_z).  One application is a loop over node chunks of
per-axis batched matmuls with a running log-sum-exp across nodes.  The
form is exact (the gather's corner weights, reordered) and covers
tensor-product quadrature and joint Monte Carlo draws alike.  The fused
SSY kernel over the same nodes lives in :mod:`..kernels.post_interp_kernel`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.quadrature import tensor_quadrature_normal
from .continuous_common import hat_basis
from .continuous_gcy import _log_kappa_gcy
from .continuous_ssy import _host_grids

__all__ = ["node_basis_ssy", "make_node_chain_T_ssy", "ssy_quadrature_nodes",
           "node_basis_gcy", "make_node_chain_T_gcy", "gcy_quadrature_nodes"]

_F64 = torch.float64
# Default node-chunk size: the most nodes whose (chunk, N) intermediate
# stays within this many bytes.  Each chunk costs a fixed number of
# launches (and, under torch.func.jvp, of host dispatches), so few large
# chunks beat the JAX package's 32-node chunks, which fit TPU memory.
CHUNK_BYTES = 128 * 2**20


def _default_chunk(Q: int, N: int, dtype: torch.dtype) -> int:
    """Nodes per chunk: within :data:`CHUNK_BYTES` per (chunk, N)
    intermediate, spread evenly over the fewest chunks."""
    per_node = N * torch.finfo(dtype).bits // 8
    cmax = max(1, min(Q, CHUNK_BYTES // per_node))
    n_chunks = -(-Q // cmax)
    return -(-Q // n_chunks)


def ssy_quadrature_nodes(quad_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Joint tensor-product Gauss-Hermite nodes (4, d^4) and log-weights
    (d^4,) in the (h_lam, h_c, h_z, z) shock order (numpy float64)."""
    nodes, weights = tensor_quadrature_normal([quad_degree] * 4)
    return (np.asarray(nodes, np.float64),
            np.log(np.asarray(weights, np.float64)))


def node_basis_ssy(model, grids: Sequence, nodes) -> dict:
    """Per-node hat-basis matrices for the SSY successor maps.

    ``nodes`` is (4, Q) joint shocks.  Returns float64 CPU tensors:

    * ``B_lam`` (Q, n_l, n_l): h_lam' = rho_lam*h_lam + s_lam*eta1
    * ``B_c``   (Q, n_k, n_k): h_c'   = rho_c*h_c + s_c*eta2
    * ``B_hz``  (Q, n_i, n_i): h_z'   = rho_z*h_z + s_z*eta3
    * ``B_z``   (Q, n_i, n_j, n_j): z' = rho*z + phi_z*e^{h_z}*eta4,
      conditioned on the *current* h_z index i
    * ``pay``   (Q, n_l): theta * h_lam', the exp(theta*h_lam') payoff of
      the H kernel in log form.
    """
    m = model
    h_lam, h_c, h_z, z = _host_grids(grids)
    eta = torch.as_tensor(np.asarray(nodes, np.float64))         # (4, Q)
    nl1 = m.rho_lam * h_lam[None, :] + m.s_lam * eta[0][:, None]   # (Q, n_l)
    B_lam = hat_basis(h_lam, nl1)
    B_c = hat_basis(h_c, m.rho_c * h_c[None, :] + m.s_c * eta[1][:, None])
    B_hz = hat_basis(h_z, m.rho_z * h_z[None, :] + m.s_z * eta[2][:, None])
    sigma_z = m.phi_z * torch.exp(h_z)                             # (n_i,)
    zn = (m.rho * z[None, None, :]
          + sigma_z[None, :, None] * eta[3][:, None, None])        # (Q, i, j)
    B_z = hat_basis(z, zn)
    pay = m.theta * nl1
    return dict(B_lam=B_lam, B_c=B_c, B_hz=B_hz, B_z=B_z, pay=pay)


def _log_kappa_parts_ssy(model, grids):
    """log kappa(h_c, z) = log_A2[k] + log_A3[j] (float64 CPU tensors)."""
    m = model
    _, h_c, _, z = _host_grids(grids)
    sigma_c = m.phi_c * torch.exp(h_c)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2
    log_A3 = (1 - m.gamma) * (m.mu_c + z)
    return log_A2, log_A3


def _pad_chunk(arrs, logw, chunk):
    """Pad the node axis to a multiple of ``chunk``.  Padding nodes reuse
    the first node's basis rows (finite values) with log-weight -inf, so
    they contribute exp(-inf) = 0 to the accumulation."""
    Q = logw.shape[0]
    pad = (-Q) % chunk
    if pad == 0:
        return arrs, logw
    arrs = [torch.cat([a, a[:1].repeat((pad,) + (1,) * (a.ndim - 1))])
            for a in arrs]
    logw = torch.cat([logw, torch.full((pad,), -np.inf, dtype=logw.dtype)])
    return arrs, logw


def _node_stacks(arrs, log_weights, chunk, dtype, dev):
    """The per-node arrays and log-weights padded to whole chunks and
    stacked as (n_chunks, chunk, ...) tensors on ``dev``."""
    logw = torch.as_tensor(np.asarray(log_weights, np.float64))
    arrs, logw = _pad_chunk(arrs, logw, chunk)
    n_chunks = logw.shape[0] // chunk
    stack = lambda a: a.reshape((n_chunks, chunk) + tuple(a.shape[1:])).to(
        device=dev, dtype=dtype)
    return [stack(a) for a in arrs], stack(logw)


def _lse_over_nodes(chain, field2, stacks, logw, interp, c, theta, shape,
                    dtype, dev):
    """Streaming log-sum-exp over node chunks: returns log of
    sum_q exp(theta*f(u_q) + pay_q + logw_q) on ``shape`` (f = log + c
    for "post", the identity for "loglin").  The running max carries no
    tangent: the shift's contribution cancels exactly (the sum is
    shift-invariant), so detaching it is exact, as the JAX package's
    ``stop_gradient``."""
    neg_inf = torch.tensor(-np.inf, dtype=dtype, device=dev)
    m = torch.full(shape, -np.inf, dtype=dtype, device=dev)
    acc = torch.zeros(shape, dtype=dtype, device=dev)
    pay_idx = (slice(None), slice(None)) + (None,) * (len(shape) - 1)
    w_idx = (slice(None),) + (None,) * len(shape)
    for n in range(logw.shape[0]):
        xs = [s[n] for s in stacks]
        u = chain(field2, xs[:-1])
        if interp == "post":
            a = theta * (torch.log(u) + c)
        else:
            a = theta * u
        a = a + xs[-1][pay_idx] + logw[n][w_idx]
        m_new = torch.maximum(m, torch.amax(a, dim=0).detach())
        # exp(m - m_new) with m = -inf on the first step: guard the
        # -inf - -inf = nan case.
        scale = torch.where(m == neg_inf, 0.0, torch.exp(m - m_new))
        acc = acc * scale + torch.sum(torch.exp(a - m_new[None]), dim=0)
        m = m_new
    return m + torch.log(acc)


def _field(ell, interp, dtype):
    """(field, c): exp(ell - max ell) with the max detached for "post"
    (interpolation is linear, so the shift is exact), ell and 0 for
    "loglin"."""
    ell = ell.to(dtype)
    if interp == "post":
        c = torch.amax(ell).detach()
        return torch.exp(ell - c), c
    return ell, torch.zeros((), dtype=dtype, device=ell.device)


def make_node_chain_T_ssy(model, grids: Sequence, nodes, log_weights,
                          interp: str = "post",
                          dtype: Optional[torch.dtype] = None,
                          chunk: Optional[int] = None, *,
                          device="cuda") -> Callable:
    """Log-space post/loglin-interpolation SSY operator as a node chain,
    on ``device`` in ``dtype`` (float64 when None).

    Maps ell = log w -> log T(w) with the reference's post-power
    semantics (``interp="post"``: E[interp(w)(x')^theta *
    e^{theta h_lam'}]) or the log-interpolation variant (``"loglin"``:
    the interpolant applied to ell).  ``nodes`` (4, Q) and
    ``log_weights`` (Q,) are the joint shock nodes (quadrature or Monte
    Carlo draws).  Node chunks of ``chunk`` run the four per-axis
    contractions as batched matmuls and fold into a running log-sum-exp,
    so peak memory is O(chunk * N); by default a chunk's intermediate
    stays within :data:`CHUNK_BYTES` (the JAX package takes
    min(Q, 32) nodes).  Chunking changes the result only by rounding.
    """
    if interp not in ("post", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    dev = resolve_device(device)
    dtype = dtype or _F64
    theta, beta = float(model.theta), float(model.beta)
    shapes = tuple(len(g) for g in grids)
    basis = node_basis_ssy(model, grids, nodes)
    Q = np.asarray(log_weights).shape[0]
    if chunk is None:
        chunk = _default_chunk(Q, int(np.prod(shapes)), dtype)
    stacks, logw = _node_stacks(
        [basis["B_lam"], basis["B_c"], basis["B_hz"], basis["B_z"],
         basis["pay"]], log_weights, chunk, dtype, dev)
    log_A2, log_A3 = _log_kappa_parts_ssy(model, grids)
    log_kappa = (log_A2[:, None] + log_A3[None, :]).to(device=dev,
                                                        dtype=dtype)
    n_l, n_k, n_i, n_j = shapes
    ck = chunk

    def chain(field2, xs):
        # field2: (L, K*I*J), shared by all nodes.  Each step is one
        # batched matmul with the node chunk leading and the contracted
        # axis adjacent, then one permute of the (chunk, N) intermediate.
        b1, b2, b3, b4 = xs
        u = (b1.reshape(ck * n_l, n_l) @ field2).reshape(ck, n_l, n_k, n_i,
                                                         n_j)
        u = u.permute(0, 2, 1, 3, 4).reshape(ck, n_k, n_l * n_i * n_j)
        u = (b2 @ u).reshape(ck, n_k, n_l, n_i, n_j)
        u = u.permute(0, 3, 1, 2, 4).reshape(ck, n_i, n_k * n_l * n_j)
        u = (b3 @ u).reshape(ck, n_i, n_k * n_l, n_j)
        # J: batch (chunk, i) — the z factor is conditioned on current h_z.
        u = (b4 @ u.transpose(-1, -2)).reshape(ck, n_i, n_j, n_k, n_l)
        return u.permute(0, 4, 3, 1, 2)                # (ck, l, k, i, j)

    def T(ell):
        field, c = _field(ell, interp, dtype)
        lse = _lse_over_nodes(chain, field.reshape(n_l, n_k * n_i * n_j),
                              stacks, logw, interp, c, theta, shapes,
                              dtype, dev)
        log_kg = lse + log_kappa[None, :, None, :]
        return torch.log1p(beta * torch.exp(log_kg / theta))

    return T


def gcy_quadrature_nodes(quad_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Joint tensor-product Gauss-Hermite nodes (6, d^6) and log-weights
    in the (h_lam, h_c, h_z, h_zpi, z, z_pi) shock order.  d^6 nodes make
    quadrature node chains O(d^6 * N): Monte Carlo (a few thousand joint
    draws) is usually the cheaper expectation at 6 states."""
    nodes, weights = tensor_quadrature_normal([quad_degree] * 6)
    return (np.asarray(nodes, np.float64),
            np.log(np.asarray(weights, np.float64)))


def node_basis_gcy(model, grids: Sequence, nodes) -> dict:
    """Per-node hat-basis matrices for the GCY successor maps.

    ``nodes`` is (6, Q) joint shocks in the continuous-layer state order
    (h_lam, h_c, h_z, h_zpi, z, z_pi).  Returns float64 CPU tensors:
    own-axis ``B_lam``/``B_c``/``B_hz``/``B_hzpi`` (Q, n, n), the
    conditioned ``B_zpi`` (Q, n_y, n_b, n_b) (sigma_zpi depends on the
    current h_zpi index y) and ``B_z`` (Q, n_i, n_j, n_b, n_j) (mean
    depends on current z_pi = b, spread on current h_z = i), and ``pay``
    (Q, n_l) = theta * h_lam'.
    """
    m = model
    h_lam, h_c, h_z, h_zpi, z, z_pi = _host_grids(grids)
    eta = torch.as_tensor(np.asarray(nodes, np.float64))         # (6, Q)
    nl1 = m.rho_lam * h_lam[None, :] + m.s_lam * eta[0][:, None]
    B_lam = hat_basis(h_lam, nl1)
    B_c = hat_basis(h_c, m.rho_c * h_c[None, :] + m.s_c * eta[1][:, None])
    B_hz = hat_basis(h_z, m.rho_z * h_z[None, :] + m.s_z * eta[2][:, None])
    B_hzpi = hat_basis(h_zpi,
                 m.rho_zpi * h_zpi[None, :] + m.s_zpi * eta[3][:, None])
    sigma_z = m.phi_z * torch.exp(h_z)                # (n_i,)
    sigma_zpi = m.phi_zpi * torch.exp(h_zpi)          # (n_y,)
    zpin = (m.rho_pipi * z_pi[None, None, :]
            + sigma_zpi[None, :, None] * eta[5][:, None, None])  # (Q, y, b)
    B_zpi = hat_basis(z_pi, zpin)
    zn = (m.rho * z[None, None, :, None] + m.rho_pi * z_pi[None, None, None, :]
          + sigma_z[None, :, None, None] * eta[4][:, None, None, None])
    B_z = hat_basis(z, zn)                                  # (Q, i, j, b, n_j)
    pay = m.theta * nl1
    return dict(B_lam=B_lam, B_c=B_c, B_hz=B_hz, B_hzpi=B_hzpi,
                B_zpi=B_zpi, B_z=B_z, pay=pay)


def make_node_chain_T_gcy(model, grids: Sequence, nodes, log_weights,
                          interp: str = "post",
                          dtype: Optional[torch.dtype] = None,
                          chunk: Optional[int] = None, *,
                          device="cuda") -> Callable:
    """Log-space post/loglin-interpolation GCY operator as a node chain
    (six-state analogue of :func:`make_node_chain_T_ssy`; field order
    (l, k, i, y, j, b) = (h_lam, h_c, h_z, h_zpi, z, z_pi); ``chunk`` as
    there, where the JAX package takes min(Q, 16) nodes).

    Cost scales with the node count: Monte Carlo draws are the practical
    expectation at 6 states, where a d-degree tensor quadrature has d^6
    joint nodes.
    """
    if interp not in ("post", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    dev = resolve_device(device)
    dtype = dtype or _F64
    theta, beta = float(model.theta), float(model.beta)
    shapes = tuple(len(g) for g in grids)
    basis = node_basis_gcy(model, grids, nodes)
    Q = np.asarray(log_weights).shape[0]
    if chunk is None:
        chunk = _default_chunk(Q, int(np.prod(shapes)), dtype)
    stacks, logw = _node_stacks(
        [basis["B_lam"], basis["B_c"], basis["B_hz"], basis["B_hzpi"],
         basis["B_zpi"],
         # (Q, i, j, b, J) -> (Q, i, b, j, J): the chain's J step batches
         # over (node, i, b) with j as the left free dimension.
         basis["B_z"].permute(0, 1, 3, 2, 4).contiguous(),
         basis["pay"]], log_weights, chunk, dtype, dev)
    hg = _host_grids(grids)
    log_kappa = _log_kappa_gcy(model, hg[1][:, None], hg[4][None, :]).to(
        device=dev, dtype=dtype)                                  # (k, j)
    n_l, n_k, n_i, n_y, n_j, n_b = shapes
    ck = chunk

    def chain(field2, xs):
        # field2: (L, K*I*Y*J*B), shared by all nodes; batched matmuls
        # with leading batch dimensions, as in the SSY chain.
        b1, b2, b3, b4, b5, b6 = xs
        u = (b1.reshape(ck * n_l, n_l) @ field2).reshape(
            ck, n_l, n_k, n_i, n_y, n_j, n_b)
        u = u.permute(0, 2, 1, 3, 4, 5, 6).reshape(ck, n_k, -1)
        u = (b2 @ u).reshape(ck, n_k, n_l, n_i, n_y, n_j, n_b)
        u = u.permute(0, 3, 1, 2, 4, 5, 6).reshape(ck, n_i, -1)
        u = (b3 @ u).reshape(ck, n_i, n_k, n_l, n_y, n_j, n_b)
        u = u.permute(0, 4, 1, 2, 3, 5, 6).reshape(ck, n_y, -1)
        u = (b4 @ u).reshape(ck, n_y, n_i * n_k * n_l * n_j, n_b)
        # B (next z_pi; sigma_zpi conditioned on current y): batch (ck, y).
        u = (b5 @ u.transpose(-1, -2)).reshape(ck, n_y, n_b, n_i, n_k, n_l,
                                              n_j)
        # J (next z; mean and spread conditioned on current b, i): batch
        # (ck, i, b).
        u = u.permute(0, 3, 2, 1, 4, 5, 6).reshape(ck, n_i, n_b,
                                                   n_y * n_k * n_l, n_j)
        u = (b6 @ u.transpose(-1, -2)).reshape(ck, n_i, n_b, n_j, n_y, n_k,
                                              n_l)
        return u.permute(0, 6, 5, 1, 4, 3, 2)   # (ck, l, k, i, y, j, b)

    def T(ell):
        field, c = _field(ell, interp, dtype)
        lse = _lse_over_nodes(
            chain, field.reshape(n_l, n_k * n_i * n_y * n_j * n_b), stacks,
            logw, interp, c, theta, shapes, dtype, dev)
        log_kg = lse + log_kappa[None, :, None, None, :, None]
        return torch.log1p(beta * torch.exp(log_kg / theta))

    return T
