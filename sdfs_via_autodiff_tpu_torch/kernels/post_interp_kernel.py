"""Post/loglin-interpolation SSY operator: a hand-written CUDA kernel.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py``.
Builds on the node-chain form (:mod:`..operators.post_interp`):
interpolation at a fixed shock node is a per-axis linear map of the
field, so grouping the four state axes as rows (h_lam, h_c) and columns
(h_z, z) of a matrix view turns each joint node's interpolant into two
matmuls,

    V[(q1..q4)] = [B_lam[q1] (x) B_c[q2]]  F  [B_hz[q3] (*) B_z[q4]]^T,

with the row Kronecker products ``Wr`` (d^2, R, R) shared across all
column pairs and the column products ``Wc`` (d^2, C, C) carrying the
h_z conditioning of sigma_z.  One application accumulates
exp(theta*log V (or theta*V) + payoff + node log-weights) under one
global shift s = theta*min(ell) + max(payoff + log-weights): every term
is <= 1, so no per-node log-sum-exp passes are needed.  The range
requirement is the JAX kernel's: theta * range(log w) + range(theta
h_lam') + range(log weights) must fit float32's exponent range (~85 log
units; ~35 on standard SSY grids).  The JAX kernel's VMEM budget guard
is a TPU limit and has no counterpart here.

Each basis is a hat basis with at most two non-zeros per row, so the
kernel takes the per-axis corner tables (:func:`post_interp_corners_ssy`:
the lower corner index and the upper corner's weight per 1-D node and
current index) in place of the dense stacks, and forms each V as a
16-corner combination factored per axis.  Its arguments are
``(field, corners, pay, off, s, lk_row, lk_col, theta, beta, interp)``.

:func:`post_interp_plain` is the function in plain PyTorch on the dense
stacks (:func:`post_interp_operands_ssy`, the JAX kernel's operands);
:func:`post_interp_gather_plain` is the same function on the kernel's own
arguments, by the kernel's gather arithmetic.  :func:`post_interp`
dispatches a CPU tensor to the latter and a CUDA tensor to the kernel in
``csrc/post_interp.cu`` (built from source at first use), which replaces
the TPU kernel ``_kernel``.  ``LAUNCHES`` counts its launches.  Monte
Carlo nodes share no per-axis factors, so they stay on the node chain.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import refuse
from ..ops.quadrature import gauss_hermite_normal
from ..operators.post_interp import (_log_kappa_parts_ssy, _successors_ssy,
                                     make_node_chain_T_ssy, node_basis_ssy,
                                     node_corners_ssy, ssy_quadrature_nodes)
from . import _build
from .fused_discrete import _check, _ptr
from .streamed_two_phase import _GRID_Y_MAX, SMEM_LIMIT

__all__ = ["LAUNCHES", "post_interp_operands_ssy", "post_interp_corners_ssy",
           "device_corners", "shifted_inputs", "post_interp",
           "post_interp_plain", "post_interp_gather_plain",
           "post_interp_chunk", "make_post_interp_kernel_T_ssy"]

# Kernel launches since the last reset (the wrapper adds one per launch;
# the plain versions never count).
LAUNCHES = {"post_interp": 0}
_F32 = torch.float32
_INTERPS = {"loglin": 0, "post": 1}
# The corner tables in the kernel's argument order.
CORNER_KEYS = ("lo_lam", "t_lam", "lo_c", "t_c", "lo_hz", "t_hz", "lo_z",
               "t_z")
# The .cu's shared-memory aim for one block (kGBudget).
_G_BUDGET = 48 * 1024


def _axis_nodes(quad_degree: int) -> np.ndarray:
    """The 1-D Gauss-Hermite nodes as the (4, d) node set of the per-axis
    bases (axis a takes row a)."""
    eta1, _ = gauss_hermite_normal(quad_degree)
    return np.broadcast_to(eta1, (4, quad_degree)).copy()


def _small_operands(model, grids, quad_degree: int) -> dict:
    """``pay``, ``off_base``, ``lk_row``, ``lk_col`` and ``smax`` of
    :func:`post_interp_operands_ssy` (float64 CPU tensors)."""
    m = model
    n_l, n_k, n_i, n_j = (len(g) for g in grids)
    R, C = n_l * n_k, n_i * n_j
    d = quad_degree
    _, (nl1, _, _, _) = _successors_ssy(m, grids, _axis_nodes(d))
    pay = (m.theta * nl1)[:, None, :, None].expand(d, d, n_l, n_k).reshape(
        d * d, R)
    _, w1 = gauss_hermite_normal(d)
    logw1 = torch.log(torch.as_tensor(np.asarray(w1, np.float64)))
    logw2 = (logw1[:, None] + logw1[None, :]).reshape(d * d)
    off_base = logw2[:, None] + logw2[None, :]
    log_A2, log_A3 = _log_kappa_parts_ssy(m, grids)
    lk_row = log_A2[None, :].expand(n_l, n_k).reshape(R)
    lk_col = log_A3[None, :].expand(n_i, n_j).reshape(C)
    return dict(pay=pay.contiguous(), off_base=off_base,
                lk_row=lk_row.contiguous(), lk_col=lk_col.contiguous(),
                smax=float(pay.max() + off_base.max()))


def post_interp_operands_ssy(model, grids, quad_degree: int = 5) -> dict:
    """The JAX kernel's operand stacks, float64 CPU tensors:

    * ``Wr`` (P12, R, R) = B_lam[q1] (x) B_c[q2] over row pairs
      p = (q1, q2), ``Wc`` (P34, C, C) = B_hz[q3] (*) B_z[q4] over column
      pairs q = (q3, q4) (R = n_l*n_k, C = n_i*n_j, P12 = P34 = d^2);
    * ``pay`` (P12, R): theta * h_lam' of row pair p at row (l, k);
    * ``off_base`` (P12, P34): the node pairs' log-weights;
    * ``lk_row`` (R,), ``lk_col`` (C,): log kappa = log A2[k] + log A3[j];
    * ``smax``: max(pay) + max(off_base), a Python float.
    """
    n_l, n_k, n_i, n_j = (len(g) for g in grids)
    R, C = n_l * n_k, n_i * n_j
    P = quad_degree ** 2
    basis = node_basis_ssy(model, grids, _axis_nodes(quad_degree))
    Wr = torch.einsum("alL,bkK->ablkLK", basis["B_lam"],
                      basis["B_c"]).reshape(P, R, R)
    Wc = torch.einsum("aiI,bijJ->abijIJ", basis["B_hz"],
                      basis["B_z"]).reshape(P, C, C)
    return dict(Wr=Wr, Wc=Wc, **_small_operands(model, grids, quad_degree))


def post_interp_corners_ssy(model, grids, quad_degree: int = 5) -> dict:
    """The kernel's per-axis corner tables (CPU tensors, built in float64):
    for each axis a in ("lam", "c", "hz", "z") the lower corner index
    ``lo_<a>`` (int64) and the upper corner's weight ``t_<a>`` (float64)
    over the d 1-D nodes: (d, n_l), (d, n_k), (d, n_i) and (d, n_i, n_j)
    (z conditioned on the current h_z index).  They hold exactly the
    non-zeros of the per-axis bases behind ``Wr`` and ``Wc``
    (``continuous_common.hat_from_corners`` rebuilds them)."""
    return node_corners_ssy(model, grids, _axis_nodes(quad_degree))


def device_corners(corners: dict, device) -> tuple:
    """The corner tables as the kernel takes them: a tuple in
    ``CORNER_KEYS`` order, indices int32 and weights float32 on
    ``device``."""
    return tuple(
        corners[k].to(device=device, dtype=torch.int32 if k.startswith("lo")
                      else _F32).contiguous() for k in CORNER_KEYS)


def shifted_inputs(ell, off_base, smax: float, theta: float, interp: str):
    """The kernel's per-call inputs on the field ``ell`` (any shape):
    ``(field, off, s)`` with the one global shift s = theta*min(ell) +
    smax (every exponent is <= 0: theta < 0 and the interpolant is a
    convex combination of field values), field = exp(ell - max ell) and
    off = off_base + theta*max(ell) - s for "post", field = ell and
    off = off_base - s for "loglin"; s has shape (1,)."""
    s = theta * torch.amin(ell) + smax
    if interp == "post":
        c = torch.amax(ell)
        return torch.exp(ell - c), off_base + (theta * c - s), s.reshape(1)
    return ell, off_base - s, s.reshape(1)


def post_interp_plain(field, Wr, Wc, pay, off, s, lk_row, lk_col,
                      theta: float, beta: float, interp: str):
    """One application on the (R, C) view ``field`` (exp(ell - max ell)
    for "post", ell for "loglin"): ``off`` (P12, P34) already carries the
    shift terms and ``s`` (1,) is added back after the log."""
    post = _interp_flag(interp)
    G = torch.matmul(Wr, field)                             # (P12, R, C)
    acc = torch.zeros_like(field)
    for q in range(Wc.shape[0]):
        V = torch.matmul(G, Wc[q].mT)                       # (P12, R, C)
        a = theta * (torch.log(V) if post else V)
        acc = acc + torch.exp(a + pay[:, :, None]
                              + off[:, q, None, None]).sum(dim=0)
    log_kg = torch.log(acc) + s + lk_row[:, None] + lk_col[None, :]
    return torch.log1p(beta * torch.exp(log_kg / theta))


def _interp_flag(interp: str) -> int:
    if interp not in _INTERPS:
        raise ValueError(f"unknown interp {interp!r}")
    return _INTERPS[interp]


def _corner_shapes(corners) -> tuple:
    """(n_l, n_k, n_i, n_j, d) of a corner-table tuple."""
    d, n_l = corners[0].shape
    n_i, n_j = corners[6].shape[1], corners[6].shape[2]
    return n_l, corners[2].shape[1], n_i, n_j, d


def _hat(lo, t, n: int):
    """(lower index, upper index, lower weight, upper weight) of a corner
    table on an n-point axis, as the kernel forms them."""
    lo = lo.long()
    return lo, torch.clamp(lo + 1, max=n - 1), 1.0 - t, t


def post_interp_gather_plain(field, corners, pay, off, s, lk_row, lk_col,
                             theta: float, beta: float, interp: str):
    """One application on the kernel's own arguments, by its arithmetic:
    G_p = the weighted 2 x 2 (h_lam, h_c) corner rows of ``field`` (R, C)
    per row pair p, then per column pair q the weighted 2 x 2 (h_z, z)
    corners of G_p, the power, the payoff and log-weights and the
    exp-sum, and the epilogue (``off`` and ``s`` as in
    :func:`post_interp_plain`)."""
    post = _interp_flag(interp)
    n_l, n_k, n_i, n_j, d = _corner_shapes(corners)
    R, C, P = n_l * n_k, n_i * n_j, d * d
    La, Lb, wl0, wl1 = _hat(corners[0], corners[1], n_l)        # (d, n_l)
    Ka, Kb, wk0, wk1 = _hat(corners[2], corners[3], n_k)        # (d, n_k)
    Ia, Ib, wi0, wi1 = _hat(corners[4], corners[5], n_i)        # (d, n_i)
    Ja, Jb, wj0, wj1 = _hat(corners[6], corners[7], n_j)        # (d, i, j)
    F = field.reshape(n_l, n_k, C)
    row = lambda x: x[:, None, :, None]                    # (q1, ., l, .)
    col = lambda x: x[None, :, None, :]                    # (., q2, ., k)
    G = 0.0
    for L, wl in ((La, wl0), (Lb, wl1)):
        for K, wk in ((Ka, wk0), (Kb, wk1)):
            G = G + (row(wl) * col(wk))[..., None] * F[row(L), col(K)]
    G = G.reshape(P, R, C)
    acc = torch.zeros_like(field)
    corner = lambda I, J: (I[:, None, :, None] * n_j + J[None]).reshape(P, C)
    weight = lambda wi, wj: (wi[:, None, :, None] * wj[None]).reshape(P, C)
    cols = [(corner(I, J), weight(wi, wj))
            for I, wi in ((Ia, wi0), (Ib, wi1))
            for J, wj in ((Ja, wj0), (Jb, wj1))]
    for q in range(P):
        V = 0.0
        for idx, w in cols:
            V = V + w[q] * G[:, :, idx[q]]                 # (P, R, C)
        a = theta * (torch.log(V) if post else V)
        acc = acc + torch.exp(a + pay[:, :, None]
                              + off[:, q, None, None]).sum(dim=0)
    log_kg = torch.log(acc) + s + lk_row[:, None] + lk_col[None, :]
    return torch.log1p(beta * torch.exp(log_kg / theta))


def post_interp_chunk(C: int, P: int) -> Optional[int]:
    """Row pairs per shared-memory chunk of one kernel block (mirrors the
    .cu): the most whose G (C columns, odd stride), payoffs and
    log-weights stay within 48 KB, else the most that fit a block;
    None when not even one fits."""
    for limit in (_G_BUDGET, SMEM_LIMIT):
        for pc in range(P, 0, -1):
            if 4 * (C * (pc | 1) + pc + pc * P) <= limit:
                return pc
    return None


def _lib():
    lib = _build.load("post_interp")
    if not getattr(lib, "_sdfs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdfs_post_interp.argtypes = [p] * 15 + [i] * 5 + [f, f, i, p]
        lib.sdfs_post_interp.restype = i
        lib.sdfs_post_interp_error_string.argtypes = [i]
        lib.sdfs_post_interp_error_string.restype = ctypes.c_char_p
        lib._sdfs_typed = True
    return lib


def _post_interp_cuda(field, corners, pay, off, s, lk_row, lk_col, theta,
                      beta, interp):
    post = _interp_flag(interp)
    if len(corners) != len(CORNER_KEYS) or corners[6].ndim != 3:
        raise ValueError(f"corners must be the {len(CORNER_KEYS)} tables "
                         f"{CORNER_KEYS}")
    n_l, n_k, n_i, n_j, d = _corner_shapes(corners)
    R, C, P = n_l * n_k, n_i * n_j, d * d
    dev = field.device
    table_shapes = ((d, n_l), (d, n_k), (d, n_i), (d, n_i, n_j))
    for k, (name, t) in enumerate(zip(CORNER_KEYS, corners)):
        _check(name, t, dev, table_shapes[k // 2],
               torch.int32 if k % 2 == 0 else _F32)
    for name, t, shape in (("field", field, (R, C)), ("pay", pay, (P, R)),
                           ("off", off, (P, P)), ("s", s, (1,)),
                           ("lk_row", lk_row, (R,)),
                           ("lk_col", lk_col, (C,))):
        _check(name, t, dev, shape)
    if post_interp_chunk(C, P) is None or R > _GRID_Y_MAX:
        raise ValueError(f"post-interp kernel with {R} rows and {C} columns "
                         "exceeds shared memory or the grid")
    out = torch.empty_like(field)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_post_interp(
            _ptr(field), *(_ptr(t) for t in corners), _ptr(pay), _ptr(off),
            _ptr(s), _ptr(lk_row), _ptr(lk_col), _ptr(out), n_l, n_k, n_i,
            n_j, d, float(theta), float(beta), post, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"post-interp kernel launch failed: "
            f"{lib.sdfs_post_interp_error_string(rc).decode()} ({rc})")
    LAUNCHES["post_interp"] += 1
    return out


def post_interp(field, corners, pay, off, s, lk_row, lk_col, theta: float,
                beta: float, interp: str):
    """One application on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`post_interp_gather_plain`)."""
    if field.device.type == "cpu":
        return post_interp_gather_plain(field, corners, pay, off, s, lk_row,
                                        lk_col, theta, beta, interp)
    if field.device.type == "cuda":
        return _post_interp_cuda(field, corners, pay, off, s, lk_row, lk_col,
                                 theta, beta, interp)
    raise ValueError(f"no post-interp kernel for device {field.device}")


def make_post_interp_kernel_T_ssy(model, grids, quad_degree: int = 5,
                                  interp: str = "post", *,
                                  device="cuda") -> Callable:
    """Post/loglin-interpolation SSY operator through the kernel (float32
    tier) on ``device``.

    Maps ell = log w -> log T(w).  The returned ``T`` is a
    ``torch.autograd.Function``: its forward-mode tangent (``jvp``) and
    its gradient go through ``T.twin``, the float32 node chain over the
    same quadrature nodes, as the JAX package's custom JVP goes through
    its XLA twin.  ``T.kernel_args(ell)`` is the argument tuple that
    ``T(ell)`` hands to :func:`post_interp`.
    """
    _interp_flag(interp)
    dev = resolve_device(device)
    theta, beta = float(model.theta), float(model.beta)
    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    R, C = n_l * n_k, n_i * n_j
    ops = _small_operands(model, grids, quad_degree)
    cast = lambda a: a.to(device=dev, dtype=_F32).contiguous()
    pay, off_base, lk_row, lk_col = (
        cast(ops[k]) for k in ("pay", "off_base", "lk_row", "lk_col"))
    smax = ops["smax"]
    corners = device_corners(
        post_interp_corners_ssy(model, grids, quad_degree), dev)
    nodes, logw = ssy_quadrature_nodes(quad_degree)
    twin = make_node_chain_T_ssy(model, grids, nodes, logw, interp=interp,
                                 dtype=_F32, device=dev)

    def kernel_args(ell):
        field, off, s = shifted_inputs(ell.to(_F32), off_base, smax, theta,
                                       interp)
        return (field.reshape(R, C).contiguous(), corners, pay, off, s,
                lk_row, lk_col, theta, beta, interp)

    def primal(ell):
        return post_interp(*kernel_args(ell)).reshape(shapes)

    class _PostInterpT(torch.autograd.Function):
        @staticmethod
        def forward(ell):
            return primal(ell)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0])
            ctx.save_for_backward(inputs[0])

        @staticmethod
        def jvp(ctx, dell):
            (ell,) = ctx.saved_tensors
            return torch.func.jvp(twin, (ell,), (dell,))[1]

        @staticmethod
        def backward(ctx, grad):
            (ell,) = ctx.saved_tensors
            with torch.enable_grad():
                x = ell.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(twin(x), x, grad)
            return g

    def T(ell):
        refuse(ell, "make_post_interp_kernel_T_ssy's operator")
        return _PostInterpT.apply(ell)

    T.twin = twin
    T.shapes = shapes
    T.kernel_args = kernel_args
    return T
