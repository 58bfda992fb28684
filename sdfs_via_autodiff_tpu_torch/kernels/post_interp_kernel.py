"""Post/loglin-interpolation SSY operator: a hand-written CUDA kernel.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py``.
Builds on the node-chain form (:mod:`..operators.post_interp`):
interpolation at a fixed shock node is a per-axis linear map of the
field, so grouping the four state axes as rows (h_lam, h_c) and columns
(h_z, z) of a matrix view turns each joint node's interpolant into two
dense matmuls,

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
is a TPU limit and has no counterpart here: the CUDA kernel streams the
stacks from device memory and L2.

:func:`post_interp_plain` is the function in plain PyTorch (the same
Kronecker formula); :func:`post_interp` dispatches a CPU tensor to it and
a CUDA tensor to the kernel in ``csrc/post_interp.cu`` (built from source
at first use), which replaces the TPU kernel ``_kernel``.  ``LAUNCHES``
counts its launches.  Monte Carlo nodes share no per-axis factors, so
they stay on the node chain.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..ops.quadrature import gauss_hermite_normal
from ..operators.post_interp import (_log_kappa_parts_ssy,
                                     make_node_chain_T_ssy, node_basis_ssy,
                                     ssy_quadrature_nodes)
from . import _build
from .fused_discrete import _check, _ptr

__all__ = ["LAUNCHES", "post_interp_operands_ssy", "shifted_inputs",
           "post_interp", "post_interp_plain",
           "make_post_interp_kernel_T_ssy"]

# Kernel launches since the last reset (the wrapper adds one per launch;
# the plain version never counts).
LAUNCHES = {"post_interp": 0}
_F32 = torch.float32
_INTERPS = {"loglin": 0, "post": 1}


def post_interp_operands_ssy(model, grids, quad_degree: int = 5) -> dict:
    """The kernel's operand stacks, float64 CPU tensors:

    * ``Wr`` (P12, R, R) = B_lam[q1] (x) B_c[q2] over row pairs
      p = (q1, q2), ``Wc`` (P34, C, C) = B_hz[q3] (*) B_z[q4] over column
      pairs q = (q3, q4) (R = n_l*n_k, C = n_i*n_j, P12 = P34 = d^2);
    * ``pay`` (P12, R): theta * h_lam' of row pair p at row (l, k);
    * ``off_base`` (P12, P34): the node pairs' log-weights;
    * ``lk_row`` (R,), ``lk_col`` (C,): log kappa = log A2[k] + log A3[j];
    * ``smax``: max(pay) + max(off_base), a Python float.
    """
    m = model
    n_l, n_k, n_i, n_j = (len(g) for g in grids)
    R, C = n_l * n_k, n_i * n_j
    d = quad_degree
    P12, P34 = d * d, d * d
    eta1, w1 = gauss_hermite_normal(d)
    basis = node_basis_ssy(m, grids, np.broadcast_to(eta1, (4, d)).copy())
    Wr = torch.einsum("alL,bkK->ablkLK", basis["B_lam"],
                      basis["B_c"]).reshape(P12, R, R)
    Wc = torch.einsum("aiI,bijJ->abijIJ", basis["B_hz"],
                      basis["B_z"]).reshape(P34, C, C)
    pay = basis["pay"][:, None, :, None].expand(d, d, n_l, n_k).reshape(
        P12, R)
    logw1 = torch.log(torch.as_tensor(np.asarray(w1, np.float64)))
    logw2 = (logw1[:, None] + logw1[None, :]).reshape(d * d)
    off_base = logw2[:, None] + logw2[None, :]
    log_A2, log_A3 = _log_kappa_parts_ssy(m, grids)
    lk_row = log_A2[None, :].expand(n_l, n_k).reshape(R)
    lk_col = log_A3[None, :].expand(n_i, n_j).reshape(C)
    return dict(Wr=Wr, Wc=Wc, pay=pay.contiguous(), off_base=off_base,
                lk_row=lk_row.contiguous(), lk_col=lk_col.contiguous(),
                smax=float(pay.max() + off_base.max()))


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


def _lib():
    lib = _build.load("post_interp")
    if not getattr(lib, "_sdfs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdfs_post_interp.argtypes = [p] * 11 + [i, i, i, i, f, f, i, p]
        lib.sdfs_post_interp.restype = i
        lib.sdfs_post_interp_error_string.argtypes = [i]
        lib.sdfs_post_interp_error_string.restype = ctypes.c_char_p
        lib._sdfs_typed = True
    return lib


def _post_interp_cuda(field, Wr, Wc, pay, off, s, lk_row, lk_col, theta,
                      beta, interp):
    R, C = field.shape
    P12, P34 = off.shape
    dev = field.device
    for name, t, shape in (("field", field, (R, C)), ("Wr", Wr, (P12, R, R)),
                           ("Wc", Wc, (P34, C, C)), ("pay", pay, (P12, R)),
                           ("off", off, (P12, P34)), ("s", s, (1,)),
                           ("lk_row", lk_row, (R,)),
                           ("lk_col", lk_col, (C,))):
        _check(name, t, dev, shape)
    post = _interp_flag(interp)
    g = torch.empty((P12, R, C), dtype=_F32, device=dev)
    part = torch.empty_like(g)
    out = torch.empty_like(field)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_post_interp(
            _ptr(field), _ptr(Wr), _ptr(Wc), _ptr(pay), _ptr(off), _ptr(s),
            _ptr(lk_row), _ptr(lk_col), _ptr(g), _ptr(part), _ptr(out), R, C,
            P12, P34, float(theta), float(beta), post,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"post-interp kernel launch failed: "
            f"{lib.sdfs_post_interp_error_string(rc).decode()} ({rc})")
    LAUNCHES["post_interp"] += 1
    return out


def post_interp(field, Wr, Wc, pay, off, s, lk_row, lk_col, theta: float,
                beta: float, interp: str):
    """One application on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`post_interp_plain`)."""
    if field.device.type == "cpu":
        return post_interp_plain(field, Wr, Wc, pay, off, s, lk_row, lk_col,
                                 theta, beta, interp)
    if field.device.type == "cuda":
        return _post_interp_cuda(field, Wr, Wc, pay, off, s, lk_row, lk_col,
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
    ops = post_interp_operands_ssy(model, grids, quad_degree)
    cast = lambda a: a.to(device=dev, dtype=_F32).contiguous()
    Wr, Wc, pay, off_base, lk_row, lk_col = (
        cast(ops[k]) for k in ("Wr", "Wc", "pay", "off_base", "lk_row",
                               "lk_col"))
    smax = ops["smax"]
    nodes, logw = ssy_quadrature_nodes(quad_degree)
    twin = make_node_chain_T_ssy(model, grids, nodes, logw, interp=interp,
                                 dtype=_F32, device=dev)

    def kernel_args(ell):
        field, off, s = shifted_inputs(ell.to(_F32), off_base, smax, theta,
                                       interp)
        return (field.reshape(R, C).contiguous(), Wr, Wc, pay, off, s,
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
        return _PostInterpT.apply(ell)

    T.twin = twin
    T.shapes = shapes
    T.kernel_args = kernel_args
    return T
