"""Fused two-matmul log-space operator: a hand-written CUDA kernel.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/fused_discrete.py``.  The
factored operators are chains of skinny per-axis matmuls; grouping the
axes into rows and columns re-associates each chain into two dense
contractions of the (rows, cols) field,

    u = M1 @ v @ M2^T

(discrete SSY: M1 = kron(B_lam, Q_c), M2 = kron(Q_hz, z_P); continuous
SSY: M2 composes the h_z and conditional-z expectation matrices;
discrete GCY: triple Kronecker products per group; continuous GCY: M2
composes the four conditioned column axes), with per-step
log-sum-exp shifts around both products:

    p = theta*ell - sub;  sh1 = max over rows of p (per column)
    log u = sh1 + log(M1 @ exp(p - sh1));  sh2 = max over columns (per row)
    log T = log1p(beta * exp((sh2 + log(exp(log u - sh2) @ M2T) + kap) / theta))

:func:`fused_T_plain` is that function in plain PyTorch;
:func:`fused_T` dispatches a CPU tensor to it and a CUDA tensor to the
kernel in ``csrc/fused_two_matmul.cu`` (built from source at first use),
which replaces the TPU kernel ``_fused_kernel``.  The whole-solve
kernels over the same operator live in :mod:`.solver_kernel` (SA) and
:mod:`.anderson_kernel` (Anderson).  ``LAUNCHES`` counts the three
kernels' launches.

The operands must fit the card's L2 cache beside the field's working
set: the kernels sweep every operand once per application, and a 40^4
grid (10 MB per operand) raises ``ValueError`` as the JAX package's VMEM
guard does.  Larger grids belong to the streamed tier.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..config import resolve_device
from ..ops.dtensor import refuse
from ..ops.tangent import linearizable, log1p_epilogue, lse_step, viewed
from ..models.ssy import SSY
from ..operators.continuous_common import expectation_matrix
from ..operators.continuous_ssy import (_gauss_hermite, _host_grids,
                                        _log_kappa_ssy)
from ..operators.discrete_gcy import _gcy_factors
from ..operators.discrete_ssy import SSYDiscretization, _ssy_factors
from . import _build

__all__ = ["LAUNCHES", "L2_BYTES_H100", "fused_T", "fused_T_plain",
           "kron_operands_ssy", "kron_operands_ssy_continuous",
           "kron_operands_gcy", "kron_operands_gcy_continuous",
           "fused_layout",
           "make_fused_T_from_operands", "make_xla_T_from_operands",
           "make_fused_T_log_ssy", "make_fused_T_log_ssy_continuous",
           "make_fused_T_log_gcy", "make_fused_T_log_gcy_continuous"]

# Kernel launches since the last reset (the wrappers add one per launch;
# the plain versions never count).
LAUNCHES = {"fused_T": 0, "fused_sa": 0, "fused_anderson": 0}

# The H100's L2 cache (50 MiB); the size guard reads the card's own value
# when the operator lives on one.
L2_BYTES_H100 = 50 * 1024 * 1024
# Kernel modes of sdfs_fused_solve (mirroring the .cu).
ALGO_APPLY, ALGO_SA, ALGO_AA = 0, 1, 2
MAX_HISTORY = 8
# The kernel's tiling (mirroring the .cu): threads per block (kThreads),
# tile columns (kBN), the tallest tile (kMaxBM), the chunked layout's tile
# rows and K-chunk (kChunkBM, kChunkK), the tile's sums (kPartFloats),
# the static shared memory (sizeof(Smem)), a block's shared-memory limit
# (kSmemLimit) and the H100's SM count (what sm_count reads on the card).
_THREADS, _TILE_COLS, _MAX_BM, _CHUNK_BM, _CHUNK_K = 256, 32, 64, 32, 256
_PART_FLOATS, _STATIC_SMEM, _SMEM_LIMIT = 64 * 32, 3744, 232_448
SMS_H100 = 132
_F32 = torch.float32


# ------------------------------------------------------- operand sets

def kron_operands_ssy(model: SSY, disc: SSYDiscretization,
                      dtype: torch.dtype = _F32):
    """(M1, M2T, log_kappa) for the kron-form contraction, as ``dtype``
    CPU tensors.

    log_kappa[(l k), (i j)] = log A2[k] + log A3[i, j] broadcast to the
    matrix view of the state space.
    """
    B_lam, A2, A3 = _ssy_factors(model, disc)
    n_l, n_k, n_i, n_j = disc.shapes
    M1 = torch.kron(B_lam, disc.h_c_Q)
    M2 = torch.kron(disc.h_z_Q, disc.z_P)
    log_kap = (torch.log(A2)[None, :, None, None]
               + torch.log(A3)[None, None, :, :]
               + torch.zeros((n_l, 1, 1, 1), dtype=torch.float64))
    log_kap = log_kap.expand(disc.shapes).reshape(n_l * n_k, n_i * n_j)
    return (M1.to(dtype), M2.T.contiguous().to(dtype),
            log_kap.contiguous().to(dtype))


def kron_operands_ssy_continuous(model: SSY, grids, degree: int = 5,
                                 dtype: torch.dtype = _F32):
    """(M1, M2T, log_kappa) for the *continuous* factored operator
    (quadrature, pre-power interpolation) in the same two-matmul form, as
    ``dtype`` CPU tensors computed in float64 from the grids' values.

    M1 = kron(P_lam, P_c); the (h_z, z) block composes the h_z expectation
    matrix with the (i, j)-conditional z expectation matrix into one dense
    (n_i*n_j, n_i*n_j) operand C[(i,j),(i',j')] = P_hz[i,i'] * P_z[i,j,j'].
    """
    theta = model.theta
    m = model
    h_lam_grid, h_c_grid, h_z_grid, z_grid = _host_grids(grids)
    eta, omega = _gauss_hermite(degree)
    P_lam = expectation_matrix(h_lam_grid, m.rho_lam * h_lam_grid, m.s_lam,
                               eta, omega,
                               payoff=lambda xn: torch.exp(theta * xn))
    P_c = expectation_matrix(h_c_grid, m.rho_c * h_c_grid, m.s_c, eta, omega)
    P_hz = expectation_matrix(h_z_grid, m.rho_z * h_z_grid, m.s_z, eta, omega)
    sigma_z = m.phi_z * torch.exp(h_z_grid)
    P_z = expectation_matrix(z_grid,
                             (m.rho * z_grid).expand(len(h_z_grid),
                                                     len(z_grid)),
                             sigma_z[:, None], eta, omega)
    n_i, n_j = len(h_z_grid), len(z_grid)
    C = P_hz[:, None, :, None] * P_z[:, :, None, :]       # (i, j, i', j')
    M1 = torch.kron(P_lam, P_c)
    M2T = C.reshape(n_i * n_j, n_i * n_j).T
    n_l, n_k = len(h_lam_grid), len(h_c_grid)
    log_kap = _log_kappa_ssy(m, h_c_grid[:, None], z_grid[None, :])  # (k, j)
    full = log_kap[None, :, None, :].expand(n_l, n_k, n_i, n_j)
    return (M1.to(dtype), M2T.contiguous().to(dtype),
            full.reshape(n_l * n_k, n_i * n_j).contiguous().to(dtype))


def kron_operands_gcy(model, disc, dtype: torch.dtype = _F32):
    """(M1, M2T, log_kappa) for the discrete GCY operator in two-matmul
    form: rows group (z, z_pi, h_z), columns group (h_c, h_zpi, h_lam).

    All conditional chains share their transition matrices, so both
    groups are pure Kronecker products:  M1 = zP (x) zpiP (x) Qhz,
    M2 = Qc (x) Qhzpi (x) B_lam.
    """
    B_lam, A2, A3 = _gcy_factors(model, disc)
    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    M1 = torch.kron(disc.z_P, torch.kron(disc.z_pi_P, disc.h_z_Q))
    M2 = torch.kron(disc.h_c_Q, torch.kron(disc.h_zpi_Q, B_lam))
    # log kappa over (a,b,c,d,e,l): A2 over d, A3 over (a,b,c,e).
    log_kap = (torch.log(A2)[None, None, None, :, None, None]
               + torch.log(A3)[:, :, :, None, :, None]
               + torch.zeros((1, 1, 1, 1, 1, n_l), dtype=torch.float64))
    log_kap = log_kap.expand(disc.shapes).reshape(n_a * n_b * n_c,
                                                  n_d * n_e * n_l)
    return (M1.to(dtype), M2.T.contiguous().to(dtype),
            log_kap.contiguous().to(dtype))


def kron_operands_gcy_continuous(model, grids, degree: int = 5,
                                 baseline=None, dtype: torch.dtype = _F32):
    """(M1, M2T, log_kappa, shapes, rows, cols, sub) for the *continuous*
    GCY factored operator (quadrature, pre-power interpolation) in
    two-matmul form, computed in float64 from the grids' values; the
    matrices are ``dtype`` CPU tensors.

    Grid order (l, k, i, y, j, b) = (h_lam, h_c, h_z, h_zpi, z, z_pi):
    rows group (l, k); the column group holds all four conditioned axes —
    z' conditions on (h_z, z, z_pi) and z_pi' on (h_zpi, z_pi) — so the
    column operand is the dense composition

        D[(i,y,j,b), (I,Y,J,B)] =
            P_hz[i,I] P_hzpi[y,Y] P_zpi[y,b,B] P_z[i,j,b,J],

    O((n_i n_y n_j n_b)^2) memory: a small-grid form (~6-7 points per
    axis).  ``baseline`` ("loglinear" or ``(const, profiles)``; strongly
    recommended for float32, where theta * log-w range is ~200 on these
    grids) folds a separable baseline into the P matrices before
    composing; ``sub`` is then theta * ell0 as a (rows, cols) operand and
    log_kappa carries + theta * ell0 (else ``sub`` is None).
    """
    from ..operators.continuous_gcy import (_factored_arrays_gcy,
                                            _log_kappa_gcy)

    m = model
    theta = m.theta
    arrs = _factored_arrays_gcy(m, grids, degree, baseline)
    n_l, n_k, n_i, n_y, n_j, n_b = (len(g) for g in grids)
    shapes = (n_l, n_k, n_i, n_y, n_j, n_b)
    rows, cols = n_l * n_k, n_i * n_y * n_j * n_b
    D = torch.einsum("iI,yY,ybB,ijbJ->iyjbIYJB", arrs["P_hz"],
                     arrs["P_hzpi"], arrs["P_zpi"],
                     arrs["P_z"]).reshape(cols, cols)
    M1 = torch.kron(arrs["P_lam"], arrs["P_c"])
    # log kappa(h_c, z) is additively separable: the row part carries its
    # h_c-dependence relative to h_c = 0, the column part the rest.
    _, h_c_g, _, _, z_g, _ = _host_grids(grids)
    zero = torch.zeros((), dtype=torch.float64)
    log_A2 = _log_kappa_gcy(m, h_c_g, zero) - _log_kappa_gcy(m, zero, zero)
    log_A3 = _log_kappa_gcy(m, zero, z_g)
    kap = ((torch.zeros((n_l, 1), dtype=torch.float64)
            + log_A2[None, :]).reshape(rows, 1)
           + log_A3[None, None, :, None].expand(n_i, n_y, n_j, n_b)
           .reshape(1, cols))
    sub = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = arrs["ell0_parts"]
        row0 = phi_l[:, None] + phi_k[None, :]
        col0 = (const0 + phi_i[:, None, None, None]
                + phi_y[None, :, None, None] + phi_j[None, None, :, None]
                + phi_b[None, None, None, :])
        sub = torch.as_tensor(theta * (row0.reshape(rows, 1)
                                       + col0.reshape(1, cols)))
        kap = kap + sub
    cast = lambda a: None if a is None else a.contiguous().to(dtype)
    return (cast(M1), cast(D.T), cast(kap), shapes, rows, cols, cast(sub))


# ------------------------------------------------------- size guard

def l2_bytes(device: torch.device) -> int:
    """L2 cache bytes of the card ``device`` names, the H100's for a
    CPU device (where the plain versions run)."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).L2_cache_size)
    return L2_BYTES_H100


def check_working_set(shapes, rows: int, cols: int, fields: int,
                      device: torch.device, what: str) -> None:
    """Raise ``ValueError`` when ``fields`` float32 (rows, cols) fields
    plus the two operands M1 (rows, rows) and M2T (cols, cols) exceed the
    card's L2 cache.  (The kernels would still run, but every sweep of
    the operands would go to device memory; such grids belong to the
    streamed tier.)"""
    working = (rows * cols * fields + rows * rows + cols * cols) * 4
    limit = l2_bytes(device)
    if working > limit:
        raise ValueError(
            f"state space {tuple(shapes)} needs ~{working / 2**20:.1f} MiB "
            f"for {what}, beyond the card's {limit / 2**20:.0f} MiB L2 "
            "cache; use the factored or streamed operator for grids this "
            "large")


# --------------------------------------------------------- the tiling

def _smem_bytes(bm: int, kc1: int, kc2: int) -> int:
    """Dynamic shared memory of one block (mirrors the .cu's
    fused_smem_floats): M1 rows k-major (row stride bm + 4 or bm + 8,
    whichever is 4 mod 8), M2T columns,
    the staged field operand and the split-K partial sums."""
    bms = bm + 4 if (bm + 4) % 8 == 4 else bm + 8
    return 4 * (kc1 * bms + kc2 * _TILE_COLS
                + max(kc1 * _TILE_COLS, kc2 * bms) + _PART_FLOATS)


def fused_layout(R: int, C: int, sms: int = SMS_H100) -> dict:
    """The fused kernel's tiling of (R, C) fields on ``sms`` SMs, as its
    launcher chooses (mirrors the .cu's ``tiling``): tiles of ``bm`` rows
    by 32 columns, ``bm`` the smallest multiple of 4 (at most 64) that
    leaves at most one tile per SM, with the block's M1 rows and M2T
    columns resident in shared memory when they fit ("resident": one
    block per tile, the same tile in every iteration); else 32-row tiles
    over the grid with both operands staged in K-chunks of 256
    ("chunked").  Keys: bm, resident, n_rt, n_ct, n_tiles, smem (dynamic
    bytes), kc1, kc2, product_threads (4 x 2 outputs each, one fmaf
    chain over k in order per output)."""
    n_ct = -(-C // _TILE_COLS)
    for bm in range(4, _MAX_BM + 1, 4):
        n_rt = -(-R // bm)
        if n_rt * n_ct > sms:
            continue
        smem = _smem_bytes(bm, R, C)
        if smem > _SMEM_LIMIT - _STATIC_SMEM:
            break
        return dict(bm=bm, resident=True, n_rt=n_rt, n_ct=n_ct,
                    n_tiles=n_rt * n_ct, smem=smem, kc1=R, kc2=C,
                    product_threads=4 * bm)
    n_rt = -(-R // _CHUNK_BM)
    return dict(bm=_CHUNK_BM, resident=False, n_rt=n_rt, n_ct=n_ct,
                n_tiles=n_rt * n_ct,
                smem=_smem_bytes(_CHUNK_BM, _CHUNK_K, _CHUNK_K),
                kc1=_CHUNK_K, kc2=_CHUNK_K, product_threads=4 * _CHUNK_BM)


# --------------------------------------------------------- the kernel

def fused_T_plain(ell, M1, M2T, log_kap, sub, theta: float, beta: float,
                  tape=None):
    """One application on the (rows, cols) field ``ell``; ``sub`` (rows,
    cols) or None.  The shifts are constants of the tangent (detached),
    as the JAX package's custom JVP treats them.  ``tape``
    (``ops/tangent.Tape``) records the tangent-linear: the two matmuls,
    each between its stage's factors."""
    p = theta * ell
    if tape is not None:
        tape.scale(theta)
    if sub is not None:
        p = p - sub
    log_u = lse_step(p, torch.amax(p, dim=0, keepdim=True).detach(),
                     lambda t: torch.matmul(M1, t), tape)
    log_hwt = lse_step(log_u, torch.amax(log_u, dim=1, keepdim=True).detach(),
                       lambda t: torch.matmul(t, M2T), tape) + log_kap
    return log1p_epilogue(log_hwt, theta, beta, tape)


def _lib():
    lib = _build.load("fused_two_matmul")
    if not getattr(lib, "_sdfs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdfs_fused_work_floats.argtypes = [i, i, i, i]
        lib.sdfs_fused_work_floats.restype = ctypes.c_longlong
        lib.sdfs_fused_solve.argtypes = [i, p, p, p, p, p, p, p, p, p, p,
                                         i, i, f, f, f, i, i, i, f, f, p]
        lib.sdfs_fused_solve.restype = i
        lib.sdfs_fused_tiling.argtypes = [i, i, p]
        lib.sdfs_fused_tiling.restype = i
        lib.sdfs_fused_error_string.argtypes = [i]
        lib.sdfs_fused_error_string.restype = ctypes.c_char_p
        lib._sdfs_typed = True
    return lib


def _check(name: str, t: torch.Tensor, device, shape, dtype=_F32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype)[6:]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch(algo: int, ell0, M1, M2T, log_kap, sub, theta: float,
           beta: float, tol: float = 0.0, max_iter: int = 1,
           history: int = 1, mixing_frequency: int = 1,
           beta_aa: float = 1.0, ridge: float = 0.0):
    """One cooperative launch of ``sdfs_fused_solve`` on CUDA tensors:
    returns (out, iters (1,) int32, err (1,) float32).  The wrapper
    allocates the output, the scratch (midway field, ping-pong buffer,
    partial maxima and sums, and for Anderson the X/F rings) and the
    zeroed grid-barrier counters."""
    R, C = ell0.shape
    dev = ell0.device
    _check("ell", ell0, dev, (R, C))
    _check("M1", M1, dev, (R, R))
    _check("M2T", M2T, dev, (C, C))
    _check("log_kap", log_kap, dev, (R, C))
    if sub is not None:
        _check("sub", sub, dev, (R, C))
    lib = _lib()
    with torch.cuda.device(dev):
        n_work = int(lib.sdfs_fused_work_floats(algo, R, C, history))
    if n_work < 0:
        raise RuntimeError("fused kernel: cannot query the device")
    work = torch.empty(n_work, dtype=_F32, device=dev)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty_like(ell0)
    iters = torch.zeros(1, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_fused_solve(
            algo, _ptr(ell0), _ptr(M1), _ptr(M2T), _ptr(log_kap), _ptr(sub),
            _ptr(out), _ptr(work), _ptr(sync), _ptr(iters), _ptr(err), R, C,
            float(theta), float(beta), float(tol), int(max_iter),
            int(history), int(mixing_frequency), float(beta_aa),
            float(ridge), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fused kernel launch failed: "
            f"{lib.sdfs_fused_error_string(rc).decode()} ({rc})")
    return out, iters, err


def fused_T(ell, M1, M2T, log_kap, sub, theta: float, beta: float):
    """One application on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`fused_T_plain`)."""
    if ell.device.type == "cpu":
        return fused_T_plain(ell, M1, M2T, log_kap, sub, theta, beta)
    if ell.device.type == "cuda":
        out, _, _ = launch(ALGO_APPLY, ell, M1, M2T, log_kap, sub, theta,
                           beta)
        LAUNCHES["fused_T"] += 1
        return out
    raise ValueError(f"no fused kernel for device {ell.device}")


# --------------------------------------------------------- operators

def _device_operands(M1, M2T, log_kap, sub, dtype, dev):
    cast = lambda a: (None if a is None else torch.as_tensor(a).to(
        device=dev, dtype=dtype).contiguous())
    return cast(M1), cast(M2T), cast(log_kap), cast(sub)


def make_xla_T_from_operands(M1, M2T, log_kap, theta, beta, shapes,
                             rows, cols, dtype: torch.dtype = _F32,
                             sub=None, *, device="cuda") -> Callable:
    """Two-matmul log-space T in plain PyTorch (no kernel, no size cap):
    the same math as the fused kernel, differentiable by ``torch.func``
    and ``torch.autograd``.  It is the fused operator's twin (its tangent
    and gradient; ``T.linearize(x)`` is Newton's tangent-linear).
    ``sub`` (rows, cols), as the kernel takes it, is an extension of the
    JAX function, which has none."""
    dev = resolve_device(device)
    M1, M2T, log_kap, sub = _device_operands(M1, M2T, log_kap, sub, dtype,
                                             dev)
    theta, beta = float(theta), float(beta)
    shapes = tuple(shapes)

    @linearizable
    def T(ell, tape=None):
        ell_mat = viewed(ell, lambda t: t.reshape(rows, cols).to(dtype), tape)
        out = fused_T_plain(ell_mat, M1, M2T, log_kap, sub, theta, beta,
                            tape)
        return viewed(out, lambda t: t.reshape(shapes), tape)
    return T


def make_fused_T_from_operands(M1, M2T, log_kap, theta, beta, shapes,
                               rows, cols, dtype: torch.dtype = _F32,
                               sub=None, *, device="cuda") -> Callable:
    """Fused two-matmul log-space T from prebuilt operands (float32).

    One application is one launch of the CUDA kernel on a CUDA device
    (its plain version on the CPU).  The returned ``T`` is a
    ``torch.autograd.Function``: its forward-mode tangent (``jvp``) and
    its reverse-mode gradient go through ``T.twin``
    (:func:`make_xla_T_from_operands`), as the JAX package's custom JVP
    does.
    """
    if dtype != _F32:
        raise ValueError("the fused kernel is the float32 tier")
    dev = resolve_device(device)
    shapes = tuple(shapes)
    check_working_set(shapes, rows, cols, 4 + (sub is not None), dev,
                      "the fused operator")
    M1, M2T, log_kap, sub = _device_operands(M1, M2T, log_kap, sub, dtype,
                                             dev)
    theta, beta = float(theta), float(beta)
    twin = make_xla_T_from_operands(M1, M2T, log_kap, theta, beta, shapes,
                                    rows, cols, dtype, sub, device=dev)

    def primal(ell):
        ell_mat = ell.reshape(rows, cols).to(dtype).contiguous()
        return fused_T(ell_mat, M1, M2T, log_kap, sub, theta,
                       beta).reshape(shapes)

    class _FusedT(torch.autograd.Function):
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
        refuse(ell, "the fused operator")
        return _FusedT.apply(ell)

    T.twin = twin
    T.shapes = shapes
    return T


def make_fused_T_log_ssy(model: SSY, disc: SSYDiscretization,
                         dtype: torch.dtype = _F32, *,
                         device="cuda") -> Callable:
    """Fused log-space T for the *discrete* SSY operator (kron operands).

    Maps ell (n_l, n_k, n_i, n_j) -> T-image, differentiable.
    """
    n_l, n_k, n_i, n_j = disc.shapes
    M1, M2T, log_kap = kron_operands_ssy(model, disc, torch.float64)
    return make_fused_T_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, disc.shapes,
        n_l * n_k, n_i * n_j, dtype=dtype, device=device)


def make_fused_T_log_ssy_continuous(model: SSY, grids, degree: int = 5,
                                    dtype: torch.dtype = _F32, *,
                                    device="cuda") -> Callable:
    """Fused log-space T for the *continuous* SSY operator (quadrature,
    pre-power interpolation) — same two-matmul kernel with the composed
    (h_z, z) expectation operand."""
    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    M1, M2T, log_kap = kron_operands_ssy_continuous(model, grids, degree,
                                                    torch.float64)
    return make_fused_T_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, shapes,
        n_l * n_k, n_i * n_j, dtype=dtype, device=device)


def make_fused_T_log_gcy(model, disc, dtype: torch.dtype = _F32, *,
                         device="cuda") -> Callable:
    """Fused log-space T for the discrete GCY operator."""
    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    M1, M2T, log_kap = kron_operands_gcy(model, disc, torch.float64)
    return make_fused_T_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, disc.shapes,
        n_a * n_b * n_c, n_d * n_e * n_l, dtype=dtype, device=device)


def make_fused_T_log_gcy_continuous(model, grids, degree: int = 5,
                                    baseline="loglinear",
                                    dtype: torch.dtype = _F32, *,
                                    device="cuda") -> Callable:
    """Fused log-space T for the *continuous* GCY factored operator
    (quadrature, pre-power interpolation): the two-matmul form with the
    four conditioned column axes composed into one dense operand.
    Baseline normalization defaults on ("loglinear"): theta * (log-w
    range) ~ 200 on these grids exceeds float32's exponential range
    without it.  With a baseline, ``T.baseline_log_w`` is ell0 (float32,
    on ``device``)."""
    (M1, M2T, kap, shapes, rows, cols,
     sub) = kron_operands_gcy_continuous(model, grids, degree, baseline,
                                         torch.float64)
    T = make_fused_T_from_operands(M1, M2T, kap, model.theta, model.beta,
                                   shapes, rows, cols, dtype=dtype, sub=sub,
                                   device=device)
    if sub is not None:
        T.baseline_log_w = (sub / model.theta).reshape(shapes).to(
            device=resolve_device(device), dtype=dtype)
    return T
