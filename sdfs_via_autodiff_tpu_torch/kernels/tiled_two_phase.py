"""Tiled fast tier of the two-phase log-space operators.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py``: the
strip tier (hand-written CUDA in ``csrc/tiled_two_phase.cu``) and the
dispatch between it and the streamed kernels (:mod:`.streamed_two_phase`).
``make_tiled_T_log`` runs an operand set through the streamed kernels when
they cover it or its conjugated-shared form and the mode asked for, else
through the strip kernels; ``make_tiled_T_log_ssy``,
``make_tiled_T_log_ssy_continuous``, ``make_tiled_T_log_gcy`` and
``make_tiled_T_log_gcy_continuous`` build the operand sets of discrete
SSY, continuous SSY, discrete GCY and continuous GCY.

The strip tier, one application in two phases:

    column phase (``strip_col``): ell (R, n1, n2) -> midway field: c1 then
        c2 contracted, each factor shared or batched (W_c1 over the next
        c2 index, W_c2 over the current c1 index), dense or lazy
        (``W[b] = exp(logW0 + sum_k t[k, b] D[k])``);
    row phase (``strip_row``): midway field (R, C) -> log T(w): r1 then r2
        contracted, the additive terms and the epilogue.

Mode "lse" shifts per axis at every contraction; "fast" takes one shift
per field row in the column phase (emitting it), carries the field
linearly and rescales rows by ``exp(s - max s)`` in the row phase.  Each
phase has a plain PyTorch version (``strip_col_plain``,
``strip_row_plain``) and a dispatcher: a CPU tensor goes to the plain
version, a CUDA tensor to the kernels (built from source at first use) or
to an error.  ``LAUNCHES`` counts the kernel launches per phase (the
column phase is one shift and exp pass and one tiled product per column
axis, counted once; ``strip_col_layout`` mirrors the products' tiles).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import refuse
from ..ops.tangent import linearizable, viewed
from ..operators.two_phase import (TwoPhaseOperands, make_eager_two_phase_T,
                                   two_phase_operands_gcy,
                                   two_phase_operands_gcy_continuous,
                                   two_phase_operands_ssy,
                                   two_phase_operands_ssy_continuous)
from ..utils.profiling import span
from . import _build
from .streamed_two_phase import (_GRID_Y_MAX, SMEM_LIMIT, _check,
                                 _check_mode, _check_sub, _folded, _ptr,
                                 make_streamed_T_log, streamed_accepts,
                                 streamed_coverable, streamed_mode,
                                 strip_row_layout)

__all__ = ["TPU_ONLY_OPTIONS", "reject_tpu_options", "LAUNCHES",
           "strip_col", "strip_col_plain", "strip_col_layout",
           "strip_col_work_floats", "strip_row", "strip_row_plain",
           "strip_row_tile", "strip_row_layout", "strip_device_operands",
           "tiled_engine",
           "make_tiled_T_log",
           "make_tiled_T_log_ssy", "make_tiled_T_log_ssy_continuous",
           "make_tiled_T_log_gcy", "make_tiled_T_log_gcy_continuous"]

# Options of the JAX tiled tier that exist only for the TPU (bf16 "3x"
# contraction splits, software transcendentals, VMEM budgets, interpret
# mode).  ROADMAP "Do not port" lists why.
TPU_ONLY_OPTIONS = ("precision", "transcendentals", "strip_bytes",
                    "twin_precision", "interpret")

# Kernel launches per strip phase since the last reset (the wrappers add
# one per phase; the plain versions never count).
LAUNCHES = {"strip_col": 0, "strip_col_fast": 0, "strip_row": 0,
            "strip_row_fast": 0}

_MODES = {"fast": 0, "lse": 1}
# Batched column factors above this many float32 bytes run in their lazy
# form when the set has one (the JAX package's default).
LAZY_BYTES = 6 * 1024 * 1024
# A column factor's kind, as the .cu's factor_kind numbers it.
_FACTOR_KINDS = {"shared": 0, "dense": 1, "lazy": 2}

# A column factor: a (n, n) or (B, n, n) tensor, or the lazy triple
# (logW0 (n, n), D (K, n, n), t (K, B)).
Factor = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def reject_tpu_options(options: dict) -> None:
    """Raise on any keyword argument of the tiled tier the port lacks."""
    tpu = sorted(k for k in options if k in TPU_ONLY_OPTIONS)
    if tpu:
        raise ValueError(
            f"{', '.join(tpu)}: TPU-only option(s) of the JAX tiled tier, "
            "not ported (ROADMAP 'Do not port'); the CUDA kernels run full "
            "FP32 contractions with CUDA's expf/logf")
    if options:
        raise TypeError(f"unexpected keyword argument(s): "
                        f"{', '.join(sorted(options))}")


# ------------------------------------------------------- plain versions

def _slices(W: Factor) -> torch.Tensor:
    """A factor as one dense tensor: itself, or every slice of a lazy
    triple, ``exp(logW0 + t[0, b] D[0] + t[1, b] D[1] + ...)`` in that
    order (the JAX kernel's ``_slice_W``)."""
    if not isinstance(W, tuple):
        return W
    log0, D, t = W
    a = log0[None]
    for k in range(D.shape[0]):
        a = a + t[k][:, None, None] * D[k][None]
    return torch.exp(a)


def strip_col_plain(ell, W_c1: Factor, W_c2: Factor, theta: float,
                    mode: str, sub_row=None, sub_col=None):
    """Column phase of ``ell`` (R, n1, n2): a = theta*ell (less the folded
    baseline ``sub_row`` (R,), ``sub_col`` (n1, n2), both or neither, one
    fused multiply-add as in pass B); contract i' with ``W_c1`` ((n1, n1)
    shared, (n2, n1, n1) batched over the next j, or its lazy triple),
    then j' with ``W_c2`` ((n2, n2), (n1, n2, n2) batched over the current
    i, or lazy).

    fast: returns (mid, s), s (R, 1) the max of a over the row and mid the
    linear c2(c1(exp(a - s))).
    lse:  returns the log-domain mid with per-axis shifts (max over i'
    before c1, max over j' before c2).
    """
    _check_mode(mode)
    _check_sub(sub_row, sub_col)
    W1, W2 = _slices(W_c1), _slices(W_c2)
    c1 = "im,tmj->tij" if W1.dim() == 2 else "jim,tmj->tij"
    c2 = "jm,tim->tij" if W2.dim() == 2 else "ijm,tim->tij"
    a = _folded(ell, theta, sub_row, sub_col)
    if mode == "fast":
        s = torch.amax(a, dim=(1, 2), keepdim=True)
        u = torch.einsum(c1, W1, torch.exp(a - s))
        return torch.einsum(c2, W2, u), s.reshape(-1, 1)
    m = torch.amax(a, dim=1, keepdim=True)
    a = m + torch.log(torch.einsum(c1, W1, torch.exp(a - m)))
    m = torch.amax(a, dim=2, keepdim=True)
    return m + torch.log(torch.einsum(c2, W2, torch.exp(a - m)))


def strip_row_plain(mid, scale, S, W_r1, W_r2, add_row, add_col,
                    theta: float, beta: float, mode: str):
    """Row phase of ``mid`` (R, C), R = L*K: contract l' with ``W_r1``
    (L, L), then k' with ``W_r2`` (K, K), add ``add_row`` (L, K) and
    ``add_col`` (C,), and apply the epilogue log1p(beta*exp(lh/theta)).

    fast: ``mid`` is linear; row r is rescaled by ``scale`` (R, 1) =
    exp(s - S) first and ``S`` (1,) is added back after the log.
    lse:  ``mid`` is log-domain; shift m1 = max over l before the l'
    contraction, log, then m2 = max over k before the k' contraction
    (``scale`` and ``S`` unused).
    """
    _check_mode(mode)
    L, K = W_r1.shape[0], W_r2.shape[0]
    R, C = mid.shape
    if mode == "fast":
        y = torch.matmul(W_r1, (mid * scale).reshape(L, K * C))
        z = torch.matmul(W_r2, y.reshape(L, K, C))
        lh = S + torch.log(z)
    else:
        x = mid.reshape(L, K, C)
        m1 = torch.amax(x, dim=0, keepdim=True)               # (1, K, C)
        y = m1 + torch.log(torch.matmul(
            W_r1, torch.exp(x - m1).reshape(L, K * C)).reshape(L, K, C))
        m2 = torch.amax(y, dim=1, keepdim=True)               # (L, 1, C)
        lh = m2 + torch.log(torch.matmul(W_r2, torch.exp(y - m2)))
    lh = lh + add_row[:, :, None] + add_col[None, None, :]
    return torch.log1p(beta * torch.exp(lh / theta)).reshape(R, C)


# ---------------------------------------------------------- CUDA kernels

def _lib():
    lib = _build.load("tiled_two_phase")
    if not getattr(lib, "_sdfs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.sdfs_strip_col.argtypes = ([p, p, p, f] + [p, ll, p, p, p, i] * 2
                                       + [p, p, p, i, i, i, i, p])
        lib.sdfs_strip_col.restype = i
        lib.sdfs_strip_col_work_floats.argtypes = [i, i, i]
        lib.sdfs_strip_col_work_floats.restype = ll
        lib.sdfs_strip_col_layout.argtypes = [i, i, i, i, i, p]
        lib.sdfs_strip_col_layout.restype = i
        lib.sdfs_strip_row.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                       f, f, i, p]
        lib.sdfs_strip_row.restype = i
        lib.sdfs_strip_row_layout.argtypes = [i, i, p]
        lib.sdfs_strip_row_layout.restype = i
        lib.sdfs_strip_error_string.argtypes = [i]
        lib.sdfs_strip_error_string.restype = ctypes.c_char_p
        lib._sdfs_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.sdfs_strip_error_string(rc).decode()} "
                           f"({rc})")


def _check_factor(name: str, W: Factor, dev, n: int, B: int):
    """Validate a column factor for the kernels; returns (dense tensor or
    None, batch stride, lazy triple or None)."""
    if isinstance(W, tuple):
        log0, D, t = W
        K = D.shape[0] if D.dim() == 3 else -1
        _check(f"{name} logW0", log0, dev, (n, n))
        _check(f"{name} D", D, dev, (K, n, n))
        _check(f"{name} t", t, dev, (K, B))
        return None, 0, W
    if W.dim() == 2:
        _check(name, W, dev, (n, n))
        return W, 0, None
    _check(name, W, dev, (B, n, n))
    return W, n * n, None


def _factor_kind(W: Factor) -> str:
    """"shared", "dense" (batched) or "lazy": how the products read a
    column factor."""
    if isinstance(W, tuple):
        return "lazy"
    return "shared" if W.dim() == 2 else "dense"


def _gemm_tile(P: int, N: int, kind: str) -> Tuple[int, int]:
    """(TM, TN) of one column-phase product (mirrors the .cu's
    gemm_tile): 32 x 256 for P <= 32; 64 x 192 (one column tile over N <=
    192 field rows) or 64 x 256 for a lazy factor or P <= 64; else 128 x
    128."""
    if P <= 32:
        return 32, 256
    if kind == "lazy" or P <= 64:
        return 64, 192 if N <= 192 else 256
    return 128, 128


def strip_col_work_floats(R: int, n1: int, n2: int) -> int:
    """float32 workspace of one column phase (mirrors the .cu's
    col_work_floats): X1 and X2 (n1 * n2 * Qp each), the shifts m1 (n2 *
    Qp) and m2 (n1 * Qp), Qp = R rounded up to 4."""
    Qp = -(-R // 4) * 4
    return 2 * n1 * n2 * Qp + (n1 + n2) * Qp


def strip_col_layout(R: int, n1: int, n2: int, kind1: str,
                     kind2: str) -> dict:
    """The column phase's two products as the launcher lays them out
    (mirrors the .cu's sdfs_strip_col_layout): for "c1" and "c2" a tuple
    (TM, TN, p_tiles, n_tiles, batches, threads).  c1 has P = M = n1 and
    columns the field rows t of each batch j (dense or lazy W_c1), or the
    (j, t) pairs of one product (shared W_c1, the batch axis folded into
    N); c2 likewise with n2, batches i.  N counts Qp = R rounded up to 4
    rows per batch."""
    Qp = -(-R // 4) * 4

    def one(P, B, kind):
        batched = kind != "shared"
        N = Qp if batched else B * Qp
        tm, tn = _gemm_tile(P, N, kind)
        return (tm, tn, -(-P // tm), -(-N // tn), B if batched else 1,
                (tm // 8) * (tn // 8))

    return {"c1": one(n1, n2, kind1), "c2": one(n2, n1, kind2)}


def _strip_col_cuda(ell, W_c1, W_c2, theta, mode, sub_row, sub_col):
    R, n1, n2 = ell.shape
    dev = ell.device
    _check("ell", ell, dev, (R, n1, n2))
    f1 = _check_factor("W_c1", W_c1, dev, n1, n2)
    f2 = _check_factor("W_c2", W_c2, dev, n2, n1)
    for name, (_, _, lazy) in (("W_c1", f1), ("W_c2", f2)):
        if lazy is not None and lazy[1].shape[0] not in (1, 2):
            raise ValueError(f"{name}: the strip kernels take lazy factors "
                             f"of rank 1 or 2, not {lazy[1].shape[0]}")
    if sub_row is not None:
        _check("sub_row", sub_row, dev, (R,))
        _check("sub_col", sub_col, dev, (n1, n2))
    if max(R, n1, n2) > _GRID_Y_MAX:
        raise ValueError(f"strip column phase at ({R}, {n1}, {n2}) "
                         "exceeds the grid")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty_like(ell)
    s = torch.empty((R,), **f32)
    work = torch.empty((strip_col_work_floats(R, n1, n2),), **f32)

    def args(f):
        dense, fb, lazy = f
        log0, D, t = lazy if lazy is not None else (None, None, None)
        return (_ptr(dense), fb, _ptr(log0), _ptr(D), _ptr(t),
                0 if D is None else D.shape[0])

    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.sdfs_strip_col(_ptr(ell), _ptr(sub_row), _ptr(sub_col),
                                float(theta), *args(f1), *args(f2), _ptr(out),
                                _ptr(s), _ptr(work), R, n1, n2, _MODES[mode],
                                stream)
    _raise_on(lib, rc, "strip column phase")
    fast = mode == "fast"
    LAUNCHES["strip_col_fast" if fast else "strip_col"] += 1
    return (out, s.reshape(R, 1)) if fast else out


def strip_col(ell, W_c1: Factor, W_c2: Factor, theta: float, mode: str,
              sub_row=None, sub_col=None):
    """Strip column phase on the tensors' device: the plain version for
    CPU tensors, the CUDA kernels for CUDA tensors (same arguments and
    results as :func:`strip_col_plain`)."""
    _check_mode(mode)
    _check_sub(sub_row, sub_col)
    if ell.device.type == "cpu":
        return strip_col_plain(ell, W_c1, W_c2, theta, mode, sub_row,
                               sub_col)
    if ell.device.type == "cuda":
        return _strip_col_cuda(ell, W_c1, W_c2, theta, mode, sub_row,
                               sub_col)
    raise ValueError(f"no strip column-phase kernel for device {ell.device}")


def strip_row_tile(L: int, K: int) -> Optional[int]:
    """Columns per row-phase tile (:func:`strip_row_layout`), or None
    when no tile fits."""
    lay = strip_row_layout(L, K)
    return None if lay is None else lay[0]


def _strip_row_cuda(mid, scale, S, W_r1, W_r2, add_row, add_col, theta,
                    beta, mode):
    R, C = mid.shape
    L, K = W_r1.shape[0], W_r2.shape[0]
    dev = mid.device
    _check("mid", mid, dev, (R, C))
    _check("W_r1", W_r1, dev, (L, L))
    _check("W_r2", W_r2, dev, (K, K))
    _check("add_row", add_row, dev, (L, K))
    _check("add_col", add_col, dev, (C,))
    if L * K != R:
        raise ValueError(f"mid has {R} rows, W_r1/W_r2 give {L}*{K}")
    if mode == "fast":
        _check("scale", scale, dev, (R, 1))
        _check("S", S, dev, (1,))
    if strip_row_layout(L, K) is None:
        raise ValueError(f"strip row phase at (L, K) = ({L}, {K}) exceeds "
                         "shared memory")
    out = torch.empty_like(mid)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_strip_row(_ptr(mid), _ptr(scale), _ptr(S), _ptr(W_r1),
                                _ptr(W_r2), _ptr(add_row), _ptr(add_col),
                                _ptr(out), L, K, C, float(theta),
                                float(beta), _MODES[mode],
                                ctypes.c_void_p(stream))
    _raise_on(lib, rc, "strip row phase")
    LAUNCHES["strip_row_fast" if mode == "fast" else "strip_row"] += 1
    return out


def strip_row(mid, scale, S, W_r1, W_r2, add_row, add_col, theta: float,
              beta: float, mode: str):
    """Strip row phase on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`strip_row_plain`)."""
    _check_mode(mode)
    if mid.device.type == "cpu":
        return strip_row_plain(mid, scale, S, W_r1, W_r2, add_row, add_col,
                               theta, beta, mode)
    if mid.device.type == "cuda":
        return _strip_row_cuda(mid, scale, S, W_r1, W_r2, add_row, add_col,
                               theta, beta, mode)
    raise ValueError(f"no strip row-phase kernel for device {mid.device}")


# ------------------------------------------------------------- operators

def tiled_engine(ops: TwoPhaseOperands, mode: str = "auto",
                 engine: str = "auto"):
    """The tier that runs ``ops`` in ``mode``: ``("streamed", covered,
    mode)`` with the set the streamed kernels run (``ops`` or its
    conjugated-shared form) and their mode, or ``("strip", ops, mode)``.

    ``engine="auto"`` takes the streamed kernels when they cover the set
    and accept the mode (e.g. not "fast" on a deferred or pair set), else
    the strip kernels; "streamed" and "strip" force a tier.  Raises
    ``ValueError`` when the forced or only tier cannot run the set: a
    pair set the streamed kernels decline, a set built with
    ``dense=False``, or a ``mid_col`` set, on the strip tier.  A pure
    function of its arguments, decided before anything is built.
    """
    if engine not in ("auto", "strip", "streamed"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "strip":
        covered = streamed_coverable(ops)
        if covered is not None and (engine == "streamed"
                                    or ops.dense_placeholder
                                    or streamed_accepts(covered, mode)):
            # streamed_mode raises for a mode the kernels refuse.
            return "streamed", covered, streamed_mode(covered, mode)
        if covered is None and engine == "streamed":
            raise ValueError("operand set not covered by the streamed "
                             f"kernels at shapes {ops.shapes}")
    if ops.is_pair:
        raise ValueError(
            "pair-factored operand sets (continuous GCY) run only on the "
            "streamed kernels' pair configuration, which declines shapes "
            f"{ops.shapes} (pair {ops.pair_shapes}); use kernel='xla'")
    if ops.dense_placeholder:
        raise ValueError(
            "operand set was built with dense=False (batched column "
            "factors not materialized): the strip tier needs them; "
            "rebuild with dense=True")
    if ops.has_mid:
        raise ValueError("mid_col (conjugated-shared) operand sets run on "
                         "the streamed kernels only")
    if mode == "auto":
        mode = "lse" if ops.has_sub else "fast"
    _check_mode(mode)
    return "strip", ops, mode


def strip_device_operands(ops: TwoPhaseOperands, lazy_bytes: int = LAZY_BYTES,
                          *, device="cuda") -> dict:
    """The strip kernels' float32 operands of ``ops`` on ``device``:
    ``W_c1``/``W_c2`` (a batched factor larger than ``lazy_bytes`` as its
    lazy triple when the set has one), ``sub_row`` (R,) and ``sub_col``
    (or None), ``W_r1``, ``W_r2``, ``add_row`` and ``add_col`` (C,)."""
    dev = resolve_device(device)
    L, K, n1, n2 = ops.shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)

    def factor(W, lazy):
        if lazy is not None and W.ndim == 3 and W.size * 4 > lazy_bytes:
            return tuple(cast(a) for a in lazy)
        return cast(W)

    return dict(
        W_c1=factor(ops.W_c1, ops.lazy_c1), W_c2=factor(ops.W_c2, ops.lazy_c2),
        sub_row=(cast(np.asarray(ops.sub_row).reshape(L * K))
                 if ops.has_sub else None),
        sub_col=cast(ops.sub_col) if ops.has_sub else None,
        W_r1=cast(ops.W_r1), W_r2=cast(ops.W_r2), add_row=cast(ops.add_row),
        add_col=cast(np.asarray(ops.add_col).reshape(n1 * n2)))


def _make_strip_T_log(ops: TwoPhaseOperands, dtype, mode: str,
                      lazy_bytes: int, dev) -> Callable:
    L, K, n1, n2 = ops.shapes
    R, C = L * K, n1 * n2
    theta, beta = float(ops.theta), float(ops.beta)
    with span("sdfs.build.upload"):
        d = strip_device_operands(ops, lazy_bytes, device=dev)
        twin = make_eager_two_phase_T(ops, dtype, device=dev)
        baseline_log_w = (None if ops.baseline_log_w is None else
                          torch.as_tensor(np.asarray(
                              ops.baseline_log_w, np.float64)).to(
                                  device=dev, dtype=dtype))
    W_c1, W_c2, sub_row, sub_col = (d["W_c1"], d["W_c2"], d["sub_row"],
                                    d["sub_col"])
    W_r1, W_r2, add_row, add_col = (d["W_r1"], d["W_r2"], d["add_row"],
                                    d["add_col"])

    def primal(ell):
        e = ell.to(dtype).reshape(R, n1, n2).contiguous()
        if mode == "fast":
            u, s = strip_col(e, W_c1, W_c2, theta, mode, sub_row, sub_col)
            S = torch.amax(s).reshape(1)
            out = strip_row(u.reshape(R, C), torch.exp(s - S), S, W_r1,
                            W_r2, add_row, add_col, theta, beta, mode)
        else:
            mid = strip_col(e, W_c1, W_c2, theta, mode, sub_row, sub_col)
            out = strip_row(mid.reshape(R, C), None, None, W_r1, W_r2,
                            add_row, add_col, theta, beta, mode)
        return out.reshape(ops.shapes)

    class _StripT(torch.autograd.Function):
        # Both derivatives are the eager twin's at the same point, as the
        # JAX package's custom_jvp operator transposes its twin's tangent.
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
        refuse(ell, "the strip tier's operator")
        with span("sdfs.primal"):
            return _StripT.apply(ell)

    T.twin = twin
    T.mode = mode
    T.engine = "strip"
    T.strip_sizes = (strip_col_layout(R, n1, n2, _factor_kind(W_c1),
                                      _factor_kind(W_c2))["c2"][1],
                     strip_row_tile(L, K))
    T.lazy = (isinstance(W_c1, tuple), isinstance(W_c2, tuple))
    if baseline_log_w is not None:
        T.baseline_log_w = baseline_log_w
    return T


def make_tiled_T_log(ops: TwoPhaseOperands,
                     dtype: torch.dtype = torch.float32,
                     mode: str = "auto", *, device="cuda",
                     engine: str = "auto", lazy_bytes: int = LAZY_BYTES,
                     **tpu_options) -> Callable:
    """Tiled two-pass operator from any two-phase operand set, on the tier
    :func:`tiled_engine` picks: the streamed kernels
    (:func:`.streamed_two_phase.make_streamed_T_log`, ``T.engine``
    "streamed", "streamed-deferred" or "streamed-pair") or the strip
    kernels (``T.engine == "strip"``).

    On the strip tier "auto" mode is "lse" for a set with a folded
    baseline (whose folded factors the LSE steps renormalize), "fast"
    otherwise; a batched column factor larger than ``lazy_bytes`` runs in
    its lazy form when the set has one (``T.lazy`` says which did).  The
    returned ``T`` carries ``T.twin`` (the eager evaluator: Newton's
    tangent through ``T.twin.linearize``, ``torch.func``'s derivatives),
    ``T.mode``, ``T.engine``, ``T.strip_sizes`` (the
    columns of a c2 product tile, :func:`strip_col_layout`, and the
    columns per row-phase block) and, for a set with a folded baseline,
    ``T.baseline_log_w``.
    """
    reject_tpu_options(tpu_options)
    if dtype != torch.float32:
        raise ValueError("the tiled kernels are the float32 tier; use the "
                         "eager operators for float64")
    tier, run_ops, run_mode = tiled_engine(ops, mode, engine)
    if tier == "streamed":
        return make_streamed_T_log(ops, dtype, run_mode, device=device,
                                   covered=run_ops)
    return _make_strip_T_log(run_ops, dtype, run_mode, lazy_bytes,
                             resolve_device(device))


def make_tiled_T_log_ssy(model, disc, baseline=None,
                         dtype: torch.dtype = torch.float32,
                         mode: str = "auto", *, device="cuda",
                         engine: str = "auto", lazy_bytes: int = LAZY_BYTES,
                         **tpu_options) -> Callable:
    """Tiled two-pass log-space T for the discrete SSY operator;
    ``baseline="loglinear"`` runs the normalized operand set (batched
    folded column factors: the streamed full configuration through its
    conjugated-shared form under "auto", or the strip kernels)."""
    reject_tpu_options(tpu_options)
    return make_tiled_T_log(two_phase_operands_ssy(model, disc, baseline),
                            dtype, mode, device=device, engine=engine,
                            lazy_bytes=lazy_bytes)


def make_tiled_T_log_ssy_continuous(model, grids, degree: int = 5,
                                    baseline=None,
                                    dtype: torch.dtype = torch.float32,
                                    mode: str = "auto", *, device="cuda",
                                    engine: str = "auto",
                                    **tpu_options) -> Callable:
    """Tiled two-pass log-space T for the continuous factored-quadrature
    SSY operator (interp="pre"), on the field ``ell[h_lam, h_c, h_z, z]``.

    Its z expectation matrix P_z is conditioned on the current h_z (a c2
    factor batched over the c1 index), so this family runs the streamed
    kernels' batched configuration: pass B contracts h_z' only, pass C
    each h_z slice's z' with its own P_z[i] before the row phase.
    ``baseline`` ("loglinear" or a ``(const, profiles)`` pair) folds a
    separable baseline (``T.baseline_log_w``); "auto" mode is then "lse",
    and "fast" without one.  ``engine="strip"`` runs the strip kernels
    with the dense batched P_z instead.
    """
    reject_tpu_options(tpu_options)
    return make_tiled_T_log(
        two_phase_operands_ssy_continuous(model, grids, degree, baseline),
        dtype, mode, device=device, engine=engine)


def make_tiled_T_log_gcy(model, disc, dtype: torch.dtype = torch.float32,
                         mode: str = "auto", *, device="cuda",
                         baseline: Optional[str] = None,
                         engine: str = "auto", lazy_bytes: int = LAZY_BYTES,
                         **tpu_options) -> Callable:
    """Tiled two-pass log-space T for the discrete six-state GCY operator
    via Kronecker grouping (``operators/two_phase.two_phase_operands_gcy``):
    rows (h_c, h_lam), columns (z (x) z_pi, h_z (x) h_zpi).

    The returned T maps the natural 6-D field ``ell[z, z_pi, h_z, h_c,
    h_zpi, h_lam]`` -> log T(w) through ``T.to_view`` (one permute), the
    view operator ``T.view_T`` on the 4-D view and ``T.from_view``;
    ``T.twin`` is the eager twin in the natural layout (Newton's
    tangent).  GCY's theta = -36 gives the plain operator a wide dynamic
    range, so "auto" mode resolves to "lse".  Column groups too large for
    the full configuration (e.g. 512 x 256 at the 25.2M-point grid) run
    the deferred one.

    ``baseline="loglinear"`` runs the normalized operand set (shared row
    factors, rank-2 lazy batched column factors) and exposes
    ``T.baseline_log_w``, the warm start.  Its set is first built with
    ``dense=False``; when the streamed kernels cover its conjugated-shared
    form (which uses only the lazy triples) that is what runs, and only
    the strip tier rebuilds it with the dense batched factors (the strip
    twin's tangent needs them).
    """
    reject_tpu_options(tpu_options)
    if mode == "auto":
        mode = "lse"
    ops = None
    if baseline is not None and engine != "strip":
        probe = two_phase_operands_gcy(model, disc, baseline, dense=False)
        if streamed_coverable(probe) is not None:
            ops = probe
    if ops is None:
        ops = two_phase_operands_gcy(model, disc, baseline)
    return _natural_layout(ops, make_tiled_T_log(
        ops, dtype, mode, device=device, engine=engine,
        lazy_bytes=lazy_bytes))


def make_tiled_T_log_gcy_continuous(model, grids, degree: int = 5,
                                    baseline=None,
                                    dtype: torch.dtype = torch.float32,
                                    mode: str = "auto", *, device="cuda",
                                    **tpu_options) -> Callable:
    """Streamed-pair log-space T for the continuous factored-quadrature
    six-state GCY operator (interp="pre").

    The conditioned z / z_pi expectation matrices (P_z on the current h_z
    and z_pi, P_zpi on the current h_zpi) do not conjugate into shared
    factors, so this family runs the streamed kernels' pair
    configuration: the (h_z (x) h_zpi) Kronecker factor contracts in the
    deferred pass B (with the folded baseline), the conditioned pair per
    slice in pass C.  ``baseline`` ("loglinear" or a ``(const,
    profiles)`` pair; the coarse-solve profiles in production) is
    effectively required: GCY's theta = -36 puts the plain iterate far
    outside float32's exp range, and a warning says so when none is
    given.

    The returned T maps the natural 6-D field ``ell[h_lam, h_c, h_z,
    h_zpi, z, z_pi]`` -> log T(w) through ``T.to_view``, the view
    operator ``T.view_T`` on ``(h_c, h_lam, (h_z, h_zpi), (z_pi, z))``
    and ``T.from_view``; ``T.twin`` is the eager twin in the natural
    layout (the tangent), ``T.baseline_log_w`` the folded baseline in
    the natural layout.
    """
    reject_tpu_options(tpu_options)
    if baseline is None:
        from ..models.gcy import gcy_loglinear_factory
        from ..operators.continuous_common import warn_if_f32_range_unsafe
        warn_if_f32_range_unsafe(model, grids, gcy_loglinear_factory,
                                 dtype)
    ops = two_phase_operands_gcy_continuous(model, grids, degree, baseline)
    return _natural_layout(ops, make_tiled_T_log(ops, dtype, mode,
                                                 device=device))


def _natural_layout(ops: TwoPhaseOperands, view_T) -> Callable:
    """The six-state natural-layout operator around the view operator
    ``view_T`` of ``ops`` (one permute in, one out).  Each crossing, with
    the copy it forces, is an ``sdfs.layout`` span, also where the
    tangent's tape replays it on every matvec."""
    perm, inv_perm = ops.perm, ops.inv_perm
    view_shapes = tuple(ops.state_shapes[p] for p in perm)

    def to_view(ell):
        return ell.permute(perm)

    def from_view(ell_v):
        return ell_v.permute(inv_perm)

    def into(ell):
        with span("sdfs.layout"):
            return to_view(ell).reshape(ops.shapes)

    def out_of(ell_v):
        with span("sdfs.layout"):
            return from_view(ell_v.reshape(view_shapes)).contiguous()

    def T(ell):
        refuse(ell, "the six-state tiled operator")
        return out_of(view_T(into(ell)))

    @linearizable
    def twin(ell, tape=None):
        out = view_T.twin.primal(viewed(ell, into, tape), tape)
        return viewed(out, out_of, tape)

    T.view_T = view_T
    T.to_view = to_view
    T.from_view = from_view
    T.twin = twin
    T.mode = view_T.mode
    T.engine = view_T.engine
    for attr in ("strip_sizes", "lazy"):
        if hasattr(view_T, attr):
            setattr(T, attr, getattr(view_T, attr))
    if getattr(view_T, "baseline_log_w", None) is not None:
        T.baseline_log_w = from_view(
            view_T.baseline_log_w.reshape(view_shapes)).contiguous()
    return T
