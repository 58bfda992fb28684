"""Tiled fast tier of the two-phase log-space operators.

PyTorch port of the dispatch in
``sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py``: ``make_tiled_T_log``
runs an operand set through the streamed kernels
(:mod:`.streamed_two_phase`); ``make_tiled_T_log_ssy``,
``make_tiled_T_log_ssy_continuous``, ``make_tiled_T_log_gcy`` and
``make_tiled_T_log_gcy_continuous`` build the operand sets of discrete
SSY, continuous SSY, discrete GCY and continuous GCY.  The
JAX package's strip tier, which covers the operand sets the streamed
kernels decline under the TPU compiler's layout rules, is not ported
(ROADMAP queue B item 9): an uncovered operand set raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..operators.two_phase import (TwoPhaseOperands, two_phase_operands_gcy,
                                   two_phase_operands_gcy_continuous,
                                   two_phase_operands_ssy,
                                   two_phase_operands_ssy_continuous)
from .streamed_two_phase import make_streamed_T_log, streamed_supported

__all__ = ["TPU_ONLY_OPTIONS", "reject_tpu_options", "make_tiled_T_log",
           "make_tiled_T_log_ssy", "make_tiled_T_log_ssy_continuous",
           "make_tiled_T_log_gcy", "make_tiled_T_log_gcy_continuous"]

# Options of the JAX tiled tier that exist only for the TPU (bf16 "3x"
# contraction splits, software transcendentals, VMEM budgets, tier
# selection, interpret mode).  ROADMAP "Do not port" lists why.
TPU_ONLY_OPTIONS = ("precision", "transcendentals", "strip_bytes",
                    "lazy_bytes", "engine", "twin_precision", "interpret")


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


def make_tiled_T_log(ops: TwoPhaseOperands,
                     dtype: torch.dtype = torch.float32,
                     mode: str = "auto", *, device="cuda",
                     **tpu_options) -> Callable:
    """Tiled two-pass operator from a two-phase operand set: the streamed
    kernels when they cover ``ops``, else ``NotImplementedError``."""
    reject_tpu_options(tpu_options)
    if dtype != torch.float32:
        raise ValueError("the tiled kernels are the float32 tier; use the "
                         "eager operators for float64")
    if not streamed_supported(ops):
        raise NotImplementedError(
            f"operand set with shapes {ops.shapes} is not covered by the "
            "streamed kernels, and the strip tier is not ported (ROADMAP "
            "queue B item 9)")
    return make_streamed_T_log(ops, dtype, mode, device=device)


def make_tiled_T_log_ssy(model, disc, baseline=None,
                         dtype: torch.dtype = torch.float32,
                         mode: str = "auto", *, device="cuda",
                         **tpu_options) -> Callable:
    """Tiled two-pass log-space T for the discrete SSY operator."""
    reject_tpu_options(tpu_options)
    return make_tiled_T_log(two_phase_operands_ssy(model, disc, baseline),
                            dtype, mode, device=device)


def make_tiled_T_log_ssy_continuous(model, grids, degree: int = 5,
                                    baseline=None,
                                    dtype: torch.dtype = torch.float32,
                                    mode: str = "auto", *, device="cuda",
                                    **tpu_options) -> Callable:
    """Tiled two-pass log-space T for the continuous factored-quadrature
    SSY operator (interp="pre"), on the field ``ell[h_lam, h_c, h_z, z]``.

    Its z expectation matrix P_z is conditioned on the current h_z (a c2
    factor batched over the c1 index), so this family runs the streamed
    kernels' batched configuration: pass B contracts h_z' only, pass C
    each h_z slice's z' with its own P_z[i] before the row phase.
    ``baseline`` ("loglinear" or a ``(const, profiles)`` pair) folds a
    separable baseline (``T.baseline_log_w``); "auto" mode is then "lse",
    and "fast" without one.
    """
    reject_tpu_options(tpu_options)
    return make_tiled_T_log(
        two_phase_operands_ssy_continuous(model, grids, degree, baseline),
        dtype, mode, device=device)


def make_tiled_T_log_gcy(model, disc, dtype: torch.dtype = torch.float32,
                         mode: str = "auto", *, device="cuda",
                         baseline: Optional[str] = None,
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
    """
    reject_tpu_options(tpu_options)
    ops = two_phase_operands_gcy(model, disc, baseline)
    if mode == "auto":
        mode = "lse"
    return _natural_layout(ops, make_tiled_T_log(ops, dtype, mode,
                                                 device=device))


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
    ``view_T`` of ``ops`` (one permute in, one out)."""
    perm, inv_perm = ops.perm, ops.inv_perm
    view_shapes = tuple(ops.state_shapes[p] for p in perm)

    def to_view(ell):
        return ell.permute(perm)

    def from_view(ell_v):
        return ell_v.permute(inv_perm)

    def natural(op):
        return lambda ell: from_view(op(to_view(ell).reshape(ops.shapes))
                                     .reshape(view_shapes)).contiguous()

    T = natural(view_T)
    T.view_T = view_T
    T.to_view = to_view
    T.from_view = from_view
    T.twin = natural(view_T.twin)
    T.mode = view_T.mode
    T.engine = view_T.engine
    if getattr(view_T, "baseline_log_w", None) is not None:
        T.baseline_log_w = from_view(
            view_T.baseline_log_w.reshape(view_shapes)).contiguous()
    return T
