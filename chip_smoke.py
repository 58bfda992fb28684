#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device facts (name, power limit, toolchain); full-FP32 matmuls;
2. build the CUDA kernels from ``kernels/csrc/streamed_two_phase.cu``;
3. SSY: pass B and pass C against their plain PyTorch versions on the
   card, both modes, at (4,8,6,64), (56,56,56,64) Rouwenhorst and
   (32,32,32,384) Tauchen;
4. SSY: one operator application against the float64 operator on the
   card;
5. the SSY path: a float32 Newton solve through the kernels at the
   12.6M-point (32,32,32,384) Tauchen grid, checked against the float64
   operator, with the kernels' launch counts;
6. SSY: a second (warm) solve's seconds, and ms per application,
   kernels vs the plain eager twin (CUDA events);
7. GCY: the deferred pass B and pass C against their plain versions at
   a ragged view (2,4,56,258) and at the 25.2M-point grid's
   (12,16,512,256); one application of the GCY operator at
   (32,16,16,12,16,16) Tauchen against the float64 operator;
8. the GCY path: a float32 Newton solve through the deferred kernels at
   (32,16,16,12,16,16) Tauchen from the log-linear warm start, checked
   against the float64 operator, with the launch counts, the outer and
   BiCGStab iterations and the seconds;
9. GCY: ms per application, kernels vs the eager twin, ms per tangent
   matvec, and each deferred kernel vs its plain version;
10. the fused kernels (one application, the SA loop, the Anderson loop,
    ``kernels/csrc/fused_two_matmul.cu``) against their plain versions
    at four two-matmul operand sets: continuous SSY (5,5,5,6), discrete
    SSY (8,8,6,6), discrete GCY (4,3,3,3,3,3) and continuous SSY 20^4
    (the Anderson loop iterate by iterate over 20 steps, its fall back
    to T(x), and at tol 1e-5 in a tenth of the SA loop's iterations);
11. one fused application at the 20^4 continuous grid against the
    float64 factored operator;
12. the continuous-SSY path at 20^4: ``wc_ratio_continuous`` with
    ``algorithm="fused_anderson"`` and ``"fused_sa"`` (tol 1e-5, from
    w = 1) and a float32 Newton solve through the fused operator (tol
    2e-5), each with its launch counts, float64 residual, distance to
    the float64 Newton solution and cold/warm seconds;
13. timing: us per iteration of the SA kernel over 20,000 iterations,
    each fused kernel vs its plain version (the loops over the same
    200 iterations); the Anderson loops' iteration counts at tol 2e-6;
14. continuous GCY: the deferred pass B with the folded baseline and the
    pair pass C against their plain versions at (8,3,2,4,128,2)
    (log-linear baseline), a ragged (5,3,3,2,40,3), the 4.2M-point
    (8,8,8,8,128,8) and the 18.9M-point (16,8,12,12,128,8) grids (coarse
    baseline); one application at 18.9M against the float64 factored
    operator with the same baseline;
15. the continuous-GCY path at 18.9M: ``wc_ratio_continuous(GCY(),
    (16,8,12,12,128,8), kernel="tiled", baseline="coarse", tol=3.04e-5,
    max_iter=2000)`` (SA; Anderson continues from SA's iterate if SA's
    stall guard stops it above tol), cold then warm, with the coarse
    baseline's seconds, the iterations, the launch counts and the float64
    residual;
16. continuous GCY timing at 4.2M and 18.9M: ms per application, kernels
    vs the eager twin, and each new kernel vs its plain version; at
    18.9M the SA loop's seconds on the prebuilt operator and 64 of its
    iterations under torch.profiler (device time by kernel, busy share);
17. the fused tier on continuous GCY at 6^6: ``fused_sa`` and
    ``fused_anderson`` with the coarse baseline (tol 3.04e-5, float64
    residual), and the fused application against its plain version at
    that operand set;
18. the post-interp kernel (``kernels/csrc/post_interp.cu``) against its
    plain version at 15^4 and 20^4, "post" and "loglin", on the arguments
    the operator hands it (``T.kernel_args``), with both timed, and one
    application at 20^4 against the float64 node chain;
19. the continuous-SSY post-interp path at 20^4:
    ``wc_ratio_continuous(SSY(), (20,)*4, kernel="tiled", interp="post")``
    and again with ``"loglin"`` (Newton, tol 2e-5, from w = 1), cold then
    warm, with the launch counts, the iterations and the float64 residual
    through the float64 node chain;
20. the reference's published one-step moment anchors at 15^4, degree
    5: a float64 Newton solve (tol 1e-9, ``interp="pre"`` and
    ``"loglin"``, 3.2 and 2.5 standard deviations), then
    ``construct_wstar_callable`` and ``one_step_w_moments`` with 10^6
    draws, each within 1e-3 on the mean and 5e-3 on the std;
21. the Monte Carlo node chains of the JAX suite: SSY 20^4 and GCY
    (8,8,8,8,6,6) with 2,000 draws, "post", float32, ms per application
    over 5 applications (GCY: throughput only, as in the JAX suite: its
    float32 span warning is expected);
22. a JSON line of per-kernel facts (with each kernel's bound: the
    larger of its FP32 operations over 67 TFLOP/s and its bytes over
    3.35 TB/s, from this run's shapes and iteration counts), then the
    result line ``{"ok": true, "device": {...}}``.

The kernels build in parallel (one nvcc per source).  Each path runs
with every launch count set to 0 just before it and read just after.  The port never imports JAX, and neither does this script.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
SHAPES = (((4, 8, 6, 64), "rouwenhorst"),
          ((56, 56, 56, 64), "rouwenhorst"),
          ((32, 32, 32, 384), "tauchen"))
MAIN_SHAPES, MAIN_METHOD = SHAPES[2]
# Kernel vs plain: absolute on log-domain values (plus one float32
# rounding of the value: lse-mode midway values sit near theta*log(800)
# ~ -107, where one ulp is 7.6e-6 and two correct evaluations may round
# apart), relative on the fast-mode linear midway field.
KERNEL_ATOL = 5e-6
KERNEL_RTOL_LINEAR = 5e-6
OPERATOR_ATOL = 5e-6        # one application vs float64
MAIN_TOL = 2e-5             # f32 Newton tolerance (above f32_tol_floor)
MAIN_F64_RESIDUAL = 5e-5    # max |T64(ell*) - ell*|
# GCY: the NORTHSTAR gcy_discrete_tauchen grid (25,165,824 states, view
# (12,16,512,256)) and a ragged view (2,4,56,258) for the kernel checks.
GCY_SHAPES, GCY_METHOD = (32, 16, 16, 12, 16, 16), "tauchen"
GCY_RAGGED = (7, 8, 43, 2, 6, 4)
GCY_F64_RESIDUAL = 5e-5     # max |T64(ell*) - ell*|
# The continuous-SSY fused tier: the JAX suite's
# ssy_continuous_fused_kernel_20^4_f32_20k_iters cell
# (benchmarks/suite.py:128-140), quadrature degree 5, interp "pre".
FUSED_SIZES = (20, 20, 20, 20)
FUSED_TOL = 1e-5            # fused SA / Anderson tolerance
FUSED_NEWTON_TOL = 2e-5     # f32 Newton through the fused operator
FUSED_F64_RESIDUAL = 5e-5   # max |T64(ell*) - ell*|
FUSED_CELL_ITERS = 20_000   # the suite cell's iteration count
B6_CAP_ATOL = 1e-4          # 50 SA steps of ~1e-6 rounding each
# Anderson iterate by iterate: 20 steps (mixes at steps 6, 8, ..., 18)
# with ridge 0.1 (times tr/m).  The default ridge 1e-6 leaves the early
# normal equations so ill-conditioned that a 1e-7 change of the start
# moves the 10th iterate by ~4e-3; at 0.1 rounding moves it by ~2e-5
# while mixing still moves it by 2e-2..2 away from SA's iterate.
B7_CHECK_RIDGE, B7_CHECK_ITERS, B7_ITER_ATOL = 0.1, 20, 1e-4
B7_ITER_SHARE = 0.1         # AA iterations at tol 1e-5 / SA's, at most
FUSED_TIMED_ITERS = 200     # fixed count of the kernel-vs-plain timings
FLOOR_TOL, FLOOR_MAX_ITER = 2e-6, 5000   # Anderson near the f32 floor
# Continuous GCY: the JAX NORTHSTAR gcy_continuous_quadpre_pair grid
# (benchmarks/northstar.py:442-536; 18,874,368 states, view
# (8,16,144,1024)), the JAX suite's gcy_continuous_pair_4.2M_f32 grid
# (benchmarks/suite.py:357-391) and two small sets for the kernel checks.
GCYC_SHAPES = (16, 8, 12, 12, 128, 8)
GCYC_SUITE = (8, 8, 8, 8, 128, 8)
GCYC_SMALL = (8, 3, 2, 4, 128, 2)
GCYC_RAGGED = (5, 3, 3, 2, 40, 3)
GCYC_MAX_ITER = 2000
GCYC_F64_RESIDUAL = 5e-5    # max |T64(ell*) - ell*|
FUSED_GCY_SIZES = (6,) * 6
# The continuous-SSY post-interp path: the reference's largest recorded
# post-interp grid (test_newton.md:219), degree 5, and a second check set.
POST_SIZES = (20, 20, 20, 20)
POST_CHECK_SIZES = (15, 15, 15, 15)
POST_DEGREE = 5
POST_TOL = 2e-5             # f32 Newton tolerance
POST_F64_ATOL = 2e-5        # one application vs the float64 node chain
POST_F64_RESIDUAL = 5e-5    # max |T64(ell*) - ell*|
# The anchors (JAX tests/test_reference_anchors.py): sizes, degree and
# (interp, num_std_devs, mean, std).
ANCHOR_SIZES, ANCHOR_DEGREE, ANCHOR_DRAWS = (15, 15, 15, 15), 5, 1_000_000
ANCHORS = (("pre", 3.2, 670.75128139, 6.60051464),
           ("pre", 2.5, 983.28449407, 8.76520362),
           ("loglin", 3.2, 865.00929848, 8.35713019),
           ("loglin", 2.5, 1077.95676508, 9.61219993))
ANCHOR_MEAN_RTOL, ANCHOR_STD_RTOL = 1e-3, 5e-3
# The JAX suite's Monte Carlo node-chain cells (benchmarks/suite.py:
# 315-355).
MC_SSY_SIZES, MC_GCY_SIZES, MC_DRAWS, MC_APPS = (
    (20, 20, 20, 20), (8, 8, 8, 8, 6, 6), 2000, 5)
PEAK_FP32 = 67e12           # H100 SXM FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
_CSRC = "sdfs_via_autodiff_tpu_torch/kernels/csrc/"
SOURCES = {"streamed_two_phase": _CSRC + "streamed_two_phase.cu",
           "fused_two_matmul": _CSRC + "fused_two_matmul.cu",
           "post_interp": _CSRC + "post_interp.cu"}
_JAX_KERNELS = "sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py"
REPLACES = {"pass_b": f"{_JAX_KERNELS}:324",            # _b_kernel
            "pass_c": f"{_JAX_KERNELS}:446",            # _c_kernel
            "pass_b_deferred": f"{_JAX_KERNELS}:384",   # _b_kernel_deferred
            "pass_c_deferred": f"{_JAX_KERNELS}:446",   # _c_kernel, c2_deferred
            "pass_c_pair": f"{_JAX_KERNELS}:673",       # _c_kernel_pair
            "fused_T": "sdfs_via_autodiff_tpu/kernels/fused_discrete.py:72",
            "fused_sa": "sdfs_via_autodiff_tpu/kernels/solver_kernel.py:41",
            "fused_anderson":
                "sdfs_via_autodiff_tpu/kernels/anderson_kernel.py:36",
            "post_interp":
                "sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py:58"}
KERNELS = tuple(REPLACES)
SOURCE_OF = {k: SOURCES["fused_two_matmul" if k.startswith("fused")
                        else k if k in SOURCES else "streamed_two_phase"]
             for k in KERNELS}
# (FP32 FLOP, bytes) of each kernel's timed call, filled by the phases.
WORK = {}


def bound(name: str):
    """(bound_ms, bound_by) of a kernel's timed call: the larger of its
    FP32 operations over the peak rate and its bytes (each input read
    once, each output written once) over the memory rate."""
    flop, nbytes = WORK[name]
    t_ops, t_bytes = flop / PEAK_FP32, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def noise_field(shapes, seed):
    """log(800) plus seeded noise of scale 0.05 (the JAX bench's input)."""
    rng = np.random.default_rng(seed)
    return np.log(800.0) + 0.05 * rng.standard_normal(shapes)


def time_ms(torch, fn, x, n=50, runs=3):
    """Median over ``runs`` of the mean ms per call of ``n`` calls."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(x)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def f32_cast(torch, dev):
    return lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)


def gcy_phases(torch, port, st, dev, smi):
    """Phases 7-9 (GCY).  Returns the kernels' max abs errors vs plain,
    the path's launch counts and (kernel ms, plain ms) per kernel."""
    model = port.GCY()
    cast = f32_cast(torch, dev)
    eps32 = float(np.finfo(np.float32).eps)
    max_err = {"pass_b_deferred": 0.0, "pass_c_deferred": 0.0}

    # 7. Deferred kernels vs plain versions, and one application vs f64.
    for shapes in (GCY_RAGGED, GCY_SHAPES):
        disc = port.discretize_gcy(model, shapes, method=GCY_METHOD)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops = port.two_phase_operands_gcy(model, disc)
        for w in caught:
            print(f"warning at GCY {shapes}: {w.message}")
        L, K, I, J = ops.shapes
        R, C = L * K, I * J
        th, be = float(ops.theta), float(ops.beta)
        W_c1t = cast(np.asarray(ops.W_c1).T)
        c_args = (cast(np.asarray(ops.W_c2).T), cast(ops.W_r1),
                  cast(ops.W_r2), cast(ops.add_row),
                  cast(ops.add_col.reshape(C)), th, be)
        ell = cast(noise_field((R, I, J), SEED))
        got_b = st.pass_b_deferred(ell, W_c1t, th)
        want_b = st.pass_b_deferred_plain(ell, W_c1t, th)
        err_b = float((got_b - want_b).abs().max())
        # Midway values near theta*log(800) ~ -241 (one ulp 1.5e-5): one
        # float32 rounding of the value beside the 5e-6.
        lim = KERNEL_ATOL + eps32 * want_b.abs()
        check(bool(((got_b - want_b).abs() <= lim).all()),
              f"pass_b_deferred {ops.shapes}: max abs err {err_b:.3e}")
        mid = want_b.reshape(R, C)
        got_c = st.pass_c_deferred(mid, *c_args)
        want_c = st.pass_c_deferred_plain(mid, *c_args)
        err_c = float((got_c - want_c).abs().max())
        check(bool(torch.isfinite(got_c).all()) and err_c <= KERNEL_ATOL,
              f"pass_c_deferred {ops.shapes}: max abs err {err_c:.3e}")
        torch.cuda.synchronize()
        print(f"pass_b_deferred {ops.shapes}: max abs err mid {err_b:.3e}; "
              f"pass_c_deferred: max abs err out {err_c:.3e}")
        max_err["pass_b_deferred"] = max(max_err["pass_b_deferred"], err_b)
        max_err["pass_c_deferred"] = max(max_err["pass_c_deferred"], err_c)
        del ell, got_b, want_b, mid, got_c, want_c
    T = port.make_tiled_T_log_gcy(model, disc, device=dev)
    check(T.engine == "streamed-deferred" and T.mode == "lse",
          f"GCY {GCY_SHAPES} runs {T.engine}/{T.mode}, not the deferred "
          "lse configuration")
    T64 = port.T_gcy_factory(model, disc, space="log", device=dev)
    ell64 = torch.as_tensor(noise_field(GCY_SHAPES, SEED), device=dev)
    err = float((T(ell64.float()).double() - T64(ell64)).abs().max())
    check(err <= OPERATOR_ATOL, f"GCY operator vs f64: {err:.3e}")
    print(f"operator GCY {GCY_SHAPES} {GCY_METHOD}: one application vs f64 "
          f"max abs err {err:.3e}")
    del ell64

    # 8. The GCY path.
    tol = 1.2 * port.f32_tol_floor(model.theta)
    torch.cuda.synchronize()
    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    inner = []
    t0 = time.perf_counter()
    sol = port.wc_ratio_discrete(model, GCY_SHAPES, kernel="tiled",
                                 discretization=GCY_METHOD,
                                 algorithm="newton", tol=tol, device=dev,
                                 inner_iterations=inner)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    res = sol.result
    print(f"GCY path {GCY_SHAPES} {GCY_METHOD} newton tol {tol:.3e}: {res}, "
          f"{solve_s:.3f} s ({smi}); BiCGStab iterations per step {inner} "
          f"= {sum(inner)}; launches {launches}")
    check(res.converged, f"GCY path did not converge: {res}")
    check(all(launches[k] > 0 for k in ("pass_b_deferred",
                                         "pass_c_deferred")),
          f"a deferred kernel of the GCY path never launched: {launches}")
    ell_star = torch.log(sol.w_star.double())
    check(bool(torch.isfinite(ell_star).all())
          and tuple(ell_star.shape) == GCY_SHAPES, "GCY w* not finite/shaped")
    r64 = float((T64(ell_star) - ell_star).abs().max())
    w = sol.w_star.double()
    print(f"GCY path f64 residual max|T64(l*) - l*| = {r64:.3e}; "
          f"w* in [{float(w.min()):.3f}, {float(w.max()):.3f}]")
    check(r64 <= GCY_F64_RESIDUAL, f"GCY f64 residual {r64:.3e}")
    del T64, sol, w, ell_star
    torch.cuda.empty_cache()

    # 9. Timing.
    x = torch.as_tensor(noise_field(GCY_SHAPES, SEED), device=dev).float()
    ms_k = time_ms(torch, T, x)
    ms_p = time_ms(torch, T.twin, x)
    ms_k2 = time_ms(torch, T, x)
    ms_view = time_ms(torch, T.view_T, T.to_view(x).reshape(ops.shapes))
    v = 0.01 * x
    ms_jvp = time_ms(torch, lambda y: torch.func.jvp(
        lambda z: T.twin(z) - z, (y,), (v,))[1], x, n=10)
    print(f"timing GCY {GCY_SHAPES}: kernels {ms_k:.4f} / {ms_k2:.4f} ms per "
          f"application (view layout {ms_view:.4f}), plain eager twin "
          f"{ms_p:.4f} ms, tangent matvec (jvp of the twin) {ms_jvp:.4f} ms "
          f"({smi})")
    e = T.to_view(x).reshape(R, I, J).contiguous()
    mid = st.pass_b_deferred_plain(e, W_c1t, th).reshape(R, C)
    kernels_ms = {
        "pass_b_deferred": (
            time_ms(torch, lambda y: st.pass_b_deferred(y, W_c1t, th), e),
            time_ms(torch, lambda y: st.pass_b_deferred_plain(y, W_c1t, th),
                    e)),
        "pass_c_deferred": (
            time_ms(torch, lambda y: st.pass_c_deferred(y, *c_args), mid),
            time_ms(torch, lambda y: st.pass_c_deferred_plain(y, *c_args),
                    mid))}
    # Contractions: c1 over I' per (row, column) in pass B; c2 over J'
    # and the two row contractions in pass C.  Each pass reads and writes
    # one f32 field (plus its small factors).
    field = 4 * R * C
    WORK["pass_b_deferred"] = (2 * R * I * I * J, 2 * field + 4 * I * I)
    WORK["pass_c_deferred"] = (2 * R * I * J * J + 2 * C * R * (L + K),
                               2 * field + 4 * (J * J + L * L + K * K + R + C))
    for name, (k_ms, p_ms) in kernels_ms.items():
        print(f"timing {name} {ops.shapes}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms")
    return max_err, launches, kernels_ms


def fused_sets(torch, port, fd):
    """The four two-matmul operand sets of the fused kernel checks
    (float64 CPU tensors)."""
    ssy, gcy = port.SSY(), port.GCY()
    f64 = torch.float64
    return [
        ("continuous (5,5,5,6)", ssy, fd.kron_operands_ssy_continuous(
            ssy, port.build_grid_ssy(ssy, 5, 5, 5, 6), 5, f64)),
        ("discrete SSY (8,8,6,6)", ssy, fd.kron_operands_ssy(
            ssy, port.discretize_ssy(ssy, (8, 8, 6, 6)), f64)),
        ("discrete GCY (4,3,3,3,3,3)", gcy, fd.kron_operands_gcy(
            gcy, port.discretize_gcy(gcy, (4, 3, 3, 3, 3, 3)), f64)),
        ("continuous 20^4", ssy, fd.kron_operands_ssy_continuous(
            ssy, port.build_grid_ssy(ssy, *FUSED_SIZES), 5, f64))]


def events_ms(torch, fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def fused_phases(torch, port, dev, smi):
    """Phases 10-13 (the fused tier).  Returns the kernels' max abs
    errors vs plain, the path's launch counts and (kernel ms, plain ms)
    per kernel."""
    from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
    from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
    from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk
    from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

    cast = f32_cast(torch, dev)
    max_err = {"fused_T": 0.0, "fused_sa": 0.0, "fused_anderson": 0.0}

    # 10. Each fused kernel vs its plain version at four operand sets.
    for label, model, ops64 in fused_sets(torch, port, fd):
        ops = tuple(cast(a.numpy()) for a in ops64)
        R, C = ops[2].shape
        th, be = model.theta, model.beta
        ell = cast(noise_field((R, C), SEED))
        got = fd.fused_T(ell, *ops, None, th, be)
        err_t = float((got - fd.fused_T_plain(ell, *ops, None, th,
                                              be)).abs().max())
        check(bool(torch.isfinite(got).all()) and err_t <= KERNEL_ATOL,
              f"fused_T {label}: max abs err {err_t:.3e}")
        e_k, i_k, _ = sk.fused_sa(ell, *ops, None, th, be, 0.0, 50)
        e_p, i_p, _ = sk.fused_sa_plain(ell, *ops, None, th, be, 0.0, 50)
        err_s = float((e_k - e_p).abs().max())
        check(int(i_k) == int(i_p) == 50 and err_s <= B6_CAP_ATOL,
              f"fused_sa {label}: {int(i_k)}/{int(i_p)} iterations, max abs "
              f"err {err_s:.3e}")
        # Anderson from w = 1 (continuous) or w = 800 (discrete).
        x0 = (torch.zeros_like(ell) if label.startswith("continuous")
              else torch.full_like(ell, float(np.log(800.0))))
        # Iterate by iterate at a fixed count (tol -1): the Gram sums,
        # the Gauss-Jordan solve and the combination against plain.
        n = B7_CHECK_ITERS
        a_k, j_k, _ = ak.fused_anderson(x0, *ops, None, th, be, -1.0, n,
                                        ridge=B7_CHECK_RIDGE)
        a_p, j_p, _ = ak.fused_anderson_plain(x0, *ops, None, th, be, -1.0,
                                              n, ridge=B7_CHECK_RIDGE)
        err_a = float((a_k - a_p).abs().max())
        check(int(j_k) == int(j_p) == n and err_a <= B7_ITER_ATOL,
              f"fused_anderson {label}: {int(j_k)}/{int(j_p)} iterations at "
              f"ridge {B7_CHECK_RIDGE:g}, max abs err {err_a:.3e}")
        # The fall back to T(x): a NaN ridge makes every combination NaN,
        # so the loop is plain SA.
        f_k, _, _ = ak.fused_anderson(x0, *ops, None, th, be, -1.0, n,
                                      ridge=float("nan"))
        s_p, _, _ = sk.fused_sa_plain(x0, *ops, None, th, be, -1.0, n)
        err_f = float((f_k - s_p).abs().max())
        check(err_f <= B7_ITER_ATOL,
              f"fused_anderson {label}: NaN-ridge fall back vs SA {err_f:.3e}")
        # At tol 1e-5 with the default ridge: both converge, in a tenth of
        # SA's iterations from the same start.  Their end states lie
        # within tol*beta/(1-beta) of the fixed point (the stop rule), so
        # within twice that of each other; the kernel's end state is a
        # fixed point of the plain operator to FUSED_F64_RESIDUAL.
        b_k, i_k, q_k = ak.fused_anderson(x0, *ops, None, th, be, FUSED_TOL,
                                          20_000)
        b_p, i_p, q_p = ak.fused_anderson_plain(x0, *ops, None, th, be,
                                                FUSED_TOL, 20_000)
        _, i_sa, _ = sk.fused_sa(x0, *ops, None, th, be, FUSED_TOL, 20_000)
        end = float((b_k - b_p).abs().max())
        band = 2 * FUSED_TOL * be / (1 - be)
        res_k = float((fd.fused_T_plain(b_k, *ops, None, th, be)
                       - b_k).abs().max())
        check(float(q_k) <= FUSED_TOL and float(q_p) <= FUSED_TOL,
              f"fused_anderson {label}: kernel err {float(q_k):.3e}, plain "
              f"{float(q_p):.3e} > tol")
        check(int(i_k) <= B7_ITER_SHARE * int(i_sa),
              f"fused_anderson {label}: {int(i_k)} iterations against "
              f"fused_sa's {int(i_sa)}")
        check(end <= band and res_k <= FUSED_F64_RESIDUAL,
              f"fused_anderson {label}: end states {end:.3e} apart "
              f"(band {band:.3e}), kernel residual {res_k:.3e}")
        torch.cuda.synchronize()
        tiles = -(-R // 32) * -(-C // 32)
        print(f"fused {label} ({R}x{C}, {tiles} tiles of 32x32): "
              f"fused_T max abs err {err_t:.3e}; fused_sa 50 steps max abs "
              f"err {err_s:.3e}; fused_anderson {n} steps at ridge "
              f"{B7_CHECK_RIDGE:g} max abs err {err_a:.3e}, NaN-ridge fall "
              f"back vs SA {err_f:.3e}; tol {FUSED_TOL:g}: kernel "
              f"{int(i_k)} iterations, plain {int(i_p)}, fused_sa "
              f"{int(i_sa)}, end states {end:.3e} apart (band {band:.3e}), "
              f"kernel residual under the plain operator {res_k:.3e}")
        max_err["fused_T"] = max(max_err["fused_T"], err_t)
        max_err["fused_sa"] = max(max_err["fused_sa"], err_s)
        max_err["fused_anderson"] = max(max_err["fused_anderson"], err_a,
                                        err_f)

    # 11. One application at 20^4 vs the float64 factored operator.
    model = port.SSY()
    grids64 = port.build_grid_ssy(model, *FUSED_SIZES)
    T = port.make_fused_T_log_ssy_continuous(model, grids64, device=dev)
    T64 = port.T_ssy_continuous_factory(model, grids64, space="log",
                                        device=dev)
    ell64 = torch.as_tensor(noise_field(FUSED_SIZES, SEED), device=dev)
    err = float((T(ell64.float()).double() - T64(ell64)).abs().max())
    check(err <= OPERATOR_ATOL, f"fused operator 20^4 vs f64: {err:.3e}")
    print(f"operator fused continuous {FUSED_SIZES}: one application vs "
          f"f64 max abs err {err:.3e}")

    # 12. The path, on the float32 grids wc_ratio_continuous builds for
    # the fused algorithms.
    grids32 = port.build_grid_ssy(model, *FUSED_SIZES, dtype=torch.float32)
    T64 = port.T_ssy_continuous_factory(
        model, tuple(g.double() for g in grids32), space="log", device=dev)
    zeros64 = torch.zeros(FUSED_SIZES, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    ref = port.solve(T64, zeros64, method="newton", tol=1e-10)
    torch.cuda.synchronize()
    check(ref.converged, f"f64 Newton reference did not converge: {ref}")
    print(f"f64 Newton reference {FUSED_SIZES} (same grids): {ref}, "
          f"{time.perf_counter() - t0:.3f} s")

    def run_fused(algorithm):
        sol = port.wc_ratio_continuous(model, FUSED_SIZES,
                                       algorithm=algorithm, tol=FUSED_TOL,
                                       device=dev)
        return torch.log(sol.w_star), sol.result

    def run_newton():
        T_f = port.make_fused_T_log_ssy_continuous(model, grids32,
                                                   device=dev)
        res = port.solve(T_f, torch.zeros(FUSED_SIZES, device=dev),
                         method="newton", tol=FUSED_NEWTON_TOL)
        return res.x, res

    launches = {}
    counts = (st.LAUNCHES, fd.LAUNCHES)
    for kernel, label, run in (
            ("fused_anderson", "wc_ratio_continuous fused_anderson",
             lambda: run_fused("fused_anderson")),
            ("fused_sa", "wc_ratio_continuous fused_sa",
             lambda: run_fused("fused_sa")),
            ("fused_T", "newton through the fused operator", run_newton)):
        torch.cuda.synchronize()
        for c in counts:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        ell_star, res = run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        now = {**st.LAUNCHES, **fd.LAUNCHES}
        launches[kernel] = now[kernel]
        check(now[kernel] > 0,
              f"{kernel} never launched on the {label} path: {now}")
        check(res.converged, f"{label} did not converge: {res}")
        ell_star = ell_star.double()
        check(bool(torch.isfinite(ell_star).all())
              and tuple(ell_star.shape) == FUSED_SIZES,
              f"{label}: w* not finite/shaped")
        r64 = float((T64(ell_star) - ell_star).abs().max())
        dist = float((ell_star - ref.x).abs().max())
        w = torch.exp(ell_star)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        print(f"path {label} {FUSED_SIZES}: {res}; launches "
              f"{ {k: v for k, v in now.items() if v} }; f64 residual "
              f"{r64:.3e}; max|l* - l*_f64 Newton| {dist:.3e}; w* in "
              f"[{float(w.min()):.3f}, {float(w.max()):.3f}]; {cold:.3f} s "
              f"cold, {warm:.3f} s warm ({smi})")
        check(r64 <= FUSED_F64_RESIDUAL, f"{label}: f64 residual {r64:.3e}")

    # 13. Timing at 20^4: the suite cell, each kernel vs its plain
    # version.
    ops = tuple(cast(a.numpy()) for a in fd.kron_operands_ssy_continuous(
        model, grids32, 5, torch.float64))
    R, C = ops[2].shape
    th, be = model.theta, model.beta
    # The cell runs a fixed count from w = 800: tol -1 never stops it
    # (with tol 0 an iterate that T maps exactly onto itself would).
    x800 = torch.full((R, C), float(np.log(800.0)), device=dev)
    sk.fused_sa(x800, *ops, None, th, be, -1.0, 100)
    (_, iters, _), ms = events_ms(torch, lambda: sk.fused_sa(
        x800, *ops, None, th, be, -1.0, FUSED_CELL_ITERS))
    check(int(iters) == FUSED_CELL_ITERS, f"SA cell ran {int(iters)}")
    app_flop = 2 * R * R * C + 2 * R * C * C
    print(f"timing fused_sa cell {FUSED_SIZES}, {FUSED_CELL_ITERS} "
          f"iterations: {ms:.3f} ms, {1e3 * ms / FUSED_CELL_ITERS:.3f} us "
          f"per iteration (bound {1e6 * app_flop / PEAK_FP32:.3f} us) ({smi})")
    ell = cast(noise_field((R, C), SEED))
    ms_k = time_ms(torch, lambda y: fd.fused_T(y, *ops, None, th, be), ell)
    ms_p = time_ms(torch, lambda y: fd.fused_T_plain(y, *ops, None, th, be),
                   ell)
    T_f = port.make_fused_T_log_ssy_continuous(model, grids32, device=dev)
    x4 = ell.reshape(FUSED_SIZES)
    ms_T, ms_twin = time_ms(torch, T_f, x4), time_ms(torch, T_f.twin, x4)
    kernels_ms = {"fused_T": (ms_k, ms_p)}
    x0 = torch.zeros((R, C), device=dev)
    field_bytes = 4 * (3 * R * C + R * R + C * C)
    WORK["fused_T"] = (app_flop, field_bytes)
    n = FUSED_TIMED_ITERS
    for name, kern, plain in (("fused_sa", sk.fused_sa, sk.fused_sa_plain),
                              ("fused_anderson", ak.fused_anderson,
                               ak.fused_anderson_plain)):
        # One solve at tol 1e-5, then kernel vs plain over the same fixed
        # count from the same start (tol -1).
        kern(x0, *ops, None, th, be, FUSED_TOL, 20_000)
        (_, it_s, _), s_ms = events_ms(torch, lambda: kern(
            x0, *ops, None, th, be, FUSED_TOL, 20_000))
        (_, it_k, _), k_ms = events_ms(torch, lambda: kern(
            x0, *ops, None, th, be, -1.0, n))
        (_, it_p, _), p_ms = events_ms(torch, lambda: plain(
            x0, *ops, None, th, be, -1.0, n))
        check(int(it_k) == int(it_p) == n,
              f"{name} timing ran {int(it_k)}/{int(it_p)} iterations")
        kernels_ms[name] = (k_ms, p_ms)
        flop = n * app_flop
        if name == "fused_anderson":
            m = 5                                # history; mixing every 2nd
            mixes = sum(1 for i in range(m, n) if i % 2 == 0)
            flop += mixes * (2 * m * (m + 1) // 2 + 4 * m) * R * C
        WORK[name] = (flop, field_bytes)
        print(f"timing {name} {FUSED_SIZES} from w = 1: tol {FUSED_TOL:g} "
              f"solve {s_ms:.3f} ms ({int(it_s)} iterations); {n} "
              f"iterations: kernel {k_ms:.3f} ms "
              f"({1e3 * k_ms / n:.3f} us per iteration), plain loop "
              f"{p_ms:.3f} ms ({1e3 * p_ms / n:.3f} us per iteration) "
              f"({smi})")
    # Near the float32 floor the two Anderson loops' iteration counts
    # part; printed, not checked.
    _, it_k, q_k = ak.fused_anderson(x0, *ops, None, th, be, FLOOR_TOL,
                                     FLOOR_MAX_ITER)
    _, it_p, q_p = ak.fused_anderson_plain(x0, *ops, None, th, be, FLOOR_TOL,
                                           FLOOR_MAX_ITER)
    print(f"fused_anderson {FUSED_SIZES} from w = 1 at tol {FLOOR_TOL:g}: "
          f"kernel {int(it_k)} iterations (err {float(q_k):.3e}), plain "
          f"{int(it_p)} (err {float(q_p):.3e}), cap {FLOOR_MAX_ITER}")
    print(f"timing fused_T {FUSED_SIZES}: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms; operator T {ms_T:.4f} ms vs its twin "
          f"{ms_twin:.4f} ms per application ({smi})")
    return max_err, launches, kernels_ms


def pair_kernel_check(torch, st, ops, dev, seed):
    """Pass B deferred (with the folded baseline) and pass C pair vs
    their plain versions on one operand set.  Returns (err_b, err_c,
    ell, b_args, c_args, mid): the view field and arguments for timing."""
    cast = f32_cast(torch, dev)
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    th, be = float(ops.theta), float(ops.beta)
    rng = np.random.default_rng(seed)
    ell = cast(ops.baseline_log_w
               + 0.05 * rng.standard_normal(ops.shapes)).reshape(R, I, J)
    b_args = (cast(np.asarray(ops.W_c1).T), th,
              cast(np.asarray(ops.sub_row).reshape(R)), cast(ops.sub_col))
    got_b = st.pass_b_deferred(ell, *b_args)
    want_b = st.pass_b_deferred_plain(ell, *b_args)
    err_b = float((got_b - want_b).abs().max())
    lim = KERNEL_ATOL + float(np.finfo(np.float32).eps) * want_b.abs()
    check(bool(((got_b - want_b).abs() <= lim).all()),
          f"pass_b_deferred with sub {ops.shapes}: max abs err {err_b:.3e}")
    mid = want_b.reshape(R, C)
    del got_b, want_b
    P_zpi, PzT = st.pair_device_operands(ops, device=dev)
    c_args = (P_zpi, PzT, cast(ops.W_r1), cast(ops.W_r2), cast(ops.add_row),
              cast(np.asarray(ops.add_col).reshape(C)), th, be)
    got_c = st.pass_c_pair(mid, *c_args)
    want_c = st.pass_c_pair_plain(mid, *c_args)
    err_c = float((got_c - want_c).abs().max())
    check(bool(torch.isfinite(got_c).all()) and err_c <= KERNEL_ATOL,
          f"pass_c_pair {ops.shapes}: max abs err {err_c:.3e}")
    torch.cuda.synchronize()
    return err_b, err_c, ell, b_args, c_args, mid


def gcy_continuous_phases(torch, port, st, dev, smi):
    """Phases 14-16 (continuous GCY).  Returns the kernels' max abs
    errors vs plain, the path's launch counts and (kernel ms, plain ms)
    of pass_c_pair at 18.9M."""
    from sdfs_via_autodiff_tpu_torch import drivers

    model = port.GCY()
    max_err = {"pass_b_deferred": 0.0, "pass_c_pair": 0.0}
    tol = 1.2 * port.f32_tol_floor(model.theta)

    # 14. Kernels vs plain at four sets; one application vs f64.
    coarse_s = {}
    timing_sets = {}
    for sizes in (GCYC_SMALL, GCYC_RAGGED, GCYC_SUITE, GCYC_SHAPES):
        if sizes in (GCYC_SMALL, GCYC_RAGGED):
            baseline, label = "loglinear", "log-linear"
        else:
            t0 = time.perf_counter()
            baseline = drivers._coarse_additive_baseline(
                model, sizes, num_std_devs=3.2, quad_degree=5,
                dtype=torch.float64, device=dev)
            coarse_s[sizes] = time.perf_counter() - t0
            label = f"coarse ({coarse_s[sizes]:.2f} s)"
        grids = port.build_grid_gcy(model, *sizes)
        ops = port.two_phase_operands_gcy_continuous(model, grids, 5,
                                                     baseline)
        check(port.streamed_config(ops) == "pair",
              f"continuous GCY {sizes}: not the pair configuration")
        err_b, err_c, ell, b_args, c_args, mid = pair_kernel_check(
            torch, st, ops, dev, SEED)
        print(f"continuous GCY {sizes} view {ops.shapes}, {label} baseline: "
              f"pass_b_deferred with sub max abs err mid {err_b:.3e}; "
              f"pass_c_pair max abs err out {err_c:.3e}")
        max_err["pass_b_deferred"] = max(max_err["pass_b_deferred"], err_b)
        max_err["pass_c_pair"] = max(max_err["pass_c_pair"], err_c)
        if sizes in (GCYC_SUITE, GCYC_SHAPES):
            timing_sets[sizes] = (grids, baseline, ops, ell, b_args, c_args,
                                  mid)
        else:
            del ell, b_args, c_args, mid
    grids, base18 = timing_sets[GCYC_SHAPES][:2]
    T = port.make_tiled_T_log_gcy_continuous(model, grids, baseline=base18,
                                             device=dev)
    check(T.engine == "streamed-pair" and T.mode == "lse",
          f"continuous GCY runs {T.engine}/{T.mode}")
    T64 = port.T_gcy_continuous_factory(model, grids, space="log",
                                        baseline=base18, device=dev)
    rng = np.random.default_rng(SEED)
    ell64 = T.baseline_log_w.double() + 0.05 * torch.as_tensor(
        rng.standard_normal(GCYC_SHAPES), device=dev)
    err = float((T(ell64.float()).double() - T64(ell64)).abs().max())
    check(err <= OPERATOR_ATOL, f"continuous GCY operator vs f64: {err:.3e}")
    print(f"operator continuous GCY {GCYC_SHAPES}, coarse baseline: one "
          f"application vs f64 max abs err {err:.3e}")
    del ell64
    torch.cuda.empty_cache()

    # 15. The path, cold then warm.
    algorithm = drivers._default_algorithm(model, "tiled")
    launches = None
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        for k in st.LAUNCHES:
            st.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        sol = port.wc_ratio_continuous(
            model, GCYC_SHAPES, kernel="tiled", baseline="coarse", tol=tol,
            max_iter=GCYC_MAX_ITER, device=dev)
        res, how = sol.result, algorithm
        if not res.converged:
            # The NORTHSTAR recipe: Anderson from SA's iterate.
            sa = res
            res = port.solve(T, res.x, method="anderson", tol=tol,
                             max_iter=GCYC_MAX_ITER)
            how = (f"{algorithm} stopped ({sa.iterations} iterations, "
                   f"residual {sa.residual:.3e}), then anderson")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if launches is None:
            launches = dict(st.LAUNCHES)
        print(f"continuous GCY path {GCYC_SHAPES} tiled, coarse baseline "
              f"(~{coarse_s[GCYC_SHAPES]:.2f} s of it), tol {tol:.3e}, "
              f"{run}: {how}: {res}; launches "
              f"{ {k: v for k, v in st.LAUNCHES.items() if v} }; "
              f"{secs:.3f} s ({smi})")
        check(res.converged, f"continuous GCY path ({run}) did not "
              f"converge: {res}")
    check(launches["pass_b_deferred"] > 0 and launches["pass_c_pair"] > 0,
          f"a kernel of the continuous GCY path never launched: {launches}")
    ell_star = res.x.double()
    check(bool(torch.isfinite(ell_star).all())
          and tuple(ell_star.shape) == GCYC_SHAPES,
          "continuous GCY w* not finite/shaped")
    r64 = float((T64(ell_star) - ell_star).abs().max())
    w = torch.exp(ell_star)
    print(f"continuous GCY path f64 residual max|T64(l*) - l*| = {r64:.3e}; "
          f"w* in [{float(w.min()):.3f}, {float(w.max()):.3f}]")
    check(r64 <= GCYC_F64_RESIDUAL, f"continuous GCY f64 residual {r64:.3e}")
    del T64, sol, res, ell_star, w
    torch.cuda.empty_cache()

    # 16. Timing at 4.2M and 18.9M.
    kernels_ms = {}
    for sizes in (GCYC_SUITE, GCYC_SHAPES):
        grids, baseline, ops, ell, b_args, c_args, mid = timing_sets.pop(
            sizes)
        t0 = time.perf_counter()
        T = port.make_tiled_T_log_gcy_continuous(model, grids,
                                                 baseline=baseline,
                                                 device=dev)
        torch.cuda.synchronize()
        print(f"continuous GCY {sizes}: operator build (host float64 "
              f"operands, copies to the card) {time.perf_counter() - t0:.3f} "
              "s")
        x = T.from_view(ell.reshape(T.to_view(T.baseline_log_w).shape))
        x = x.contiguous()
        ms_k = time_ms(torch, T, x)
        ms_p = time_ms(torch, T.twin, x)
        ms_view = time_ms(torch, T.view_T, ell.reshape(ops.shapes))
        b_k = time_ms(torch, lambda y: st.pass_b_deferred(y, *b_args), ell)
        b_p = time_ms(torch, lambda y: st.pass_b_deferred_plain(y, *b_args),
                      ell)
        c_k = time_ms(torch, lambda y: st.pass_c_pair(y, *c_args), mid)
        c_p = time_ms(torch, lambda y: st.pass_c_pair_plain(y, *c_args), mid)
        L, K, I, J = ops.shapes
        n_i, n_y, n_b, n_j = ops.pair_shapes
        R, C = L * K, I * J
        field = 4 * R * C
        # Pass B: c1 over I' per (row, column).  Pass C: z_pi' and z'
        # per slice, then the two row contractions; each pass reads and
        # writes one f32 field plus its operands.
        b_work = (2 * R * I * I * J, 2 * field + 4 * (I * I + R + C))
        c_work = (2 * R * I * n_b * n_j * (n_j + n_b) + 2 * C * R * (L + K),
                  2 * field + 4 * (n_i * n_b * n_j * n_j + n_y * n_b * n_b
                                   + L * L + K * K + R + C))
        WORK["pass_c_pair"] = c_work
        kernels_ms["pass_c_pair"] = (c_k, c_p)
        bounds = []
        for flop, nbytes in (b_work, c_work):
            t_o, t_b = flop / PEAK_FP32, nbytes / HBM_BYTES_PER_S
            bounds.append(f"{1e3 * max(t_o, t_b):.4f} ms "
                          f"({'operations' if t_o >= t_b else 'bytes'}, "
                          f"{flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        print(f"timing continuous GCY {sizes} view {ops.shapes}: kernels "
              f"{ms_k:.4f} ms per application (view layout {ms_view:.4f}), "
              f"plain eager twin {ms_p:.4f} ms; pass_b_deferred with sub: "
              f"kernel {b_k:.4f} ms, plain {b_p:.4f} ms, bound {bounds[0]}; "
              f"pass_c_pair: kernel {c_k:.4f} ms, plain {c_p:.4f} ms, bound "
              f"{bounds[1]} ({smi})")
        if sizes == GCYC_SHAPES:
            sa_split(torch, port, T, tol, smi)
        del T, x, ell, b_args, c_args, mid
        torch.cuda.empty_cache()
    return max_err, launches, kernels_ms


def sa_split(torch, port, T, tol, smi):
    """Where the continuous-GCY SA loop's time goes: its seconds on the
    prebuilt operator, then 64 iterations under torch.profiler (device
    time by kernel and the device's busy share of the window)."""
    from torch.profiler import ProfilerActivity, profile

    x0 = T.baseline_log_w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = port.solve(T, x0, method="sa", tol=tol, max_iter=GCYC_MAX_ITER)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"continuous GCY SA on the prebuilt operator: {res}, {secs:.3f} s, "
          f"{1e3 * secs / max(res.iterations, 1):.3f} ms per iteration "
          f"({smi})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.solve(T, x0, method="sa", tol=0.0, max_iter=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: an operator's entry also carries the time
    # of the kernels it launched.
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    busy = sum(t for _, t in rows)
    if busy == 0:
        print("torch.profiler recorded no device time for the SA loop")
        return
    top = "; ".join(f"{k[:40]} {t / 1e3:.2f} ms ({100 * t / busy:.1f}%)"
                    for k, t in rows[:6])
    print(f"continuous GCY SA, 64 iterations under torch.profiler: wall "
          f"{1e3 * wall:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / 1e6 / wall:.1f}%); by kernel: {top}")


def fused_gcy_phase(torch, port, dev, smi):
    """Phase 17: the fused tier on continuous GCY at 6^6.  Returns the
    fused application's max abs error vs plain."""
    from sdfs_via_autodiff_tpu_torch import drivers
    from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd

    model = port.GCY()
    tol = 1.2 * port.f32_tol_floor(model.theta)
    for algorithm in ("fused_sa", "fused_anderson"):
        torch.cuda.synchronize()
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        sol = port.wc_ratio_continuous(model, FUSED_GCY_SIZES,
                                       algorithm=algorithm,
                                       baseline="coarse", tol=tol,
                                       device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = dict(fd.LAUNCHES)
        check(now[algorithm] > 0, f"{algorithm} never launched on the "
              f"continuous GCY fused path: {now}")
        check(sol.converged, f"fused GCY {algorithm} did not converge: "
              f"{sol.result}")
        ell = torch.log(sol.w_star.double())
        T64 = port.T_gcy_continuous_factory(
            model, tuple(g.double() for g in sol.grids), space="log",
            device=dev)
        r64 = float((T64(ell) - ell).abs().max())
        print(f"path continuous GCY {FUSED_GCY_SIZES} {algorithm}, coarse "
              f"baseline, tol {tol:.3e}: {sol.result}; launches "
              f"{ {k: v for k, v in now.items() if v} }; f64 residual "
              f"{r64:.3e}; {secs:.3f} s with the coarse solve ({smi})")
        check(r64 <= GCYC_F64_RESIDUAL,
              f"fused GCY {algorithm}: f64 residual {r64:.3e}")
    grids32 = port.build_grid_gcy(model, *FUSED_GCY_SIZES,
                                  dtype=torch.float32)
    base = drivers._coarse_additive_baseline(
        model, FUSED_GCY_SIZES, num_std_devs=3.2, quad_degree=5,
        dtype=torch.float64, device=dev)
    M1, M2T, kap, shapes, rows, cols, sub = fd.kron_operands_gcy_continuous(
        model, grids32, 5, base, torch.float64)
    ops = tuple(a.to(device=dev, dtype=torch.float32).contiguous()
                for a in (M1, M2T, kap, sub))
    rng = np.random.default_rng(SEED)
    ell = (ops[3] / model.theta + 0.05 * torch.as_tensor(
        rng.standard_normal((rows, cols)), dtype=torch.float32, device=dev))
    th, be = model.theta, model.beta
    got = fd.fused_T(ell, *ops, th, be)
    err = float((got - fd.fused_T_plain(ell, *ops, th, be)).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= KERNEL_ATOL,
          f"fused_T continuous GCY {FUSED_GCY_SIZES}: max abs err {err:.3e}")
    print(f"fused continuous GCY {FUSED_GCY_SIZES} ({rows}x{cols}, with "
          f"sub): fused_T max abs err {err:.3e}")
    return err


def post_interp_work(sizes, degree):
    """(FP32 FLOP, bytes) the post-interp function needs for one
    application: the per-axis node chain, which contracts the field along
    each of the four axes at each of the d^4 joint nodes (2 * d^4 * N *
    (n_l + n_k + n_i + n_j) FLOP; transcendentals not counted), reading
    the field, the per-axis bases (the z basis conditioned on h_z), the
    payoff, the per-axis log-weights and the kappa parts once and writing
    the output once."""
    n_l, n_k, n_i, n_j = sizes
    N = n_l * n_k * n_i * n_j
    flop = 2 * degree ** 4 * N * (n_l + n_k + n_i + n_j)
    nbytes = 4 * (2 * N + degree * (n_l ** 2 + n_k ** 2 + n_i ** 2
                                    + n_i * n_j ** 2 + n_l + 4)
                  + n_k + n_j)
    return flop, nbytes


def post_interp_phases(torch, port, dev, smi):
    """Phases 18-19 (the post-interp kernel and its path).  Returns the
    kernel's max abs error vs plain, its launches on the post path and
    (kernel ms, plain ms) at 20^4 "post"."""
    from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
    from sdfs_via_autodiff_tpu_torch.operators import post_interp as ppi

    model = port.SSY()
    max_err = 0.0
    kernels_ms = None
    nodes, logw = ppi.ssy_quadrature_nodes(POST_DEGREE)
    # 18. Kernel vs plain at two grids, both interpolation spaces, on the
    # arguments the operator hands the kernel; timed.  At 20^4 also one
    # application of the operator vs the float64 node chain.
    for sizes in (POST_CHECK_SIZES, POST_SIZES):
        grids = port.build_grid_ssy(model, *sizes)
        ell64 = torch.as_tensor(noise_field(sizes, SEED), device=dev)
        for interp in ("post", "loglin"):
            T = pk.make_post_interp_kernel_T_ssy(model, grids, POST_DEGREE,
                                                 interp, device=dev)
            args = T.kernel_args(ell64.float())
            got = pk.post_interp(*args)
            want = pk.post_interp_plain(*args)
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= KERNEL_ATOL,
                  f"post_interp {interp} {sizes}: max abs err {err:.3e}")
            max_err = max(max_err, err)
            ms_k = time_ms(torch, lambda y: pk.post_interp(*args), None,
                           n=20)
            ms_p = time_ms(torch, lambda y: pk.post_interp_plain(*args),
                           None, n=20)
            print(f"post_interp {interp} {sizes} (R = C = "
                  f"{args[0].shape[0]}, {args[4].numel()} node pairs): max "
                  f"abs err {err:.3e}; kernel {ms_k:.4f} ms, plain "
                  f"{ms_p:.4f} ms ({smi})")
            del got, want, args
            if sizes == POST_SIZES:
                if interp == "post":
                    kernels_ms = (ms_k, ms_p)
                    WORK["post_interp"] = post_interp_work(sizes,
                                                           POST_DEGREE)
                T64 = ppi.make_node_chain_T_ssy(model, grids, nodes, logw,
                                                interp=interp, device=dev)
                err = float((T(ell64.float()).double()
                             - T64(ell64)).abs().max())
                check(err <= POST_F64_ATOL,
                      f"post-interp operator {interp} vs f64: {err:.3e}")
                print(f"operator post-interp {interp} {sizes}: one "
                      f"application vs the f64 node chain max abs err "
                      f"{err:.3e}")
                del T64
            del T
        del ell64
    torch.cuda.empty_cache()

    # 19. The path, "post" then "loglin", cold then warm.
    grids = port.build_grid_ssy(model, *POST_SIZES)
    launches = None
    for interp in ("post", "loglin"):
        T64 = port.T_ssy_continuous_factory(model, grids, interp=interp,
                                            space="log",
                                            quad_degree=POST_DEGREE,
                                            device=dev)
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            pk.LAUNCHES["post_interp"] = 0
            t0 = time.perf_counter()
            sol = port.wc_ratio_continuous(model, POST_SIZES, kernel="tiled",
                                           interp=interp, tol=POST_TOL,
                                           quad_degree=POST_DEGREE,
                                           device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = pk.LAUNCHES["post_interp"]
            if interp == "post" and run == "cold":
                launches = n
            check(n > 0, f"post_interp never launched on the {interp} path")
            check(sol.converged, f"post-interp path {interp} ({run}) did "
                  f"not converge: {sol.result}")
            ell = torch.log(sol.w_star.double())
            check(bool(torch.isfinite(ell).all())
                  and tuple(ell.shape) == POST_SIZES,
                  f"post-interp path {interp}: w* not finite/shaped")
            r64 = float((T64(ell) - ell).abs().max())
            w = sol.w_star.double()
            print(f"post-interp path {POST_SIZES} {interp} newton tol "
                  f"{POST_TOL:g}, {run}: {sol.result}; post_interp launches "
                  f"{n}; f64 residual {r64:.3e}; w* in "
                  f"[{float(w.min()):.3f}, {float(w.max()):.3f}]; "
                  f"{secs:.3f} s ({smi})")
            check(r64 <= POST_F64_RESIDUAL,
                  f"post-interp path {interp}: f64 residual {r64:.3e}")
        del T64, sol, ell, w
        torch.cuda.empty_cache()
    # Where a Newton step's time goes: the primal through the kernel, the
    # twin, and the tangent matvec (jvp of the float32 node-chain twin).
    T = pk.make_post_interp_kernel_T_ssy(model, grids, POST_DEGREE, "post",
                                         device=dev)
    x = torch.as_tensor(noise_field(POST_SIZES, SEED), device=dev).float()
    v = 0.01 * x
    ms_T = time_ms(torch, T, x, n=10)
    ms_twin = time_ms(torch, T.twin, x, n=10)
    ms_jvp = time_ms(torch, lambda y: torch.func.jvp(T.twin, (y,), (v,))[1],
                     x, n=5)
    print(f"timing post-interp {POST_SIZES}: operator T {ms_T:.3f} ms, its "
          f"node-chain twin {ms_twin:.3f} ms, tangent matvec (jvp of the "
          f"twin) {ms_jvp:.3f} ms ({smi})")
    del T, x, v
    return max_err, launches, kernels_ms


def anchor_phase(torch, port, dev, smi):
    """Phase 20: the reference's one-step moment anchors on the card."""
    model = port.SSY()
    for interp, std, mean_ref, std_ref in ANCHORS:
        t0 = time.perf_counter()
        sol = port.wc_ratio_continuous(model, ANCHOR_SIZES,
                                       algorithm="newton", tol=1e-9,
                                       interp=interp,
                                       quad_degree=ANCHOR_DEGREE,
                                       num_std_devs=std, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        check(sol.converged, f"anchor solve {interp} {std}: {sol.result}")
        t0 = time.perf_counter()
        f = port.construct_wstar_callable(sol.w_star, sol.grids, device=dev)
        mean, sd = port.one_step_w_moments(model, f, num_draws=ANCHOR_DRAWS,
                                           device=dev)
        mom_s = time.perf_counter() - t0
        rm, rs = (mean - mean_ref) / mean_ref, (sd - std_ref) / std_ref
        print(f"anchor {ANCHOR_SIZES} d={ANCHOR_DEGREE} interp={interp} "
              f"{std} sd: {sol.result} in {solve_s:.3f} s; E[w] = "
              f"{mean:.5f} (anchor {mean_ref:.5f}, rel {rm:+.2e}), sd[w] = "
              f"{sd:.5f} (anchor {std_ref:.5f}, rel {rs:+.2e}); moments "
              f"{mom_s:.3f} s ({smi})")
        check(abs(rm) < ANCHOR_MEAN_RTOL and abs(rs) < ANCHOR_STD_RTOL,
              f"anchor {interp} {std}: E[w] {mean:.5f} / sd {sd:.5f} vs "
              f"{mean_ref} / {std_ref}")
    torch.cuda.empty_cache()


def mc_phase(torch, port, dev, smi):
    """Phase 21: the JAX suite's Monte Carlo node chains, ms per
    application over MC_APPS applications (CUDA events)."""
    f32 = torch.float32
    ssy, gcy = port.SSY(), port.GCY()
    cases = []
    grids = port.build_grid_ssy(ssy, *MC_SSY_SIZES)
    T = port.T_ssy_continuous_factory(ssy, grids, method="monte_carlo",
                                      interp="post", space="log",
                                      mc_draw_size=MC_DRAWS, dtype=f32,
                                      device=dev)
    cases.append(("SSY", MC_SSY_SIZES, T, torch.full(
        MC_SSY_SIZES, float(np.log(800.0)), dtype=f32, device=dev), ""))
    grids = port.build_grid_gcy(gcy, *MC_GCY_SIZES)
    x0 = port.T_gcy_continuous_factory(
        gcy, grids, space="log", baseline="loglinear", dtype=f32,
        device=dev).baseline_log_w
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        T = port.T_gcy_continuous_factory(gcy, grids, method="monte_carlo",
                                          interp="post", space="log",
                                          mc_draw_size=MC_DRAWS, dtype=f32,
                                          device=dev)
    note = ("; throughput only, f32 span warning: " + "; ".join(
        str(w.message)[:60] for w in caught)) if caught else ""
    cases.append(("GCY", MC_GCY_SIZES, T, x0, note))
    for label, sizes, T, x0, note in cases:
        def apps():
            x = x0
            for _ in range(MC_APPS):
                x = T(x)
            return x
        apps()
        out, ms = events_ms(torch, apps)
        finite = bool(torch.isfinite(out).all())
        if not note:
            check(finite, f"MC node chain {label}: non-finite output")
        print(f"MC node chain {label} {sizes} ({int(np.prod(sizes))} states, "
              f"{MC_DRAWS} draws, post, f32): {ms / MC_APPS:.3f} ms per "
              f"application over {MC_APPS}; output finite {finite}{note} "
              f"({smi})")
        del T, x0, out
        torch.cuda.empty_cache()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA GPU")

    import sdfs_via_autodiff_tpu_torch as port
    from sdfs_via_autodiff_tpu_torch.kernels import _build
    from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
    from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
    from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Device facts.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    print(f"device: {kind}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    print(f"triton imports: {has_triton}")
    print(f"before: float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "could not set full-FP32 matmuls")

    # 2. Build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    st._lib()
    fd._lib()
    pk._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in paths)}")
    for lib_path in paths:
        print(lib_path.with_suffix(".log").read_text().strip())

    # 3. Kernels vs plain versions, and 4. operator vs float64.
    max_err = {"pass_b": 0.0, "pass_c": 0.0}
    model = port.SSY()
    for shapes, method in SHAPES:
        L, K, I, J = shapes
        R, C = L * K, I * J
        disc = port.discretize_ssy(model, shapes, method=method)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops = port.two_phase_operands_ssy(model, disc)
        for w in caught:
            print(f"warning at {shapes} {method}: {w.message}")
        cast = f32_cast(torch, dev)
        W_c1, W_c2t = cast(ops.W_c1), cast(np.asarray(ops.W_c2).T)
        W_r1, W_r2 = cast(ops.W_r1), cast(ops.W_r2)
        add_row, add_col = cast(ops.add_row), cast(ops.add_col.reshape(C))
        th, be = float(ops.theta), float(ops.beta)
        ell64 = torch.as_tensor(noise_field(shapes, SEED), device=dev)
        ell = ell64.float().reshape(R, I, J).contiguous()
        for mode in ("fast", "lse"):
            got_b = st.pass_b(ell, W_c1, W_c2t, th, mode)
            want_b = st.pass_b_plain(ell, W_c1, W_c2t, th, mode)
            if mode == "fast":
                (mid_k, s_k), (mid_p, s_p) = got_b, want_b
                rel = float(((mid_k - mid_p).abs() / mid_p.abs()).max())
                s_err = float((s_k - s_p).abs().max())
                err_b = float((mid_k - mid_p).abs().max())
                check(rel <= KERNEL_RTOL_LINEAR and s_err <= KERNEL_ATOL,
                      f"pass B fast {shapes}: mid rel {rel:.3e}, s {s_err:.3e}")
                scale = torch.exp(s_p - s_p.max())
                S = s_p.max().reshape(1)
                print(f"pass_b fast {shapes}: max rel err mid {rel:.3e}, "
                      f"max abs err s {s_err:.3e}")
            else:
                mid_k, mid_p = got_b, want_b
                scale = S = None
                lim = KERNEL_ATOL + float(np.finfo(np.float32).eps) * mid_p.abs()
                err_b = float((mid_k - mid_p).abs().max())
                check(bool(((mid_k - mid_p).abs() <= lim).all()),
                      f"pass B lse {shapes}: max abs err {err_b:.3e}")
                print(f"pass_b lse  {shapes}: max abs err mid {err_b:.3e}")
            max_err["pass_b"] = max(max_err["pass_b"], err_b)
            mid2 = mid_p.reshape(R, C)
            out_k = st.pass_c(mid2, scale, S, W_r1, W_r2, add_row, add_col,
                              th, be, mode)
            out_p = st.pass_c_plain(mid2, scale, S, W_r1, W_r2, add_row,
                                    add_col, th, be, mode)
            err_c = float((out_k - out_p).abs().max())
            check(bool(torch.isfinite(out_k).all()) and err_c <= KERNEL_ATOL,
                  f"pass C {mode} {shapes}: max abs err {err_c:.3e}")
            print(f"pass_c {mode:4s} {shapes}: max abs err out {err_c:.3e}")
            max_err["pass_c"] = max(max_err["pass_c"], err_c)
        torch.cuda.synchronize()

        if shapes != SHAPES[0][0]:
            T64 = port.T_ssy_factory(model, disc, space="log", device=dev)
            ref = T64(ell64)
            for mode in ("fast", "lse"):
                T = port.make_tiled_T_log_ssy(model, disc, mode=mode,
                                              device=dev)
                err = float((T(ell64.float()).double() - ref).abs().max())
                check(err <= OPERATOR_ATOL,
                      f"operator {mode} {shapes} vs f64: {err:.3e}")
                print(f"operator {mode} {shapes} {method}: one application "
                      f"vs f64 max abs err {err:.3e}")
            del T64, ref

    # 5. Main path.
    torch.cuda.synchronize()
    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    sol = port.wc_ratio_discrete(model, MAIN_SHAPES, kernel="tiled",
                                 discretization=MAIN_METHOD,
                                 algorithm="newton", tol=MAIN_TOL,
                                 device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    res = sol.result
    print(f"main path {MAIN_SHAPES} {MAIN_METHOD} newton: {res}, "
          f"{solve_s:.3f} s, launches {launches}")
    check(res.converged, f"main path did not converge: {res}")
    check(launches["pass_b"] > 0 and launches["pass_c"] > 0,
          f"a kernel of the SSY path never launched: {launches}")
    disc = port.discretize_ssy(model, MAIN_SHAPES, method=MAIN_METHOD)
    T64 = port.T_ssy_factory(model, disc, space="log", device=dev)
    ell_star = torch.log(sol.w_star.double())
    check(bool(torch.isfinite(ell_star).all())
          and tuple(ell_star.shape) == MAIN_SHAPES, "w* not finite/shaped")
    r64 = float((T64(ell_star) - ell_star).abs().max())
    w = sol.w_star.double()
    print(f"main path f64 residual max|T64(l*) - l*| = {r64:.3e}; "
          f"w* in [{float(w.min()):.3f}, {float(w.max()):.3f}]")
    check(r64 <= MAIN_F64_RESIDUAL, f"f64 residual {r64:.3e}")
    del T64, sol, w, ell_star

    # 6. Timing.  The solve above was the process's first: it carries
    # one-time start-up (torch.func, cuBLAS); time a second, warm solve.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = port.wc_ratio_discrete(model, MAIN_SHAPES, kernel="tiled",
                                  discretization=MAIN_METHOD,
                                  algorithm="newton", tol=MAIN_TOL,
                                  device=dev)
    torch.cuda.synchronize()
    print(f"main path warm solve: {warm.result}, "
          f"{time.perf_counter() - t0:.3f} s ({smi})")
    check(warm.converged, f"warm solve did not converge: {warm.result}")
    del warm
    kernels_ms = {}
    for shapes, method in SHAPES[1:]:
        disc = port.discretize_ssy(model, shapes, method=method)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            T = port.make_tiled_T_log_ssy(model, disc, device=dev)
        x = torch.as_tensor(noise_field(shapes, SEED), device=dev).float()
        ms_k = time_ms(torch, T, x)
        ms_p = time_ms(torch, T.twin, x)
        ms_k2 = time_ms(torch, T, x)
        print(f"timing {shapes} {method}: kernels {ms_k:.4f} / {ms_k2:.4f} "
              f"ms per application, plain eager twin {ms_p:.4f} ms "
              f"({smi})")
        if shapes == MAIN_SHAPES:
            L, K, I, J = shapes
            ops = port.two_phase_operands_ssy(model, disc)
            cast = f32_cast(torch, dev)
            W_c1, W_c2t = cast(ops.W_c1), cast(np.asarray(ops.W_c2).T)
            W_r1, W_r2 = cast(ops.W_r1), cast(ops.W_r2)
            add_row = cast(ops.add_row)
            add_col = cast(ops.add_col.reshape(I * J))
            th, be = float(ops.theta), float(ops.beta)
            e = x.reshape(L * K, I, J)
            mid, s = st.pass_b_plain(e, W_c1, W_c2t, th, "fast")
            S = s.max().reshape(1)
            scale = torch.exp(s - S)
            mid2 = mid.reshape(L * K, I * J)
            b_args = (W_c1, W_c2t, th, "fast")
            c_args = (scale, S, W_r1, W_r2, add_row, add_col, th, be, "fast")
            kernels_ms["pass_b"] = (
                time_ms(torch, lambda y: st.pass_b(y, *b_args), e),
                time_ms(torch, lambda y: st.pass_b_plain(y, *b_args), e))
            kernels_ms["pass_c"] = (
                time_ms(torch, lambda y: st.pass_c(y, *c_args), mid2),
                time_ms(torch, lambda y: st.pass_c_plain(y, *c_args), mid2))
            R, C = L * K, I * J
            field = 4 * R * C
            WORK["pass_b"] = (2 * R * (I * I * J + I * J * J),
                              2 * field + 4 * (I * I + J * J + R))
            WORK["pass_c"] = (2 * C * R * (L + K),
                              2 * field + 4 * (L * L + K * K + 2 * R + C + 1))
            for name, (k_ms, p_ms) in kernels_ms.items():
                print(f"timing {name} fast {shapes}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms")

    # 7-9. GCY.
    del T
    torch.cuda.empty_cache()
    gcy_err, gcy_launches, gcy_ms = gcy_phases(torch, port, st, dev, smi)
    max_err.update(gcy_err)
    launches = {"pass_b": launches["pass_b"], "pass_c": launches["pass_c"],
                **{k: gcy_launches[k] for k in gcy_err}}
    kernels_ms.update(gcy_ms)

    # 10-13. The continuous-SSY fused tier.
    torch.cuda.empty_cache()
    fused_err, fused_launches, fused_ms = fused_phases(torch, port, dev, smi)
    max_err.update(fused_err)
    launches.update(fused_launches)
    kernels_ms.update(fused_ms)

    # 14-16. Continuous GCY.
    torch.cuda.empty_cache()
    gcyc_err, gcyc_launches, gcyc_ms = gcy_continuous_phases(
        torch, port, st, dev, smi)
    max_err["pass_b_deferred"] = max(max_err["pass_b_deferred"],
                                     gcyc_err["pass_b_deferred"])
    max_err["pass_c_pair"] = gcyc_err["pass_c_pair"]
    launches["pass_c_pair"] = gcyc_launches["pass_c_pair"]
    kernels_ms.update(gcyc_ms)

    # 17. The fused tier on continuous GCY.
    torch.cuda.empty_cache()
    max_err["fused_T"] = max(max_err["fused_T"],
                             fused_gcy_phase(torch, port, dev, smi))

    # 18-19. The post-interp kernel and the continuous-SSY post path.
    torch.cuda.empty_cache()
    (max_err["post_interp"], launches["post_interp"],
     kernels_ms["post_interp"]) = post_interp_phases(torch, port, dev, smi)

    # 20. The reference's moment anchors; 21. the Monte Carlo node chains.
    anchor_phase(torch, port, dev, smi)
    mc_phase(torch, port, dev, smi)

    # 22. Result.
    print(f"total {time.perf_counter() - t_start:.1f} s")
    rows = []
    for name in KERNELS:
        bound_ms, bound_by = bound(name)
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCE_OF[name], "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": kernels_ms[name][0],
                     "plain_ms": kernels_ms[name][1], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
