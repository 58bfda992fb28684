#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device facts (name, power limit, toolchain); full-FP32 matmuls;
2. build the CUDA kernels from the five sources in ``kernels/csrc/``;
3. SSY: pass B and pass C against their plain PyTorch versions on the
   card, both modes, at (4,8,6,64), (56,56,56,64) Rouwenhorst and
   (32,32,32,384) Tauchen;
4. SSY: one operator application against the float64 operator on the
   card;
5. the SSY path: a float32 Newton solve through the kernels at the
   12.6M-point (32,32,32,384) Tauchen grid, checked against the float64
   operator, with the kernels' launch counts (the fused Krylov passes'
   against its BiCGStab iterations, each of the tangent passes' three
   kernels against its tangent matvecs);
6. SSY: a second (warm) solve's seconds, and ms per application,
   kernels vs the plain eager twin (CUDA events); then the fused Krylov
   passes (K1, ``kernels/csrc/krylov_fused.cu``) against the eager
   BiCGStab loop on Newton's first SSY tangent at that grid (iteration
   count within 1, x within 1e-3 of max |x|, fused solves bitwise
   repeatable), their device ms per iteration against their byte bound
   (CUDA events around each group of passes, a spin kernel ahead of
   each group so the card never waits for the host's launches; and
   without it, as in a solve), and the eager loop's vector work per
   iteration (a solve's device time less its matvecs');
7. GCY: the deferred pass B and pass C against their plain versions at
   a ragged view (2,4,56,258) and at the 25.2M-point grid's
   (12,16,512,256); the deferred pass B's tensor-core layout at ragged
   (R, I, J) = (3,301,70) and (2,517,37), with and without a fold; one
   application of the GCY operator at (32,16,16,12,16,16) Tauchen
   against the float64 operator;
8. the GCY path: a float32 Newton solve through the deferred kernels at
   (32,16,16,12,16,16) Tauchen from the log-linear warm start, checked
   against the float64 operator, with the launch counts (one deferred
   pass B per pass C), the outer and BiCGStab iterations and the seconds;
9. GCY: ms per application, kernels vs the eager twin, ms per tangent
   matvec, and each deferred kernel vs its plain version, the deferred
   pass B also with a synthetic folded baseline at that view;
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
    (log-linear baseline), a ragged (5,3,3,2,40,3), (5,3,2,2,40,12)
    (12 z_pi points: two rounds of the 8-block cluster), the 4.2M-point
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
    residual), and at that operand set (the chunked layout) the fused
    application, 50 SA steps, 20 Anderson steps at ridge 0.1 and its
    NaN-ridge fall back against their plain versions;
18. the post-interp kernel (``kernels/csrc/post_interp.cu``, a gather
    over the per-axis hat-basis corner tables) against its plain version
    on the same arguments and against the plain Kronecker version on the
    dense stacks, at 15^4 and 20^4, "post" and "loglin", on the arguments
    the operator hands it (``T.kernel_args``), all three timed, and one
    application at 20^4 against the float64 node chain;
19. the continuous-SSY post-interp path at 20^4:
    ``wc_ratio_continuous(SSY(), (20,)*4, kernel="tiled", interp="post")``
    (cold only) and again with ``"loglin"`` (cold then warm; Newton, tol
    2e-5, from w = 1, its tangent the float32 twin's linearization, one
    build per Newton step), with the launch counts, the iterations and
    the float64 residual through the float64 node chain; then a Newton
    step's parts timed: the operator, its twin, the linearized matvec
    and its build, and the jvp matvec;
20. the reference's published one-step moment anchors at 15^4, degree
    5: a float64 Newton solve (tol 1e-9, ``interp="pre"`` and
    ``"loglin"``, 3.2 and 2.5 standard deviations), then
    ``construct_wstar_callable`` and ``one_step_w_moments`` with 10^6
    draws, each within 1e-3 on the mean and 5e-3 on the std;
21. the Monte Carlo node chains of the JAX suite: SSY 20^4 and GCY
    (8,8,8,8,6,6) with 2,000 draws, "post", float32, ms per application
    over 5 applications (GCY: throughput only, as in the JAX suite: its
    float32 span warning is expected);
22. tiled continuous SSY (``interp="pre"``, the batched configuration):
    pass B's c1-only branch (with and without the log-linear fold) and
    the batched pass C against their plain versions, both modes, at
    (4,8,6,64), (3,5,7,40), 20^4, the ragged (31,29,5,42) (its pass C a
    cluster of 2) and the 11.2M-point (56,56,56,64) cell (a cluster of
    8), each pass-C layout held against the launcher's own choice;
    pass B's folded-baseline branch with a shared c2 on discrete SSY sets
    with a synthetic fold;
23. one application at the cell against the float64 factored operator,
    (a) plain and (b) with the log-linear fold, both modes;
24. the continuous-SSY tiled path at the cell, cold then warm:
    (a) ``wc_ratio_continuous(SSY(), (56,56,56,64), kernel="tiled",
    tol=2e-5)`` (fast mode) from the log-linear solution on the grid, and
    (b) the same with ``baseline="loglinear"`` (lse mode) from the
    baseline, with the launch counts, Newton and BiCGStab iterations and
    the float64 residual;
25. timing at the cell: ms per application (kernels vs the eager twin),
    each new kernel vs its plain version, ms per tangent matvec;
26. the reference's 20^4 anchor (degree 8, 2.5 standard deviations)
    solved through the tiled float32 path, then
    ``construct_wstar_callable`` and ``one_step_w_moments`` with 10^6
    draws, within 1e-3 on the mean and 5e-3 on the std;
27. the strip tier (``kernels/csrc/tiled_two_phase.cu``): its column and
    row phases against their plain versions, both modes, with shared,
    dense-batched and lazy (rank 1 and 2) factors, with and without the
    fold, at SSY (4,5,6,7), (6,5,6,16) with every batched factor lazy,
    the GCY (6,5,4,3,4,3) view, the column phase's product tiles at
    their edges (SSY (20,13,5,70): 260 field rows over two column
    tiles; (3,5,67,130): shared factors folded into N, ragged 128 x 128
    tiles), and both cells (plain and normalized), each column phase one
    ``strip_col`` launch count;
    pass B's mid_col branch against its plain version at (4,8,6,64) and
    (32,32,32,384) on a conjugated normalized SSY set with a seeded
    non-separable mid_col, and one application of that set against its
    float64 twin;
28. one application at each cell against the float64 chain, timed:
    normalized SSY 12.6M auto (the streamed full configuration with the
    fold) and strip, plain SSY strip (fast), normalized GCY 25.2M auto
    (the deferred configuration with the fold) and strip (rank-2 lazy),
    plain GCY strip (lse); then the plain SSY Tauchen set (103,41,64,512)
    through ``make_tiled_T_log_ssy(..., engine="auto")``, which the
    streamed kernels' pass C has no layout for: it must run the strip
    tier, within 5e-6 of its float64 twin;
29. the paths, cold then warm: (a) ``wc_ratio_discrete(SSY(),
    (32,32,32,384), kernel="tiled", baseline="loglinear",
    discretization="tauchen", tol=2e-5)``, (b) Newton through
    ``make_tiled_T_log_ssy(..., baseline="loglinear", engine="strip")``
    from its baseline, (c) ``wc_ratio_discrete(GCY(), (32,16,16,12,16,16),
    kernel="tiled", baseline="loglinear", ...)`` at tol 3.04e-5; then,
    cold only, (d) Newton through the plain SSY strip tier (fast mode)
    and (e) Newton through the mid_col set at the SSY cell; each with its
    launch counts, iterations, seconds, float64 residual and distance to
    the plain solve of the same grid;
30. timing of the new kernels against their plain versions at the SSY
    cell (the sets the paths ran them on; pass B with the fold and pass
    C lse, the linear carry, on the normalized set (a), each first held
    against its plain version there), of the strip column phase at
    the 25.2M GCY view (192, 512, 256), lse, rank-2 lazy and plain, and
    of the row phase at its (L, K, C) = (12, 16, 131072), plain;
31. the solver layer (the fast stages' launch counts read as in 5):
    ``polish=True`` at tol 1e-7 (the fast float32 stage at 1e-4, then
    float64 Newton on the card through the fast operator's tangent):
    discrete SSY at (32,32,32,384) Tauchen (checked within 1e-9 on log w
    against a float64 Newton solve without ``tangent_T`` from the same
    float32 start), discrete GCY at (32,16,16,12,16,16) Tauchen and
    continuous SSY tiled at (56,56,56,64) from the log-linear start, each
    with its float64 residual (at most 1e-7), both stages' iterations and
    seconds and the fast stage's kernel launches;
32. ``inner="gmres"`` (restart 20, 5 cycles a step) at the SSY cell,
    float32, tol 2e-5, within 2e-4 of the BiCGStab solve of phase 5;
33. ``inner="dense"`` and ``method="gd"`` on the card, SSY (4,4,4,6)
    float64: dense within 1e-10 of BiCGStab, gd at tol 1e-4;
34. the calibration gradient: ``wc_ratio_differentiable(SSY(), 20^4,
    fields=("beta", "gamma"), quad_degree=5, tol=1e-11)`` in float64,
    d mean log w* against central differences (rtol 2e-4), the seconds
    of the solve and of the adjoint;
35. ``calibrate_moments`` at 15^4, degree 5, 10^6 draws, from beta =
    0.9985 to the E[w] of SSY's beta (within 5e-6), and a risk-free-rate
    gradient through w*;
36. the command line (``sdfs_via_autodiff_tpu_torch.cli.main``, in
    process, launch counts read as in 5): ``info``; ``check ssy --kind
    discrete --shapes 32,32,32,384 --decompose``; then
    ``existence_check`` in float64 at the SSY 12.6M and GCY 25.2M
    Tauchen cells (r(H), beta r(H)^(1/theta) < 1, power iterations,
    seconds);
37. ``solve ssy --kind discrete --kernel tiled --discretization tauchen
    --shapes 32,32,32,384 --tol 2e-5 --checkpoint``: converged, phase
    5's launch counts, w_mean within 2e-4 relative of phase 5's, and
    ``load_solution`` of the file bitwise the solve's w*;
38. ``timed_solve`` around the 12.6M tiled Newton solve (cold, warm,
    point-updates/s), then, in a process of its own
    (``chip_smoke.py --trace-child DIR``), ``utils.trace`` around three
    applications: the trace file names the pass B and pass C kernels;
39. ``solve ssy --kind continuous --kernel tiled --baseline loglinear
    --shapes 56,56,56,64 --tol 2e-5 --checkpoint`` (pass B c1-only with
    the fold, pass C batched lse), then ``simulate`` (10^6 steps) and
    ``price`` from the file, each timed, and
    ``construct_wstar_callable(datafile=)`` against the solve's own
    interpolant at 10^4 seeded states (1e-12);
40. de Groot: ``degroot_fixed_point(SSY(), (15,)*4, h=0.99, tol=1e-9)``
    and the same through ``solve ssy --spec degroot`` (the JSON must
    match), ``existence_check_degroot`` (S~ < 0), 100 applications of
    the float64 log-space operator at the 12.6M Tauchen grid, and the
    h = 1, s_lam = 0 closed form g* = ((1-beta) w*)^theta at 15^4
    (1e-8 on ln g);
41. ``wc_ratio_sweep`` over SSY gamma in {8.3, 8.6, 8.89, 9.2} at 32^4,
    Anderson, tol 1e-7, 2,000 iterations at most, float64, against four
    sequential ``wc_ratio_continuous`` solves from the same start (1e-9
    on log w*), both timed;
42. ``stability_exponent_mc(SSY())`` at T = 100,000 and N = 10,000,
    timed, and on a damped calibration (T = 10,000, N = 2,000) against
    ``stability_decomposition`` (1e-5) and the Gaussian closed form of
    S_lambda (2e-6);
43. the sharded path at world size 1: a real NCCL process group (rank
    0, ``cuda:0``, a free local port); ``parallel.
    streamed_shard_map_factory`` on the SSY 12.6M Tauchen set (fast):
    one application against ``make_streamed_T_log``'s (1e-6, and
    whether bitwise), a float32 Newton solve through it from w = 800 at
    tol 2e-5 (w* within 1e-6 relative of the single-device solve from
    the same start on the same tangent steps, a DTensor's tangent keeping
    the stages' steps; B1 / B2 launched as in phase 5), and ``T_ssy_shard_map_factory`` and
    ``two_phase_shard_map_factory`` in float64 at (8,8,6,6) against the
    single-device float64 operators (1e-12), and their linearized
    matvecs against ``torch.func.jvp`` of ``T.local`` (1e-12 relative);
44. the sharded kernels rank by rank at a 4-rank layout on one card
    (``parallel.streamed_shard_plan``, one plan per rank; the reshards
    by slicing and concatenation): SSY 12.6M fast (256 rows and 3,072
    columns a rank), the normalized SSY set (a), GCY 25.2M deferred (48
    rows and 32,768 columns a rank) and the continuous-GCY 18.9M pair
    set (n = 4): each rank's pass B and pass C against their plain
    versions, the assembled field against the single-device operator,
    the launches and each rank's kernel times;
45. the single-device operators and solvers on a DTensor iterate
    (``ops/dtensor.py``, ``parallel/gspmd.py``), inside phase 43's NCCL group on its 1 x 1
    mesh: one float64 application of ``T_ssy_factory(space="log")`` at
    the SSY 12.6M Tauchen cell, of ``T_gcy_factory`` at the GCY 25.2M
    cell and of the continuous-SSY factored operator at (56,56,56,64),
    each bitwise the single-device one with its placements kept; the
    tangent route (the operator's hand linearization run on the DTensor)
    against ``torch.func.jvp`` at the SSY cell, and the derivative of a
    VJP for ``T_ssy_factory(space="w")``, which has no hand
    linearization, there (1e-12 of sup |jvp|), ms per matvec by CUDA
    events; the card's allocated
    bytes after 50 more applications no more than after one; float64
    Newton at tol 1e-10 from phase 31's float32 w* on the DTensor
    (within 1e-10 of
    phase 31's float64 Newton reference) and Anderson at tol 1e-9 from
    the same start (against the single-device Anderson solve); phase
    34's calibration gradient from a DTensor start (1e-8 relative);
    phase 40's de Groot Newton solve (1e-12); one kernel-backed operator
    refusing a DTensor; each solve's seconds beside its single-device
    counterpart's;
46. Newton's tangent: at the SSY 12.6M, GCY 25.2M, continuous SSY
    11.2M (a) and (b), normalized SSY (a), fused 20^4, B8's "post" and
    "loglin" 20^4, the Monte Carlo SSY node chain (20^4, 2,000 draws)
    and the float32 per-axis normalized SSY 12.6M (deep windows) cells,
    the hand linearization (``ops/tangent.py``, one primal per Newton
    step) against ``torch.func.jvp`` of the twin at the Newton start:
    the matvecs' difference (2e-6 of sup |v|), ms per matvec on each
    route (CUDA events, median of 21), the build's ms per Newton step,
    the stored bytes; then, except at the last two cells, a Newton
    solve's seconds with the card's allocated bytes before and after it
    (equal), and, except at "post", the same solve's seconds on the jvp
    route;
47. the tangent passes (K2) at the SSY 12.6M and GCY 25.2M shapes: the
    tape's fused step, its three launches a matvec, J v and J v - v
    against the einsum replay of the same tape (2e-6 of sup |v|), ms per
    matvec of the step, of the replay and of Newton's whole matvec
    (median of 3 runs of 50) beside the bound, a matvec's peak bytes
    (the SSY cell's figures, with phase 5's launches, are the JSON
    line's ``tangent_passes`` row);
48. a JSON line of per-kernel facts (with each kernel's bound: the
    largest of its FP32 operations over 67 TFLOP/s, its TF32 tensor-core
    operations over 495 TFLOP/s (the deferred pass B at I = 512 and pass
    B's c2 product: split TF32, three TF32 products per FP32 one; their
    rows also give the FP32 route's bound, ``bound_fp32_ms``, and share),
    its bytes over 3.35
    TB/s and, for the post-interp kernel, the pair pass C and the
    deferred pass B with the fold, its special-function operations
    (expf, logf, log1pf) over 16 per clock per SM at the card's maximum
    SM clock, from this run's shapes and iteration counts, and its share
    of that bound; the deferred pass B has a row without the fold (25.2M
    GCY view) and one with it (18.9M continuous-GCY view); with the
    launches of phase 43's sharded solve (``sharded_launches``) and of
    phase 44 (``rank_launches``)), then the result line
    ``{"ok": true, "device": {...}}``.

The kernels build in parallel (one nvcc per source).  Each path runs
with every launch count set to 0 just before it and read just after.
The port never imports JAX, and neither does this script.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# K1 against the eager BiCGStab loop on the SSY tangent: the loops part
# by float32 rounding of the steps as the dots' summation order moves
# the scalars (the card tests' tolerance).
KRYLOV_ITER_SLACK, KRYLOV_X_RTOL = 1, 1e-3
KRYLOV_INNER_TOL, KRYLOV_MAXITER = 1e-4, 50     # Newton's inner defaults
# Vectors of n entries each BiCGStab iteration's passes read or write:
# P1 r, p, v, p; P2 rhat, v; P3 r, v, s; P4 t, s; P5 x, p, s, t, rhat,
# x, r.
KRYLOV_VECTORS_PER_ITER = 18
# Clocks of the spin kernel ahead of each timed group of K1's passes
# (~0.5 ms at 1.98 GHz, ten times the host's enqueue of a group).
KRYLOV_SPIN_CYCLES = 1_000_000
# GCY: the NORTHSTAR gcy_discrete_tauchen grid (25,165,824 states, view
# (12,16,512,256)) and a ragged view (2,4,56,258) for the kernel checks.
GCY_SHAPES, GCY_METHOD = (32, 16, 16, 12, 16, 16), "tauchen"
GCY_RAGGED = (7, 8, 43, 2, 6, 4)
# (R, I, J) of the deferred pass B's tensor-core layout at ragged shapes.
DEFB_RAGGED = ((3, 301, 70), (2, 517, 37))
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
GCYC_WIDE = (5, 3, 2, 2, 40, 12)     # n_b = 12: above the cluster limit
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
# Tiled continuous SSY: the JAX NORTHSTAR ssy_continuous_quadrature_pre
# cell (benchmarks/northstar.py:42,49,59-64,196-203; 11,239,424 states,
# view R = 3,136 rows by C = 3,584 columns), degree 5, 3.2 std, Newton at
# tol 2e-5; three smaller sets for the kernel checks; the reference's
# 20^4 degree-8 anchor (JAX tests/test_reference_anchors.py:22-23).
SSYC_SHAPES = (56, 56, 56, 64)
# (31, 29, 5, 42): ragged, its batched pass C a cluster of 2 blocks.
SSYC_CHECKS = ((4, 8, 6, 64), (3, 5, 7, 40), (20, 20, 20, 20),
               (31, 29, 5, 42), SSYC_SHAPES)
SSYC_TOL = 2e-5
SSYC_F64_RESIDUAL = 5e-5    # max |T64(ell*) - ell*|
ANCHOR20 = ((20, 20, 20, 20), 8, 2.5, 976.43571268, 8.62554633)
# Phase 46: matvecs and builds timed per route, and the float32
# linearized matvec's distance from the jvp one relative to sup |v| (the
# CPU tests' bound at small sets; the cells measured 5.1e-8 to 2.3e-7).
TANGENT_MATVECS, TANGENT_BUILDS, TANGENT_RTOL = 21, 5, 2e-6
PEAK_FP32 = 67e12           # H100 SXM FP32 (non-tensor) FLOP/s
PEAK_TF32 = 495e12          # H100 SXM TF32 tensor-core FLOP/s (dense)
HBM_BYTES_PER_S = 3.35e12
_CSRC = "sdfs_via_autodiff_tpu_torch/kernels/csrc/"
SOURCES = {"streamed_two_phase": _CSRC + "streamed_two_phase.cu",
           "fused_two_matmul": _CSRC + "fused_two_matmul.cu",
           "post_interp": _CSRC + "post_interp.cu",
           "tiled_two_phase": _CSRC + "tiled_two_phase.cu",
           "krylov_fused": _CSRC + "krylov_fused.cu"}
_JAX_KERNELS = "sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py"
_JAX_STRIP = "sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py"
# The normalized tiers (baseline="loglinear") and the strip tier: the
# strip kernels vs their plain versions at these operand sets (name,
# model, shapes, method, baseline, lazy_bytes; lazy_bytes 0 runs every
# batched factor in its lazy form), then at the two cells.
STRIP_CHECKS = (("ssy", (4, 5, 6, 7), "rouwenhorst", None, None),
                ("ssy", (4, 5, 6, 7), "rouwenhorst", "loglinear", None),
                ("ssy", (6, 5, 6, 16), "rouwenhorst", "loglinear", 0),
                ("gcy", (6, 5, 4, 3, 4, 3), "rouwenhorst", None, None),
                ("gcy", (6, 5, 4, 3, 4, 3), "rouwenhorst", "loglinear", None),
                ("gcy", (6, 5, 4, 3, 4, 3), "rouwenhorst", "loglinear", 0),
                ("ssy", (20, 13, 5, 70), "tauchen", "loglinear", 0),
                ("ssy", (3, 5, 67, 130), "rouwenhorst", None, None))
# A plain SSY Tauchen set whose shared factors the streamed tier covers
# by its pass-C footprint but whose slab pass C has no layout: the tier
# decision sends it to the strip tier (fast mode).
UNCOVERED_SSY = (103, 41, 64, 512)
# One step past it, R = 6,144: the row phase's narrow layout.
NARROW_SSY = (128, 48, 64, 512)
MID_CHECKS = ((4, 8, 6, 64), (32, 32, 32, 384))
MID_SCALE = 0.05            # seeded non-separable mid_col, log units
REPLACES = {"pass_b": f"{_JAX_KERNELS}:324",            # _b_kernel
            "pass_c": f"{_JAX_KERNELS}:446",            # _c_kernel
            "pass_b_deferred": f"{_JAX_KERNELS}:384",   # _b_kernel_deferred
            # ... with the folded baseline (has_sub), at the 18.9M view
            "pass_b_deferred_sub": f"{_JAX_KERNELS}:384",
            "pass_c_deferred": f"{_JAX_KERNELS}:446",   # _c_kernel, c2_deferred
            "pass_c_pair": f"{_JAX_KERNELS}:673",       # _c_kernel_pair
            "pass_b_c1": f"{_JAX_KERNELS}:324",         # _b_kernel, c1 only
            "pass_b_c1_sub": f"{_JAX_KERNELS}:324",     # ... with has_sub
            "pass_c_batched": f"{_JAX_KERNELS}:446",    # _c_kernel, batched
            "pass_c_batched_lse": f"{_JAX_KERNELS}:446",
            "fused_T": "sdfs_via_autodiff_tpu/kernels/fused_discrete.py:72",
            "fused_sa": "sdfs_via_autodiff_tpu/kernels/solver_kernel.py:41",
            "fused_anderson":
                "sdfs_via_autodiff_tpu/kernels/anderson_kernel.py:36",
            "post_interp":
                "sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py:58",
            "pass_b_mid": f"{_JAX_KERNELS}:324",        # _b_kernel, has_mid
            # _b_kernel with the fold (has_sub) and a shared c2, lse, and
            # _c_kernel's shared-c2 lse, at the normalized SSY cell (a)
            "pass_b_sub": f"{_JAX_KERNELS}:324",
            "pass_c_lse": f"{_JAX_KERNELS}:446",
            "strip_col": f"{_JAX_STRIP}:170",           # _col_phase_kernel
            "strip_row": f"{_JAX_STRIP}:195",           # _row_phase_kernel
            "strip_col_fast": f"{_JAX_STRIP}:226",      # _col_phase_fast_kernel
            "strip_row_fast": f"{_JAX_STRIP}:259",      # _row_phase_fast_kernel
            # K1, the five fused BiCGStab passes: the JAX package's
            # BiCGStab is jnp code in XLA's while loop, no TPU kernel.
            "krylov_pass": None,
            # K2, the tangent passes' three kernels a matvec: the JAX
            # tangent is jax.linearize of the XLA twin, no TPU kernel.
            "tangent_passes": None}
KERNELS = tuple(REPLACES)
SOURCE_OF = {k: SOURCES["fused_two_matmul" if k.startswith("fused")
                        else "tiled_two_phase" if k.startswith("strip")
                        else "krylov_fused" if k.startswith("krylov")
                        else k if k in SOURCES else "streamed_two_phase"]
             for k in KERNELS}
# (FP32 FLOP, bytes[, special-function operations[, TF32 tensor-core
# FLOP]]) of each kernel's timed call, filled by the phases.  A kernel
# whose products run on the tensor cores (B3 at I = 512: split TF32,
# three TF32 products per FP32 one) counts them as TF32 FLOP; FP32_WORK
# keeps its FP32 FLOP for the bound of the FP32 route beside it.
WORK = {}
FP32_WORK = {}
# Special-function results (expf, logf, log1pf: one each) per clock per
# SM; main() sets SFU_PER_S from the SM count and the card's maximum SM
# clock (nvidia-smi clocks.max.sm).
SFU_PER_CLOCK_PER_SM = 16
SFU_PER_S = [0.0]


def bound_of(flop, nbytes, sfu=0, tf32=0):
    """(bound_ms, bound_by, binding term) of work: the largest of FP32
    operations over the FP32 peak rate, TF32 tensor-core operations over
    the TF32 peak rate, special-function operations over the
    special-function rate and bytes (each input read once, each output
    written once) over the memory rate."""
    terms = {"FP32": flop / PEAK_FP32, "bytes": nbytes / HBM_BYTES_PER_S,
             "special functions": sfu / SFU_PER_S[0] if sfu else 0.0,
             "TF32": tf32 / PEAK_TF32}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def pass_b_work(name, R, I, J, nbytes):
    """WORK and FP32_WORK of pass B with a shared c2 at (R, I, J): c1 in
    FP32 FMA, c2 split TF32 (three TF32 products per FP32 one)."""
    c1, c2 = 2 * R * I * I * J, 2 * R * I * J * J
    WORK[name] = (c1, nbytes, 0, 3 * c2)
    FP32_WORK[name] = (c1 + c2, nbytes)


def bound(name: str):
    """(bound_ms, bound_by, binding term) of a kernel's timed call."""
    return bound_of(*WORK[name])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


@contextlib.contextmanager
def krylov_counts(port):
    """Yields a list that holds, once the block ends, the Krylov
    iteration count of each Newton step the block ran (the port's
    ``sdfs.krylov`` spans)."""
    counts = []
    with port.utils.profiling.recorded() as recs:
        yield counts
    counts.extend(r.count for r in recs if r.name == "sdfs.krylov")


@contextlib.contextmanager
def span_count(port, name):
    """Yields a list that holds, once the block ends, the number of the
    port's ``name`` spans the block ran."""
    n = []
    with port.utils.profiling.recorded() as recs:
        yield n
    n.append(sum(1 for r in recs if r.name == name))


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
    the path's launch counts, (kernel ms, plain ms) per kernel and the
    path's solution (float32 log w*)."""
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
    # The tensor-core layout of the deferred pass B at ragged (R, I, J)
    # (I not a multiple of 4, 8 or 16; J not of 4 or 2), with and
    # without a fold, on seeded synthetic operands (W_c1 row-stochastic).
    for R_, I_, J_ in DEFB_RAGGED:
        check(st.pass_b_deferred_layout(I_, J_)[0] == "mma",
              f"pass_b_deferred ({R_}, {I_}, {J_}) is not the tensor-core "
              "layout")
        rng = np.random.default_rng(SEED + I_)
        W = rng.random((I_, I_))
        W /= W.sum(axis=1, keepdims=True)
        th_ = -36.0
        e_ = cast(np.log(800.0) + 0.05 * rng.standard_normal((R_, I_, J_)))
        fold = (cast(th_ * np.log(800.0) + 0.1 * rng.standard_normal(R_)),
                cast(0.05 * rng.standard_normal((I_, J_))))
        for sub in ((None, None), fold):
            got = st.pass_b_deferred(e_, cast(W.T), th_, *sub)
            want = st.pass_b_deferred_plain(e_, cast(W.T), th_, *sub)
            err = float((got - want).abs().max())
            check(bool(((got - want).abs()
                        <= KERNEL_ATOL + eps32 * want.abs()).all()),
                  f"pass_b_deferred ({R_}, {I_}, {J_}) fold "
                  f"{sub[0] is not None}: max abs err {err:.3e}")
            max_err["pass_b_deferred"] = max(max_err["pass_b_deferred"], err)
            print(f"pass_b_deferred tensor cores ({R_}, {I_}, {J_}) fold "
                  f"{sub[0] is not None}: max abs err {err:.3e}")
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
    t0 = time.perf_counter()
    with krylov_counts(port) as inner:
        sol = port.wc_ratio_discrete(model, GCY_SHAPES, kernel="tiled",
                                     discretization=GCY_METHOD,
                                     algorithm="newton", tol=tol, device=dev)
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
    check(launches["pass_b_deferred"] == launches["pass_c_deferred"],
          f"GCY path: not one deferred pass B per application: {launches}")
    ell_star = torch.log(sol.w_star.double())
    check(bool(torch.isfinite(ell_star).all())
          and tuple(ell_star.shape) == GCY_SHAPES, "GCY w* not finite/shaped")
    r64 = float((T64(ell_star) - ell_star).abs().max())
    w = sol.w_star.double()
    print(f"GCY path f64 residual max|T64(l*) - l*| = {r64:.3e}; "
          f"w* in [{float(w.min()):.3f}, {float(w.max()):.3f}]")
    check(r64 <= GCY_F64_RESIDUAL, f"GCY f64 residual {r64:.3e}")
    star = ell_star.float()
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
    # B3 at I = 512 runs split TF32 on the tensor cores: three TF32
    # products per FP32 one; its FP32 bound is kept beside.
    WORK["pass_b_deferred"] = (0, 2 * field + 4 * I * I, 0,
                               3 * 2 * R * I * I * J)
    FP32_WORK["pass_b_deferred"] = (2 * R * I * I * J, 2 * field + 4 * I * I)
    WORK["pass_c_deferred"] = (2 * R * I * J * J + 2 * C * R * (L + K),
                               2 * field + 4 * (J * J + L * L + K * K + R + C))
    for name, (k_ms, p_ms) in kernels_ms.items():
        print(f"timing {name} {ops.shapes}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms ({smi})")
    b_tf32 = bound("pass_b_deferred")[0]
    b_fp32 = bound_of(*FP32_WORK["pass_b_deferred"])[0]
    k_ms = kernels_ms["pass_b_deferred"][0]
    print(f"pass_b_deferred {ops.shapes} bounds: split-TF32 route "
          f"{b_tf32:.4f} ms (share {b_tf32 / k_ms:.3f}), FP32 "
          f"{b_fp32:.4f} ms (share {b_fp32 / k_ms:.3f}) ({smi})")
    # B3 with a folded baseline at this view (the normalized GCY cell's
    # shape; a synthetic fold: a row baseline near theta*log(800) and a
    # small column profile), kernel vs plain.
    rng = np.random.default_rng(SEED)
    sub = (cast(th * np.log(800.0) + 0.1 * rng.standard_normal(R)),
           cast(0.05 * rng.standard_normal((I, J))))
    got = st.pass_b_deferred(e, W_c1t, th, *sub)
    want = st.pass_b_deferred_plain(e, W_c1t, th, *sub)
    err_s = float((got - want).abs().max())
    check(bool(((got - want).abs() <= KERNEL_ATOL + eps32 * want.abs()).all()),
          f"pass_b_deferred with a fold {ops.shapes}: max abs err {err_s:.3e}")
    max_err["pass_b_deferred"] = max(max_err["pass_b_deferred"], err_s)
    s_k = time_ms(torch, lambda y: st.pass_b_deferred(y, W_c1t, th, *sub), e)
    s_p = time_ms(torch, lambda y: st.pass_b_deferred_plain(y, W_c1t, th,
                                                            *sub), e)
    print(f"timing pass_b_deferred with a synthetic fold {ops.shapes}: "
          f"kernel {s_k:.4f} ms, plain {s_p:.4f} ms, max abs err "
          f"{err_s:.3e} ({smi})")
    return max_err, launches, kernels_ms, star


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
        lay = fd.fused_layout(R, C, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        print(f"fused {label} ({R}x{C}, {lay['n_tiles']} tiles of "
              f"{lay['bm']}x32, "
              f"{'resident' if lay['resident'] else 'chunked'}): "
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
    errors vs plain, the path's launch counts, (kernel ms, plain ms)
    of pass_c_pair at 18.9M and the 18.9M operand set (phase 44)."""
    from sdfs_via_autodiff_tpu_torch import drivers

    model = port.GCY()
    max_err = {"pass_b_deferred": 0.0, "pass_c_pair": 0.0}
    tol = 1.2 * port.f32_tol_floor(model.theta)

    # 14. Kernels vs plain at five sets; one application vs f64.
    coarse_s = {}
    timing_sets = {}
    for sizes in (GCYC_SMALL, GCYC_RAGGED, GCYC_WIDE, GCYC_SUITE,
                  GCYC_SHAPES):
        if sizes in (GCYC_SMALL, GCYC_RAGGED, GCYC_WIDE):
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
    grids, base18, ops18 = timing_sets[GCYC_SHAPES][:3]
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
        b_work = (2 * R * I * I * J, 2 * field + 4 * (I * I + R + C),
                  2 * R * C)
        # Special functions: one exp per slice entry, the epilogue's log,
        # exp and log1p per output, the row carry's R + K exps per
        # output group.
        c_work = (2 * R * I * n_b * n_j * (n_j + n_b) + 2 * C * R * (L + K),
                  2 * field + 4 * (n_i * n_b * n_j * n_j + n_y * n_b * n_b
                                   + L * L + K * K + R + C),
                  4 * R * C + I * n_b * (R + K))
        WORK["pass_c_pair"] = c_work
        kernels_ms["pass_c_pair"] = (c_k, c_p)
        if sizes == GCYC_SHAPES:
            WORK["pass_b_deferred_sub"] = b_work
            kernels_ms["pass_b_deferred_sub"] = (b_k, b_p)
        bounds = []
        for work in (b_work, c_work):
            bms, _, term = bound_of(*work)
            sfu = f", {work[2] / 1e6:.1f}M special" if len(work) > 2 else ""
            bounds.append(f"{bms:.4f} ms ({term}, {work[0] / 1e9:.2f} GFLOP"
                          f"{sfu}, {work[1] / 1e6:.1f} MB)")
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
    return max_err, launches, kernels_ms, ops18


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
    fused kernels' max abs errors vs plain on the path's operands."""
    from sdfs_via_autodiff_tpu_torch import drivers
    from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
    from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
    from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk

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
    label = f"continuous GCY {FUSED_GCY_SIZES}"
    got = fd.fused_T(ell, *ops, th, be)
    err = float((got - fd.fused_T_plain(ell, *ops, th, be)).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= KERNEL_ATOL,
          f"fused_T {label}: max abs err {err:.3e}")
    # The loops at this shape (the chunked layout, two row tiles): SA and
    # Anderson at a fixed count (tol -1) against their plain versions,
    # iterate by iterate, and Anderson's fall back to T(x).
    e_k, i_k, _ = sk.fused_sa(ell, *ops, th, be, -1.0, 50)
    e_p, i_p, _ = sk.fused_sa_plain(ell, *ops, th, be, -1.0, 50)
    err_s = float((e_k - e_p).abs().max())
    check(int(i_k) == int(i_p) == 50 and err_s <= B6_CAP_ATOL,
          f"fused_sa {label}: {int(i_k)}/{int(i_p)} iterations, max abs err "
          f"{err_s:.3e}")
    n = B7_CHECK_ITERS
    a_k, j_k, _ = ak.fused_anderson(ell, *ops, th, be, -1.0, n,
                                    ridge=B7_CHECK_RIDGE)
    a_p, j_p, _ = ak.fused_anderson_plain(ell, *ops, th, be, -1.0, n,
                                          ridge=B7_CHECK_RIDGE)
    err_a = float((a_k - a_p).abs().max())
    check(int(j_k) == int(j_p) == n and err_a <= B7_ITER_ATOL,
          f"fused_anderson {label}: {int(j_k)}/{int(j_p)} iterations at "
          f"ridge {B7_CHECK_RIDGE:g}, max abs err {err_a:.3e}")
    f_k, _, _ = ak.fused_anderson(ell, *ops, th, be, -1.0, n,
                                  ridge=float("nan"))
    s_p, _, _ = sk.fused_sa_plain(ell, *ops, th, be, -1.0, n)
    err_f = float((f_k - s_p).abs().max())
    check(err_f <= B7_ITER_ATOL,
          f"fused_anderson {label}: NaN-ridge fall back vs SA {err_f:.3e}")
    print(f"fused {label} ({rows}x{cols}, with sub): fused_T max abs err "
          f"{err:.3e}; fused_sa 50 steps max abs err {err_s:.3e}; "
          f"fused_anderson {n} steps at ridge {B7_CHECK_RIDGE:g} max abs err "
          f"{err_a:.3e}, NaN-ridge fall back vs SA {err_f:.3e}")
    return {"fused_T": err, "fused_sa": err_s,
            "fused_anderson": max(err_a, err_f)}


def post_interp_work(sizes, degree, interp="post"):
    """(FP32 FLOP, bytes, special-function operations) the post-interp
    function needs for one application on the hat basis's non-zeros (at
    most two per row on each axis), factored per axis: the 2 x 2
    (h_lam, h_c) corners per row pair and state (4 multiply-adds), the
    2 x 2 (h_z, z) corners per joint node and state (4 multiply-adds),
    the power's scale, the payoff, the log-weight and the sum (4 FLOP),
    and the epilogue (5 FLOP); d^4 * N logs ("post") and d^4 * N exps,
    and the epilogue's log, exp and log1p per state.  Bytes: the field,
    the corner tables (an int32 index and a float32 weight per entry),
    the payoff, the log-weights and the kappa parts read once, the
    output written once."""
    n_l, n_k, n_i, n_j = sizes
    N = n_l * n_k * n_i * n_j
    d2, d4 = degree ** 2, degree ** 4
    flop = 8 * d2 * N + 12 * d4 * N + 5 * N
    sfu = (2 if interp == "post" else 1) * d4 * N + 3 * N
    nbytes = 4 * (2 * N + 2 * degree * (n_l + n_k + n_i + n_i * n_j)
                  + d2 * n_l * n_k + d2 * d2 + 1 + n_l * n_k + n_i * n_j)
    return flop, nbytes, sfu


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
        dense = pk.post_interp_operands_ssy(model, grids, POST_DEGREE)
        ell64 = torch.as_tensor(noise_field(sizes, SEED), device=dev)
        for interp in ("post", "loglin"):
            T = pk.make_post_interp_kernel_T_ssy(model, grids, POST_DEGREE,
                                                 interp, device=dev)
            args = T.kernel_args(ell64.float())
            got = pk.post_interp(*args)
            want = pk.post_interp_gather_plain(*args)
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= KERNEL_ATOL,
                  f"post_interp {interp} {sizes}: max abs err {err:.3e}")
            max_err = max(max_err, err)
            # The same function on the dense Kronecker stacks (the JAX
            # kernel's operands).
            kron = tuple(f32_cast(torch, dev)(dense[k]) for k in ("Wr", "Wc"))
            want_kron = pk.post_interp_plain(args[0], *kron, *args[2:])
            err_kron = float((got - want_kron).abs().max())
            check(err_kron <= KERNEL_ATOL, f"post_interp {interp} {sizes} vs "
                  f"the Kronecker version: max abs err {err_kron:.3e}")
            ms_k = time_ms(torch, lambda y: pk.post_interp(*args), None,
                           n=20)
            ms_p = time_ms(torch, lambda y: pk.post_interp_gather_plain(
                *args), None, n=20)
            ms_kron = time_ms(torch, lambda y: pk.post_interp_plain(
                args[0], *kron, *args[2:]), None, n=20)
            work = post_interp_work(sizes, POST_DEGREE, interp)
            bms, _, term = bound_of(*work)
            print(f"post_interp {interp} {sizes} ((R, C) = "
                  f"{tuple(args[0].shape)}, {args[3].numel()} node pairs): max "
                  f"abs err {err:.3e} vs the gather plain version, "
                  f"{err_kron:.3e} vs the Kronecker version; kernel "
                  f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, Kronecker plain "
                  f"{ms_kron:.4f} ms; bound {bms:.4f} ms ({term}, "
                  f"{work[0] / 1e9:.3f} GFLOP, {work[2] / 1e6:.1f}M special) "
                  f"({smi})")
            del got, want, want_kron, kron, args
            if sizes == POST_SIZES:
                if interp == "post":
                    kernels_ms = (ms_k, ms_p)
                    WORK["post_interp"] = work
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
        del ell64, dense
    torch.cuda.empty_cache()

    # 19. The path, "post" (cold only: on the jvp route its 45 Newton
    # iterations took 67-90 s) then "loglin", cold then warm.
    grids = port.build_grid_ssy(model, *POST_SIZES)
    launches = None
    for interp in ("post", "loglin"):
        T64 = port.T_ssy_continuous_factory(model, grids, interp=interp,
                                            space="log",
                                            quad_degree=POST_DEGREE,
                                            device=dev)
        for run in ("cold",) if interp == "post" else ("cold", "warm"):
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
    # twin, and the tangent matvec on both routes: the twin's
    # linearization (built once per Newton step, its build timed apart)
    # and jvp of the float32 node-chain twin.
    T = pk.make_post_interp_kernel_T_ssy(model, grids, POST_DEGREE, "post",
                                         device=dev)
    x = torch.as_tensor(noise_field(POST_SIZES, SEED), device=dev).float()
    v = 0.01 * x
    ms_T = time_ms(torch, T, x, n=10)
    ms_twin = time_ms(torch, T.twin, x, n=10)
    ms_jvp = time_ms(torch, lambda y: torch.func.jvp(T.twin, (y,), (v,))[1],
                     x, n=5)
    lin = T.twin.linearize(x)
    _, ms_build = events_ms(torch, lin.build)
    ms_lin = time_ms(torch, lin, v, n=10)
    print(f"timing post-interp {POST_SIZES}: operator T {ms_T:.3f} ms, its "
          f"node-chain twin {ms_twin:.3f} ms, tangent matvec: linearized "
          f"{ms_lin:.3f} ms (its build {ms_build:.3f} ms once per Newton "
          f"step), jvp of the twin {ms_jvp:.3f} ms ({smi})")
    del T, x, v, lin
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


def loglinear_start(port, model, grids):
    """log w of the log-linear solution on the grids (float64 numpy), as
    the JAX northstar's loglinear_warm_start evaluates it."""
    ll = port.ssy_loglinear_factory(model)
    x = port.ops.grids.flatten_mesh([g.cpu() for g in grids]).numpy()
    return ll(x.T).reshape(tuple(len(g) for g in grids))


def batched_kernel_check(torch, st, ops, dev, mode):
    """Pass B's c1-only branch (with the set's folded baseline, if any)
    and the batched pass C vs their plain versions on one operand set, in
    one mode.  Returns (err_b, err_c, b_args, c_args, ell, mid): the view
    field, pass C's input and the arguments, for timing."""
    cast = f32_cast(torch, dev)
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    th, be = float(ops.theta), float(ops.beta)
    rng = np.random.default_rng(SEED)
    base = (np.log(800.0) if ops.baseline_log_w is None
            else ops.baseline_log_w)
    ell = cast(base + 0.02 * rng.standard_normal(ops.shapes)).reshape(R, I, J)
    sub = ((cast(np.asarray(ops.sub_row).reshape(R)), cast(ops.sub_col))
           if ops.has_sub else (None, None))
    b_args = (cast(ops.W_c1), None, th, mode) + sub
    got_b = st.pass_b(ell, *b_args)
    want_b = st.pass_b_plain(ell, *b_args)
    scale = S = None
    if mode == "fast":
        (got_b, _), (want_b, s) = got_b, want_b
        rel = (got_b - want_b).abs() / want_b.abs()
        err_b = float(rel.max())
        check(err_b <= KERNEL_RTOL_LINEAR,
              f"pass_b c1 fast {ops.shapes}: max rel err {err_b:.3e}")
        S = s.max().reshape(1)
        scale = torch.exp(s - S)
    else:
        err_b = float((got_b - want_b).abs().max())
        lim = KERNEL_ATOL + float(np.finfo(np.float32).eps) * want_b.abs()
        check(bool(((got_b - want_b).abs() <= lim).all()),
              f"pass_b c1 lse {ops.shapes}: max abs err {err_b:.3e}")
    mid = want_b.reshape(R, C)
    del got_b, want_b
    c_args = (scale, S, cast(np.swapaxes(ops.W_c2, 1, 2)), cast(ops.W_r1),
              cast(ops.W_r2), cast(ops.add_row),
              cast(np.asarray(ops.add_col).reshape(C)), th, be, mode)
    got_c = st.pass_c_batched(mid, *c_args)
    want_c = st.pass_c_batched_plain(mid, *c_args)
    err_c = float((got_c - want_c).abs().max())
    check(bool(torch.isfinite(got_c).all()) and err_c <= KERNEL_ATOL,
          f"pass_c_batched {mode} {ops.shapes}: max abs err {err_c:.3e}")
    torch.cuda.synchronize()
    return err_b, err_c, b_args, c_args, ell, mid


def ssy_continuous_phases(torch, port, st, dev, smi):
    """Phases 22-26 (tiled continuous SSY).  Returns the new kernels' max
    errors vs plain (and pass B's folded-baseline branch with a shared
    c2, for the pass_b row), the paths' launch counts and (kernel ms,
    plain ms) per new kernel at the cell."""
    model = port.SSY()
    cast = f32_cast(torch, dev)
    max_err = {"pass_b": 0.0, "pass_b_c1": 0.0, "pass_b_c1_sub": 0.0,
               "pass_c_batched": 0.0, "pass_c_batched_lse": 0.0}
    names = {(None, "fast"): ("pass_b_c1", "pass_c_batched"),
             (None, "lse"): ("pass_b_c1", "pass_c_batched_lse"),
             ("loglinear", "fast"): ("pass_b_c1_sub", "pass_c_batched"),
             ("loglinear", "lse"): ("pass_b_c1_sub", "pass_c_batched_lse")}
    timing = {}

    # 22. The new branches vs their plain versions.
    for sizes in SSYC_CHECKS:
        grids = port.build_grid_ssy(model, *sizes)
        for baseline in (None, "loglinear"):
            ops = port.two_phase_operands_ssy_continuous(model, grids, 5,
                                                         baseline)
            check(port.streamed_config(ops) == "batched",
                  f"continuous SSY {sizes}: not the batched configuration")
            L, K, _, J = sizes
            lay = st.pass_c_deferred_layout(L, K, J)
            got = (ctypes.c_int * 5)()
            check(lay is not None
                  and st._lib().sdfs_pass_c_deferred_layout(L, K, J, got)
                  and tuple(got) == lay[1:],
                  f"pass C layout {sizes}: mirror {lay}, launcher "
                  f"{tuple(got)}")
            check(sizes != (31, 29, 5, 42) or lay[1] >= 2,
                  f"{sizes}: batched pass C is not a cluster: {lay}")
            for mode in ("fast", "lse"):
                err_b, err_c, *rest = batched_kernel_check(
                    torch, st, ops, dev, mode)
                kb, kc = names[(baseline, mode)]
                max_err[kb] = max(max_err[kb], err_b)
                max_err[kc] = max(max_err[kc], err_c)
                print(f"continuous SSY {sizes} baseline {baseline} {mode}: "
                      f"{kb} max {'rel' if mode == 'fast' else 'abs'} err "
                      f"mid {err_b:.3e}; {kc} max abs err out {err_c:.3e}")
                if sizes == SSYC_SHAPES and (baseline, mode) in (
                        (None, "fast"), ("loglinear", "lse")):
                    timing[(kb, kc)] = rest
                del rest
    for shapes, method in SHAPES[::2]:
        # Pass B's folded-baseline branch with a shared c2 (discrete SSY
        # with a synthetic fold near theta*log(800)).
        L, K, I, J = shapes
        ops = port.two_phase_operands_ssy(
            model, port.discretize_ssy(model, shapes, method=method))
        rng = np.random.default_rng(SEED)
        th = float(ops.theta)
        ell = cast(noise_field((L * K, I, J), SEED))
        sub = (cast(th * (3.0 + 0.1 * rng.standard_normal(L * K))),
               cast(th * (np.log(800.0) - 3.0
                          + 0.1 * rng.standard_normal((I, J)))))
        for mode in ("fast", "lse"):
            args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T), th,
                    mode) + sub
            got, want = st.pass_b(ell, *args), st.pass_b_plain(ell, *args)
            if mode == "fast":
                err = float(((got[0] - want[0]).abs()
                             / want[0].abs()).max())
                ok = err <= KERNEL_RTOL_LINEAR
            else:
                err = float((got - want).abs().max())
                lim = (KERNEL_ATOL
                       + float(np.finfo(np.float32).eps) * want.abs())
                ok = bool(((got - want).abs() <= lim).all())
            check(ok, f"pass_b with sub {mode} {shapes}: err {err:.3e}")
            if mode == "lse":
                max_err["pass_b"] = max(max_err["pass_b"], err)
            print(f"pass_b shared c2 with sub {mode} {shapes}: max "
                  f"{'rel' if mode == 'fast' else 'abs'} err {err:.3e}")
        del ell, got, want
    torch.cuda.empty_cache()

    # 23. One application at the cell vs the float64 factored operator.
    grids = port.build_grid_ssy(model, *SSYC_SHAPES)
    ell0 = loglinear_start(port, model, grids)
    rng = np.random.default_rng(SEED)
    ell64 = torch.as_tensor(ell0 + 0.02 * rng.standard_normal(SSYC_SHAPES),
                            device=dev)
    T64 = port.T_ssy_continuous_factory(model, grids, space="log",
                                        device=dev)
    ref = T64(ell64)
    for baseline in (None, "loglinear"):
        for mode in ("fast", "lse"):
            T = port.make_tiled_T_log_ssy_continuous(
                model, grids, baseline=baseline, mode=mode, device=dev)
            err = float((T(ell64.float()).double() - ref).abs().max())
            check(err <= OPERATOR_ATOL, f"continuous SSY operator {baseline} "
                  f"{mode} vs f64: {err:.3e}")
            print(f"operator continuous SSY {SSYC_SHAPES} baseline "
                  f"{baseline} {mode}: one application vs f64 max abs err "
                  f"{err:.3e}")
            del T
    del ref
    torch.cuda.empty_cache()

    # 24. The paths (a) and (b), cold then warm.
    launches = {}
    runs = (("a", None, torch.exp(torch.as_tensor(ell0, device=dev))),
            ("b", "loglinear", None))
    for label, baseline, w_init in runs:
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            for k in st.LAUNCHES:
                st.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            with krylov_counts(port) as inner:
                sol = port.wc_ratio_continuous(
                    model, SSYC_SHAPES, kernel="tiled", baseline=baseline,
                    w_init=w_init, tol=SSYC_TOL, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            now = {k: v for k, v in st.LAUNCHES.items() if v}
            res = sol.result
            print(f"continuous SSY path ({label}) {SSYC_SHAPES} tiled, "
                  f"baseline {baseline}, newton tol {SSYC_TOL:g}, {run}: "
                  f"{res}; BiCGStab iterations per step {inner} = "
                  f"{sum(inner)}; launches {now}; {secs:.3f} s ({smi})")
            check(res.converged, f"continuous SSY path ({label}, {run}) did "
                  f"not converge: {res}")
            if run == "cold":
                launches.update(now)
        kb, kc = names[(baseline, "fast" if baseline is None else "lse")]
        check(launches.get(kb, 0) > 0 and launches.get(kc, 0) > 0,
              f"a kernel of continuous SSY path ({label}) never launched: "
              f"{launches}")
        ell_star = torch.log(sol.w_star.double())
        check(bool(torch.isfinite(ell_star).all())
              and tuple(ell_star.shape) == SSYC_SHAPES,
              f"continuous SSY path ({label}): w* not finite/shaped")
        r64 = float((T64(ell_star) - ell_star).abs().max())
        w = sol.w_star.double()
        print(f"continuous SSY path ({label}) f64 residual max|T64(l*) - "
              f"l*| = {r64:.3e}; w* in [{float(w.min()):.3f}, "
              f"{float(w.max()):.3f}]")
        check(r64 <= SSYC_F64_RESIDUAL,
              f"continuous SSY path ({label}): f64 residual {r64:.3e}")
        del sol, ell_star, w
    del T64, ell64
    torch.cuda.empty_cache()

    # 25. Timing at the cell.
    kernels_ms = {}
    x = torch.as_tensor(ell0, device=dev).float()
    for baseline in (None, "loglinear"):
        T = port.make_tiled_T_log_ssy_continuous(model, grids,
                                                 baseline=baseline,
                                                 device=dev)
        v = 0.01 * x
        ms_k, ms_p = time_ms(torch, T, x), time_ms(torch, T.twin, x)
        ms_jvp = time_ms(torch, lambda y: torch.func.jvp(
            T.twin, (y,), (v,))[1], x, n=10)
        print(f"timing continuous SSY {SSYC_SHAPES} baseline {baseline} "
              f"({T.mode}): kernels {ms_k:.4f} ms per application, plain "
              f"eager twin {ms_p:.4f} ms, tangent matvec (jvp of the twin) "
              f"{ms_jvp:.4f} ms ({smi})")
        del T
    L, K, I, J = SSYC_SHAPES
    R, C = L * K, I * J
    field = 4 * R * C
    for (kb, kc), (b_args, c_args, ell, mid) in timing.items():
        kernels_ms[kb] = (
            time_ms(torch, lambda y: st.pass_b(y, *b_args), ell),
            time_ms(torch, lambda y: st.pass_b_plain(y, *b_args), ell))
        kernels_ms[kc] = (
            time_ms(torch, lambda y: st.pass_c_batched(y, *c_args), mid),
            time_ms(torch, lambda y: st.pass_c_batched_plain(y, *c_args),
                    mid))
        # Pass B: c1 over I' per (row, column), reading the field (and the
        # fold's R + C values) and writing it.  Pass C: each slice's c2
        # over J', then the two row contractions; it reads the midway
        # field, P_z and the small operands and writes the output.
        sub_bytes = 4 * (R + C) if kb.endswith("_sub") else 0
        WORK[kb] = (2 * R * I * I * J,
                    2 * field + 4 * (I * I + R) + sub_bytes)
        WORK[kc] = (2 * R * I * J * J + 2 * C * R * (L + K),
                    2 * field + 4 * (I * J * J + L * L + K * K + 2 * R + C
                                     + 1))
        for name in (kb, kc):
            bms, by, _ = bound(name)
            print(f"timing {name} {SSYC_SHAPES}: kernel "
                  f"{kernels_ms[name][0]:.4f} ms, plain "
                  f"{kernels_ms[name][1]:.4f} ms, bound {bms:.4f} ms ({by}, "
                  f"{WORK[name][0] / 1e9:.3f} GFLOP, "
                  f"{WORK[name][1] / 1e6:.1f} MB) ({smi})")
    del timing, x
    torch.cuda.empty_cache()

    # 26. The reference's 20^4 degree-8 anchor through the tiled path.
    sizes, degree, std, mean_ref, std_ref = ANCHOR20
    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    sol = port.wc_ratio_continuous(model, sizes, kernel="tiled",
                                   quad_degree=degree, num_std_devs=std,
                                   tol=SSYC_TOL, device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(sol.converged, f"20^4 anchor solve: {sol.result}")
    grids64 = port.build_grid_ssy(model, *sizes, num_std_devs=std)
    t0 = time.perf_counter()
    f = port.construct_wstar_callable(sol.w_star.double(), grids64,
                                      device=dev)
    mean, sd = port.one_step_w_moments(model, f, num_draws=ANCHOR_DRAWS,
                                       device=dev)
    mom_s = time.perf_counter() - t0
    rm, rs = (mean - mean_ref) / mean_ref, (sd - std_ref) / std_ref
    print(f"anchor {sizes} d={degree} interp=pre {std} sd, tiled float32: "
          f"{sol.result} in {solve_s:.3f} s, launches "
          f"{ {k: v for k, v in st.LAUNCHES.items() if v} }; E[w] = "
          f"{mean:.5f} (anchor {mean_ref:.5f}, rel {rm:+.2e}), sd[w] = "
          f"{sd:.5f} (anchor {std_ref:.5f}, rel {rs:+.2e}); moments "
          f"{mom_s:.3f} s ({smi})")
    check(abs(rm) < ANCHOR_MEAN_RTOL and abs(rs) < ANCHOR_STD_RTOL,
          f"20^4 anchor: E[w] {mean:.5f} / sd {sd:.5f} vs {mean_ref} / "
          f"{std_ref}")
    return max_err, launches, kernels_ms


def _operand_set(port, name, shapes, method, baseline, dense=True):
    """(model, disc, two-phase operand set) of a discrete SSY or GCY grid."""
    if name == "ssy":
        model = port.SSY()
        disc = port.discretize_ssy(model, shapes, method=method)
        return model, disc, port.two_phase_operands_ssy(model, disc, baseline)
    model = port.GCY()
    disc = port.discretize_gcy(model, shapes, method=method)
    return model, disc, port.two_phase_operands_gcy(model, disc, baseline,
                                                    dense=dense)


def strip_kernel_check(torch, tt, ops, dev, mode, lazy_bytes):
    """The strip column and row phases vs their plain versions on one
    operand set, in one mode.  Returns (err_col, err_row, col_args,
    row_args, ell, mid) for timing."""
    cast = f32_cast(torch, dev)
    L, K, n1, n2 = ops.shapes
    R, C = L * K, n1 * n2
    th, be = float(ops.theta), float(ops.beta)
    d = tt.strip_device_operands(
        ops, tt.LAZY_BYTES if lazy_bytes is None else lazy_bytes, device=dev)
    rng = np.random.default_rng(SEED)
    base = (np.log(800.0) if ops.baseline_log_w is None
            else ops.baseline_log_w)
    ell = cast(base + 0.02 * rng.standard_normal(ops.shapes)).reshape(
        R, n1, n2)
    col_args = (d["W_c1"], d["W_c2"], th, mode, d["sub_row"], d["sub_col"])
    key = "strip_col" + ("_fast" if mode == "fast" else "")
    before = tt.LAUNCHES[key]
    got = tt.strip_col(ell, *col_args)
    check(tt.LAUNCHES[key] == before + 1,
          f"{key} {ops.shapes}: {tt.LAUNCHES[key] - before} launch counts "
          "for one column phase")
    want = tt.strip_col_plain(ell, *col_args)
    scale = S = None
    if mode == "fast":
        (got, s_k), (want, s) = got, want
        err_col = float(((got - want).abs() / want.abs()).max())
        s_err = float((s_k - s).abs().max())
        check(err_col <= KERNEL_RTOL_LINEAR and s_err <= KERNEL_ATOL,
              f"strip_col fast {ops.shapes}: max rel err {err_col:.3e}, "
              f"s {s_err:.3e}")
        S = s.max().reshape(1)
        scale = torch.exp(s - S)
    else:
        err_col = float((got - want).abs().max())
        lim = KERNEL_ATOL + float(np.finfo(np.float32).eps) * want.abs()
        check(bool(((got - want).abs() <= lim).all()),
              f"strip_col lse {ops.shapes}: max abs err {err_col:.3e}")
    mid = want.reshape(R, C)
    del got, want
    row_args = (scale, S, d["W_r1"], d["W_r2"], d["add_row"], d["add_col"],
                th, be, mode)
    key = "strip_row" + ("_fast" if mode == "fast" else "")
    before = tt.LAUNCHES[key]
    got_r = tt.strip_row(mid, *row_args)
    check(tt.LAUNCHES[key] == before + 1,
          f"{key} {ops.shapes}: {tt.LAUNCHES[key] - before} launch counts "
          "for one row phase")
    want_r = tt.strip_row_plain(mid, *row_args)
    err_row = float((got_r - want_r).abs().max())
    check(bool(torch.isfinite(got_r).all()) and err_row <= KERNEL_ATOL,
          f"strip_row {mode} {ops.shapes}: max abs err {err_row:.3e}")
    torch.cuda.synchronize()
    return err_col, err_row, col_args, row_args, ell, mid


def mid_set(port, shapes):
    """The conjugated normalized SSY set at ``shapes`` (Tauchen) with a
    seeded mid_col that is not separable (a random field)."""
    import dataclasses
    model = port.SSY()
    disc = port.discretize_ssy(model, shapes, method="tauchen")
    conj = port.conjugate_to_shared(
        port.two_phase_operands_ssy(model, disc, "loglinear"))
    rng = np.random.default_rng(SEED + 1)
    return dataclasses.replace(
        conj, mid_col=MID_SCALE * rng.standard_normal(shapes[2:]))


def solve_path(torch, counters, run):
    """Run ``run()`` (a solve ending in a WCSolution or SolveResult) with
    every launch count set to 0 just before it; returns (result, seconds,
    launches)."""
    torch.cuda.synchronize()
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {}
    for c in counters:
        launches.update(c)
    return out, secs, launches


def normalized_phases(torch, port, st, tt, dev, smi, plain_star):
    """Phases 27-31: the normalized tiers and the strip tier.  Returns the
    new kernels' max abs errors vs plain, their launch counts on the
    paths and (kernel ms, plain ms) per kernel; ``plain_star`` holds the
    plain SSY and GCY solutions (float32 log w*) for comparison."""
    cast = f32_cast(torch, dev)
    eps32 = float(np.finfo(np.float32).eps)
    max_err = {k: 0.0 for k in ("strip_col", "strip_row", "strip_col_fast",
                                "strip_row_fast", "pass_b_mid",
                                "pass_b_sub", "pass_c_lse")}
    counters = (st.LAUNCHES, tt.LAUNCHES)

    # 27. The strip kernels vs plain: small sets, then both cells.
    cells = ((("ssy",) + SHAPES[2] + (None, None)),
             (("ssy",) + SHAPES[2] + ("loglinear", None)),
             ("gcy", GCY_SHAPES, GCY_METHOD, None, None),
             ("gcy", GCY_SHAPES, GCY_METHOD, "loglinear", None))
    for name, shapes, method, baseline, lazy_bytes in STRIP_CHECKS + cells:
        _, _, ops = _operand_set(port, name, shapes, method, baseline)
        small = shapes in (c[1] for c in STRIP_CHECKS)
        # Fast mode only inside its envelope (the JAX package's rule): a
        # plain GCY row spans more than float32's exp range (theta = -36;
        # "auto" is "lse" there), so its single-shift linear field sinks
        # into subnormals; a normalized set at a cell overflows the linear
        # chain (its folded factors need the LSE steps).
        fast_ok = (name == "ssy" or baseline is not None) and (
            small or baseline is None)
        modes = ("lse", "fast") if fast_ok else ("lse",)
        for mode in modes:
            err_c, err_r, *_ = strip_kernel_check(torch, tt, ops, dev, mode,
                                                  lazy_bytes)
            suffix = "_fast" if mode == "fast" else ""
            max_err["strip_col" + suffix] = max(max_err["strip_col" + suffix],
                                                err_c)
            max_err["strip_row" + suffix] = max(max_err["strip_row" + suffix],
                                                err_r)
            print(f"strip {name} {shapes} {baseline} lazy_bytes={lazy_bytes} "
                  f"{mode}: col max {'rel' if mode == 'fast' else 'abs'} err "
                  f"{err_c:.3e}, row max abs err {err_r:.3e}")
        del ops
        torch.cuda.empty_cache()

    # 27b. Pass B's mid_col branch vs plain, and one application of a
    # mid_col set against its float64 twin.
    for shapes in MID_CHECKS:
        ops = mid_set(port, shapes)
        L, K, I, J = shapes
        R = L * K
        rng = np.random.default_rng(SEED)
        ell = cast(ops.baseline_log_w + 0.02 * rng.standard_normal(shapes))
        b_args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T),
                  float(ops.theta), "lse",
                  cast(np.asarray(ops.sub_row).reshape(R)),
                  cast(ops.sub_col), cast(ops.mid_col))
        e = ell.reshape(R, I, J)
        got = st.pass_b(e, *b_args)
        want = st.pass_b_plain(e, *b_args)
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= KERNEL_ATOL
                    + eps32 * want.abs()).all()),
              f"pass_b mid {shapes}: max abs err {err:.3e}")
        max_err["pass_b_mid"] = max(max_err["pass_b_mid"], err)
        T = port.make_tiled_T_log(ops, device=dev)
        T64 = port.make_eager_two_phase_T(ops, torch.float64, device=dev)
        app = float((T(ell).double() - T64(ell.double())).abs().max())
        check(T.engine == "streamed" and T.mode == "lse"
              and app <= OPERATOR_ATOL,
              f"mid_col set {shapes}: {T.engine}/{T.mode}, one application "
              f"vs f64 {app:.3e}")
        print(f"pass_b mid {shapes}: max abs err {err:.3e}; one application "
              f"({T.engine}, {T.mode}) vs the float64 twin {app:.3e}")
        del ops, ell, e, got, want, T, T64
    torch.cuda.empty_cache()

    # 28. One application at each cell vs the float64 chain, timed.
    apps_ms = {}
    model_s, disc_s, ops_s = _operand_set(port, "ssy", MAIN_SHAPES,
                                          MAIN_METHOD, None)
    model_g, disc_g, ops_g = _operand_set(port, "gcy", GCY_SHAPES,
                                          GCY_METHOD, None)
    views = {False: tuple(ops_s.shapes), True: tuple(ops_g.shapes)}
    del ops_s, ops_g
    for label, model, disc, baseline, engine, want_engine in (
            ("ssy normalized", model_s, disc_s, "loglinear", "auto",
             "streamed"),
            ("ssy normalized", model_s, disc_s, "loglinear", "strip",
             "strip"),
            ("ssy plain", model_s, disc_s, None, "strip", "strip"),
            ("gcy normalized", model_g, disc_g, "loglinear", "auto",
             "streamed-deferred"),
            ("gcy normalized", model_g, disc_g, "loglinear", "strip",
             "strip"),
            ("gcy plain", model_g, disc_g, None, "strip", "strip")):
        gcy = isinstance(model, port.GCY)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            T = (port.make_tiled_T_log_gcy if gcy
                 else port.make_tiled_T_log_ssy)(model, disc,
                                                 baseline=baseline,
                                                 engine=engine, device=dev)
            build_s = time.perf_counter() - t0
        for w in caught:
            print(f"warning at {label} {engine}: {w.message}")
        T64 = (port.T_gcy_factory if gcy else port.T_ssy_factory)(
            model, disc, space="log", baseline=baseline, device=dev)
        shapes = GCY_SHAPES if gcy else MAIN_SHAPES
        base = (T64.baseline_log_w if baseline
                else torch.full(shapes, np.log(800.0), device=dev,
                                dtype=torch.float64))
        ell64 = base + torch.as_tensor(
            noise_field(shapes, SEED) - np.log(800.0), device=dev)
        x = ell64.float()
        err = float((T(x).double() - T64(ell64)).abs().max())
        check(T.engine == want_engine,
              f"{label} engine={engine} runs {T.engine}, not {want_engine}")
        check(err <= OPERATOR_ATOL,
              f"{label} {T.engine} one application vs f64: {err:.3e}")
        del T64, ell64, base
        ms_k = time_ms(torch, T, x, n=10)
        ms_p = time_ms(torch, T.twin, x, n=10)
        apps_ms[(label, engine)] = (ms_k, ms_p)
        # Bound of one application on its view (L, K, I, J): the column
        # phase's c1 and c2 contractions and the row phase's two, each
        # phase reading and writing one float32 field.
        L, K, I, J = views[gcy]
        R, C = L * K, I * J
        bms, _, term = bound_of(2 * R * I * J * (I + J) + 2 * C * R * (L + K),
                                16 * R * C)
        print(f"operator {label} {shapes} {T.engine}/{T.mode}"
              f"{' lazy ' + str(T.lazy) if T.engine == 'strip' else ''}: "
              f"one application vs f64 max abs err {err:.3e}; {ms_k:.4f} ms "
              f"per application, eager twin {ms_p:.4f} ms, bound "
              f"{bms:.4f} ms ({term}, view {views[gcy]}); built in "
              f"{build_s:.2f} s ({smi})")
        del T, x
        torch.cuda.empty_cache()

    # 28b. Sets the streamed pass C has no slab layout for run the strip
    # tier (the second in the row phase's narrow layout): one application
    # each against its float64 twin.
    for shapes in (UNCOVERED_SSY, NARROW_SSY):
        model_u = port.SSY()
        disc_u = port.discretize_ssy(model_u, shapes, method="tauchen")
        T = port.make_tiled_T_log_ssy(model_u, disc_u, engine="auto",
                                      device=dev)
        T64 = port.T_ssy_factory(model_u, disc_u, space="log", device=dev)
        ell64 = torch.as_tensor(noise_field(shapes, SEED), device=dev)
        before = dict(tt.LAUNCHES)
        got = T(ell64.float())
        torch.cuda.synchronize()
        err = float((got.double() - T64(ell64)).abs().max())
        check(T.engine == "strip" and all(
            tt.LAUNCHES[k] == before[k] + 1
            for k in ("strip_col_fast", "strip_row_fast")),
              f"{shapes} auto runs {T.engine}/{T.mode}")
        check(err <= OPERATOR_ATOL,
              f"{shapes} {T.engine} one application vs f64: {err:.3e}")
        print(f"operator plain SSY {shapes} auto: {T.engine}/{T.mode}, row "
              f"layout {tt.strip_row_layout(*shapes[:2])}, one application "
              f"vs f64 max abs err {err:.3e} ({smi})")
        del T, T64, ell64, got, model_u, disc_u
        torch.cuda.empty_cache()

    # 29. The paths, each with every launch count set to 0 just before it.
    launches = {}
    tol_g = 1.2 * port.f32_tol_floor(model_g.theta)
    T64_s = port.T_ssy_factory(model_s, disc_s, space="log", device=dev)

    def report(label, res, secs, got, T64, star, plain, want):
        ell = star.double()
        r64 = float((T64(ell) - ell).abs().max())
        dist = ("" if plain is None else "; max|l*_normalized - l*_plain| "
                f"{float((star.float() - plain).abs().max()):.3e}")
        print(f"{label}: {res}, {secs:.3f} s ({smi}); launches {got}; f64 "
              f"residual {r64:.3e}{dist}")
        check(res.converged, f"{label} did not converge: {res}")
        check(bool(torch.isfinite(ell).all()), f"{label}: l* not finite")
        check(r64 <= MAIN_F64_RESIDUAL, f"{label} f64 residual {r64:.3e}")
        check(all(got[k] > 0 for k in want),
              f"{label}: a kernel of the path never launched: {got}")
        # One row phase per column phase (strips), one deferred pass B per
        # pass C (GCY).
        for k, per in (("strip_row", "strip_col"),
                       ("strip_row_fast", "strip_col_fast"),
                       ("pass_b_deferred", "pass_c_deferred")):
            check(k not in want or got[k] == got[per],
                  f"{label}: {got[k]} {k} launches for {got[per]} {per}")
        for k in want:
            launches[k] = got[k]

    for run in ("cold", "warm"):
        # (a) Normalized SSY, auto: the streamed full configuration with
        # the fold (B1 has_sub, B2 lse).
        sol, secs, got = solve_path(torch, counters, lambda: (
            port.wc_ratio_discrete(model_s, MAIN_SHAPES, kernel="tiled",
                                   baseline="loglinear",
                                   discretization=MAIN_METHOD, tol=MAIN_TOL,
                                   device=dev)))
        check(got["strip_col"] == 0, "normalized SSY auto ran the strips")
        report(f"path normalized SSY {MAIN_SHAPES} auto, {run}", sol.result,
               secs, got, T64_s, torch.log(sol.w_star), plain_star["ssy"],
               ("pass_b", "pass_c"))
        # Every pass B and pass C of this path is B1 with the fold, lse,
        # and B2 lse.
        launches["pass_b_sub"], launches["pass_c_lse"] = (got["pass_b"],
                                                          got["pass_c"])
        del sol
        # (b) Normalized SSY on the strip tier (B9 lse) end to end.
        T = port.make_tiled_T_log_ssy(model_s, disc_s, baseline="loglinear",
                                      engine="strip", device=dev)
        check(T.engine == "strip", f"strip SSY runs {T.engine}")
        res, secs, got = solve_path(torch, counters, lambda: port.solve(
            T, T.baseline_log_w, method="newton", tol=MAIN_TOL))
        report(f"path normalized SSY {MAIN_SHAPES} strip {T.mode} lazy "
               f"{T.lazy}, {run}", res, secs, got, T64_s, res.x,
               plain_star["ssy"], ("strip_col", "strip_row"))
        del T, res
        torch.cuda.empty_cache()
        # (c) Normalized GCY, auto: the deferred configuration with the
        # fold (B3 <true>, B2 deferred).
        T64_g = port.T_gcy_factory(model_g, disc_g, space="log", device=dev)
        sol, secs, got = solve_path(torch, counters, lambda: (
            port.wc_ratio_discrete(model_g, GCY_SHAPES, kernel="tiled",
                                   baseline="loglinear",
                                   discretization=GCY_METHOD, tol=tol_g,
                                   device=dev)))
        check(got["strip_col"] == 0, "normalized GCY auto ran the strips")
        report(f"path normalized GCY {GCY_SHAPES} auto tol {tol_g:.3e}, "
               f"{run}", sol.result, secs, got, T64_g, torch.log(sol.w_star),
               plain_star["gcy"], ("pass_b_deferred", "pass_c_deferred"))
        del sol, T64_g
        torch.cuda.empty_cache()

    # (d) Plain SSY on the strip tier, fast mode (B9 fast), cold.
    T = port.make_tiled_T_log_ssy(model_s, disc_s, engine="strip",
                                  device=dev)
    check(T.engine == "strip" and T.mode == "fast",
          f"plain strip SSY runs {T.engine}/{T.mode}")
    x0 = torch.full(MAIN_SHAPES, np.log(800.0), device=dev)
    res, secs, got = solve_path(torch, counters, lambda: port.solve(
        T, x0, method="newton", tol=MAIN_TOL))
    report(f"path plain SSY {MAIN_SHAPES} strip fast", res, secs, got, T64_s,
           res.x, plain_star["ssy"], ("strip_col_fast", "strip_row_fast"))
    del T, res
    # (e) A conjugated normalized SSY set with a non-separable mid_col at
    # the cell (B1 mid), cold; checked against its own float64 twin.
    ops = mid_set(port, MAIN_SHAPES)
    T = port.make_tiled_T_log(ops, device=dev)
    T64_m = port.make_eager_two_phase_T(ops, torch.float64, device=dev)
    res, secs, got = solve_path(torch, counters, lambda: port.solve(
        T, T.baseline_log_w, method="newton", tol=MAIN_TOL))
    report(f"path mid_col set {MAIN_SHAPES} ({T.engine}, {T.mode})", res,
           secs, got, T64_m, res.x, None, ("pass_b_mid",))
    del T, T64_m, res, T64_s
    torch.cuda.empty_cache()

    # 30. Timing: each new kernel vs its plain version at the cell the
    # paths above ran it at.
    kernels_ms = {}
    L, K, I, J = MAIN_SHAPES
    R, C = L * K, I * J
    field = 4 * R * C
    _, _, ops_n = _operand_set(port, "ssy", MAIN_SHAPES, MAIN_METHOD,
                               "loglinear")
    _, _, ops_p = _operand_set(port, "ssy", MAIN_SHAPES, MAIN_METHOD, None)

    def factor_bytes(W):
        return 4 * sum(a.numel() for a in (W if isinstance(W, tuple)
                                           else (W,)))

    for ops, mode in ((ops_n, "lse"), (ops_p, "fast")):
        _, _, col_args, row_args, ell, mid = strip_kernel_check(
            torch, tt, ops, dev, mode, None)
        suffix = "_fast" if mode == "fast" else ""
        kernels_ms["strip_col" + suffix] = (
            time_ms(torch, lambda y: tt.strip_col(y, *col_args), ell, n=20),
            time_ms(torch, lambda y: tt.strip_col_plain(y, *col_args), ell,
                    n=20))
        kernels_ms["strip_row" + suffix] = (
            time_ms(torch, lambda y: tt.strip_row(y, *row_args), mid, n=20),
            time_ms(torch, lambda y: tt.strip_row_plain(y, *row_args), mid,
                    n=20))
        sub_bytes = 4 * (R + C) if ops.has_sub else 0
        WORK["strip_col" + suffix] = (
            2 * R * I * J * (I + J),
            2 * field + factor_bytes(col_args[0]) + factor_bytes(col_args[1])
            + sub_bytes)
        WORK["strip_row" + suffix] = (
            2 * C * R * (L + K),
            2 * field + 4 * (L * L + K * K + R + C)
            + (4 * (R + 1) if mode == "fast" else 0))
        del col_args, row_args, ell, mid
    # The strip column phase at the GCY view (192, 512, 256), lse:
    # normalized (rank-2 lazy factors) and plain (shared); the row phase
    # at its (L, K, C) = (12, 16, 131072), plain.
    for baseline in ("loglinear", None):
        _, _, ops = _operand_set(port, "gcy", GCY_SHAPES, GCY_METHOD,
                                 baseline, dense=baseline is None)
        _, _, col_args, row_args, ell, mid = strip_kernel_check(
            torch, tt, ops, dev, "lse", None)
        Lg, Kg, Ig, Jg = ops.shapes
        Rg = Lg * Kg
        k_ms = time_ms(torch, lambda y: tt.strip_col(y, *col_args), ell, n=20)
        p_ms = time_ms(torch, lambda y: tt.strip_col_plain(y, *col_args),
                       ell, n=20)
        bms, _, term = bound_of(2 * Rg * Ig * Jg * (Ig + Jg),
                                8 * Rg * Ig * Jg)
        lazy = tuple(isinstance(w, tuple) for w in col_args[:2])
        print(f"timing strip_col GCY view {tuple(ops.shapes)} {baseline} "
              f"lse lazy {lazy}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({term}), share {bms / k_ms:.3f} ({smi})")
        if baseline is None:
            Cg = Ig * Jg
            k_ms = time_ms(torch, lambda y: tt.strip_row(y, *row_args), mid,
                           n=20)
            p_ms = time_ms(torch, lambda y: tt.strip_row_plain(y, *row_args),
                           mid, n=20)
            bms, _, term = bound_of(
                2 * Cg * Rg * (Lg + Kg),
                8 * Rg * Cg + 4 * (Lg * Lg + Kg * Kg + Rg + Cg),
                6 * Rg * Cg)
            print(f"timing strip_row GCY view (L, K, C) = {(Lg, Kg, Cg)} "
                  f"lse: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({term}), share {bms / k_ms:.3f} ({smi})")
        del ops, col_args, row_args, ell, mid
        torch.cuda.empty_cache()
    ops = mid_set(port, MAIN_SHAPES)
    rng = np.random.default_rng(SEED)
    e = cast(ops.baseline_log_w + 0.02 * rng.standard_normal(
        MAIN_SHAPES)).reshape(R, I, J)
    b_args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T), float(ops.theta),
              "lse", cast(np.asarray(ops.sub_row).reshape(R)),
              cast(ops.sub_col), cast(ops.mid_col))
    kernels_ms["pass_b_mid"] = (
        time_ms(torch, lambda y: st.pass_b(y, *b_args), e),
        time_ms(torch, lambda y: st.pass_b_plain(y, *b_args), e))
    pass_b_work("pass_b_mid", R, I, J,
                2 * field + 4 * (I * I + J * J + R + 2 * I * J))
    # B1 lse with the fold and B2 lse (the linear carry) on the normalized
    # set (a) at the cell, the conjugated-shared set path (a) runs.
    conj = st.streamed_coverable(ops_n)
    check(port.streamed_config(conj) == "full" and not conj.has_mid,
          "normalized SSY (a) is not the full configuration")
    e = cast(conj.baseline_log_w + 0.02 * rng.standard_normal(
        MAIN_SHAPES)).reshape(R, I, J)
    b_args = (cast(conj.W_c1), cast(np.asarray(conj.W_c2).T),
              float(conj.theta), "lse",
              cast(np.asarray(conj.sub_row).reshape(R)), cast(conj.sub_col))
    got, want = st.pass_b(e, *b_args), st.pass_b_plain(e, *b_args)
    err = float((got - want).abs().max())
    check(bool(((got - want).abs()
                <= KERNEL_ATOL + eps32 * want.abs()).all()),
          f"pass_b with the fold {MAIN_SHAPES}: max abs err {err:.3e}")
    max_err["pass_b_sub"] = err
    mid = want.reshape(R, C)
    c_args = (None, None, cast(conj.W_r1), cast(conj.W_r2),
              cast(conj.add_row), cast(np.asarray(conj.add_col).reshape(C)),
              float(conj.theta), float(conj.beta), "lse")
    out_k, out_p = st.pass_c(mid, *c_args), st.pass_c_plain(mid, *c_args)
    err = float((out_k - out_p).abs().max())
    check(bool(torch.isfinite(out_k).all()) and err <= KERNEL_ATOL,
          f"pass_c lse {MAIN_SHAPES}: max abs err {err:.3e}")
    max_err["pass_c_lse"] = err
    del got, want, out_k, out_p
    kernels_ms["pass_b_sub"] = (
        time_ms(torch, lambda y: st.pass_b(y, *b_args), e),
        time_ms(torch, lambda y: st.pass_b_plain(y, *b_args), e))
    kernels_ms["pass_c_lse"] = (
        time_ms(torch, lambda y: st.pass_c(y, *c_args), mid),
        time_ms(torch, lambda y: st.pass_c_plain(y, *c_args), mid))
    pass_b_work("pass_b_sub", R, I, J,
                2 * field + 4 * (I * I + J * J + R + I * J))
    WORK["pass_c_lse"] = (2 * C * R * (L + K),
                          2 * field + 4 * (L * L + K * K + R + C),
                          # expf per entry at the load, logf + expf +
                          # log1pf at the epilogue, the carries per (k, c)
                          4 * R * C + K * C)
    for name in max_err:
        k_ms, p_ms = kernels_ms[name]
        print(f"timing {name} {MAIN_SHAPES}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms ({smi})")
    return max_err, launches, kernels_ms


# The solver layer and calibration (phases 31-35).
POLISH_TOL = 1e-7           # the reference's default tolerance
POLISH_REF_TOL = 1e-10      # the float64 Newton reference, no tangent_T
POLISH_REF_ATOL = 1e-9      # polished log w vs that reference
GMRES_MAXITER = 5           # restart cycles: 100 matvecs a step, as
                            # BiCGStab's 50 iterations
GMRES_ATOL = 2e-4           # log w*, GMRES vs BiCGStab at tol 2e-5
SMALL_SHAPES = (4, 4, 4, 6)
DENSE_ATOL = 1e-10          # dense vs BiCGStab fixed point, float64
GD_TOL = 1e-4
GRAD_SIZES, GRAD_DEGREE, GRAD_TOL = (20, 20, 20, 20), 5, 1e-11
GRAD_EPS = {"beta": 1e-7, "gamma": 1e-5}
GRAD_FD_RTOL = 2e-4
CAL_SIZES, CAL_START_BETA, CAL_BETA_ATOL = (15, 15, 15, 15), 0.9985, 5e-6


class StageSpy:
    """Wraps the port's Newton solver to record each call (a polish has
    two: the fast stage and the float64 stage): dtype, device, result,
    Krylov iterations, whether it had a tangent_T, and seconds."""

    def __init__(self, torch, port):
        self.torch, self.port = torch, port
        self.solvers = port.solvers.api.SOLVERS
        self.calls = []

    def __enter__(self):
        self.newton = self.solvers["newton"]

        def spy(T, x0, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            with krylov_counts(self.port) as inner:
                res = self.newton(T, x0, **kw)
            self.torch.cuda.synchronize()
            self.calls.append(dict(
                dtype=x0.dtype, device=x0.device, res=res, inner=inner,
                tangent=kw.get("tangent_T") is not None,
                secs=time.perf_counter() - t0))
            return res

        self.solvers["newton"] = spy
        return self

    def __exit__(self, *exc):
        self.solvers["newton"] = self.newton

    def describe(self):
        return "; ".join(
            f"stage {i} {str(c['dtype']).replace('torch.', '')} on "
            f"{c['device']}{' with tangent_T' if c['tangent'] else ''}: "
            f"{c['res']}, Krylov iterations {sum(c['inner'])}, "
            f"{c['secs']:.3f} s" for i, c in enumerate(self.calls))


def polish_phase(torch, port, st, label, run, kernels, smi):
    """Run one polished solve (``run()``) with the launch counts set to 0
    just before it; check its float64 residual, dtype, device and that
    ``kernels`` launched.  Returns (solution, the spy)."""
    with StageSpy(torch, port) as spy:
        sol, secs, launches = solve_path(torch, [st.LAUNCHES], run)
    res = sol.result
    now = {k: v for k, v in launches.items() if v}
    print(f"polish {label}, tol {POLISH_TOL:g}: {res} in {secs:.3f} s; "
          f"{spy.describe()}; launches {now} ({smi})")
    check(res.converged and res.residual <= POLISH_TOL,
          f"polish {label}: {res}")
    check(sol.w_star.dtype == torch.float64 and sol.w_star.is_cuda,
          f"polish {label}: w* {sol.w_star.dtype} on {sol.w_star.device}")
    check(bool(torch.isfinite(sol.w_star).all()),
          f"polish {label}: w* not finite")
    check(len(spy.calls) == 2 and spy.calls[1]["tangent"]
          and spy.calls[0]["dtype"] == torch.float32,
          f"polish {label}: stages {spy.describe()}")
    check(all(launches[k] > 0 for k in kernels),
          f"polish {label}: a kernel of the fast stage never launched: "
          f"{now}")
    return sol, spy


def solver_layer_phases(torch, port, st, dev, smi, plain_ssy):
    """Phases 31-35: polish at three cells, Newton's GMRES, dense and
    gd, the calibration gradient and calibration.  Returns what phase 45
    is held to: phase 31's float32 w* and float64 Newton reference (log
    w*, seconds, result) and phase 34's gradient and seconds."""
    from sdfs_via_autodiff_tpu_torch.operators.continuous_common import (
        mc_draws)
    from sdfs_via_autodiff_tpu_torch.ops.interp import lin_interp

    model = port.SSY()
    f64 = torch.float64

    # 31a. Discrete SSY polish at the main cell.
    sol, spy = polish_phase(
        torch, port, st, f"discrete SSY {MAIN_SHAPES} {MAIN_METHOD} tiled",
        lambda: port.wc_ratio_discrete(
            model, MAIN_SHAPES, kernel="tiled", discretization=MAIN_METHOD,
            tol=POLISH_TOL, polish=True, device=dev),
        ("pass_b", "pass_c"), smi)
    ell = torch.log(sol.w_star)
    ell32 = spy.calls[0]["res"].x
    d32 = float((ell - ell32.double()).abs().max())
    t0 = time.perf_counter()
    ref = port.wc_ratio_discrete(
        model, MAIN_SHAPES, discretization=MAIN_METHOD, tol=POLISH_REF_TOL,
        w_init=torch.exp(ell32.double()), device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    d_ref = float((ell - torch.log(ref.w_star)).abs().max())
    print(f"polish discrete SSY {MAIN_SHAPES}: {sol.result.iterations} "
          f"float64 outer steps; sup |log w - log w_f32| = {d32:.3e}; vs "
          f"float64 Newton without tangent_T from the same start (tol "
          f"{POLISH_REF_TOL:g}: {ref.result}, {ref_s:.3f} s): sup diff "
          f"{d_ref:.3e} ({smi})")
    check(ref.converged and d_ref <= POLISH_REF_ATOL,
          f"polish discrete SSY vs float64 Newton: {d_ref:.3e}, {ref.result}")
    # Phase 45 starts from the float32 w* and holds its DTensor solve to
    # the float64 reference.
    refs = {"ell32": ell32, "newton64": torch.log(ref.w_star),
            "newton64_s": ref_s, "newton64_result": ref.result}
    del sol, spy, ell, ref
    torch.cuda.empty_cache()

    # 31b. Discrete GCY polish at the 25.2M cell.
    sol, _ = polish_phase(
        torch, port, st, f"discrete GCY {GCY_SHAPES} {GCY_METHOD} tiled",
        lambda: port.wc_ratio_discrete(
            port.GCY(), GCY_SHAPES, kernel="tiled",
            discretization=GCY_METHOD, tol=POLISH_TOL, polish=True,
            device=dev),
        ("pass_b_deferred", "pass_c_deferred"), smi)
    del sol
    torch.cuda.empty_cache()

    # 31c. Continuous SSY tiled polish at (56,56,56,64), from the log-linear
    # start as path 24 (a).
    grids = port.build_grid_ssy(model, *SSYC_SHAPES)
    w0 = torch.exp(torch.as_tensor(loglinear_start(port, model, grids),
                                   device=dev))
    sol, _ = polish_phase(
        torch, port, st, f"continuous SSY {SSYC_SHAPES} tiled",
        lambda: port.wc_ratio_continuous(
            model, SSYC_SHAPES, kernel="tiled", tol=POLISH_TOL, polish=True,
            w_init=w0, device=dev),
        ("pass_b_c1", "pass_c_batched"), smi)
    del sol, w0
    torch.cuda.empty_cache()

    # 32. inner="gmres" at the SSY main cell.
    with krylov_counts(port) as inner:
        sol, secs, launches = solve_path(
            torch, [st.LAUNCHES], lambda: port.wc_ratio_discrete(
                model, MAIN_SHAPES, kernel="tiled",
                discretization=MAIN_METHOD, tol=MAIN_TOL, inner="gmres",
                inner_maxiter=GMRES_MAXITER, device=dev))
    d = float((torch.log(sol.w_star) - plain_ssy).abs().max())
    print(f"gmres path {MAIN_SHAPES} {MAIN_METHOD} tiled, tol {MAIN_TOL:g}, "
          f"restart 20, {GMRES_MAXITER} cycles a step: {sol.result} in "
          f"{secs:.3f} s; Arnoldi steps per Newton step {inner} = "
          f"{sum(inner)}; launches {launches}; sup |log w - log w_bicgstab| "
          f"= {d:.3e} ({smi})")
    check(sol.converged, f"gmres path: {sol.result}")
    check(launches["pass_b"] > 0 and launches["pass_c"] > 0,
          f"gmres path: a kernel never launched: {launches}")
    check(d <= GMRES_ATOL, f"gmres path vs BiCGStab: {d:.3e}")
    del sol
    torch.cuda.empty_cache()

    # 33. inner="dense" and method="gd" on the card.
    disc = port.discretize_ssy(model, SMALL_SHAPES)
    T = port.T_ssy_factory(model, disc, space="log", device=dev)
    x0 = torch.full(SMALL_SHAPES, np.log(800.0), dtype=f64, device=dev)
    out = {}
    for name, kw in (("bicgstab", dict(method="newton", tol=1e-12)),
                     ("dense", dict(method="newton", inner="dense",
                                    tol=1e-12)),
                     ("gd", dict(method="gd", tol=GD_TOL))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = port.solve(T, x0, **kw)
        torch.cuda.synchronize()
        print(f"{name} on {dev} {SMALL_SHAPES} float64: {out[name]} in "
              f"{time.perf_counter() - t0:.3f} s ({smi})")
    d = float((out["dense"].x - out["bicgstab"].x).abs().max())
    print(f"dense vs bicgstab: sup diff {d:.3e}")
    check(out["dense"].converged and d <= DENSE_ATOL,
          f"dense Newton on the card: {out['dense']}, diff {d:.3e}")
    check(out["gd"].converged and out["gd"].residual <= GD_TOL
          and out["gd"].x.is_cuda, f"gd on the card: {out['gd']}")

    # 34. The calibration gradient at 20^4.
    wc_fn, p0 = port.wc_ratio_differentiable(
        model, GRAD_SIZES, fields=("beta", "gamma"), quad_degree=GRAD_DEGREE,
        tol=GRAD_TOL, device=dev)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = torch.mean(torch.log(wc_fn(p)))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(p.values()))
    torch.cuda.synchronize()
    adj_s = time.perf_counter() - t0
    g = {k: float(v) for k, v in zip(p, grads)}

    def loss_at(k, v):
        q = {n: x.clone() for n, x in p0.items()}
        q[k] = torch.tensor(v, dtype=f64)
        with torch.no_grad():
            return float(torch.mean(torch.log(wc_fn(q))))

    t0 = time.perf_counter()
    fd = {k: (loss_at(k, float(p0[k]) + e) - loss_at(k, float(p0[k]) - e))
          / (2 * e) for k, e in GRAD_EPS.items()}
    fd_s = time.perf_counter() - t0
    rel = {k: abs(g[k] - fd[k]) / abs(fd[k]) for k in g}
    print(f"calibration gradient {GRAD_SIZES} degree {GRAD_DEGREE} tol "
          f"{GRAD_TOL:g} float64 on {dev}: d mean log w*/d(beta, gamma) = "
          f"{g}; central differences {fd} (rel {rel}); solve {solve_s:.3f} s, "
          f"adjoint {adj_s:.3f} s, four difference solves {fd_s:.3f} s "
          f"({smi})")
    check(all(np.isfinite(v) for v in g.values())
          and all(r <= GRAD_FD_RTOL for r in rel.values()),
          f"calibration gradient vs central differences: {rel}")
    refs.update(grad=g, grad_s=solve_s + adj_s)
    del wc_fn, p, loss, grads

    # 35. Calibration at the anchor methodology (15^4, 10^6 draws).
    t0 = time.perf_counter()
    wc_fn, p0 = port.wc_ratio_differentiable(
        model, CAL_SIZES, fields=("beta",), quad_degree=ANCHOR_DEGREE,
        tol=1e-10, device=dev)
    draws = mc_draws(4, ANCHOR_DRAWS, 1234).to(dev)   # calibrate's draws
    with torch.no_grad():
        mu, _ = port.one_step_moments_differentiable(
            model, wc_fn.grids, wc_fn(p0), draws)
    cal, info = port.calibrate_moments(
        dataclasses.replace(model, beta=CAL_START_BETA), CAL_SIZES,
        {"mean": float(mu)}, fields=("beta",), quad_degree=ANCHOR_DEGREE,
        tol=1e-10, num_draws=ANCHOR_DRAWS, max_steps=10, device=dev)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    err = abs(cal.beta - model.beta)
    print(f"calibration {CAL_SIZES} degree {ANCHOR_DEGREE}, {ANCHOR_DRAWS} "
          f"draws, from beta = {CAL_START_BETA}: target E[w] = "
          f"{float(mu):.6f}, beta = {cal.beta:.9f} (|err| {err:.2e}), "
          f"converged {info['converged']}, {info['steps']} steps, cost "
          f"{info['cost']:.3e}, {cal_s:.3f} s ({smi})")
    check(info["converged"] and err <= CAL_BETA_ATOL,
          f"calibration: beta {cal.beta}, {info['converged']}")
    grids = wc_fn.grids

    def rf(q):
        w_grid = wc_fn(q)
        m = dataclasses.replace(model, beta=q["beta"])
        w_func = lambda x: lin_interp(x.reshape(4, -1), w_grid,
                                      grids).reshape(
                                          x.shape[1:] if x.ndim > 1 else ())
        return port.risk_free_rate(m, w_func, degree=ANCHOR_DEGREE,
                                   device=dev)(torch.zeros(4, dtype=f64))

    q = {"beta": p0["beta"].clone().requires_grad_(True)}
    t0 = time.perf_counter()
    r = rf(q)
    g_rf = float(torch.autograd.grad(r, q["beta"])[0])
    print(f"risk-free rate at the origin {float(r.detach()):.6e}, "
          f"d r_f / d beta = "
          f"{g_rf:.6e} through w* ({time.perf_counter() - t0:.3f} s)")
    check(np.isfinite(g_rf), f"risk-free rate gradient {g_rf}")
    return refs


# The command line and the rest of the single-card API (phases 36-42).
CLI_DISCRETE = ["solve", "ssy", "--kind", "discrete", "--kernel", "tiled",
                "--discretization", MAIN_METHOD,
                "--shapes", ",".join(map(str, MAIN_SHAPES)),
                "--tol", f"{MAIN_TOL:g}"]
CLI_CONTINUOUS = ["solve", "ssy", "--kind", "continuous", "--kernel",
                  "tiled", "--baseline", "loglinear",
                  "--shapes", ",".join(map(str, SSYC_SHAPES)),
                  "--tol", f"{SSYC_TOL:g}"]
CLI_W_MEAN_RTOL = 2e-4      # the CLI's w_mean vs phase 5's solve
DATAFILE_ATOL = 1e-12       # datafile interpolant vs the solve's own
DATAFILE_STATES = 10_000
DEGROOT_SIZES, DEGROOT_H, DEGROOT_TOL = (15, 15, 15, 15), 0.99, 1e-9
DEGROOT_APPS = 100
DEGROOT_CLOSED_ATOL = 1e-8  # ln g* vs theta ln((1-beta) w*), h = 1
SWEEP_GAMMAS, SWEEP_SIZES = (8.3, 8.6, 8.89, 9.2), (32, 32, 32, 32)
SWEEP_TOL, SWEEP_MAX_ITER, SWEEP_ATOL = 1e-7, 2000, 1e-9
MC_T, MC_N = 100_000, 10_000
TRACE_APPS, TRACE_SETTLE_S = 3, 0.5
TRACE_CHILD_FLAG, TRACE_CHILD_TIMEOUT_S = "--trace-child", 300
DAMPED_T, DAMPED_N = 10_000, 2_000
DAMPED_S_ATOL, DAMPED_SLAM_ATOL = 1e-5, 2e-6


class DriverSpy:
    """Records what the port's drivers return while the command line
    runs (``cli`` imports them from ``drivers`` at call time)."""

    NAMES = ("wc_ratio_discrete", "wc_ratio_continuous")

    def __init__(self, port):
        self.drivers, self.solutions = port.drivers, []

    def __enter__(self):
        self.saved = {n: getattr(self.drivers, n) for n in self.NAMES}

        def wrap(fn):
            def spy(*args, **kw):
                sol = fn(*args, **kw)
                self.solutions.append(sol)
                return sol
            return spy

        for n, fn in self.saved.items():
            setattr(self.drivers, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.drivers, n, fn)


def trace_child(log_dir: str) -> None:
    """``chip_smoke.py --trace-child DIR`` (phase 38, a process of its
    own): ``utils.trace`` around TRACE_APPS applications of the 12.6M
    tiled operator, the trace written to ``DIR``; prints the device
    events by kernel as a JSON line."""
    import torch

    import sdfs_via_autodiff_tpu_torch as port
    from sdfs_via_autodiff_tpu_torch.utils import trace

    dev = torch.device("cuda", 0)
    disc = port.discretize_ssy(port.SSY(), MAIN_SHAPES, method=MAIN_METHOD)
    T = port.make_tiled_T_log_ssy(port.SSY(), disc, device=dev)
    x0 = torch.full(MAIN_SHAPES, float(np.log(800.0)), dtype=torch.float32,
                    device=dev)
    T(x0)                       # load the kernels before the window
    torch.cuda.synchronize()
    with trace(log_dir) as prof:
        time.sleep(TRACE_SETTLE_S)
        for _ in range(TRACE_APPS):
            T(x0)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    print(json.dumps({e.key[:72]: e.count for e in prof.key_averages()
                      if e.device_type == cuda}))


def run_cli(torch, counters, argv):
    """``cli.main(argv)`` in process with every launch count set to 0
    just before it: (exit code, its JSON line, seconds, launches)."""
    from sdfs_via_autodiff_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, secs, launches = solve_path(torch, counters,
                                        lambda: cli.main(argv))
    text = buf.getvalue().strip()
    print(f"sdfs-torch {' '.join(argv)} -> rc {rc}, {secs:.3f} s: {text}")
    check(rc == 0, f"sdfs-torch {' '.join(argv)} exited {rc}")
    return json.loads(text.splitlines()[-1]), secs, launches


def api_phases(torch, port, st, dev, smi, main_ref, refs):
    """Phases 36-42: the command line (info, check, the two tiled solves
    with checkpoints, simulate, price), the existence checks, de Groot,
    the sweep, the Monte Carlo exponent and profiling.  ``main_ref``
    holds phase 5's launches and w mean; ``refs`` receives the de Groot
    solve's ln g* and seconds (phase 45).  Returns the command line's
    launch counts by kernel."""
    from sdfs_via_autodiff_tpu_torch.utils import (load_solution,
                                                   stability_exponent_mc,
                                                   timed_solve)
    from sdfs_via_autodiff_tpu_torch.utils.profiling import TRACE_FILE

    f64 = torch.float64
    model = port.SSY()
    counters = [st.LAUNCHES]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 36. info, check, existence at the two Tauchen cells.
        info, _, _ = run_cli(torch, counters, ["info"])
        check(info["device"].startswith("cuda") and info["device_count"] >= 1,
              f"info: {info}")
        out, secs, _ = run_cli(torch, counters, [
            "check", "ssy", "--kind", "discrete", "--shapes",
            ",".join(map(str, MAIN_SHAPES)), "--decompose"])
        dec = out["decomposition"]
        check(out["exists_unique"] and out["stability_exponent"] < 1
              and abs(dec["S"] - np.log(out["stability_exponent"])) < 1e-8,
              f"check --decompose: {out}")
        for label, fam, shapes in (("SSY", port.SSY(), MAIN_SHAPES),
                                   ("GCY", port.GCY(), GCY_SHAPES)):
            disc = (port.discretize_ssy if label == "SSY"
                    else port.discretize_gcy)(fam, shapes,
                                              method=MAIN_METHOD)
            rep, secs, _ = solve_path(torch, [], lambda: port.existence_check(
                fam, disc, device=dev))
            print(f"existence_check {label} {shapes} {MAIN_METHOD} float64: "
                  f"r(H) = {rep.spectral_radius!r}, beta r(H)^(1/theta) = "
                  f"{rep.stability_exponent!r}, {rep.iterations} power "
                  f"iterations, {secs:.3f} s ({smi})")
            check(rep.exists_unique and rep.stability_exponent < 1,
                  f"existence_check {label}: {rep}")
            del disc
        torch.cuda.empty_cache()

        # 37. The discrete tiled solve with a checkpoint.
        path = os.path.join(tmp, "discrete.npz")
        with DriverSpy(port) as spy:
            out, secs, launches = run_cli(torch, counters,
                                          CLI_DISCRETE + ["--checkpoint", path])
        now = {k: v for k, v in launches.items() if v}
        cli_launches = {k: launches[k] for k in ("pass_b", "pass_c")}
        rel = abs(out["w_mean"] - main_ref["w_mean"]) / main_ref["w_mean"]
        print(f"CLI discrete tiled: {out['iterations']} Newton iterations, "
              f"launches {now} (phase 5: {main_ref['launches']}), w_mean "
              f"{out['w_mean']!r} vs phase 5 {main_ref['w_mean']!r} (rel "
              f"{rel:.3e}), {secs:.3f} s ({smi})")
        check(out["converged"] is True, f"CLI discrete solve: {out}")
        check(now == main_ref["launches"],
              f"CLI discrete launches {now} != phase 5's "
              f"{main_ref['launches']}")
        check(rel <= CLI_W_MEAN_RTOL, f"CLI discrete w_mean rel {rel:.3e}")
        ckpt = load_solution(path)
        w_file = ckpt.w_star
        w_sol = spy.solutions[-1].w_star.cpu().numpy()
        check(w_file.dtype == w_sol.dtype and np.array_equal(w_file, w_sol)
              and ckpt.meta.get("kernel") == "tiled",
              f"checkpoint w* is not the solve's (meta {ckpt.meta})")
        print(f"checkpoint {os.path.getsize(path)} bytes: w* {w_file.dtype} "
              f"{w_file.shape} bitwise the solve's; meta {ckpt.meta}")
        del spy, ckpt, w_file, w_sol
        torch.cuda.empty_cache()

        # 38. Profiling.
        disc = port.discretize_ssy(model, MAIN_SHAPES, method=MAIN_METHOD)
        T = port.make_tiled_T_log_ssy(model, disc, device=dev)
        x0 = torch.full(MAIN_SHAPES, float(np.log(800.0)),
                        dtype=torch.float32, device=dev)
        ts = timed_solve(port.solve, T, x0, method="newton", tol=MAIN_TOL)
        print(f"timed_solve 12.6M tiled Newton: warm {ts}; cold "
              f"{ts.wall_seconds + ts.compile_seconds:.3f} s ({smi})")
        check(ts.result.converged, f"timed_solve: {ts.result}")
        del T, x0, disc
        torch.cuda.empty_cache()
        # A torch.profiler session late in this long process recorded no
        # device activity in some runs on the H100 (in others it dropped
        # the first kernels of its window), so the trace runs in a
        # process of its own, where it is the first session.
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), TRACE_CHILD_FLAG,
             tmp], capture_output=True, text=True,
            timeout=TRACE_CHILD_TIMEOUT_S)
        check(child.returncode == 0,
              f"the trace process exited {child.returncode}: "
              f"{child.stderr[-2000:]}")
        with open(os.path.join(tmp, TRACE_FILE)) as fh:
            text = fh.read()
        print(f"trace {TRACE_FILE} of {TRACE_APPS} applications: "
              f"{len(text)} bytes; device events "
              f"{child.stdout.strip().splitlines()[-1]}")
        check("pass_b_c1_kernel" in text and "strip_row_kernel" in text,
              "the trace names no pass B or pass C kernel")
        del text
        # 39. The continuous tiled solve, then simulate and price.
        path = os.path.join(tmp, "continuous.npz")
        with DriverSpy(port) as spy:
            out, secs, launches = run_cli(
                torch, counters, CLI_CONTINUOUS + ["--checkpoint", path])
        now = {k: v for k, v in launches.items() if v}
        print(f"CLI continuous tiled (loglinear): {out['iterations']} Newton "
              f"iterations, launches {now}, {secs:.3f} s ({smi})")
        check(out["converged"] is True, f"CLI continuous solve: {out}")
        check(all(launches[k] > 0 for k in ("pass_b_c1_sub",
                                            "pass_c_batched_lse")),
              f"CLI continuous: a kernel never launched: {now}")
        cli_launches.update({k: launches[k] for k in ("pass_b_c1_sub",
                                                      "pass_c_batched_lse")})
        sol = spy.solutions[-1]
        f_mem = port.construct_wstar_callable(sol.w_star, sol.grids,
                                              device=dev)
        f_file = port.construct_wstar_callable(datafile=path, device=dev)
        rng = np.random.default_rng(SEED)
        lo = np.array([float(g[0]) for g in sol.grids])
        hi = np.array([float(g[-1]) for g in sol.grids])
        xs = torch.as_tensor(lo[:, None] + (hi - lo)[:, None] * rng.uniform(
            size=(4, DATAFILE_STATES)), device=dev)
        err = float((f_file(xs).double() - f_mem(xs).double()).abs().max())
        print(f"construct_wstar_callable(datafile=) vs the solve's own "
              f"interpolant at {DATAFILE_STATES} seeded states: max abs "
              f"{err:.3e}")
        check(err <= DATAFILE_ATOL, f"datafile interpolant: {err:.3e}")
        del spy, sol, f_mem, f_file, xs
        torch.cuda.empty_cache()
        sim, secs, _ = run_cli(torch, counters,
                               ["simulate", "ssy", "--checkpoint", path])
        print(f"simulate 10^6 + 10^3 steps: {secs:.3f} s ({smi})")
        check(sim["steps"] == 1_000_000 and sim["w_mean"] > 1
              and sim["w_std"] > 0, f"simulate: {sim}")
        pr, secs, _ = run_cli(torch, counters, ["price", "--checkpoint", path])
        print(f"price: {secs:.3f} s ({smi})")
        check(0.0 < pr["expected_sdf"] < 1.0
              and abs(pr["risk_free_rate"] + np.log(pr["expected_sdf"]))
              < 1e-6, f"price: {pr}")

        # 40. de Groot.
        sol, secs, _ = solve_path(torch, [], lambda: port.degroot_fixed_point(
            model, DEGROOT_SIZES, h=DEGROOT_H, tol=DEGROOT_TOL, device=dev))
        lg = sol.log_g_star
        print(f"degroot_fixed_point SSY {DEGROOT_SIZES} h={DEGROOT_H} tol "
              f"{DEGROOT_TOL:g}: {sol.result}, ln g* in [{float(lg.min()):.6f}, "
              f"{float(lg.max()):.6f}], {secs:.3f} s ({smi})")
        check(sol.converged and bool(torch.isfinite(lg).all()),
              f"degroot_fixed_point: {sol.result}")
        refs["degroot"], refs["degroot_s"] = lg, secs
        out, secs, _ = run_cli(torch, counters, [
            "solve", "ssy", "--shapes", ",".join(map(str, DEGROOT_SIZES)),
            "--spec", "degroot", "--h", str(DEGROOT_H),
            "--tol", f"{DEGROOT_TOL:g}"])
        want = dict(iterations=sol.result.iterations, converged=True,
                    log_g_min=float(lg.min()), log_g_max=float(lg.max()),
                    log_g_mean=float(lg.mean()))
        check(all(out[k] == v for k, v in want.items()),
              f"CLI de Groot {out} vs the API's {want}")
        disc15 = port.discretize_ssy(model, DEGROOT_SIZES)
        rep = port.existence_check_degroot(model, disc15, h=DEGROOT_H,
                                           device=dev)
        print(f"existence_check_degroot {DEGROOT_SIZES} h={DEGROOT_H}: {rep}, "
              f"{rep.iterations} power iterations")
        check(rep.exists_unique and rep.S_alt < 0,
              f"existence_check_degroot: {rep}")
        disc = port.discretize_ssy(model, MAIN_SHAPES, method=MAIN_METHOD)
        Td = port.T_degroot_factory(model, disc, h=DEGROOT_H, space="log",
                                    device=dev)
        x = torch.full(MAIN_SHAPES, model.theta * np.log(
            (1 - model.beta) * 800.0), dtype=f64, device=dev)
        check(bool(torch.isfinite(Td(x)).all()),
              "de Groot operator at 12.6M: not finite")
        ms = time_ms(torch, Td, x, n=DEGROOT_APPS, runs=1)
        print(f"T_degroot_factory(space='log') float64 at {MAIN_SHAPES} "
              f"{MAIN_METHOD}: {ms:.4f} ms per application over "
              f"{DEGROOT_APPS} ({smi})")
        del Td, x, disc
        torch.cuda.empty_cache()
        noshock = dataclasses.replace(model, s_lam=0.0)
        wc = port.wc_ratio_discrete(noshock, DEGROOT_SIZES, tol=1e-11,
                                    device=dev)
        dg, secs, _ = solve_path(torch, [], lambda: port.degroot_fixed_point(
            noshock, DEGROOT_SIZES, tol=1e-12, device=dev))
        err = float((dg.log_g_star - noshock.theta * torch.log(
            (1 - noshock.beta) * wc.w_star)).abs().max())
        print(f"de Groot h = 1, s_lam = 0 at {DEGROOT_SIZES}: sup |ln g* - "
              f"theta ln((1-beta) w*)| = {err:.3e} ({dg.result}, "
              f"{secs:.3f} s)")
        check(wc.converged and dg.converged and err <= DEGROOT_CLOSED_ATOL,
              f"de Groot closed form: {err:.3e}")

        # 41. The sweep against sequential solves.
        members = [dataclasses.replace(model, gamma=g) for g in SWEEP_GAMMAS]
        (w, res, _), sweep_s, _ = solve_path(
            torch, [], lambda: port.wc_ratio_sweep(
                members, SWEEP_SIZES, algorithm="anderson", tol=SWEEP_TOL,
                max_iter=SWEEP_MAX_ITER, device=dev))
        seq, seq_s, _ = solve_path(torch, [], lambda: [
            port.wc_ratio_continuous(
                m, SWEEP_SIZES, algorithm="anderson", tol=SWEEP_TOL,
                max_iter=SWEEP_MAX_ITER, device=dev,
                w_init=torch.full(SWEEP_SIZES, 800.0, dtype=f64, device=dev))
            for m in members])
        errs = [float((torch.log(w[i]) - torch.log(s.w_star)).abs().max())
                for i, s in enumerate(seq)]
        print(f"wc_ratio_sweep gamma {SWEEP_GAMMAS} at {SWEEP_SIZES} anderson "
              f"tol {SWEEP_TOL:g}: {res}, {sweep_s:.3f} s; sequential "
              f"{[s.result.iterations for s in seq]} iterations, "
              f"{seq_s:.3f} s; max |log w diff| per member {errs} ({smi})")
        check(bool(res.converged.all()) and all(s.converged for s in seq)
              and max(errs) <= SWEEP_ATOL, f"sweep vs sequential: {errs}")
        del w, res, seq
        torch.cuda.empty_cache()

        # 42. The Monte Carlo stability exponent.
        mc, secs, _ = solve_path(torch, [], lambda: stability_exponent_mc(
            model, T=MC_T, N=MC_N, device=dev))
        print(f"stability_exponent_mc SSY T={MC_T} N={MC_N}: {mc}, "
              f"{secs:.3f} s ({smi})")
        check(all(np.isfinite(mc[k]) for k in ("S", "S_lambda", "S_c")),
              f"MC exponent: {mc}")
        damped = dataclasses.replace(
            model, s_lam=4e-5, s_z=np.sqrt(0.0039) / 10,
            s_c=np.sqrt(0.0096) / 10, phi_z=1e-5)
        dec = port.stability_decomposition(
            damped, port.discretize_ssy(damped, (8, 8, 8, 12)), device=dev)
        mc, secs, _ = solve_path(torch, [], lambda: stability_exponent_mc(
            damped, T=DAMPED_T, N=DAMPED_N, seed=0, device=dev))
        s_lam = damped.theta / 2 * damped.s_lam ** 2 / (1 - damped.rho_lam) ** 2
        print(f"damped calibration: MC {mc} ({secs:.3f} s); decomposition "
              f"{dec}; closed-form S_lambda {s_lam!r}")
        check(abs(dec.S_lambda - s_lam) <= 1e-8
              and abs(mc["S"] - dec.S) <= DAMPED_S_ATOL
              and abs(mc["S_lambda"] - s_lam) <= DAMPED_SLAM_ATOL,
              f"MC triple cross-check: {mc}, {dec}, {s_lam}")

    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cli_launches


# The sharded path (phases 43-44).
SHARD_APP_ATOL = 1e-6       # sharded application vs make_streamed_T_log
SHARD_W_RTOL = 1e-6         # sharded Newton w* vs the stepwise solve
SHARD_F64_SIZES = (8, 8, 6, 6)
SHARD_F64_ATOL = 1e-12      # the float64 factories vs single device
SHARD_RANKS = 4             # the layout phase 44 runs rank by rank


def sharded_world1_phase(torch, port, st, dev, smi, main_ref, refs):
    """Phase 43: the sharded operators under a real NCCL process group of
    world size 1, then phase 45 (:func:`gspmd_phase`) in the same group.
    Returns the sharded Newton solve's launches by kernel row name."""
    import datetime
    import socket

    import torch.distributed as dist
    from sdfs_via_autodiff_tpu_torch import parallel as par
    from sdfs_via_autodiff_tpu_torch.config import num_devices

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port_no = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port_no}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        check(num_devices() == 1, "num_devices() != 1 at world size 1")
        mesh = par.make_mesh(device="cuda")
        model = port.SSY()
        disc = port.discretize_ssy(model, MAIN_SHAPES, method=MAIN_METHOD)
        ops = port.two_phase_operands_ssy(model, disc)
        T = par.streamed_shard_map_factory(ops, mesh)
        T1 = port.make_streamed_T_log(ops, device=dev)
        check(T.mode == "fast" and T1.mode == "fast",
              f"sharded SSY operator runs {T.mode}")
        x = torch.as_tensor(noise_field(MAIN_SHAPES, SEED),
                            device=dev).float()
        y = T(x).to_local()
        y1 = T1(x)
        err = float((y - y1).abs().max())
        bitwise = bool(torch.equal(y, y1))
        check(bool(torch.isfinite(y).all()) and err <= SHARD_APP_ATOL,
              f"sharded application vs make_streamed_T_log: {err:.3e}")
        print(f"sharded streamed operator, world size 1 (NCCL), "
              f"{MAIN_SHAPES} {MAIN_METHOD}: one application vs "
              f"make_streamed_T_log max abs err {err:.3e}, bitwise equal "
              f"{bitwise}; input sharding {T.input_sharding}")
        del x, y, y1
        x0 = T.from_local(torch.log(torch.full(
            MAIN_SHAPES, 800.0, dtype=torch.float32, device=dev)))
        torch.cuda.synchronize()
        for k in st.LAUNCHES:
            st.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = port.solve(T, x0, method="newton", tol=MAIN_TOL)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in st.LAUNCHES.items() if v}
        check(res.converged, f"sharded Newton did not converge: {res}")
        check(launches == main_ref["launches"],
              f"sharded Newton launches {launches} != phase 5's "
              f"{main_ref['launches']}")
        w = torch.exp(res.x.to_local())
        # A DTensor's tangent keeps the stages' steps (the tangent passes
        # take plain tensors, phase 47), so the sharded solve's reference
        # is the single-device solve from the same start on those steps:
        # the twin records them where it sees a DTensor.
        from sdfs_via_autodiff_tpu_torch.operators import two_phase as tp
        fused_route = tp.is_dtensor
        tp.is_dtensor = lambda t: True
        try:
            ref = port.solve(T1, x0.to_local(), method="newton",
                             tol=MAIN_TOL)
        finally:
            tp.is_dtensor = fused_route
        w_ref = torch.exp(ref.x)
        rel = float(((w - w_ref).abs() / w_ref).max())
        rel5 = float(((w - main_ref["w_star"]).abs()
                      / main_ref["w_star"]).max())
        check(ref.converged and rel <= SHARD_W_RTOL,
              f"sharded Newton {res} vs the stepwise single-device solve "
              f"{ref}: w* rel {rel:.3e}")
        print(f"sharded Newton (world size 1): {res}, {secs:.3f} s "
              f"({smi}), launches {launches} (phase 5: "
              f"{main_ref['launches']}), w* vs the stepwise single-device "
              f"solve max rel {rel:.3e} (vs phase 5's, on the tangent "
              f"passes, {rel5:.3e}), x placements {res.x.placements}")
        del T, T1, x0, res, w, ref, w_ref
        # The float64 factories at a small grid.
        disc = port.discretize_ssy(model, SHARD_F64_SIZES)
        ell = torch.as_tensor(noise_field(SHARD_F64_SIZES, SEED), device=dev)
        ref = port.T_ssy_factory(model, disc, space="log", device=dev)(ell)
        errs = {}
        T_a = par.T_ssy_shard_map_factory(model, disc, mesh)
        errs["T_ssy_shard_map_factory"] = float(
            (T_a(ell).to_local() - ref).abs().max())
        ops = port.two_phase_operands_ssy(model, disc)
        T_b = par.two_phase_shard_map_factory(ops, mesh,
                                              dtype=torch.float64)
        ref_b = port.make_eager_two_phase_T(ops, torch.float64,
                                            device=dev)(ell)
        errs["two_phase_shard_map_factory"] = float(
            (T_b(ell).to_local() - ref_b).abs().max())
        for name, e in errs.items():
            check(e <= SHARD_F64_ATOL, f"{name} f64 vs single: {e:.3e}")
            print(f"{name} {SHARD_F64_SIZES} float64, world size 1: vs the "
                  f"single-device operator max abs err {e:.3e}")
        # Newton's tangent on the shard, built once per step, against
        # torch.func.jvp of T.local.
        v = torch.as_tensor(np.random.default_rng(SEED + 43).standard_normal(
            SHARD_F64_SIZES), device=dev)
        for name, T_s in (("T_ssy_shard_map_factory", T_a),
                          ("two_phase_shard_map_factory", T_b)):
            xl, vl = T_s.to_local(ell), T_s.to_local(v)
            got = T_s.local_twin.linearize(xl)(vl)
            want = torch.func.jvp(lambda y: T_s.local(y) - y, (xl,),
                                  (vl,))[1]
            rel = float((got - want).abs().max() / want.abs().max())
            check(rel <= SHARD_F64_ATOL, f"{name}: linearized matvec vs "
                  f"jvp {rel:.3e} relative")
            print(f"{name} {SHARD_F64_SIZES} float64, world size 1: "
                  f"linearized matvec (one build per Newton step) vs "
                  f"torch.func.jvp of T.local max relative diff {rel:.3e}")
        del T_a, T_b, ell, ref, ref_b, v, got, want
        torch.cuda.empty_cache()
        gspmd_phase(torch, port, dev, smi, mesh, refs)
    finally:
        dist.destroy_process_group()
    return {k: launches.get(k, 0) for k in ("pass_b", "pass_c")}


# The single-device operators and solvers on a DTensor (phase 45).
GSPMD_NEWTON_ATOL = 1e-10   # DTensor Newton vs phase 31's float64 one
GSPMD_AA_TOL = 1e-9         # Anderson's tolerance from the float32 w*
GSPMD_AA_MAX_ITER = 3000
GSPMD_GRAD_RTOL = 1e-8      # DTensor gradient vs phase 34's
GSPMD_DEGROOT_ATOL = 1e-12  # DTensor de Groot vs phase 40's
GSPMD_MATVECS = 5           # matvecs a timing run
GSPMD_LEAK_APPS = 50        # applications that must leave no bytes


def gspmd_phase(torch, port, dev, smi, mesh, refs):
    """Phase 45: the single-device factories and the solvers on a
    DTensor iterate (``ops/dtensor.py``, ``parallel/gspmd.py``), on
    phase 43's 1 x 1 NCCL mesh, at the cells the earlier phases drive;
    see the module docstring, item 45."""
    import dataclasses as dc

    from sdfs_via_autodiff_tpu_torch import parallel as par
    from sdfs_via_autodiff_tpu_torch.drivers import DEFAULT_INIT_W
    from sdfs_via_autodiff_tpu_torch.parallel import gspmd
    from sdfs_via_autodiff_tpu_torch.operators.continuous_ssy import (
        _factored_T)

    t_phase = time.perf_counter()
    f64 = torch.float64
    model = port.SSY()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a)-(c) One application on a DTensor: bitwise, placements kept.
    gcy = port.GCY()
    cases = (
        (f"T_ssy_factory(space='log') {MAIN_SHAPES} {MAIN_METHOD}",
         lambda: port.T_ssy_factory(model, port.discretize_ssy(
             model, MAIN_SHAPES, method=MAIN_METHOD), space="log",
             device=dev), MAIN_SHAPES),
        (f"T_gcy_factory(space='log') {GCY_SHAPES} {GCY_METHOD}",
         lambda: port.T_gcy_factory(gcy, port.discretize_gcy(
             gcy, GCY_SHAPES, method=GCY_METHOD), space="log", device=dev),
         GCY_SHAPES),
        (f"T_ssy_continuous_factory(interp='pre', space='log') "
         f"{SSYC_SHAPES}",
         lambda: port.T_ssy_continuous_factory(
             model, port.build_grid_ssy(model, *SSYC_SHAPES), interp="pre",
             space="log", device=dev), SSYC_SHAPES))
    for label, build, shapes in cases:
        T = build()
        x = torch.as_tensor(noise_field(shapes, SEED), device=dev)
        xd = par.shard_grid_array(x, mesh)
        y, d_s = timed(lambda: T(xd))
        y1, s_s = timed(lambda: T(x))
        equal = bool(torch.equal(y.to_local(), y1))
        kept = tuple(y.placements) == tuple(xd.placements)
        print(f"DTensor {label} float64, 1 x 1 mesh: bitwise the "
              f"single-device application {equal}, placements "
              f"{tuple(y.placements)} kept {kept}; first application "
              f"{d_s:.3f} s (single device {s_s:.3f} s) ({smi})")
        check(equal and kept, f"DTensor {label}: bitwise {equal}, "
              f"placements kept {kept}")
        if shapes == MAIN_SHAPES:
            T_main = T
            ms_d = time_ms(torch, T, xd, n=GSPMD_MATVECS, runs=3)
            ms_1 = time_ms(torch, T, x, n=GSPMD_MATVECS, runs=3)
            print(f"DTensor application at {MAIN_SHAPES}: {ms_d:.3f} ms, "
                  f"single device {ms_1:.3f} ms, by CUDA events ({smi})")
            # Nothing keeps an application's lifted constants or
            # temporaries: more applications leave the card's allocated
            # bytes where one left them.
            T(xd)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            for _ in range(GSPMD_LEAK_APPS):
                T(xd)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            print(f"allocated on the card after 1 DTensor application at "
                  f"{MAIN_SHAPES}: {before} bytes; after "
                  f"{GSPMD_LEAK_APPS} more: {after} bytes")
            check(after <= before, f"DTensor applications keep "
                  f"{after - before} bytes on the card")
            # The tangent route against torch.func.jvp.
            rng = np.random.default_rng(SEED + 1)
            v = torch.as_tensor(rng.standard_normal(shapes), device=dev)
            op = par.local_operator(T, xd)
            xl, vl = op.to_local(xd), op.to_local(
                par.shard_grid_array(v, mesh))
            mv = op.local_twin.linearize(xl)
            jv, setup_s = timed(lambda: mv(vl) + vl)
            want = torch.func.jvp(T, (x,), (v,))[1]
            err = float((jv - want).abs().max())
            ms_route = time_ms(torch, mv, vl, n=GSPMD_MATVECS, runs=3)
            ms_jvp = time_ms(torch, lambda u: torch.func.jvp(
                lambda y_: T(y_) - y_, (x,), (u,))[1], v,
                n=GSPMD_MATVECS, runs=3)
            print(f"tangent route on the DTensor (the operator's hand "
                  f"linearization, DTensor-dispatched) at "
                  f"{MAIN_SHAPES}: {ms_route:.3f} ms per matvec (first "
                  f"matvec with the linearization {setup_s:.3f} s), "
                  f"single-device torch.func.jvp {ms_jvp:.3f} ms per "
                  f"matvec, by CUDA events; max abs vs jvp {err:.3e} "
                  f"({smi})")
            check(err <= 1e-12, f"tangent route vs jvp: {err:.3e}")
            del op, xl, mv, jv, want
            # An operator without a hand linearization (w space) takes
            # the derivative of a VJP on the DTensor.
            T_w = port.T_ssy_factory(model, port.discretize_ssy(
                model, MAIN_SHAPES, method=MAIN_METHOD), space="w",
                device=dev)
            xw = torch.exp(x)
            op = par.local_operator(T_w, par.shard_grid_array(xw, mesh))
            vjp_route = isinstance(op.local_twin, gspmd.VjpLinearization)
            mv = op.local_twin.linearize(op.to_local(
                par.shard_grid_array(xw, mesh)))
            jv, setup_s = timed(lambda: mv(vl) + vl)
            want = torch.func.jvp(T_w, (xw,), (v,))[1]
            err = float((jv - want).abs().max()) / float(want.abs().max())
            ms_route = time_ms(torch, mv, vl, n=GSPMD_MATVECS, runs=3)
            print(f"tangent route on the DTensor for T_ssy_factory("
                  f"space='w') at {MAIN_SHAPES} (no hand linearization: "
                  f"the derivative of a VJP, {type(op.local_twin).__name__})"
                  f": {ms_route:.3f} ms per matvec (first matvec with the "
                  f"linearization {setup_s:.3f} s), by CUDA events; max "
                  f"abs vs jvp relative to sup|jvp| {err:.3e} ({smi})")
            check(vjp_route and err <= 1e-12, f"w-space tangent route "
                  f"{type(op.local_twin).__name__} vs jvp: {err:.3e}")
            del T_w, xw, op, vl, mv, jv, want, v
        del T, x, xd, y, y1
        torch.cuda.empty_cache()

    # (d) Newton from phase 31's float32 w*, float64 on the DTensor.
    start = refs["ell32"].double()
    x0 = par.shard_grid_array(start, mesh)
    res, secs = timed(lambda: port.solve(T_main, x0, method="newton",
                                         tol=POLISH_REF_TOL))
    d = float((res.x.to_local() - refs["newton64"]).abs().max())
    print(f"DTensor Newton float64 at {MAIN_SHAPES} from phase 31's "
          f"float32 w*, tol {POLISH_REF_TOL:g}: {res}, {secs:.3f} s "
          f"(phase 31's single-device float64 Newton: "
          f"{refs['newton64_result']}, {refs['newton64_s']:.3f} s); sup "
          f"diff {d:.3e}; x placements {tuple(res.x.placements)} ({smi})")
    check(res.converged and par.is_dtensor(res.x)
          and d <= GSPMD_NEWTON_ATOL,
          f"DTensor Newton vs phase 31: {d:.3e}, {res}")
    del res

    # (e) Anderson from the same start.
    opts = dict(method="anderson", tol=GSPMD_AA_TOL,
                max_iter=GSPMD_AA_MAX_ITER)
    res, secs = timed(lambda: port.solve(T_main, x0, **opts))
    ref, ref_s = timed(lambda: port.solve(T_main, start, **opts))
    beta = model.beta
    bound_aa = 2 * GSPMD_AA_TOL * beta / (1 - beta)
    d = float((res.x.to_local() - ref.x).abs().max())
    d64 = float((res.x.to_local() - refs["newton64"]).abs().max())
    print(f"DTensor Anderson float64 at {MAIN_SHAPES} from phase 31's "
          f"float32 w*, tol {GSPMD_AA_TOL:g}: {res}, {secs:.3f} s; single "
          f"device {ref}, {ref_s:.3f} s; sup diff {d:.3e} (bitwise "
          f"{bool(torch.equal(res.x.to_local(), ref.x))}), vs phase 31's "
          f"float64 Newton {d64:.3e} ({smi})")
    check(res.converged and ref.converged and d <= bound_aa
          and d64 <= bound_aa, f"DTensor Anderson: {res}, {d:.3e}, "
          f"{d64:.3e}")
    del res, ref, x0, start, T_main
    torch.cuda.empty_cache()

    # (f) Phase 34's calibration gradient from a DTensor start.
    fields = ("beta", "gamma")
    grids = port.build_grid_ssy(model, *GRAD_SIZES, num_std_devs=3.2,
                                dtype=f64)
    built = {}

    def T_of_p(p, x):
        leaves = tuple(p[k] for k in fields)
        if built.get("p") is None or any(
                a is not b for a, b in zip(built["p"], leaves)):
            m = dc.replace(model, **dict(zip(fields, leaves)))
            built["p"] = leaves
            built["T"] = _factored_T(m, grids, GRAD_DEGREE, "log", f64,
                                     None, device=dev)
        return built["T"](x)

    x0 = par.shard_grid_array(torch.full(
        GRAD_SIZES, float(np.log(DEFAULT_INIT_W)), dtype=f64, device=dev),
        mesh)
    p = {k: torch.tensor(float(getattr(model, k)), dtype=f64,
                         requires_grad=True) for k in fields}

    def gradient():
        x = port.implicit_fixed_point(T_of_p, p, x0, method="newton",
                                      tol=GRAD_TOL)
        return torch.autograd.grad(x.mean().full_tensor(),
                                   [p[k] for k in fields])

    grads, secs = timed(gradient)
    g = {k: float(v) for k, v in zip(fields, grads)}
    rel = {k: abs(g[k] - refs["grad"][k]) / abs(refs["grad"][k])
           for k in fields}
    print(f"DTensor calibration gradient {GRAD_SIZES} degree "
          f"{GRAD_DEGREE}: {g}, phase 34's {refs['grad']} (rel {rel}); "
          f"solve and adjoint {secs:.3f} s (phase 34: "
          f"{refs['grad_s']:.3f} s) ({smi})")
    check(all(r <= GSPMD_GRAD_RTOL for r in rel.values()),
          f"DTensor calibration gradient vs phase 34: {rel}")
    del built, x0, p, grads

    # (g) Phase 40's de Groot Newton solve: degroot_fixed_point's SA warm
    # start on one device, then Newton on the DTensor.
    Td = port.T_degroot_factory(model, port.discretize_ssy(
        model, DEGROOT_SIZES), h=DEGROOT_H, space="log", device=dev)
    ell0 = torch.full(DEGROOT_SIZES, model.theta * float(np.log(
        (1 - model.beta) * DEFAULT_INIT_W)), dtype=f64, device=dev)
    warm = port.solve(Td, ell0, method="successive_approx", tol=1e-6,
                      max_iter=20000).x
    res, secs = timed(lambda: port.solve(
        Td, par.shard_grid_array(warm, mesh), method="newton",
        tol=DEGROOT_TOL))
    d = float((res.x.to_local() - refs["degroot"]).abs().max())
    print(f"DTensor de Groot Newton {DEGROOT_SIZES} h={DEGROOT_H} tol "
          f"{DEGROOT_TOL:g} from degroot_fixed_point's SA warm start: "
          f"{res}, {secs:.3f} s (phase 40's whole solve "
          f"{refs['degroot_s']:.3f} s); sup diff vs phase 40 {d:.3e} ({smi})")
    check(res.converged and d <= GSPMD_DEGROOT_ATOL,
          f"DTensor de Groot vs phase 40: {d:.3e}, {res}")
    del Td, ell0, warm, res

    # (h) A kernel-backed operator refuses a DTensor.
    small = (4, 4, 4, 8)
    Tk = port.make_streamed_T_log(port.two_phase_operands_ssy(
        model, port.discretize_ssy(model, small)), device=dev)
    try:
        Tk(par.shard_grid_array(torch.full(small, 6.7, device=dev), mesh))
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"make_streamed_T_log's operator given a DTensor: ValueError "
          f"{refused!r}")
    check("streamed_shard_map_factory" in refused and "T.twin" in refused,
          f"kernel-backed operator on a DTensor: {refused!r}")
    print(f"phase 45 (the DTensor path): {time.perf_counter() - t_phase:.1f}"
          f" s ({smi})")


def _plain_pass_b(st, plan, e):
    """The plain version of ``plan.pass_b(e)`` on the plan's tensors."""
    if plan.config in ("deferred", "pair"):
        return st.pass_b_deferred_plain(e, plan.W_c1t, plan.theta,
                                        plan.sub_row, plan.sub_col)
    return st.pass_b_plain(e, plan.W_c1, None if plan.config == "batched"
                           else plan.W_c2t, plan.theta, plan.mode,
                           plan.sub_row, plan.sub_col, plan.mid_col)


def _plain_pass_c(st, plan, mid, scale, S):
    """The plain version of ``plan.pass_c(mid, scale, S)``."""
    args = (plan.W_r1, plan.W_r2, plan.add_row, plan.add_col, plan.theta,
            plan.beta)
    if plan.config == "pair":
        return st.pass_c_pair_plain(mid, plan.P_zpi, plan.PzT, *args)
    if plan.config == "deferred":
        return st.pass_c_deferred_plain(mid, plan.W_c2t, *args)
    if plan.config == "batched":
        return st.pass_c_batched_plain(mid, scale, S, plan.W_c2t, *args,
                                       plan.mode)
    return st.pass_c_plain(mid, scale, S, *args, plan.mode)


def _rank_by_rank(torch, port, par, st, ops, x, n, mode_label, smi):
    """One application of the streamed operator for ``ops`` on ``x`` as
    ``n`` ranks would run it, on this card: each rank's plan, its pass B
    and pass C against their plain versions, the reshards by slicing and
    concatenation, the assembled field against the single-device
    operator.  Returns (max abs errors (B, C), launches, per-rank ms)."""
    eps32 = float(np.finfo(np.float32).eps)
    dev = x.device
    plans = [par.streamed_shard_plan(ops, n, r, device=dev)
             for r in range(n)]
    p0 = plans[0]
    R_loc, C_loc, I, J = p0.R_loc, p0.C_loc, p0.shapes[2], p0.shapes[3]
    e = x.reshape(p0.R, I, J)
    fast = p0.mode == "fast"
    torch.cuda.synchronize()
    before = dict(st.LAUNCHES)
    mids, shifts = [], []
    for r, plan in enumerate(plans):
        got = plan.pass_b(e[r * R_loc:(r + 1) * R_loc].contiguous())
        if fast:
            got, s = got
            shifts.append(s)
        mids.append(got)
    launches_b = {k: st.LAUNCHES[k] - before[k] for k in st.LAUNCHES}
    err_b = 0.0
    for r, plan in enumerate(plans):
        e_r = e[r * R_loc:(r + 1) * R_loc].contiguous()
        want = _plain_pass_b(st, plan, e_r)
        got = mids[r]
        if fast:
            want = want[0]
            rel = float(((got - want).abs() / want.abs()).max())
            check(rel <= KERNEL_RTOL_LINEAR,
                  f"{mode_label} rank {r} pass B: rel {rel:.3e}")
            err_b = max(err_b, float((got - want).abs().max()))
        else:
            d = (got - want).abs()
            check(bool((d <= KERNEL_ATOL + eps32 * want.abs()).all()),
                  f"{mode_label} rank {r} pass B: {float(d.max()):.3e}")
            err_b = max(err_b, float(d.max()))
    scale = S = None
    if fast:
        S = torch.amax(torch.cat(shifts)).reshape(1)
        scale = torch.exp(torch.cat(shifts) - S)
    before = dict(st.LAUNCHES)
    outs, midvs = [], []
    for c, plan in enumerate(plans):
        midv = torch.cat([m.reshape(R_loc, -1)[:, c * C_loc:(c + 1) * C_loc]
                          for m in mids]).contiguous()
        midvs.append(midv)
        outs.append(plan.pass_c(midv, scale, S))
    launches_c = {k: st.LAUNCHES[k] - before[k] for k in st.LAUNCHES}
    err_c = 0.0
    for c, plan in enumerate(plans):
        want = _plain_pass_c(st, plan, midvs[c], scale, S)
        d = float((outs[c] - want).abs().max())
        check(bool(torch.isfinite(outs[c]).all()) and d <= KERNEL_ATOL,
              f"{mode_label} rank {c} pass C: {d:.3e}")
        err_c = max(err_c, d)
    field = torch.cat(outs, dim=1).reshape(p0.shapes)
    single = port.make_streamed_T_log(ops, device=dev)(x)
    d = float((field - single).abs().max())
    check(d <= SHARD_APP_ATOL, f"{mode_label} assembled vs single-device "
          f"operator: {d:.3e}")
    ms_b = [time_ms(torch, lambda y, p=p: p.pass_b(y),
                    e[r * R_loc:(r + 1) * R_loc].contiguous(), n=20)
            for r, p in enumerate(plans)]
    ms_c = [time_ms(torch, lambda y, p=p: p.pass_c(y, scale, S), midvs[r],
                    n=20) for r, p in enumerate(plans)]
    launches = {k: launches_b[k] + launches_c[k] for k in st.LAUNCHES
                if launches_b[k] + launches_c[k]}
    print(f"rank by rank, {mode_label}, {n} ranks ({R_loc} rows, {C_loc} "
          f"columns a rank): pass B vs plain max abs err {err_b:.3e}, pass "
          f"C {err_c:.3e}; assembled vs single-device operator max abs err "
          f"{d:.3e}, bitwise equal {bool(torch.equal(field, single))}; "
          f"launches {launches}; ms per rank pass B "
          f"{[round(v, 4) for v in ms_b]}, pass C "
          f"{[round(v, 4) for v in ms_c]} ({smi})")
    return (err_b, err_c), launches, (ms_b, ms_c)


def rank_by_rank_phase(torch, port, st, dev, smi, gcyc_ops):
    """Phase 44: the streamed shard factory's per-rank plans at a 4-rank
    layout, rank by rank on this card.  Returns the launches by kernel
    row name."""
    from sdfs_via_autodiff_tpu_torch import parallel as par

    t0 = time.perf_counter()
    ssy = port.SSY()
    disc = port.discretize_ssy(ssy, MAIN_SHAPES, method=MAIN_METHOD)
    plain = port.two_phase_operands_ssy(ssy, disc)
    norm = port.two_phase_operands_ssy(ssy, disc, "loglinear")
    gcy = port.GCY()
    gops = port.two_phase_operands_gcy(
        gcy, port.discretize_gcy(gcy, GCY_SHAPES, method=GCY_METHOD))
    rng = np.random.default_rng(SEED)
    cast = f32_cast(torch, dev)
    # (label, operand set, input, {LAUNCHES key: kernel row name})
    sets = (("SSY 12.6M fast", plain, noise_field(MAIN_SHAPES, SEED),
             {"pass_b": "pass_b", "pass_c": "pass_c"}),
            ("SSY 12.6M normalized (a)", norm, None,
             {"pass_b": "pass_b_sub", "pass_c": "pass_c_lse"}),
            ("GCY 25.2M deferred", gops, noise_field(gops.shapes, SEED),
             {"pass_b_deferred": "pass_b_deferred",
              "pass_c_deferred": "pass_c_deferred"}),
            ("continuous GCY 18.9M pair", gcyc_ops, None,
             {"pass_b_deferred": "pass_b_deferred_sub",
              "pass_c_pair": "pass_c_pair"}))
    launches_by_row = {}
    for label, ops, field, rows in sets:
        covered = port.streamed_coverable(ops)
        if field is None:
            field = (np.asarray(covered.baseline_log_w)
                     + 0.05 * rng.standard_normal(covered.shapes))
        n = SHARD_RANKS
        if covered.is_pair and covered.pair_shapes[0] % n:
            n = 2
        check(covered.shapes[0] % n == 0 and covered.shapes[2] % n == 0,
              f"{label}: {covered.shapes} does not split over {n} ranks")
        _, launches, _ = _rank_by_rank(
            torch, port, par, st, ops, cast(field).reshape(covered.shapes), n,
            label, smi)
        for key, row in rows.items():
            check(launches.get(key, 0) == n,
                  f"{label}: {key} launched {launches.get(key, 0)} times, "
                  f"not once per rank ({n})")
            launches_by_row[row] = launches.get(key, 0)
        torch.cuda.empty_cache()
    print(f"rank by rank phase: {time.perf_counter() - t0:.2f} s")
    return launches_by_row


def tangent_phase(torch, port, dev, smi):
    """Phase 46: Newton's tangent, the hand linearization (``T.linearize``,
    ``ops/tangent.py``: one primal per Newton step, each matvec the
    stored factors' contractions) against ``torch.func.jvp`` of the twin
    per matvec, at the Newton cells.  Per cell, at the solve's start x
    and a seeded v: the two matvecs' difference (relative to sup |v|, the
    CPU tests' measure, and to sup |(J - I) v|), ms per matvec on each
    route (CUDA events around each of 21 matvecs, median), the build's ms
    (median of 5), the stored bytes, then a full Newton solve from x with
    the card's allocated bytes before and after it (equal: the factors
    go with the step) and its seconds, and the same solve on the jvp
    route (a twin without ``linearize``)."""
    from sdfs_via_autodiff_tpu_torch.ops.tangent import Linearization
    from sdfs_via_autodiff_tpu_torch.solvers.sharding import tangent_matvec

    from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk

    ssy, gcy = port.SSY(), port.GCY()
    grids_c = port.build_grid_ssy(ssy, *SSYC_SHAPES)

    def ssy_cell():
        disc = port.discretize_ssy(ssy, MAIN_SHAPES, method=MAIN_METHOD)
        T = port.make_tiled_T_log_ssy(ssy, disc, device=dev)
        return T, torch.full(MAIN_SHAPES, float(np.log(800.0)),
                             device=dev), MAIN_TOL

    def gcy_cell():
        disc = port.discretize_gcy(gcy, GCY_SHAPES, method=GCY_METHOD)
        T = port.make_tiled_T_log_gcy(gcy, disc, device=dev)
        x = torch.as_tensor(port.gcy_loglinear_parts(gcy, disc)["ell0"],
                            dtype=torch.float32, device=dev)
        return T, x, 1.2 * port.f32_tol_floor(gcy.theta)

    def ssyc_cell(baseline):
        T = port.make_tiled_T_log_ssy_continuous(ssy, grids_c, 5,
                                                 baseline=baseline,
                                                 device=dev)
        x = (T.baseline_log_w if baseline else torch.as_tensor(
            loglinear_start(port, ssy, grids_c), dtype=torch.float32,
            device=dev))
        return T, x, SSYC_TOL

    def normalized_cell():
        disc = port.discretize_ssy(ssy, MAIN_SHAPES, method="tauchen")
        T = port.make_tiled_T_log_ssy(ssy, disc, baseline="loglinear",
                                      device=dev)
        return T, T.baseline_log_w, MAIN_TOL

    def fused_cell():
        grids = [g.float() for g in port.build_grid_ssy(ssy, *FUSED_SIZES)]
        T = port.make_fused_T_log_ssy_continuous(ssy, grids, device=dev)
        return T, torch.zeros(FUSED_SIZES, device=dev), FUSED_NEWTON_TOL

    def post_cell(interp):
        # B8's operator, from the driver's start (w = 1).
        grids = port.build_grid_ssy(ssy, *POST_SIZES)
        T = pk.make_post_interp_kernel_T_ssy(ssy, grids, POST_DEGREE,
                                             interp, device=dev)
        return T, torch.zeros(POST_SIZES, device=dev), POST_TOL

    def mc_cell():
        grids = port.build_grid_ssy(ssy, *MC_SSY_SIZES)
        T = port.T_ssy_continuous_factory(
            ssy, grids, method="monte_carlo", interp="post", space="log",
            mc_draw_size=MC_DRAWS, dtype=torch.float32, device=dev)
        return T, torch.full(MC_SSY_SIZES, float(np.log(800.0)),
                             device=dev), None

    def per_axis_normalized_cell():
        # The float32 deep windows (normalized, per axis), Tauchen.
        disc = port.discretize_ssy(ssy, MAIN_SHAPES, method="tauchen")
        T = port.T_ssy_factory(ssy, disc, space="log", baseline="loglinear",
                               dtype=torch.float32, device=dev)
        return T, T.baseline_log_w, None

    # (label, cell, Newton solves: on both routes, on the linearization
    # only, or none).  The 20^4 "post" solve on the jvp route took
    # 66-85 s (PERF.md): it is not rerun.
    cells = (("SSY 12.6M", ssy_cell, "both"), ("GCY 25.2M", gcy_cell, "both"),
             ("continuous SSY 11.2M (a)", lambda: ssyc_cell(None), "both"),
             ("continuous SSY 11.2M (b)", lambda: ssyc_cell("loglinear"),
              "both"),
             ("normalized SSY 12.6M (a)", normalized_cell, "both"),
             ("fused 20^4", fused_cell, "both"),
             ("post 20^4 (B8)", lambda: post_cell("post"), "lin"),
             ("loglin 20^4 (B8)", lambda: post_cell("loglin"), "both"),
             (f"MC node chain SSY 20^4, {MC_DRAWS} draws", mc_cell, None),
             ("per-axis normalized SSY 12.6M f32", per_axis_normalized_cell,
              None))

    def per_call_ms(fn, x, n=TANGENT_MATVECS):
        fn(x)
        times = []
        for _ in range(n):
            _, ms = events_ms(torch, lambda: fn(x))
            times.append(ms)
        return statistics.median(times)

    out = {}
    for label, make, solves in cells:
        torch.cuda.empty_cache()
        T, x, tol = make()
        twin = getattr(T, "twin", T)
        v = torch.as_tensor(np.random.default_rng(SEED + 46).standard_normal(
            tuple(x.shape)), dtype=torch.float32, device=dev)
        lin = tangent_matvec(twin, x)
        check(isinstance(lin, Linearization),
              f"{label}: Newton's tangent is not the hand linearization")
        jvp = lambda u: torch.func.jvp(lambda y: twin(y) - y, (x,), (u,))[1]
        got, want = lin(v), jvp(v)
        diff = float((got - want).abs().max())
        rel_v = diff / float(v.abs().max())
        rel_mv = diff / float(want.abs().max())
        del got, want
        ms_lin, ms_jvp = per_call_ms(lin, v), per_call_ms(jvp, v)
        builds = []
        for _ in range(TANGENT_BUILDS):
            fresh = twin.linearize(x)
            builds.append(events_ms(torch, fresh.build)[1])
            nbytes = fresh.nbytes
            del fresh
        del lin
        build_ms = statistics.median(builds)
        line = (f"tangent {label} {tuple(x.shape)}: linearized matvec vs "
                f"jvp max abs diff {diff:.3e} (relative to sup|v| "
                f"{rel_v:.3e}, to sup|(J - I)v| {rel_mv:.3e}); "
                f"{ms_lin:.4f} ms per linearized matvec, {ms_jvp:.4f} ms "
                f"per jvp matvec (CUDA events, median of "
                f"{TANGENT_MATVECS}); build {build_ms:.4f} ms per Newton "
                f"step (median of {TANGENT_BUILDS}); stored {nbytes} bytes")
        check(rel_v <= TANGENT_RTOL, f"{label}: linearized matvec vs jvp "
              f"{rel_v:.3e} of sup|v|")
        secs = secs_j = None
        if solves:
            # A full Newton solve: the factors of every step are freed
            # when the step ends.
            T(x)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with krylov_counts(port) as inner:
                res = port.solve(T, x, method="newton", tol=tol)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            summary = str(res)
            converged = res.converged
            del res
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            line += (f"; Newton {summary}, {sum(inner)} BiCGStab "
                     f"iterations, {secs:.3f} s; allocated before {before} "
                     f"bytes, after {after} bytes")
            check(converged, f"{label}: Newton did not converge: {summary}")
            check(after == before, f"{label}: the Newton solve left "
                  f"{after - before} bytes on the card")
        if solves == "both":
            # The same solve on the jvp route (a twin without linearize).
            T_jvp = lambda y: T(y)
            T_jvp.twin = lambda y: twin(y)
            t0 = time.perf_counter()
            with krylov_counts(port) as inner_j:
                res = port.solve(T_jvp, x, method="newton", tol=tol)
            torch.cuda.synchronize()
            secs_j = time.perf_counter() - t0
            summary_j = str(res)
            converged_j = res.converged
            del res, T_jvp
            line += (f"; on the jvp route: Newton {summary_j}, "
                     f"{sum(inner_j)} BiCGStab iterations, {secs_j:.3f} s")
            check(converged_j, f"{label}: Newton on the jvp route did not "
                  f"converge: {summary_j}")
        print(f"{line} ({smi})")
        out[label] = (ms_lin, ms_jvp, build_ms, nbytes, secs, secs_j)
        del T, twin, x, v
    torch.cuda.empty_cache()
    return out


def _krylov_expected_launches(counts, every):
    """K1's launches for Krylov solves of ``counts`` iterations: P0,
    then five passes an iteration over whole chunks of ``every``."""
    return sum(1 + 5 * every * -(-n // every) for n in counts)


# The tangent passes against the einsum replay of the same tape: both
# are float32 sums of the same terms in different orders (the passes' c2
# product and the GCY view's c1 in split TF32), a few ulps of J |v| <=
# |v| apart (the CPU tests' measure, 2e-6 of sup |v|).
TANGENT_RTOL = 2e-6
TANGENT_CALLS, TANGENT_RUNS = 50, 3


def tangent_passes_phase(torch, port, dev, smi):
    """Phase 47: the tangent passes (K2, ``kernels/tangent_two_phase.py``)
    at the two Newton cells' shapes.  Per cell, at the solve's start x and
    a seeded v: the tape's fused step, its launches per matvec (three: the
    c1 pass or product, the c2 product, the row phase), its agreement with
    its plain version (the einsum replay of the same tape, on the card)
    for J v and J v - v, ms per matvec (CUDA events, median of 3 runs of
    50) of the step, of the einsum replay and of Newton's whole matvec
    (``Linearization``, GCY's layout crossings included), the bytes
    allocated at a matvec's peak on each route, and the bound: seven
    fields of bytes at HBM bandwidth, the contractions in split TF32 (c2,
    and c1 where it runs on the tensor cores) and on FP32 FMA.  Returns
    {cell: (ms, plain ms, bound ms, launches per matvec, largest error
    relative to sup |v|)}; the SSY cell's work is the ``tangent_passes``
    row's (``WORK``, ``FP32_WORK``)."""
    from sdfs_via_autodiff_tpu_torch.kernels import tangent_two_phase as ktp
    from sdfs_via_autodiff_tpu_torch.ops.tangent import Tape

    ssy, gcy = port.SSY(), port.GCY()

    def ssy_cell():
        disc = port.discretize_ssy(ssy, MAIN_SHAPES, method=MAIN_METHOD)
        return (port.make_tiled_T_log_ssy(ssy, disc, device=dev),
                torch.full(MAIN_SHAPES, float(np.log(800.0)), device=dev))

    def gcy_cell():
        disc = port.discretize_gcy(gcy, GCY_SHAPES, method=GCY_METHOD)
        return (port.make_tiled_T_log_gcy(gcy, disc, device=dev),
                torch.as_tensor(port.gcy_loglinear_parts(gcy, disc)["ell0"],
                                dtype=torch.float32, device=dev))

    def peak_bytes(fn, v):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn(v)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base

    out = {}
    for label, make in (("SSY 12.6M", ssy_cell), ("GCY 25.2M", gcy_cell)):
        T, x = make()
        tape = Tape()
        with torch.no_grad():
            T.twin.primal(x, tape)
        steps = [s for s in tape.finish()
                 if isinstance(s, ktp.TwoPhaseTangent)]
        check(len(steps) == 1, f"{label}: the tape holds one fused step")
        step = steps[0]
        L, K, I, J = step.shapes
        R, C = L * K, I * J
        g = torch.Generator(device=dev).manual_seed(SEED + 47)
        v = torch.randn(step.shapes, generator=g, device=dev)
        with torch.no_grad():
            before = dict(ktp.LAUNCHES)
            got = step(v)
            torch.cuda.synchronize()
            per = {k: ktp.LAUNCHES[k] - before[k] for k in before}
            want = step.plain(v)
            err = float((got - want).abs().max() / v.abs().max())
            err_m = float((step.minus_identity(v) - (want - v)).abs().max()
                          / v.abs().max())
            bytes_fused = peak_bytes(step, v)
            bytes_plain = peak_bytes(step.plain, v)
            ms = time_ms(torch, step, v, TANGENT_CALLS, TANGENT_RUNS)
            plain_ms = time_ms(torch, step.plain, v, TANGENT_CALLS,
                               TANGENT_RUNS)
            lin = T.twin.linearize(x)
            vx = torch.randn(x.shape, generator=g, device=dev)
            lin_ms = time_ms(torch, lin, vx, TANGENT_CALLS, TANGENT_RUNS)
        want_per = {"tangent_c1": int(step.split == "full"),
                    "tangent_c1_mma": int(step.split == "deferred"),
                    "tangent_c2": 1, "tangent_row": 1}
        check(per == want_per, f"{label}: tangent launches {per}")
        check(err <= TANGENT_RTOL and err_m <= TANGENT_RTOL,
              f"{label}: tangent passes vs einsum replay {err:.3g}, "
              f"J v - v {err_m:.3g} of sup |v| (limit {TANGENT_RTOL:g})")
        c1, c2 = 2 * R * I * I * J, 2 * R * I * J * J
        rows = 2 * R * C * (L + K)
        tf32 = 3 * (c2 + (c1 if step.split == "deferred" else 0))
        flop = rows + (c1 if step.split == "full" else 0)
        nbytes = 7 * 4 * R * C
        bound_ms, bound_by, term = bound_of(flop, nbytes, 0, tf32)
        fp32_ms = bound_of(c1 + c2 + rows, nbytes)[0]
        if label == "SSY 12.6M":
            WORK["tangent_passes"] = (flop, nbytes, 0, tf32)
            FP32_WORK["tangent_passes"] = (c1 + c2 + rows, nbytes)
        print(f"tangent passes {label} ({step.split}, (L, K, I, J) = "
              f"{step.shapes}): {ms:.4f} ms a matvec [einsum replay "
              f"{plain_ms:.4f}], Newton's matvec {lin_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({term}; bytes "
              f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f}, FP32 route "
              f"{fp32_ms:.4f}), share {bound_ms / ms:.1%}; vs replay "
              f"{err:.3g}, J v - v {err_m:.3g} of sup |v|; peak "
              f"{bytes_fused / 2**20:.1f} MiB a matvec [replay "
              f"{bytes_plain / 2**20:.1f}]; launches {per}; {smi}")
        out[label] = (ms, plain_ms, bound_ms, sum(per.values()),
                      max(err, err_m))
        del T, x, tape, steps, step, v, vx, got, want, lin
        torch.cuda.empty_cache()
    return out


def krylov_phase(torch, port, dev, smi):
    """Phase 6's K1 part: the fused BiCGStab passes against the eager
    loop on Newton's first tangent of the SSY path (w = 800) at
    MAIN_SHAPES.  Returns (max abs error of x, device ms per iteration
    of the five passes, the eager loop's vector ms per iteration)."""
    from sdfs_via_autodiff_tpu_torch.kernels import krylov_fused as kf
    from sdfs_via_autodiff_tpu_torch.solvers import krylov
    from sdfs_via_autodiff_tpu_torch.solvers.sharding import (
        LOCAL, tangent_matvec)

    model = port.SSY()
    disc = port.discretize_ssy(model, MAIN_SHAPES, method=MAIN_METHOD)
    T = port.make_tiled_T_log_ssy(model, disc, device=dev)
    x = torch.full(MAIN_SHAPES, float(np.log(800.0)), device=dev)
    rhs = T(x) - x
    jac = tangent_matvec(getattr(T, "twin", T), x)
    atol = (KRYLOV_INNER_TOL * torch.linalg.vector_norm(rhs)).to(
        torch.float64)
    check(kf.fusable(rhs), "the SSY tangent's right-hand side is not "
          "fusable")

    events = []

    def timed(v):
        """``jac`` with CUDA events around each matvec."""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = jac(v)
        e1.record()
        events.append((e0, e1))
        return out

    def solve(fused):
        """(x, count, device ms of the whole solve less its matvecs)."""
        events.clear()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        if fused:
            out, n = krylov.bicgstab_fused(timed, rhs, atol=atol,
                                           maxiter=KRYLOV_MAXITER)
        else:
            out, n = krylov._bicgstab_eager(timed, rhs, atol,
                                            KRYLOV_MAXITER, None, LOCAL)
        stop.record()
        stop.synchronize()
        mv = sum(a.elapsed_time(b) for a, b in events)
        return out, n, start.elapsed_time(stop) - mv

    def pass_ms(spin):
        """Device ms per iteration of the five passes in one solve:
        CUDA events around each group of passes of a copy of
        ``bicgstab_fused``'s loop run to ``KRYLOV_MAXITER`` without a
        stop read (a stopped solve's passes return at once and are left
        out).  With ``spin`` a spin kernel runs before each group, so
        the host has enqueued the group before the card reaches it: the
        passes' own time; without, a group's interval also holds the
        card's waits for the host's launches, as in a solve."""
        def mark(e):
            if spin:
                torch.cuda._sleep(KRYLOV_SPIN_CYCLES)
            e.record()

        bf = rhs.reshape(-1)
        xs, r, p = torch.zeros_like(bf), bf.clone(), torch.zeros_like(bf)
        ps = kf.Passes(xs, r, p, bf, LOCAL)
        ps.start(atol, KRYLOV_MAXITER)
        marks, v = [], p
        for _ in range(KRYLOV_MAXITER):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            mark(e[0])
            ps(1, v)
            e[1].record()
            v = jac(p.reshape(MAIN_SHAPES))
            mark(e[2])
            ps(2, v)
            ps(3, v)
            e[3].record()
            t = jac(r.reshape(MAIN_SHAPES))
            mark(e[4])
            ps(4, t)
            ps(5, t)
            e[5].record()
            marks.append(e)
        torch.cuda.synchronize()
        n = int(ps.iterations)
        ms = [sum(e[i].elapsed_time(e[i + 1]) for i in (0, 2, 4))
              for e in marks[:n]]
        return sum(ms) / n, n

    x_e, n_e, vec_e = solve(False)
    for k in kf.LAUNCHES:
        kf.LAUNCHES[k] = 0
    x_f, n_f, vec_f = solve(True)
    launches = dict(kf.LAUNCHES)
    x_f2, n_f2, _ = solve(True)
    scale = float(x_e.abs().max())
    err = float((x_f - x_e).abs().max())
    print(f"K1 fused BiCGStab vs the eager loop, SSY tangent at "
          f"{MAIN_SHAPES} {MAIN_METHOD} (w = 800, atol {float(atol):.4e}):"
          f" iterations {n_f} fused, {n_e} eager; max |x_f - x_e| "
          f"{err:.3e} of max |x| {scale:.3e} ({err / scale:.3e}); a second"
          f" fused solve bitwise equal {bool(torch.equal(x_f, x_f2))}; "
          f"launches {launches}")
    check(n_f > 0 and abs(n_f - n_e) <= KRYLOV_ITER_SLACK,
          f"K1: {n_f} fused iterations against {n_e} eager")
    check(err <= KRYLOV_X_RTOL * scale,
          f"K1: max |x_f - x_e| {err:.3e} over {KRYLOV_X_RTOL} x {scale:.3e}")
    check(n_f2 == n_f and torch.equal(x_f, x_f2),
          "K1: two fused solves differ")
    check(launches == {"krylov_pass": _krylov_expected_launches(
        [n_f], krylov.SYNC_EVERY), "krylov_epilogue": 0},
          f"K1: launches {launches} for {n_f} iterations")
    runs = [pass_ms(True) for _ in range(3)]
    in_solve = [pass_ms(False) for _ in range(3)]
    check(all(n == n_f for _, n in runs + in_solve),
          f"K1: the timed loops ran {[n for _, n in runs + in_solve]} "
          f"iterations, the solve {n_f}")
    ms = statistics.median(m for m, _ in runs)
    n_vec = rhs.numel()
    WORK["krylov_pass"] = (0, KRYLOV_VECTORS_PER_ITER * n_vec
                           * rhs.element_size())
    bound_ms = bound("krylov_pass")[0]
    print(f"timing K1 {MAIN_SHAPES} float32 ({n_vec} entries): the five "
          f"passes {ms:.4f} ms per iteration (median of 3 solves of "
          f"{n_f} iterations: {', '.join(f'{m:.4f}' for m, _ in runs)}), "
          f"byte bound {bound_ms:.4f} ms ({WORK['krylov_pass'][1] / 1e6:.1f}"
          f" MB), share {bound_ms / ms:.1%}; without the spin kernel (the "
          f"card's waits for the host's launches included) "
          f"{', '.join(f'{m:.4f}' for m, _ in in_solve)} ms; whole solve "
          f"less its matvecs per iteration: fused {vec_f / n_f:.4f} ms, "
          f"eager {vec_e / n_e:.4f} ms ({smi})")
    return err, ms, vec_e / n_e


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA GPU")

    import sdfs_via_autodiff_tpu_torch as port
    from sdfs_via_autodiff_tpu_torch.kernels import _build
    from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
    from sdfs_via_autodiff_tpu_torch.kernels import krylov_fused as kf
    from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
    from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st
    from sdfs_via_autodiff_tpu_torch.kernels import tangent_two_phase as ktp
    from sdfs_via_autodiff_tpu_torch.kernels import tiled_two_phase as tt
    from sdfs_via_autodiff_tpu_torch.solvers.krylov import SYNC_EVERY

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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "--id=0"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_PER_S[0] = SFU_PER_CLOCK_PER_SM * n_sm * clock_mhz * 1e6
    print(f"device: {kind}")
    print(f"special-function rate for the bounds: {SFU_PER_CLOCK_PER_SM} "
          f"per clock per SM x {n_sm} SMs x {clock_mhz:.0f} MHz "
          f"(clocks.max.sm) = {SFU_PER_S[0] / 1e12:.4f} T/s")
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
    tt._lib()
    kf._lib()
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
    for counter in (st.LAUNCHES, kf.LAUNCHES, ktp.LAUNCHES):
        for k in counter:
            counter[k] = 0
    t0 = time.perf_counter()
    with krylov_counts(port) as inner, \
            span_count(port, "sdfs.tangent.matvec") as matvecs:
        sol = port.wc_ratio_discrete(model, MAIN_SHAPES, kernel="tiled",
                                     discretization=MAIN_METHOD,
                                     algorithm="newton", tol=MAIN_TOL,
                                     device=dev)
        torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    krylov_launches = dict(kf.LAUNCHES)
    tangent_launches = dict(ktp.LAUNCHES)
    res = sol.result
    print(f"main path {MAIN_SHAPES} {MAIN_METHOD} newton: {res}, "
          f"{solve_s:.3f} s, launches {launches}; K1 {krylov_launches} "
          f"for BiCGStab iterations {inner} a Newton step; K2 "
          f"{tangent_launches} for {matvecs[0]} tangent matvecs")
    check(res.converged, f"main path did not converge: {res}")
    check(launches["pass_b"] > 0 and launches["pass_c"] > 0,
          f"a kernel of the SSY path never launched: {launches}")
    check(sum(inner) > 0 and krylov_launches == {
        "krylov_pass": _krylov_expected_launches(inner, SYNC_EVERY),
        "krylov_epilogue": 0},
          f"K1 launches {krylov_launches} for BiCGStab iterations {inner}")
    # The SSY cell's split is "full": the c1 pass, the c2 product and the
    # row phase once per tangent matvec.
    check(matvecs[0] > 0 and tangent_launches == {
        "tangent_c1": matvecs[0], "tangent_c1_mma": 0,
        "tangent_c2": matvecs[0], "tangent_row": matvecs[0]},
          f"K2 launches {tangent_launches} for {matvecs[0]} tangent "
          f"matvecs")
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
    plain_star = {"ssy": ell_star.float()}
    main_ref = {"launches": {k: v for k, v in launches.items() if v},
                "w_mean": float(w.mean()), "w_star": w.float()}
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
            pass_b_work("pass_b", R, I, J,
                        2 * field + 4 * (I * I + J * J + R))
            WORK["pass_c"] = (2 * C * R * (L + K),
                              2 * field + 4 * (L * L + K * K + 2 * R + C + 1))
            for name, (k_ms, p_ms) in kernels_ms.items():
                print(f"timing {name} fast {shapes}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms")
    del T
    torch.cuda.empty_cache()
    max_err["krylov_pass"], *k1_ms = krylov_phase(torch, port, dev, smi)
    kernels_ms["krylov_pass"] = tuple(k1_ms)

    # 7-9. GCY.
    torch.cuda.empty_cache()
    gcy_err, gcy_launches, gcy_ms, plain_star["gcy"] = gcy_phases(
        torch, port, st, dev, smi)
    max_err.update(gcy_err)
    launches = {"pass_b": launches["pass_b"], "pass_c": launches["pass_c"],
                "krylov_pass": krylov_launches["krylov_pass"],
                "tangent_passes": sum(tangent_launches.values()),
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
    gcyc_err, gcyc_launches, gcyc_ms, gcyc_ops = gcy_continuous_phases(
        torch, port, st, dev, smi)
    max_err["pass_b_deferred_sub"] = gcyc_err["pass_b_deferred"]
    max_err["pass_c_pair"] = gcyc_err["pass_c_pair"]
    launches["pass_c_pair"] = gcyc_launches["pass_c_pair"]
    # Every deferred pass B of the continuous-GCY path has the fold.
    launches["pass_b_deferred_sub"] = gcyc_launches["pass_b_deferred"]
    kernels_ms.update(gcyc_ms)

    # 17. The fused tier on continuous GCY.
    torch.cuda.empty_cache()
    for name, err in fused_gcy_phase(torch, port, dev, smi).items():
        max_err[name] = max(max_err[name], err)

    # 18-19. The post-interp kernel and the continuous-SSY post path.
    torch.cuda.empty_cache()
    (max_err["post_interp"], launches["post_interp"],
     kernels_ms["post_interp"]) = post_interp_phases(torch, port, dev, smi)

    # 20. The reference's moment anchors; 21. the Monte Carlo node chains.
    anchor_phase(torch, port, dev, smi)
    mc_phase(torch, port, dev, smi)

    # 22-26. Tiled continuous SSY.
    torch.cuda.empty_cache()
    ssyc_err, ssyc_launches, ssyc_ms = ssy_continuous_phases(
        torch, port, st, dev, smi)
    max_err["pass_b"] = max(max_err["pass_b"], ssyc_err.pop("pass_b"))
    max_err.update(ssyc_err)
    launches.update({k: ssyc_launches[k] for k in ssyc_err})
    kernels_ms.update(ssyc_ms)

    # 27-31. The normalized tiers and the strip tier.
    torch.cuda.empty_cache()
    norm_err, norm_launches, norm_ms = normalized_phases(
        torch, port, st, tt, dev, smi, plain_star)
    max_err.update(norm_err)
    launches.update({k: norm_launches[k] for k in norm_err})
    kernels_ms.update(norm_ms)

    # 31-35. The solver layer and calibration.
    torch.cuda.empty_cache()
    refs = solver_layer_phases(torch, port, st, dev, smi,
                               plain_star["ssy"].double())
    del plain_star

    # 36-42. The command line and the rest of the single-card API.
    torch.cuda.empty_cache()
    cli_launches = api_phases(torch, port, st, dev, smi, main_ref, refs)

    # 43-45. The sharded path and the DTensor path.
    torch.cuda.empty_cache()
    sharded_launches = sharded_world1_phase(torch, port, st, dev, smi,
                                            main_ref, refs)
    del main_ref, refs
    torch.cuda.empty_cache()
    rank_launches = rank_by_rank_phase(torch, port, st, dev, smi, gcyc_ops)

    # 46. Newton's tangent: the hand linearization against jvp.
    del gcyc_ops
    tangent_phase(torch, port, dev, smi)

    # 47. The tangent passes at the Newton cells.
    k2 = tangent_passes_phase(torch, port, dev, smi)["SSY 12.6M"]
    max_err["tangent_passes"] = k2[4]
    kernels_ms["tangent_passes"] = k2[:2]

    # 48. Result.
    print(f"total {time.perf_counter() - t_start:.1f} s")
    rows = []
    for name in KERNELS:
        bound_ms, bound_by, _ = bound(name)
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCE_OF[name], "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": kernels_ms[name][0],
                     "plain_ms": kernels_ms[name][1], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "share": bound_ms / kernels_ms[name][0],
                     "library_ms": None})
        if name in cli_launches:
            # The command line's tiled solves (phases 37 and 39).
            rows[-1]["cli_launches"] = cli_launches[name]
        if name in sharded_launches:
            # The sharded Newton solve at world size 1 (phase 43).
            rows[-1]["sharded_launches"] = sharded_launches[name]
        if name in rank_launches:
            # Per sharded application, over the ranks (phase 44).
            rows[-1]["rank_launches"] = rank_launches[name]
        if name in FP32_WORK:
            # The FP32 route's bound beside the tensor-core route's.
            fp32_ms = bound_of(*FP32_WORK[name])[0]
            rows[-1].update(bound_fp32_ms=fp32_ms,
                            share_fp32=fp32_ms / kernels_ms[name][0])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [TRACE_CHILD_FLAG]:
        trace_child(sys.argv[2])
    else:
        main()
