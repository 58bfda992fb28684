"""Phase split and before/after timing of the port's redesigned kernels on
one CUDA card: the post-interp kernel (B8), the pair pass C (B4), the
deferred pass B (B3), the deferred and batched pass C (B2), the fused
whole-solve kernel (B5-B7) and the strip column and row phases (B9 col,
B9 row).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.kernel_split \
      [--before DIR]
      [--kernels post_interp,pass_c_pair,pass_b_deferred,pass_c_deferred,
                 fused,strip_col,strip_row,pass_b,pass_c]

Each kernel's source stops after a phase under a compile-time switch
(``SPLITS``; 1-3 store that phase's result in place of the output):

- ``SDFS_SPLIT`` in ``csrc/post_interp.cu``: 1 forms the row-pair
  combinations G, 2 adds the gathers and V, 3 the power and exp-sum;
- ``SDFS_PAIR_SPLIT`` in ``csrc/streamed_two_phase.cu`` (pass C pair): 1
  the slice maxima, 2 the exponentials with the z_pi' sum, 3 the z'
  product;
- ``SDFS_DEFB_SPLIT`` in the same source (deferred pass B): 1 the fold
  and the column maxima, 2 the exponentials, 3 the c1 product;
- ``SDFS_PASSC_DEF_SPLIT`` in the same source (deferred and batched pass
  C): 1 the shifts (the scales in fast mode; in the slab kernel, whose
  shifts are running maxima, the streamed pass with its exponentials and
  no product), 2 the c2 product, 3 the carries and the r1 contraction;
- ``SDFS_FUSED_SPLIT`` in ``csrc/fused_two_matmul.cu``: 1 runs phase 1
  and its barrier per iteration, 2 adds phase 2; and
  ``SDFS_FUSED_BARRIER=1``, the whole loop with every grid barrier a bare
  ``__syncthreads`` (wrong results; it times the barriers);
- ``SDFS_STRIP_SPLIT`` in ``csrc/tiled_two_phase.cu`` (the column phase,
  ``sdfs_strip_col``): 1 the first shift pass, 2 adds the c1
  contraction, 3 the c2 shift (lse; in fast mode 3 times what 2 does);
- ``SDFS_STRIP_ROW_SPLIT`` in the same source (the row phase,
  ``sdfs_strip_row``): 1 the load of the midway tile (fast: with the row
  scales), 2 adds the lse shift and exp, 3 the r1 contraction, 4 the r2
  shift and exp, 5 r2 without the epilogue;
- ``SDFS_PASSB_SPLIT`` in ``csrc/streamed_two_phase.cu`` (pass B with a
  shared c2, and its c1-only branch): 1 the load, fold, shift and exp, 2
  adds c1 (with mid_col, the lse shift and exp of its result), 3 the c2
  product without the epilogue's log; and ``noproducts``
  (``-DSDFS_DEFB_SPLIT=2``: the c2 product's copies and splits alone);
- ``SDFS_PASSC_SPLIT`` in the same source (pass C with a shared c2): 1
  the load and scale (lse: with the shifts and exp), 2 adds r1, 3 r2
  without the epilogue.

The script builds every variant with nvcc (one process each, all
started together) and times each at the main paths' shapes with CUDA
events: the median of 3 runs of N launches (the fused SA and Anderson
loops: launches of a fixed count of iterations at tol -1, reported per
iteration).  Differences of consecutive stops are the phases' times.

``--before DIR`` names a directory holding an earlier design's sources
(``post_interp.cu``, ``streamed_two_phase.cu``, ``fused_two_matmul.cu``,
``tiled_two_phase.cu``, the same C entry points) with the same switches:
its splits are timed too, and the whole kernels in turns (before, after,
after, before).
Prints one line per measurement and a last JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import sdfs_via_autodiff_tpu_torch as port
from sdfs_via_autodiff_tpu_torch import drivers
from sdfs_via_autodiff_tpu_torch.kernels import _build
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st
from sdfs_via_autodiff_tpu_torch.kernels import tiled_two_phase as tt

POST_SIZES = ((20, 20, 20, 20), (15, 15, 15, 15))
PAIR_SIZES = ((16, 8, 12, 12, 128, 8), (8, 8, 8, 8, 128, 8))
# Deferred pass B: the 18.9M continuous-GCY view (8,16,144,1024) with its
# coarse-baseline fold, and the 25.2M GCY Tauchen view (12,16,512,256)
# without and with a (synthetic) fold.
DEFB_GCYC = (16, 8, 12, 12, 128, 8)
DEFB_GCY = (32, 16, 16, 12, 16, 16)
# Deferred pass C at the 25.2M GCY Tauchen view (12,16,512,256); batched
# pass C at the 11.2M continuous-SSY cell (56,56,56,64), fast without a
# baseline and lse with the log-linear fold (the two tiled solves' modes).
DEFC_GCY = DEFB_GCY
DEFC_SSYC = (56, 56, 56, 64)
# The fused kernels: continuous SSY 20^4 and continuous GCY 6^6 (coarse
# baseline); loops of FUSED_ITERS iterations at tol -1.
FUSED_SSY, FUSED_GCY, FUSED_ITERS = (20, 20, 20, 20), (6,) * 6, 200
# The strip column phase: the normalized SSY Tauchen cell (32,32,32,384)
# in lse mode (c1 dense-batched, c2 lazy rank 1) and the plain one in
# fast mode (shared factors); the 25.2M GCY Tauchen view (192, 512, 256)
# normalized (rank-2 lazy) and plain, lse.
STRIP_SSY, STRIP_GCY = (32, 32, 32, 384), (32, 16, 16, 12, 16, 16)
# The strip row phase: the normalized SSY cell in lse mode, the plain one
# in fast mode, the GCY view (L, K, C) = (12, 16, 131072) in lse mode, and
# a plain SSY Tauchen set the streamed tier declines whose row phase runs
# the narrow layout (R = 6,144), in fast mode.
STRIP_NARROW = (128, 48, 64, 512)
# Pass B with a shared c2 and pass C (the full configuration): the plain
# SSY Tauchen cell (32,32,32,384) fast, the normalized set (a) at the cell
# (conjugated-shared, lse with the fold), the mid_col set (e) (the same
# set with a seeded mid_col of scale 0.05) and pass B's c1-only branch at
# the continuous-SSY cell (56,56,56,64), fast and lse with the log-linear
# fold.
PASSB_SSY, PASSB_C1 = (32, 32, 32, 384), (56, 56, 56, 64)
# kernel: (source stem, switch, the stops before the whole kernel).
SPLITS = {"post_interp": ("post_interp", "SDFS_SPLIT", (1, 2, 3)),
          "pass_c_pair": ("streamed_two_phase", "SDFS_PAIR_SPLIT", (1, 2, 3)),
          "pass_b_deferred": ("streamed_two_phase", "SDFS_DEFB_SPLIT",
                              (1, 2, 3)),
          "pass_c_deferred": ("streamed_two_phase", "SDFS_PASSC_DEF_SPLIT",
                              (1, 2, 3)),
          "fused": ("fused_two_matmul", "SDFS_FUSED_SPLIT", (1, 2)),
          "strip_col": ("tiled_two_phase", "SDFS_STRIP_SPLIT", (1, 2, 3)),
          "strip_row": ("tiled_two_phase", "SDFS_STRIP_ROW_SPLIT",
                        (1, 2, 3, 4, 5)),
          "pass_b": ("streamed_two_phase", "SDFS_PASSB_SPLIT", (1, 2, 3)),
          "pass_c": ("streamed_two_phase", "SDFS_PASSC_SPLIT", (1, 2, 3))}
# Variants beside the stops: name -> (source stem, nvcc define).
EXTRA = {"fused": {"nobarrier": ("fused_two_matmul",
                                 "-DSDFS_FUSED_BARRIER=1")},
         "pass_b": {"noproducts": ("streamed_two_phase",
                                   "-DSDFS_DEFB_SPLIT=2")}}
OUT_DIR = _build.BUILD_DIR / "split"


def _variants(kernels):
    """(source stem, variant name, nvcc defines) of every build the
    kernels need: each source whole once, then each stop and extra."""
    out = {}
    for k in kernels:
        stem, switch, stops = SPLITS[k]
        out[(stem, "whole")] = ()
        for stop in stops:
            out[(stem, f"{switch}={stop}")] = (f"-D{switch}={stop}",)
        for name, (xstem, define) in EXTRA.get(k, {}).items():
            out[(xstem, name)] = (define,)
    return out


def _compile(src: Path, tag: str, name: str, defines) -> Path:
    out = OUT_DIR / f"{src.stem}-{tag}-{name.replace('=', '')}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(out),
         str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} {tag} {name}:\n{proc.stderr}")
    if name == "whole":
        keep = ("post_gather", "pass_c_pair", "pass_b_", "pass_c_kernel",
                "pass_c_deferred", "pass_c_slab", "fused_", "strip_")
        lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()]
        for k, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(x in ln for x in keep):
                print(f"ptxas {tag} {src.stem}: " + " | ".join(lines[k:k + 4]))
    return out


def _typed(lib):
    """The library with its entry points typed (ctypes)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    for name, args in (
            ("sdfs_post_interp", [p] * 15 + [i] * 5 + [f, f, i, p]),
            ("sdfs_pass_c_pair", [p] * 8 + [i] * 6 + [f, f, p]),
            ("sdfs_fused_solve", [i] + [p] * 10 + [i, i, f, f, f, i, i, i,
                                                   f, f, p]),
            ("sdfs_strip_col", [p, p, p, f] + [p, ll, p, p, p, i] * 2
             + [p] * 3 + [i] * 4 + [p])):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, i
    if hasattr(lib, "sdfs_pass_b_deferred"):
        # The tensor-core layout's entry takes a workspace.
        n = 6 if hasattr(lib, "sdfs_pass_b_deferred_work_floats") else 5
        lib.sdfs_pass_b_deferred.argtypes = [p] * n + [i] * 3 + [f, p]
        lib.sdfs_pass_b_deferred.restype = i
    if hasattr(lib, "sdfs_fused_work_floats"):
        lib.sdfs_fused_work_floats.argtypes = [i] * 4
        lib.sdfs_fused_work_floats.restype = ll
    if hasattr(lib, "sdfs_strip_col_work_floats"):
        lib.sdfs_strip_col_work_floats.argtypes = [i] * 3
        lib.sdfs_strip_col_work_floats.restype = ll
    return lib


def _ms(fn, n: int, runs: int = 3) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _cast(dev):
    return lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)


def _post_calls(sizes, interp, dev):
    """(caller, out, plain) of one application: the caller takes the
    library and returns a launcher writing into ``out``."""
    model = port.SSY()
    grids = port.build_grid_ssy(model, *sizes)
    T = pk.make_post_interp_kernel_T_ssy(model, grids, 5, interp, device=dev)
    rng = np.random.default_rng(0)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(sizes),
                          device=dev, dtype=torch.float32)
    field, corners, pay, off, s, lk_row, lk_col, th, be, _ = T.kernel_args(ell)
    n_l, n_k, n_i, n_j = sizes
    out = torch.empty_like(field)
    post = int(interp == "post")
    stream = _stream(dev)
    # The launchers hold the tensors (not only their addresses), so that
    # none is freed and reused while they run.
    small = (pay, off, s, lk_row, lk_col)

    def call(lib):
        return lambda: lib.sdfs_post_interp(
            _ptr(field), *(_ptr(t) for t in corners),
            *(_ptr(t) for t in small), _ptr(out), n_l, n_k, n_i, n_j, 5, th,
            be, post, stream)

    plain = pk.post_interp_gather_plain(*T.kernel_args(ell))
    return call, out, plain


_BASELINES = {}


def _coarse(model, sizes, dev):
    """The coarse additive baseline of a continuous-GCY grid (cached)."""
    if sizes not in _BASELINES:
        _BASELINES[sizes] = drivers._coarse_additive_baseline(
            model, sizes, num_std_devs=3.2, quad_degree=5,
            dtype=torch.float64, device=dev)
    return _BASELINES[sizes]


def _pair_ops(sizes, dev):
    model = port.GCY()
    grids = port.build_grid_gcy(model, *sizes)
    ops = port.two_phase_operands_gcy_continuous(model, grids, 5,
                                                 _coarse(model, sizes, dev))
    cast = _cast(dev)
    rng = np.random.default_rng(0)
    L, K, I, J = ops.shapes
    ell = cast(ops.baseline_log_w + 0.05 * rng.standard_normal(
        ops.shapes)).reshape(L * K, I, J)
    b_args = (cast(np.asarray(ops.W_c1).T),
              cast(np.asarray(ops.sub_row).reshape(L * K)),
              cast(ops.sub_col))
    return ops, ell, b_args


def _pair_calls(sizes, dev):
    ops, ell, (w_c1t, sub_row, sub_col) = _pair_ops(sizes, dev)
    L, K, I, J = ops.shapes
    n_i, n_y, n_b, n_j = ops.pair_shapes
    R, C = L * K, I * J
    cast = _cast(dev)
    mid = st.pass_b_deferred_plain(ell, w_c1t, float(ops.theta), sub_row,
                                   sub_col).reshape(R, C).contiguous()
    P_zpi, PzT = st.pair_device_operands(ops, device=dev)
    args = (mid, P_zpi, PzT, cast(ops.W_r1), cast(ops.W_r2),
            cast(ops.add_row), cast(ops.add_col.reshape(C)))
    out = torch.empty_like(mid)
    th, be = float(ops.theta), float(ops.beta)
    stream = _stream(dev)

    def call(lib):
        return lambda: lib.sdfs_pass_c_pair(
            *(_ptr(t) for t in args), _ptr(out), L, K, n_i, n_y, n_b, n_j, th,
            be, stream)

    plain = st.pass_c_pair_plain(*args, th, be)
    return call, out, plain, f"{sizes} view {tuple(ops.shapes)}"


def _defb_sets(dev):
    """(label, ell, w_c1t, theta, sub_row, sub_col) of the deferred pass B
    timings."""
    ops, ell, (w_c1t, sub_row, sub_col) = _pair_ops(DEFB_GCYC, dev)
    yield (f"{DEFB_GCYC} view {tuple(ops.shapes)} coarse fold", ell, w_c1t,
           float(ops.theta), sub_row, sub_col)
    del ops, ell, w_c1t, sub_row, sub_col
    model = port.GCY()
    ops = port.two_phase_operands_gcy(
        model, port.discretize_gcy(model, DEFB_GCY, method="tauchen"))
    L, K, I, J = ops.shapes
    cast = _cast(dev)
    rng = np.random.default_rng(0)
    th = float(ops.theta)
    ell = cast(np.log(800.0) + 0.05 * rng.standard_normal((L * K, I, J)))
    w_c1t = cast(np.asarray(ops.W_c1).T)
    view = f"{DEFB_GCY} view {tuple(ops.shapes)}"
    yield view, ell, w_c1t, th, None, None
    # A synthetic fold of the normalized cell's size: a row baseline near
    # theta * log(800) and a small column profile.
    sub_row = cast(th * np.log(800.0) + 0.1 * rng.standard_normal(L * K))
    sub_col = cast(0.05 * rng.standard_normal((I, J)))
    yield f"{view} synthetic fold", ell, w_c1t, th, sub_row, sub_col


def _defb_calls(ell, w_c1t, th, sub_row, sub_col, dev):
    """Caller of one deferred pass-B launch; a library with
    ``sdfs_pass_b_deferred_work_floats`` also takes its workspace."""
    R, I, J = ell.shape
    out = torch.empty_like(ell)
    stream = _stream(dev)

    def call(lib):
        work = ()
        if hasattr(lib, "sdfs_pass_b_deferred_work_floats"):
            fn = lib.sdfs_pass_b_deferred_work_floats
            fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
            n = int(fn(R, I, J))
            work = (torch.empty((n,), dtype=torch.float32, device=dev)
                    if n else None,)
        go = lambda: lib.sdfs_pass_b_deferred(
            _ptr(ell), _ptr(w_c1t), _ptr(sub_row), _ptr(sub_col),
            *(_ptr(t) for t in work), _ptr(out), R, I, J, th, stream)
        go.work = work
        return go

    plain = st.pass_b_deferred_plain(ell, w_c1t, th, sub_row, sub_col)
    return call, out, plain


def _defc_sets(dev):
    """(label, args, batched, mode) of the pass-C timings: args = (mid,
    scale, S, w_c2t, W_r1, W_r2, add_row, add_col, theta, beta)."""
    cast = _cast(dev)
    model = port.GCY()
    ops = port.two_phase_operands_gcy(
        model, port.discretize_gcy(model, DEFC_GCY, method="tauchen"))
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    rng = np.random.default_rng(0)
    ell = cast(np.log(800.0) + 0.05 * rng.standard_normal((R, I, J)))
    th, be = float(ops.theta), float(ops.beta)
    mid = st.pass_b_deferred_plain(ell, cast(np.asarray(ops.W_c1).T),
                                   th).reshape(R, C).contiguous()
    del ell
    yield (f"{DEFC_GCY} view {tuple(ops.shapes)}",
           (mid, None, None, cast(np.asarray(ops.W_c2).T), cast(ops.W_r1),
            cast(ops.W_r2), cast(ops.add_row), cast(ops.add_col.reshape(C)),
            th, be), False, "lse")
    del mid
    model = port.SSY()
    grids = port.build_grid_ssy(model, *DEFC_SSYC)
    ll = port.ssy_loglinear_factory(model)
    x = port.ops.grids.flatten_mesh([g.cpu() for g in grids]).numpy()
    ell0 = ll(x.T).reshape(DEFC_SSYC)
    L, K, I, J = DEFC_SSYC
    R, C = L * K, I * J
    for baseline, mode in ((None, "fast"), ("loglinear", "lse")):
        ops = port.two_phase_operands_ssy_continuous(model, grids, 5,
                                                     baseline)
        ell = cast(ell0 + 0.02 * rng.standard_normal(DEFC_SSYC)).reshape(
            R, I, J)
        sub = ((cast(np.asarray(ops.sub_row).reshape(R)), cast(ops.sub_col))
               if ops.has_sub else (None, None))
        th, be = float(ops.theta), float(ops.beta)
        b = st.pass_b_plain(ell, cast(ops.W_c1), None, th, mode, *sub)
        scale = S = None
        if mode == "fast":
            b, s = b
            S = s.max().reshape(1)
            scale = torch.exp(s - S)
        del ell
        yield (f"{DEFC_SSYC} batched {mode}"
               + (f" {baseline} fold" if baseline else ""),
               (b.reshape(R, C).contiguous(), scale, S,
                cast(np.swapaxes(ops.W_c2, 1, 2)), cast(ops.W_r1),
                cast(ops.W_r2), cast(ops.add_row),
                cast(np.asarray(ops.add_col).reshape(C)), th, be), True, mode)
        del b


def _defc_calls(args, batched, mode, dev):
    """Caller of one deferred or batched pass-C launch.  A library with
    ``sdfs_pass_c_deferred_layout`` picks its own layout; an earlier one
    takes the (TC, JK) tiles of :func:`st.pass_c_deferred_tiles`."""
    mid, scale, S, w_c2t, W_r1, W_r2, add_row, add_col, th, be = args
    L, K = W_r1.shape[0], W_r2.shape[0]
    J = w_c2t.shape[-1]
    I = mid.shape[1] // J
    out = torch.empty_like(mid)
    stream = _stream(dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(lib):
        tiles = () if hasattr(lib, "sdfs_pass_c_deferred_layout") else \
            st.pass_c_deferred_tiles(L, K)
        n = 4 + len(tiles)
        if batched:
            fn = lib.sdfs_pass_c_batched
            fn.argtypes, fn.restype = [p] * 9 + [i] * n + [f, f, i, p], i
            return lambda: fn(
                _ptr(mid), _ptr(scale), _ptr(S), _ptr(w_c2t), _ptr(W_r1),
                _ptr(W_r2), _ptr(add_row), _ptr(add_col), _ptr(out), L, K, I,
                J, *tiles, th, be, st._MODES[mode], stream)
        fn = lib.sdfs_pass_c_deferred
        fn.argtypes, fn.restype = [p] * 7 + [i] * n + [f, f, p], i
        return lambda: fn(
            _ptr(mid), _ptr(w_c2t), _ptr(W_r1), _ptr(W_r2), _ptr(add_row),
            _ptr(add_col), _ptr(out), L, K, I, J, *tiles, th, be, stream)

    plain = st.pass_c_batched_plain(mid, scale, S, w_c2t, W_r1, W_r2,
                                    add_row, add_col, th, be, mode)
    return call, out, plain


def _fused_sets(dev):
    """(label, model, (M1, M2T, kap, sub), ell0) of the fused timings:
    continuous SSY 20^4 from w = 1, continuous GCY 6^6 (coarse baseline)
    from its baseline."""
    cast = _cast(dev)
    ssy = port.SSY()
    grids = port.build_grid_ssy(ssy, *FUSED_SSY, dtype=torch.float32)
    M1, M2T, kap = (cast(a.numpy()) for a in fd.kron_operands_ssy_continuous(
        ssy, grids, 5, torch.float64))
    yield (f"continuous SSY {FUSED_SSY}", ssy, (M1, M2T, kap, None),
           torch.zeros_like(kap))
    gcy = port.GCY()
    grids = port.build_grid_gcy(gcy, *FUSED_GCY, dtype=torch.float32)
    M1, M2T, kap, _, _, _, sub = fd.kron_operands_gcy_continuous(
        gcy, grids, 5, _coarse(gcy, FUSED_GCY, dev), torch.float64)
    ops = tuple(cast(a.numpy()) for a in (M1, M2T, kap, sub))
    yield (f"continuous GCY {FUSED_GCY} coarse fold", gcy, ops,
           (ops[3] / gcy.theta).contiguous())


def _fused_calls(model, ops, ell0, algo, iters, dev):
    """Caller of one launch of ``sdfs_fused_solve`` in mode ``algo`` (0
    apply, 1 SA, 2 Anderson with m = 5, mixing every 2nd step) at tol -1
    and ``iters`` iterations; the scratch is sized by each library."""
    M1, M2T, kap, sub = ops
    R, C = kap.shape
    out = torch.empty_like(kap)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.float32, device=dev)
    stream = _stream(dev)
    m, mix, beta_aa, ridge = (5, 2, 1.0, 1e-6) if algo == 2 else (1, 1, 1.0,
                                                                   0.0)

    def call(lib):
        work = torch.empty(int(lib.sdfs_fused_work_floats(algo, R, C, m)),
                           dtype=torch.float32, device=dev)

        def go():
            sync.zero_()
            return lib.sdfs_fused_solve(
                algo, _ptr(ell0), _ptr(M1), _ptr(M2T), _ptr(kap), _ptr(sub),
                _ptr(out), _ptr(work), _ptr(sync), _ptr(it), _ptr(err), R, C,
                float(model.theta), float(model.beta), -1.0, iters, m, mix,
                beta_aa, ridge, stream)
        go.work = work
        return go

    if algo == 0:
        plain = fd.fused_T_plain(ell0, M1, M2T, kap, sub, model.theta,
                                 model.beta)
    elif algo == 1:
        from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk
        plain = sk.fused_sa_plain(ell0, M1, M2T, kap, sub, model.theta,
                                  model.beta, -1.0, iters)[0]
    else:
        from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
        plain = ak.fused_anderson_plain(ell0, M1, M2T, kap, sub, model.theta,
                                        model.beta, -1.0, iters, history=m,
                                        mixing_frequency=mix)[0]
    return call, out, plain


def _strip_sets(dev):
    """(label, ell, col_args) of the strip column-phase timings: col_args
    = (W_c1, W_c2, theta, mode, sub_row, sub_col) as
    :func:`tt.strip_col` takes them."""
    cast = _cast(dev)
    for name, sizes, baseline, mode in (
            ("SSY", STRIP_SSY, "loglinear", "lse"),
            ("SSY", STRIP_SSY, None, "fast"),
            ("GCY", STRIP_GCY, "loglinear", "lse"),
            ("GCY", STRIP_GCY, None, "lse")):
        if name == "SSY":
            model = port.SSY()
            ops = port.two_phase_operands_ssy(
                model, port.discretize_ssy(model, sizes, method="tauchen"),
                baseline)
        else:
            # dense=False: the normalized set's batched factors run in
            # their lazy form, so the dense ones are not built.
            model = port.GCY()
            ops = port.two_phase_operands_gcy(
                model, port.discretize_gcy(model, sizes, method="tauchen"),
                baseline, dense=False)
        d = tt.strip_device_operands(ops, device=dev)
        L, K, n1, n2 = ops.shapes
        rng = np.random.default_rng(0)
        base = (np.log(800.0) if ops.baseline_log_w is None
                else ops.baseline_log_w)
        ell = cast(base + 0.02 * rng.standard_normal(ops.shapes)).reshape(
            L * K, n1, n2)
        lazy = [isinstance(d[w], tuple) for w in ("W_c1", "W_c2")]
        if ops.dense_placeholder and not all(lazy):
            raise RuntimeError(f"{name} {sizes}: a placeholder factor")
        yield (f"{name} {sizes} view {tuple(ops.shapes)} {baseline} {mode} "
               f"lazy {lazy}", ell,
               (d["W_c1"], d["W_c2"], float(ops.theta), mode, d["sub_row"],
                d["sub_col"]))
        del ops, d


def _strip_calls(ell, col_args, dev):
    """Caller of one ``sdfs_strip_col`` launch (the whole column phase;
    scratch sized by each library)."""
    W_c1, W_c2, th, mode, sub_row, sub_col = col_args
    R, n1, n2 = ell.shape
    out = torch.empty_like(ell)
    s = torch.empty(R, dtype=torch.float32, device=dev)
    stream = _stream(dev)

    def factor(W):
        if isinstance(W, tuple):
            return (None, 0, *W, W[1].shape[0])
        return W, 0 if W.dim() == 2 else W.shape[1] * W.shape[2], None, \
            None, None, 0

    f1, f2 = factor(W_c1), factor(W_c2)

    def call(lib):
        work = torch.empty(int(lib.sdfs_strip_col_work_floats(R, n1, n2)),
                           dtype=torch.float32, device=dev)

        def go():
            return lib.sdfs_strip_col(
                _ptr(ell), _ptr(sub_row), _ptr(sub_col), th,
                _ptr(f1[0]), f1[1], *(_ptr(t) for t in f1[2:5]), f1[5],
                _ptr(f2[0]), f2[1], *(_ptr(t) for t in f2[2:5]), f2[5],
                _ptr(out), _ptr(s), _ptr(work), R, n1, n2,
                tt._MODES[mode], stream)
        go.work = work
        return go

    plain = tt.strip_col_plain(ell, *col_args)
    return call, out, plain[0] if mode == "fast" else plain


def _row_sets(dev):
    """(label, mid, row_args) of the strip row-phase timings: row_args =
    (scale, S, W_r1, W_r2, add_row, add_col, theta, beta, mode) as
    :func:`tt.strip_row` takes them; mid is the plain column phase of a
    seeded field."""
    cast = _cast(dev)
    for name, sizes, baseline, mode in (
            ("SSY", STRIP_SSY, "loglinear", "lse"),
            ("SSY", STRIP_SSY, None, "fast"),
            ("GCY", STRIP_GCY, None, "lse"),
            ("SSY", STRIP_NARROW, None, "fast")):
        if name == "SSY":
            model = port.SSY()
            ops = port.two_phase_operands_ssy(
                model, port.discretize_ssy(model, sizes, method="tauchen"),
                baseline)
        else:
            model = port.GCY()
            ops = port.two_phase_operands_gcy(
                model, port.discretize_gcy(model, sizes, method="tauchen"),
                baseline)
        d = tt.strip_device_operands(ops, device=dev)
        L, K, n1, n2 = ops.shapes
        R, C = L * K, n1 * n2
        rng = np.random.default_rng(0)
        base = (np.log(800.0) if ops.baseline_log_w is None
                else ops.baseline_log_w)
        ell = cast(base + 0.02 * rng.standard_normal(ops.shapes)).reshape(
            R, n1, n2)
        th, be = float(ops.theta), float(ops.beta)
        got = tt.strip_col_plain(ell, d["W_c1"], d["W_c2"], th, mode,
                                 d["sub_row"], d["sub_col"])
        scale = S = None
        if mode == "fast":
            got, s = got
            S = s.max().reshape(1)
            scale = torch.exp(s - S)
        del ell
        yield (f"{name} {sizes} (L, K, C) = {(L, K, C)} {baseline} {mode}",
               got.reshape(R, C).contiguous(),
               (scale, S, d["W_r1"], d["W_r2"], d["add_row"], d["add_col"],
                th, be, mode))
        del ops, d, got


def _row_tile_v1(L: int, K: int) -> int:
    """Columns per block of the first row-phase kernel, which
    takes them as an argument: the widest of 64, 32, ..., 1 whose x and y
    tiles and shifts leave room for two blocks per SM, else fit one."""
    for limit in (st._SM_SMEM // 2 - st._BLOCK_RESERVED, st.SMEM_LIMIT):
        for tc in (64, 32, 16, 8, 4, 2, 1):
            if 4 * tc * (2 * L * K + K + L) <= limit:
                return tc
    raise ValueError(f"no row tile fits ({L}, {K})")


def _row_calls(mid, row_args, dev):
    """Caller of one ``sdfs_strip_row`` launch.  A library with
    ``sdfs_strip_row_layout`` picks its own tile; an earlier one takes
    :func:`_row_tile_v1`'s."""
    scale, S, W_r1, W_r2, add_row, add_col, th, be, mode = row_args
    L, K = W_r1.shape[0], W_r2.shape[0]
    R, C = mid.shape
    out = torch.empty_like(mid)
    stream = _stream(dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(lib):
        tiles = () if hasattr(lib, "sdfs_strip_row_layout") else (
            _row_tile_v1(L, K),)
        fn = lib.sdfs_strip_row
        fn.argtypes, fn.restype = [p] * 8 + [i] * (3 + len(tiles)) + [
            f, f, i, p], i
        return lambda: fn(
            _ptr(mid), _ptr(scale), _ptr(S), _ptr(W_r1), _ptr(W_r2),
            _ptr(add_row), _ptr(add_col), _ptr(out), L, K, C, *tiles, th, be,
            tt._MODES[mode], stream)

    plain = tt.strip_row_plain(mid, *row_args)
    return call, out, plain


def _passb_sets(dev):
    """(label, ell, b_args, c_args) of the pass-B and pass-C timings:
    b_args = (W_c1, W_c2t, theta, mode, sub_row, sub_col, mid_col) as
    :func:`st.pass_b` takes them; c_args = (scale, S, W_r1, W_r2,
    add_row, add_col, theta, beta, mode) for pass C on the plain pass B's
    result, or None (c1 only)."""
    import dataclasses
    cast = _cast(dev)
    model = port.SSY()
    disc = port.discretize_ssy(model, PASSB_SSY, method="tauchen")
    L, K, I, J = PASSB_SSY
    R = L * K
    plain = port.two_phase_operands_ssy(model, disc)
    conj = st.streamed_coverable(port.two_phase_operands_ssy(
        model, disc, "loglinear"))
    mid = dataclasses.replace(conj, mid_col=0.05 * np.random.default_rng(
        1).standard_normal(PASSB_SSY[2:]))
    for label, ops, mode in (("SSY cell fast", plain, "fast"),
                             ("normalized SSY (a) lse fold", conj, "lse"),
                             ("mid_col set (e) lse fold", mid, "lse")):
        rng = np.random.default_rng(0)
        base = (np.log(800.0) if ops.baseline_log_w is None
                else ops.baseline_log_w)
        ell = cast(base + 0.02 * rng.standard_normal(PASSB_SSY)).reshape(
            R, I, J)
        sub = ((cast(np.asarray(ops.sub_row).reshape(R)), cast(ops.sub_col))
               if ops.has_sub else (None, None))
        th, be = float(ops.theta), float(ops.beta)
        b_args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T), th, mode,
                  *sub, cast(ops.mid_col) if ops.has_mid else None)
        c_args = None
        if not ops.has_mid:
            b = st.pass_b_plain(ell, *b_args)
            scale = S = None
            if mode == "fast":
                b, s = b
                S = s.max().reshape(1)
                scale = torch.exp(s - S)
            c_args = (b.reshape(R, I * J).contiguous(), scale, S,
                      cast(ops.W_r1), cast(ops.W_r2), cast(ops.add_row),
                      cast(np.asarray(ops.add_col).reshape(I * J)), th, be,
                      mode)
        yield f"{PASSB_SSY} {label}", ell, b_args, c_args
    grids = port.build_grid_ssy(model, *PASSB_C1)
    L, K, I, J = PASSB_C1
    R = L * K
    x = port.ops.grids.flatten_mesh([g.cpu() for g in grids]).numpy()
    ell0 = port.ssy_loglinear_factory(model)(x.T).reshape(PASSB_C1)
    rng = np.random.default_rng(0)
    for baseline, mode in ((None, "fast"), ("loglinear", "lse")):
        ops = port.two_phase_operands_ssy_continuous(model, grids, 5,
                                                     baseline)
        ell = cast(ell0 + 0.02 * rng.standard_normal(PASSB_C1)).reshape(
            R, I, J)
        sub = ((cast(np.asarray(ops.sub_row).reshape(R)), cast(ops.sub_col))
               if ops.has_sub else (None, None))
        yield (f"{PASSB_C1} c1 only {mode}" + (" fold" if baseline else ""),
               ell, (cast(ops.W_c1), None, float(ops.theta), mode, *sub,
                     None), None)


def _passb_calls(ell, b_args, dev):
    """Caller of one ``sdfs_pass_b`` launch; a library with
    ``sdfs_pass_b_work_floats`` also takes its workspace."""
    W_c1, W_c2t, th, mode, sub_row, sub_col, mid_col = b_args
    R, I, J = ell.shape
    out = torch.empty_like(ell)
    s = torch.empty((R, 1), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(lib):
        fn = lib.sdfs_pass_b
        work = ()
        if hasattr(lib, "sdfs_pass_b_work_floats"):
            wf = lib.sdfs_pass_b_work_floats
            wf.argtypes, wf.restype = [i] * 4, ctypes.c_longlong
            n = int(wf(R, I, J, int(W_c2t is not None)))
            work = (torch.empty((n,), dtype=torch.float32, device=dev)
                    if n else None,)
        fn.argtypes, fn.restype = [p] * (8 + len(work)) + [i] * 3 + [f, i,
                                                                      p], i
        go = lambda: fn(_ptr(ell), _ptr(W_c1), _ptr(W_c2t), _ptr(sub_row),
                        _ptr(sub_col), _ptr(mid_col), _ptr(out), _ptr(s),
                        *(_ptr(t) for t in work), R, I, J, th,
                        st._MODES[mode], stream)
        go.work = work
        return go

    plain = st.pass_b_plain(ell, *b_args)
    return call, out, plain[0] if mode == "fast" else plain


def _passc_calls(c_args, dev):
    """Caller of one shared-c2 pass-C launch: ``sdfs_pass_c`` (the first
    kernel, which takes its column tile :func:`st.pass_c_tile`) or
    ``sdfs_pass_c_row`` (the row-phase kernel)."""
    mid, scale, S, W_r1, W_r2, add_row, add_col, th, be, mode = c_args
    L, K = W_r1.shape[0], W_r2.shape[0]
    R, C = mid.shape
    out = torch.empty_like(mid)
    stream = _stream(dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(lib):
        if hasattr(lib, "sdfs_pass_c_row"):
            fn, tiles = lib.sdfs_pass_c_row, ()
        else:
            fn, tiles = lib.sdfs_pass_c, (st.pass_c_tile(R, K),)
        fn.argtypes, fn.restype = [p] * 8 + [i] * (3 + len(tiles)) + [
            f, f, i, p], i
        return lambda: fn(
            _ptr(mid), _ptr(scale), _ptr(S), _ptr(W_r1), _ptr(W_r2),
            _ptr(add_row), _ptr(add_col), _ptr(out), L, K, C, *tiles, th, be,
            st._MODES[mode], stream)

    plain = st.pass_c_plain(*c_args)
    return call, out, plain


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="directory with an earlier design's post_interp.cu, "
                         "streamed_two_phase.cu, fused_two_matmul.cu and "
                         "tiled_two_phase.cu (with the switches) and "
                         "occupancy.cuh")
    ap.add_argument("--kernels", default=",".join(SPLITS),
                    help="comma-separated subset of " + ", ".join(SPLITS))
    a = ap.parse_args()
    kernels = [k for k in a.kernels.split(",") if k]
    unknown = [k for k in kernels if k not in SPLITS]
    if unknown:
        sys.exit(f"kernel_split: unknown kernels {unknown}")
    if not torch.cuda.is_available():
        sys.exit("kernel_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(f"device: {smi}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tags = ("after",) + (("before",) if a.before is not None else ())
    src_dir = {"after": _build.CSRC_DIR, "before": a.before}
    jobs = [(src_dir[tag] / f"{stem}.cu", tag, name, defines)
            for tag in tags
            for (stem, name), defines in _variants(kernels).items()]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: _compile(*j), jobs))
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {(j[0].stem, j[1], j[2]): _typed(ctypes.CDLL(str(p)))
            for j, p in zip(jobs, paths)}
    results = []

    def measure(kernel, label, call, out, plain, n, per=1):
        """Whole kernels in turns, then each variant's cumulative time;
        ``per`` divides a launch's time (iterations per launch)."""
        stem, switch, stops = SPLITS[kernel]
        names = ([f"{switch}={k}" for k in stops] + ["whole"]
                 + list(EXTRA.get(kernel, {})))
        row = {"kernel": kernel, "set": label, "per": per}
        for tag in tags:
            rc = call(libs[(stem, tag, "whole")])()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{kernel} {tag} {label}: error {rc}")
            row[f"{tag}_err_vs_plain"] = float((out - plain).abs().max())
        order = ("before", "after", "after", "before") if len(tags) == 2 \
            else ("after", "after")
        full = {t: [] for t in tags}
        for tag in order:
            full[tag].append(_ms(call(libs[(stem, tag, "whole")]), n) / per)
        for tag in tags:
            row[f"{tag}_ms"] = full[tag]
            row[f"{tag}_variants_ms"] = {
                v: _ms(call(libs[(stem, tag, v)]), n) / per for v in names}
        unit = "ms" if per == 1 else f"ms per iteration ({per} per launch)"
        print(f"{kernel} {label}: " + "; ".join(
            f"{t}: whole {', '.join(f'{x:.5f}' for x in row[f'{t}_ms'])} "
            f"{unit}; variants " + ", ".join(
                f"{v} {x:.5f}" for v, x in row[f"{t}_variants_ms"].items())
            + f"; max abs err vs plain {row[f'{t}_err_vs_plain']:.3e}"
            for t in tags) + f" ({smi})", flush=True)
        results.append(row)

    if "post_interp" in kernels:
        for sizes in POST_SIZES:
            for interp in ("post", "loglin"):
                call, out, plain = _post_calls(sizes, interp, dev)
                measure("post_interp", f"{sizes} {interp}", call, out, plain,
                        20)
                del call, out, plain
                torch.cuda.empty_cache()
    if "pass_c_pair" in kernels:
        for sizes in PAIR_SIZES:
            call, out, plain, label = _pair_calls(sizes, dev)
            measure("pass_c_pair", label, call, out, plain, 50)
            del call, out, plain
            torch.cuda.empty_cache()
    if "pass_b_deferred" in kernels:
        for label, *args in _defb_sets(dev):
            call, out, plain = _defb_calls(*args, dev)
            measure("pass_b_deferred", label, call, out, plain, 50)
            del call, out, plain, args
            torch.cuda.empty_cache()
    if "pass_c_deferred" in kernels:
        for label, args, batched, mode in _defc_sets(dev):
            call, out, plain = _defc_calls(args, batched, mode, dev)
            measure("pass_c_deferred", label, call, out, plain, 50)
            del call, out, plain, args
            torch.cuda.empty_cache()
    if "fused" in kernels:
        for label, model, ops, ell0 in _fused_sets(dev):
            for algo, what, iters, n in ((1, "SA", FUSED_ITERS, 5),
                                         (0, "apply", 1, 50),
                                         (2, "Anderson", FUSED_ITERS, 5)):
                call, out, plain = _fused_calls(model, ops, ell0, algo,
                                                iters, dev)
                measure("fused", f"{label} {what}", call, out, plain, n,
                        per=iters)
                del call, out, plain
            torch.cuda.empty_cache()
    if "strip_col" in kernels:
        for label, ell, col_args in _strip_sets(dev):
            call, out, plain = _strip_calls(ell, col_args, dev)
            measure("strip_col", label, call, out, plain, 20)
            del call, out, plain, ell, col_args
            torch.cuda.empty_cache()
    if "strip_row" in kernels:
        for label, mid, row_args in _row_sets(dev):
            call, out, plain = _row_calls(mid, row_args, dev)
            measure("strip_row", label, call, out, plain, 20)
            del call, out, plain, mid, row_args
            torch.cuda.empty_cache()
    if "pass_b" in kernels or "pass_c" in kernels:
        for label, ell, b_args, c_args in _passb_sets(dev):
            if "pass_b" in kernels:
                call, out, plain = _passb_calls(ell, b_args, dev)
                measure("pass_b", label, call, out, plain, 50)
                del call, out, plain
            if "pass_c" in kernels and c_args is not None:
                call, out, plain = _passc_calls(c_args, dev)
                measure("pass_c", label, call, out, plain, 50)
                del call, out, plain
            del ell, b_args, c_args
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "split": results}))


if __name__ == "__main__":
    main()
