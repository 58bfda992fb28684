#!/usr/bin/env python3
"""Drive the PyTorch port's two paths once on one NVIDIA GPU and check them.

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
10. a JSON line of per-kernel facts, then the result line
    ``{"ok": true, "device": {...}}``.

Each path runs with every launch count set to 0 just before it and read
just after.  The port never imports JAX, and neither does this script.
"""

from __future__ import annotations

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
SOURCE = "sdfs_via_autodiff_tpu_torch/kernels/csrc/streamed_two_phase.cu"
_JAX_KERNELS = "sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py"
REPLACES = {"pass_b": f"{_JAX_KERNELS}:324",            # _b_kernel
            "pass_c": f"{_JAX_KERNELS}:446",            # _c_kernel
            "pass_b_deferred": f"{_JAX_KERNELS}:384",   # _b_kernel_deferred
            "pass_c_deferred": f"{_JAX_KERNELS}:446"}   # _c_kernel, c2_deferred
KERNELS = tuple(REPLACES)


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
    for name, (k_ms, p_ms) in kernels_ms.items():
        print(f"timing {name} {ops.shapes}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms")
    return max_err, launches, kernels_ms


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA GPU")

    import sdfs_via_autodiff_tpu_torch as port
    from sdfs_via_autodiff_tpu_torch.kernels import _build
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

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build("streamed_two_phase")
    st._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
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

    # 10. Result.
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": kernels_ms[name][0],
         "plain_ms": kernels_ms[name][1]} for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
