"""Phase split and before/after timing of the post-interp kernel (B8) and
the pair pass C (B4) on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.kernel_split [--before DIR]

Each kernel's source stops after a phase under a compile-time switch
(``SDFS_SPLIT`` in ``csrc/post_interp.cu``: 1 forms the row-pair
combinations G, 2 adds the gathers and V, 3 the power and exp-sum;
``SDFS_PAIR_SPLIT`` in ``csrc/streamed_two_phase.cu``: 1 the slice
maxima, 2 the exponentials with the z_pi' sum, 3 the z' product; 4, the
default, is the whole kernel).  The script builds every variant with
nvcc (one process each, all started together) and times each at the
main paths' shapes with CUDA events: the median of 3 runs of N launches.
Differences of consecutive stops are the phases' times.

``--before DIR`` names a directory holding the previous design's two
sources (the dense-Kronecker post-interp kernel with its G and partial
sum scratch, entry ``sdfs_post_interp(field, Wr, Wc, pay, off, s,
lk_row, lk_col, g, part, out, R, C, P12, P34, theta, beta, post,
stream)``; the one-block-per-(slice, b) pair pass C, the same entry as
now) with the same switches: its splits (the previous B8's stops are
1: G = Wr F, 2: the Kronecker products, 3: the power and exp-sum) are
timed too, and the whole kernels in turns (before, after, after,
before).  Prints one line per measurement and a last JSON line.
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
from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

POST_SIZES = ((20, 20, 20, 20), (15, 15, 15, 15))
PAIR_SIZES = ((16, 8, 12, 12, 128, 8), (8, 8, 8, 8, 128, 8))
STOPS = (1, 2, 3, 4)
SWITCH = {"post_interp": "SDFS_SPLIT", "streamed_two_phase": "SDFS_PAIR_SPLIT"}
OUT_DIR = _build.BUILD_DIR / "split"


def _compile(src: Path, tag: str, stop: int) -> Path:
    out = OUT_DIR / f"{src.stem}-{tag}-{stop}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{SWITCH[src.stem]}={stop}",
         "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} {tag} stop {stop}:\n{proc.stderr}")
    if stop == 4:
        keep = ("post_gather", "post_acc", "post_g_", "pass_c_pair")
        lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()]
        for k, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(x in ln for x in keep):
                print(f"ptxas {tag} {src.stem}: " + " | ".join(lines[k:k + 4]))
    return out


def _load(path: Path, which: str, dense: bool):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if which == "post_interp":
        fn = lib.sdfs_post_interp
        fn.argtypes = ([p] * 11 + [i] * 4 + [f, f, i, p] if dense
                       else [p] * 15 + [i] * 5 + [f, f, i, p])
    else:
        fn = lib.sdfs_pass_c_pair
        fn.argtypes = [p] * 8 + [i] * 6 + [f, f, p]
    fn.restype = i
    return fn


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
    return ctypes.c_void_p(t.data_ptr())


def _post_calls(sizes, interp, dev):
    """(after, before) callers of one application: each takes the
    library function and returns a launcher writing into ``out``."""
    model = port.SSY()
    grids = port.build_grid_ssy(model, *sizes)
    T = pk.make_post_interp_kernel_T_ssy(model, grids, 5, interp, device=dev)
    rng = np.random.default_rng(0)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(sizes),
                          device=dev, dtype=torch.float32)
    field, corners, pay, off, s, lk_row, lk_col, th, be, _ = T.kernel_args(ell)
    n_l, n_k, n_i, n_j = sizes
    R, C, P = n_l * n_k, n_i * n_j, 25
    ops = pk.post_interp_operands_ssy(model, grids, 5)
    Wr, Wc = (ops[k].to(device=dev, dtype=torch.float32).contiguous()
              for k in ("Wr", "Wc"))
    g = torch.empty((P, R, C), device=dev)
    part = torch.empty_like(g)
    out = torch.empty_like(field)
    post = int(interp == "post")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    # The launchers hold the tensors (not only their addresses), so that
    # none is freed and reused while they run.
    small = (pay, off, s, lk_row, lk_col)

    def after(fn):
        return lambda: fn(_ptr(field), *(_ptr(t) for t in corners),
                          *(_ptr(t) for t in small), _ptr(out), n_l, n_k,
                          n_i, n_j, 5, th, be, post, stream)

    def before(fn):
        return lambda: fn(_ptr(field), _ptr(Wr), _ptr(Wc),
                          *(_ptr(t) for t in small), _ptr(g), _ptr(part),
                          _ptr(out), R, C, P, P, th, be, post, stream)

    plain = pk.post_interp_gather_plain(*T.kernel_args(ell))
    return after, before, out, plain


def _pair_calls(sizes, dev):
    model = port.GCY()
    base = drivers._coarse_additive_baseline(model, sizes, num_std_devs=3.2,
                                             quad_degree=5,
                                             dtype=torch.float64, device=dev)
    grids = port.build_grid_gcy(model, *sizes)
    ops = port.two_phase_operands_gcy_continuous(model, grids, 5, base)
    L, K, I, J = ops.shapes
    n_i, n_y, n_b, n_j = ops.pair_shapes
    R, C = L * K, I * J
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ell = cast(ops.baseline_log_w + 0.05 * rng.standard_normal(ops.shapes))
    mid = st.pass_b_deferred_plain(
        ell.reshape(R, I, J), cast(np.asarray(ops.W_c1).T),
        float(ops.theta), cast(np.asarray(ops.sub_row).reshape(R)),
        cast(ops.sub_col)).reshape(R, C).contiguous()
    P_zpi, PzT = st.pair_device_operands(ops, device=dev)
    args = (mid, P_zpi, PzT, cast(ops.W_r1), cast(ops.W_r2),
            cast(ops.add_row), cast(ops.add_col.reshape(C)))
    out = torch.empty_like(mid)
    th, be = float(ops.theta), float(ops.beta)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def call(fn):
        return lambda: fn(*(_ptr(t) for t in args), _ptr(out), L, K, n_i, n_y,
                          n_b, n_j, th, be, stream)

    plain = st.pass_c_pair_plain(*args, th, be)
    return call, call, out, plain, tuple(ops.shapes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="directory with the previous design's post_interp.cu "
                         "and streamed_two_phase.cu (with the switches)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(f"device: {smi}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(_build.CSRC_DIR / f"{w}.cu", "after", k)
            for w in SWITCH for k in STOPS]
    if a.before is not None:
        jobs += [(a.before / f"{w}.cu", "before", k)
                 for w in SWITCH for k in STOPS]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: _compile(*j), jobs))
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {(j[0].stem, j[1], j[2]): _load(p, j[0].stem, j[1] == "before"
                                           and j[0].stem == "post_interp")
            for j, p in zip(jobs, paths)}
    tags = ("after",) + (("before",) if a.before is not None else ())
    results = []

    def measure(which, label, callers, out, plain, n):
        row = {"kernel": which, "set": label}
        for tag in tags:
            fn = libs[(which, tag, 4)]
            rc = callers[tag](fn)()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{which} {tag} {label}: error {rc}")
            row[f"{tag}_err_vs_plain"] = float((out - plain).abs().max())
        # The whole kernels in turns, then each variant's cumulative time.
        order = ("before", "after", "after", "before") if len(tags) == 2 \
            else ("after", "after")
        full = {t: [] for t in tags}
        for tag in order:
            full[tag].append(_ms(callers[tag](libs[(which, tag, 4)]), n))
        for tag in tags:
            row[f"{tag}_ms"] = full[tag]
            row[f"{tag}_stops_ms"] = [
                _ms(callers[tag](libs[(which, tag, k)]), n) for k in STOPS]
        print(f"{which} {label}: " + "; ".join(
            f"{t}: whole {', '.join(f'{x:.4f}' for x in row[f'{t}_ms'])} ms, "
            f"stops 1-4 {', '.join(f'{x:.4f}' for x in row[f'{t}_stops_ms'])}"
            f" ms, max abs err vs plain {row[f'{t}_err_vs_plain']:.3e}"
            for t in tags) + f" ({smi})", flush=True)
        results.append(row)

    for sizes in POST_SIZES:
        for interp in ("post", "loglin"):
            after, before, out, plain = _post_calls(sizes, interp, dev)
            measure("post_interp", f"{sizes} {interp}",
                    {"after": after, "before": before}, out, plain, 20)
            del after, before, out, plain
            torch.cuda.empty_cache()
    for sizes in PAIR_SIZES:
        after, before, out, plain, view = _pair_calls(sizes, dev)
        measure("streamed_two_phase", f"{sizes} view {view}",
                {"after": after, "before": before}, out, plain, 50)
        del after, before, out, plain
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "split": results}))


if __name__ == "__main__":
    main()
