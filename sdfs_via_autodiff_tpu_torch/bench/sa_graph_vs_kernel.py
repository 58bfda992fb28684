"""Successive approximation at the 20^4 continuous-SSY grid, three ways:
the whole-solve SA kernel (one launch), a CUDA graph of SA steps over
the one-application kernel, and the same steps launched eagerly.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.sa_graph_vs_kernel

Every variant runs ITERS iterations from w = 800 and computes each
step's sup-norm error on the card (the SA kernel's stop test; the graph
and the eager loop would read it on the host once per chunk).  The SA
kernel runs with tol -1, a fixed count.  The graph holds CHUNK steps
(one application and one error reduction each) and is replayed.
Variants run in turns (kernel, graph, eager, graph, kernel).  Prints one
line per run and a JSON line of us per iteration.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

import sdfs_via_autodiff_tpu_torch as port
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk

ITERS = 20_000
CHUNK = 50
EAGER_ITERS = 2_000
SIZES = (20, 20, 20, 20)


def _elapsed_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sa_graph_vs_kernel: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    model = port.SSY()
    th, be = model.theta, model.beta
    grids = port.build_grid_ssy(model, *SIZES, dtype=torch.float32)
    ops = tuple(a.to(device=dev, dtype=torch.float32).contiguous()
                for a in fd.kron_operands_ssy_continuous(model, grids, 5,
                                                         torch.float64))
    R, C = ops[2].shape
    x0 = torch.full((R, C), float(np.log(800.0)), device=dev)

    def kernel():
        _, iters, _ = sk.fused_sa(x0, *ops, None, th, be, -1.0, ITERS)
        assert int(iters) == ITERS

    # A graph of CHUNK SA steps over the one-application kernel.
    x = x0.clone()
    errs = torch.empty(CHUNK, device=dev)

    def steps(n, xs, errs_out=None):
        for i in range(n):
            new = fd.fused_T(xs, *ops, None, th, be)
            e = torch.amax(torch.abs(new - xs))
            if errs_out is not None:
                errs_out[i].copy_(e)
            xs.copy_(new)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps(3, x.clone())                     # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps(CHUNK, x, errs)

    def graphed():
        x.copy_(x0)
        for _ in range(ITERS // CHUNK):
            graph.replay()

    def eager():
        xs = x0.clone()
        steps(EAGER_ITERS, xs)

    # Agreement: the graph's iterate after one chunk vs the kernel's.
    x.copy_(x0)
    graph.replay()
    want, _, _ = sk.fused_sa(x0, *ops, None, th, be, -1.0, CHUNK)
    torch.cuda.synchronize()
    diff = float((x - want).abs().max())
    print(f"graph vs SA kernel after {CHUNK} steps: max abs diff {diff:.3e}")

    result = {}
    for name, fn, n in (("sa_kernel", kernel, ITERS),
                        ("graph_over_fused_T", graphed, ITERS),
                        ("eager_over_fused_T", eager, EAGER_ITERS),
                        ("graph_over_fused_T (again)", graphed, ITERS),
                        ("sa_kernel (again)", kernel, ITERS)):
        fn()                                    # warm
        us = 1e3 * _elapsed_ms(fn) / n
        result[name] = us
        print(f"{name}: {us:.3f} us per SA iteration at {SIZES} over {n} "
              f"iterations ({smi})")
    print(json.dumps({"device": smi, "sizes": SIZES, "chunk": CHUNK,
                      "graph_vs_kernel_max_abs_diff": diff,
                      "us_per_iteration": result}))


if __name__ == "__main__":
    main()
