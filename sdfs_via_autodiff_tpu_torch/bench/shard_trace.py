"""Where the sharded streamed operator's Newton solve spends its time at
world size 1, against the single-device operator's, on one CUDA card.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.shard_trace

It starts a NCCL process group of world size 1, builds
``make_streamed_T_log`` and ``streamed_shard_map_factory`` for the SSY
Tauchen (32,32,32,384) set (fast mode), and

- times the Newton solve from w = 800 at tol 2e-5 through each, in turns
  (single, sharded, sharded, single; host clock, synchronized), with the
  inner iterations of each;
- times with CUDA events (median of 3 runs of 20 calls) one primal
  application, one tangent matvec (a matvec of the twin's linearization
  at x, as Newton runs it) and the loop's reductions (sup, float64 dot,
  norm), each on the single-device and the sharded side, and the tangent
  matvec's host time per call;
- profiles one solve of each with ``torch.profiler`` and prints the
  kernels with the most device time, the ops with the most self host
  time, the device's busy share (kernel time over the solve's wall
  time), the count of collectives and the NCCL kernels' time.

Prints one line per measurement and a last JSON line.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import sdfs_via_autodiff_tpu_torch as port
from sdfs_via_autodiff_tpu_torch import parallel as par
from sdfs_via_autodiff_tpu_torch.solvers.sharding import LOCAL, Reductions
from sdfs_via_autodiff_tpu_torch.utils.profiling import recorded

SHAPES, METHOD, TOL = (32, 32, 32, 384), "tauchen", 2e-5
TOP = 12


def _ms(fn, n=20, runs=3) -> float:
    """Median over ``runs`` of the mean CUDA-event ms of ``n`` calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / n)
    return float(np.median(out))


def _host_ms(fn, n=20) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _solve(T, x0):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded() as recs:
        res = port.newton_solver(T, x0, tol=TOL)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, sum(
        r.count for r in recs if r.name == "sdfs.krylov")


def _profile(label, T, x0) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs, _ = _solve(T, x0)
    events = prof.key_averages()
    # Kernel rows only: an operator's row repeats its kernels' time.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in kernels) / 1e6
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    comms = sum(e.count for e in events if e.key == "record_param_comms")
    out = {"wall_s": secs, "device_s": dev_total,
           "busy_share": dev_total / secs, "collectives": comms,
           "nccl_kernels": sum(e.count for e in nccl),
           "nccl_s": sum(e.self_device_time_total for e in nccl) / 1e6}
    for rows, key, name in ((kernels, "self_device_time_total", "device"),
                            (events, "self_cpu_time_total", "host")):
        top = sorted(rows, key=lambda e: getattr(e, key),
                     reverse=True)[:TOP]
        out[f"top_{name}"] = [(e.key[:80], e.count, getattr(e, key) / 1e3)
                              for e in top]
        print(f"{label}: top {TOP} by self {name} time (ms, calls): "
              + "; ".join(f"{k} {ms:.1f} ({c})"
                          for k, c, ms in out[f"top_{name}"]))
    print(f"{label}: profiled solve {secs:.3f} s, kernels {dev_total:.3f} s "
          f"({100 * out['busy_share']:.1f}% busy), {comms} collectives, "
          f"{out['nccl_kernels']} NCCL kernels {out['nccl_s']:.3f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("shard_trace: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port_no = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port_no}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        result = _run(dev, smi)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result))


def _run(dev, smi) -> dict:
    model = port.SSY()
    ops = port.two_phase_operands_ssy(
        model, port.discretize_ssy(model, SHAPES, method=METHOD))
    T1 = port.make_streamed_T_log(ops, device=dev)
    Ts = par.streamed_shard_map_factory(ops, par.make_mesh(device="cuda"))
    x0 = torch.full(SHAPES, float(np.log(800.0)), dtype=torch.float32,
                    device=dev)
    side = {"single": (T1, x0), "sharded": (Ts, Ts.from_local(x0))}
    result = {"device": smi, "shapes": SHAPES, "solve_s": {}}
    for label in ("single", "sharded", "sharded", "single"):
        T, x = side[label]
        res, secs, inner = _solve(T, x)
        result["solve_s"].setdefault(label, []).append(secs)
        result[f"{label}_iterations"] = (res.iterations, inner)
        print(f"{label} Newton solve: {secs:.3f} s, {res.iterations} "
              f"iterations, {inner} inner, converged {res.converged} "
              f"({smi})")

    rng = np.random.default_rng(0)
    x = x0 + 0.05 * torch.as_tensor(rng.standard_normal(SHAPES),
                                    dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.standard_normal(SHAPES), dtype=torch.float32,
                        device=dev)
    flat = v.reshape(-1)
    red = Reductions(Ts.reduce_axis.group)
    lin1, lins = T1.twin.linearize(x), Ts.local_twin.linearize(x)
    pieces = {
        "primal": (lambda: T1(x), lambda: Ts.local(x)),
        "tangent": (lambda: lin1(v), lambda: lins(v)),
        "sup": (lambda: LOCAL.sup(v), lambda: red.sup(v)),
        "dot64": (lambda: LOCAL.dot64(flat, flat),
                  lambda: red.dot64(flat, flat)),
        "norm": (lambda: LOCAL.norm(v), lambda: red.norm(v)),
    }
    result["ms"] = {}
    for name, (one, sharded) in pieces.items():
        ms = (_ms(one), _ms(sharded))
        result["ms"][name] = ms
        print(f"{name}: single {ms[0]:.4f} ms, sharded {ms[1]:.4f} ms "
              f"(CUDA events; {smi})")
    host = (_host_ms(pieces["tangent"][0]), _host_ms(pieces["tangent"][1]))
    result["tangent_host_ms"] = host
    print(f"tangent matvec host ms per call: single {host[0]:.4f}, sharded "
          f"{host[1]:.4f}")
    result["profile"] = {label: _profile(label, *side[label])
                         for label in ("single", "sharded")}
    return result


if __name__ == "__main__":
    main()
