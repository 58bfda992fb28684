"""The simulated path and the Monte Carlo stability exponent at their
defaults, as a plain Python loop of steps and with chunks of steps
replayed as CUDA graphs.

Run on a machine with a CUDA card, from the repository root:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.sim_graphs [--quick]

1. ``simulate_states(SSY(), 10^6 + 10^3)`` (the ``simulate`` command's
   path), loop then graphs: seconds each, and the two paths held equal
   bit for bit;
2. ``stability_exponent_mc(SSY())`` at T = 100,000 and N = 10,000,
   loop then graphs, the same;
3. torch.profiler over a short window of each loop (2,000 steps of
   the path, 200 of the exponent): the device's busy share (kernel time
   over the window's wall time), which says whether the host bounds it.

``--quick`` cuts the step counts by 100 (a first check of a new
build).  Prints one line per run and a JSON line of the results.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import sdfs_via_autodiff_tpu_torch as port
from sdfs_via_autodiff_tpu_torch.utils import graphs as graphs_mod
from sdfs_via_autodiff_tpu_torch.utils.spectral import stability_exponent_mc

SIM_STEPS, BURN_IN = 1_000_000, 1000
MC_T, MC_N = 100_000, 10_000
PROFILE_SIM, PROFILE_MC = 2000, 200


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _busy_share(fn):
    """(device kernel seconds, wall seconds) of ``fn`` under
    torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: an operator's entry also carries the time
    # of the kernels it launched.
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda)
    return dev_us * 1e-6, wall


def _run(model, steps, T, dev, smi, out, graphs):
    """One pass of both paths, as the loop (``graphs`` False, then also
    profiled) or with the chunks replayed as CUDA graphs."""
    tag = "graphs" if graphs else "loop"
    path, secs = _timed(lambda: port.simulate_states(model, steps,
                                                     device=dev))
    out[f"sim_{tag}_s"] = secs
    out[f"sim_{tag}"] = path
    print(f"simulate_states {steps} steps, {tag}: {secs:.3f} s ({smi})",
          flush=True)
    mc, secs = _timed(lambda: stability_exponent_mc(model, T=T, N=MC_N,
                                                    device=dev))
    out[f"mc_{tag}_s"] = secs
    out[f"mc_{tag}"] = mc
    print(f"stability_exponent_mc T={T} N={MC_N}, {tag}: {mc}, "
          f"{secs:.3f} s ({smi})", flush=True)
    if not graphs:
        busy, wall = _busy_share(lambda: port.simulate_states(
            model, PROFILE_SIM, device=dev))
        out["sim_loop_busy"] = busy / wall
        print(f"  profiler, {PROFILE_SIM} path steps: device busy "
              f"{busy:.4f} s of {wall:.4f} s = {busy / wall:.1%}")
        busy, wall = _busy_share(lambda: stability_exponent_mc(
            model, T=PROFILE_MC, N=MC_N, device=dev))
        out["mc_loop_busy"] = busy / wall
        print(f"  profiler, {PROFILE_MC} exponent steps: device busy "
              f"{busy:.4f} s of {wall:.4f} s = {busy / wall:.1%}")


def main(quick: bool = False) -> None:
    if not torch.cuda.is_available():
        sys.exit("sim_graphs: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    cut = 100 if quick else 1
    steps, T = SIM_STEPS // cut + BURN_IN, MC_T // cut
    model = port.SSY()
    out = {"device": smi, "sim_steps": steps, "mc_T": T, "mc_N": MC_N}

    # Warm the allocator and the kernels' first calls.
    port.simulate_states(model, 2048, device=dev)
    stability_exponent_mc(model, T=500, N=MC_N, device=dev)

    try:
        for graphs in (False, True):
            graphs_mod._ENABLED = graphs
            _run(model, steps, T, dev, smi, out, graphs)
    finally:
        graphs_mod._ENABLED = True
    same_path = torch.equal(out.pop("sim_loop"), out.pop("sim_graphs"))
    same_mc = out.pop("mc_loop") == out["mc_graphs"]
    out.update(sim_bitwise=same_path, mc_bitwise=same_mc)
    print(json.dumps(out))
    if not (same_path and same_mc):
        sys.exit("sim_graphs: the graph path differs from the loop")


if __name__ == "__main__":
    main(quick="--quick" in sys.argv[1:])
