"""The sharded Newton solve's BiCGStab on several ranks: the fused passes
(``kernels/krylov_fused.py``) against the eager loop.

Run on a host with ``--world`` CUDA cards, ``nvcc`` and PyTorch built for
CUDA, from the repository root:

    python3 -m sdfs_via_autodiff_tpu_torch.bench.sharded_krylov [--world 4]

It builds the kernels once, then starts one process a card, each a rank
of a NCCL process group (gloo with ``--device cpu``, where both sides run
the eager loop), and builds ``streamed_shard_map_factory`` for the SSY
Tauchen set (``--shapes``, by default the 12.6M-state (32,32,32,384))
on the default mesh (2 x 2 at four ranks).  Every rank runs the Newton
solve from w = 800 at tol 2e-5 four times in turns, eager, fused, fused,
eager (eager: ``krylov_fused.fusable`` patched off), and reports

- each solve's seconds (host clock, synchronized), Newton steps and
  BiCGStab iterations per step, and the share of them that ran fused;
- the largest relative difference of w* between the fused and the eager
  solves, and whether the two fused solves and the two eager solves are
  bitwise equal;
- for every fused Krylov solve, whether the ranks' scalar blocks (the
  recurrence scalars, flags, stop flag and count) are bitwise equal at
  its end: the stop stayed in lockstep across the ranks;
- the same solve through the single-device operator on rank 0's card.

Rank 0 prints one line per solve and a last JSON line; a failed check
exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SHAPES, METHOD, TOL = (32, 32, 32, 384), "tauchen", 2e-5
W_RTOL = 1e-5          # fused against eager w*: float32 rounding of steps
TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _solve(port, kf, T, x0, fused: bool, dev) -> dict:
    """One Newton solve; with ``fused`` False the eager loop."""
    from sdfs_via_autodiff_tpu_torch.utils.profiling import recorded
    made = []
    start = kf.Passes.start

    def kept(self, *args):
        made.append(self)
        return start(self, *args)

    fusable = kf.fusable
    kf.Passes.start = kept
    if not fused:
        kf.fusable = lambda b: False
    try:
        _sync(dev)
        t0 = time.perf_counter()
        with recorded() as recs:
            res = port.newton_solver(T, x0, tol=TOL)
        _sync(dev)
        secs = time.perf_counter() - t0
    finally:
        kf.Passes.start, kf.fusable = start, fusable
    counts = lambda name: [r.count for r in recs if r.name == name]
    inner = counts("sdfs.krylov")
    # The ranks' scalar blocks at the end of each fused Krylov solve.
    lockstep = []
    for ps in made:
        got = [torch.empty_like(ps.S) for _ in range(dist.get_world_size())]
        dist.all_gather(got, ps.S)
        lockstep.append(all(torch.equal(g, got[0]) for g in got))
    return {"x": res.x, "converged": bool(res.converged),
            "steps": int(res.iterations), "secs": secs, "inner": inner,
            "fused_share": sum(counts("sdfs.krylov.fused")) / max(
                sum(inner), 1),
            "lockstep": lockstep}


def _rank(rank: int, world: int, addr: str, device: str, shapes) -> None:
    import sdfs_via_autodiff_tpu_torch as port
    from sdfs_via_autodiff_tpu_torch import parallel as par
    from sdfs_via_autodiff_tpu_torch.kernels import krylov_fused as kf
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=addr,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    say = print if rank == 0 else (lambda *a, **k: None)
    failed = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failed.append(msg)
            say(f"sharded_krylov: FAIL: {msg}", flush=True)

    try:
        mesh = par.make_mesh(device=device)
        model = port.SSY()
        disc = port.discretize_ssy(model, shapes, method=METHOD)
        ops = port.two_phase_operands_ssy(model, disc)
        T = par.streamed_shard_map_factory(ops, mesh)
        full = torch.full(shapes, float(np.log(800.0)), dtype=torch.float32,
                          device=dev)
        x0 = par.shard_grid_array(full, mesh)
        say(f"ranks {world} x {dev.type}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
            f"{shapes} {METHOD}, local {T.local_shape}, input sharding "
            f"{T.input_sharding}", flush=True)
        runs = []
        for label in ("eager", "fused", "fused", "eager"):
            r = _solve(port, kf, T, x0, label == "fused", dev)
            r["label"] = label
            r["w"] = torch.exp(r.pop("x").full_tensor().double())
            runs.append(r)
            say(f"{label}: converged {r['converged']}, {r['steps']} Newton "
                f"steps, BiCGStab {r['inner']}, fused share "
                f"{r['fused_share']:.3f}, {r['secs']:.3f} s, ranks' scalar "
                f"blocks equal {r['lockstep']}", flush=True)
        single = None
        if rank == 0:
            T1 = port.make_streamed_T_log(ops, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            res1 = port.newton_solver(T1, full, tol=TOL)
            _sync(dev)
            single = {"secs": time.perf_counter() - t0,
                      "steps": int(res1.iterations),
                      "w": torch.exp(res1.x.double())}
        e1, f1, f2, e2 = runs
        rel = lambda a, b: float(((a - b).abs() / b).max())
        report = {
            "world": world, "device": dev.type, "shapes": list(shapes),
            "solves": [{k: r[k] for k in ("label", "converged", "steps",
                                          "inner", "fused_share", "secs",
                                          "lockstep")} for r in runs],
            "w_rel_fused_vs_eager": rel(f1["w"], e1["w"]),
            "fused_bitwise_repeat": bool(torch.equal(f1["w"], f2["w"])),
            "eager_bitwise_repeat": bool(torch.equal(e1["w"], e2["w"]))}
        if single is not None:
            report.update(single_secs=single["secs"],
                          single_steps=single["steps"],
                          w_rel_fused_vs_single=rel(f1["w"], single["w"]))
        if cuda:
            report["card"] = torch.cuda.get_device_name(dev)
        check(all(r["converged"] for r in runs), "a solve did not converge")
        check(report["w_rel_fused_vs_eager"] <= W_RTOL,
              f"fused w* vs eager: rel {report['w_rel_fused_vs_eager']:.3e}")
        check(f1["steps"] == e1["steps"], "Newton steps differ")
        check(all(abs(a - b) <= 1 for a, b in zip(f1["inner"], e1["inner"]))
              and len(f1["inner"]) == len(e1["inner"]),
              "BiCGStab iterations differ by more than 1 at a step")
        check(report["fused_bitwise_repeat"]
              and report["eager_bitwise_repeat"], "a repeat differs")
        if cuda:
            check(f1["fused_share"] == 1.0 and e1["fused_share"] == 0.0,
                  "the fused passes did not run (or ran on the eager side)")
            check(all(all(r["lockstep"]) and r["lockstep"]
                      for r in (f1, f2)),
                  "the ranks' scalar blocks differ after a fused solve")
        say(json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()
    if failed:
        sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shapes", default=",".join(map(str, SHAPES)))
    args = ap.parse_args(argv)
    shapes = tuple(int(s) for s in args.shapes.split(","))
    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            sys.exit(f"sharded_krylov: {args.world} ranks need as many "
                     f"CUDA cards, found {torch.cuda.device_count()}")
        from sdfs_via_autodiff_tpu_torch.kernels import _build
        for name in ("streamed_two_phase", "krylov_fused"):
            _build.build(name)          # once, before the ranks load it
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, args.world, addr,
                                             args.device, shapes))
             for r in range(args.world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1.0))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
        codes.append(p.exitcode)
    if any(c != 0 for c in codes):
        sys.exit(f"sharded_krylov: rank exit codes {codes}")


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
