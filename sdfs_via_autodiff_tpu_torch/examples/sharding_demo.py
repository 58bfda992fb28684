"""Multi-device grid sharding demo: the explicit sharded operators.

Every device is one rank of a ``torch.distributed`` process group.  On
a host with N cards:

    torchrun --nproc-per-node=N -m sdfs_via_autodiff_tpu_torch.examples.sharding_demo

or, on one card, ``python -m sdfs_via_autodiff_tpu_torch.examples.
sharding_demo`` (a process group of world size 1).  Each rank solves the
same problems; the sharded solves run on the rank's shard, with the
collectives the operators place by hand (``parallel/shard_ops.py``):
the h_lam-sharded SSY operator (a reduce-scatter per application), the
two-phase operator on a (dp, tp) mesh (two) and the streamed kernels
(two all-to-alls).  Rank 0 prints the report.
"""

import datetime
import os
import socket

import torch
import torch.distributed as dist


def _init(device: str) -> bool:
    """Initialize the default process group unless one is: from
    torchrun's environment, else at world size 1 on a free local port.
    Returns whether this call initialized it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    timeout = datetime.timedelta(seconds=120)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=0, world_size=1,
                                timeout=timeout)
    return True


def main(shapes=(8, 8, 6, 6), streamed_shapes=(8, 8, 8, 16),
         device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (SSY, T_ssy_factory,
                                             discretize_ssy,
                                             make_streamed_T_log, solve,
                                             two_phase_operands_ssy)
    from sdfs_via_autodiff_tpu_torch.config import num_devices
    from sdfs_via_autodiff_tpu_torch.parallel import (
        T_ssy_shard_map_factory, make_mesh, shard_grid_array,
        streamed_shard_map_factory, two_phase_shard_map_factory)

    owned = _init(device)
    try:
        n = num_devices()
        say = print if dist.get_rank() == 0 else (lambda *a: None)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.device(device).type == "cuda" else
               torch.device("cpu"))
        say(f"ranks: {n} x {dev.type}")
        model = SSY()
        disc = discretize_ssy(model, shapes)
        ell0 = torch.full(shapes, float(torch.log(torch.tensor(800.0))),
                          dtype=torch.float64, device=dev)
        ref = solve(T_ssy_factory(model, disc, space="log", device=dev),
                    ell0, method="newton", tol=1e-10)
        say(f"single-device newton:   {ref}")
        diffs = {}

        mesh = make_mesh(device=dev.type)
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
        tall = make_mesh(shape=(n, 1), device=dev.type)
        T = T_ssy_shard_map_factory(model, disc, tall)
        res = solve(T, shard_grid_array(ell0, tall), method="newton",
                    tol=1e-10)
        diffs["ssy"] = float((res.x.full_tensor() - ref.x).abs().max())
        say(f"h_lam-sharded newton:   {res}  (sup diff vs single "
            f"{diffs['ssy']:.2e})")

        ops = two_phase_operands_ssy(model, disc)
        T2 = two_phase_shard_map_factory(ops, mesh, dtype=torch.float64)
        res2 = solve(T2, shard_grid_array(ell0, mesh), method="newton",
                     tol=1e-10)
        diffs["two_phase"] = float((res2.x.full_tensor() - ref.x)
                                   .abs().max())
        say(f"(dp, tp) newton:        {res2}  (sup diff vs single "
            f"{diffs['two_phase']:.2e})")

        ops3 = two_phase_operands_ssy(model, discretize_ssy(model,
                                                            streamed_shapes))
        T3 = streamed_shard_map_factory(ops3, tall)
        x3 = torch.full(streamed_shapes, 6.7, device=dev)
        y3 = T3(x3).full_tensor()
        diffs["streamed"] = float((y3 - make_streamed_T_log(
            ops3, device=dev)(x3)).abs().max())
        res3 = solve(T3, T3.from_local(T3.to_local(x3)), method="newton",
                     tol=2e-5)
        say(f"streamed kernels ({T3.mode}): one application vs single "
            f"{diffs['streamed']:.2e}; newton {res3}")
        return diffs, res, res2, res3
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
