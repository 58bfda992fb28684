"""Ranks of ``torch.distributed`` (gloo, CPU) for the parallel tests.

:func:`spawn` starts ``world`` processes, each a rank of a fresh gloo
process group on a free local port, runs one of this module's rank
functions in each and returns every rank's result.  A spawned rank
imports this module and not the test module, so it imports torch,
numpy and the port only (never JAX); the JAX side of each comparison
runs in the test process, on the same inputs (:func:`field`) and the
same operand recipes (:func:`operand_set`, given either package).

Each rank function returns a dict; rank 0's holds the full fields
(numpy) of every case, the others their scalars.  A rank that raises
returns its traceback, and :func:`spawn` raises it in the test.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import traceback
import types

import numpy as np

TIMEOUT_S = 120         # every collective of a rank
SPAWN_TIMEOUT_S = 420   # the whole spawn

# One entry per sharded-operator case: the world size, the mesh (shape,
# axis names), the factory, its operand recipe and its keyword
# arguments.  The JAX side builds the same factory on a JAX mesh of the
# same shape over its first devices.
SSY_SHAPES, STREAMED_SHAPES = (8, 8, 6, 6), (8, 8, 8, 16)
CASES = {
    "tssy_2x1": dict(world=2, mesh=(2, 1), factory="tssy",
                     recipe=("ssy_disc", (8, 6, 6, 6))),
    "tssy_4x1": dict(world=4, mesh=(4, 1), factory="tssy",
                     recipe=("ssy_disc", (8, 6, 6, 6))),
    "two_phase_ssy_2x1": dict(world=2, mesh=(2, 1), factory="two_phase",
                              recipe=("ssy", SSY_SHAPES)),
    "two_phase_ssy_2x2": dict(world=4, mesh=(2, 2), factory="two_phase",
                              recipe=("ssy", SSY_SHAPES)),
    "two_phase_ssy_normalized_2x2": dict(
        world=4, mesh=(2, 2), factory="two_phase",
        recipe=("ssy_normalized", SSY_SHAPES)),
    "two_phase_ssy_continuous_4x1": dict(
        world=4, mesh=(4, 1), factory="two_phase",
        recipe=("ssy_continuous", SSY_SHAPES)),
    "two_phase_gcy_2x2": dict(world=4, mesh=(2, 2), factory="two_phase",
                              recipe=("gcy", (3, 4, 3, 4, 3, 4))),
    "streamed_ssy_2x1": dict(world=2, mesh=(2, 1), factory="streamed",
                             recipe=("ssy", STREAMED_SHAPES)),
    "streamed_ssy_2x2": dict(world=4, mesh=(2, 2), factory="streamed",
                             recipe=("ssy", STREAMED_SHAPES)),
    "streamed_ssy_4x1": dict(world=4, mesh=(4, 1), factory="streamed",
                             recipe=("ssy", STREAMED_SHAPES)),
    "streamed_conjugated_2x2": dict(
        world=4, mesh=(2, 2), factory="streamed",
        recipe=("ssy_normalized", STREAMED_SHAPES)),
    "streamed_batched_2x2": dict(
        world=4, mesh=(2, 2), factory="streamed",
        recipe=("ssy_continuous_normalized", STREAMED_SHAPES)),
    "streamed_deferred_2x1": dict(
        world=2, mesh=(2, 1), factory="streamed",
        recipe=("ssy_tauchen", (2, 8, 64, 512))),
    "streamed_pair_2x2": dict(
        world=4, mesh=(2, 2), factory="streamed",
        recipe=("gcy_continuous", (8, 4, 4, 2, 128, 2))),
    "streamed_dcn_2x2": dict(
        world=4, mesh=(2, 2), names=("slice", "tp"), factory="streamed",
        recipe=("ssy", STREAMED_SHAPES),
        kw=dict(axis_names=("tp",), batch_axis="slice")),
    "streamed_sweep_2x2": dict(
        world=4, mesh=(2, 2), names=("slice", "tp"), factory="streamed",
        recipe=("ssy_sweep", STREAMED_SHAPES),
        kw=dict(axis_names=("tp",), batch_axis="slice")),
}


def operand_set(ns, recipe):
    """The operand set (or, for "ssy_disc", the (model, discretization)
    pair, for "ssy_sweep" the list of two members) of ``recipe`` =
    (name, shapes), built with the namespace ``ns`` of either package
    (SSY, GCY, the discretizers, grid builders and two-phase recipes)."""
    name, shapes = recipe
    if name == "ssy_disc":
        m = ns.SSY()
        return m, ns.discretize_ssy(m, shapes)
    if name in ("ssy", "ssy_normalized", "ssy_tauchen"):
        m = ns.SSY()
        method = "tauchen" if name == "ssy_tauchen" else "rouwenhorst"
        return ns.two_phase_operands_ssy(
            m, ns.discretize_ssy(m, shapes, method=method),
            "loglinear" if name == "ssy_normalized" else None)
    if name == "ssy_sweep":
        out = []
        for m in (ns.SSY(), dataclasses.replace(ns.SSY(), rho_z=0.99)):
            out.append(ns.two_phase_operands_ssy(
                m, ns.discretize_ssy(m, shapes)))
        return out
    if name in ("ssy_continuous", "ssy_continuous_normalized"):
        m = ns.SSY()
        grids = ns.build_grid_ssy(m, *shapes)
        if name == "ssy_continuous":
            return ns.two_phase_operands_ssy_continuous(m, grids, 5)
        return ns.two_phase_operands_ssy_continuous(m, grids, 3,
                                                    "loglinear")
    if name == "gcy":
        m = ns.GCY()
        return ns.two_phase_operands_gcy(m, ns.discretize_gcy(m, shapes))
    if name == "gcy_continuous":
        m = ns.GCY()
        return ns.two_phase_operands_gcy_continuous(
            m, ns.build_grid_gcy(m, *shapes), 5, "loglinear")
    raise ValueError(name)


def field(case: str, ops=None) -> np.ndarray:
    """The input field of ``case`` (float64; the streamed cases take it
    as float32): log(800) plus seeded noise of scale 0.05, or a
    normalized set's baseline plus noise of scale 0.02; the multi-slice
    cases a batch of two members (the second shifted by 0.01)."""
    spec = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    name = spec["recipe"][0]
    if name == "ssy_disc":
        shapes = spec["recipe"][1]
    else:
        shapes = (ops[0] if isinstance(ops, list) else ops).shapes
    if spec.get("kw", {}).get("batch_axis"):
        x0 = np.full(shapes, np.log(800.0))
        return np.stack([x0, x0 + 0.01])
    base = getattr(ops, "baseline_log_w", None)
    if base is not None and spec["factory"] == "streamed":
        return (np.asarray(base, np.float64).reshape(shapes)
                + 0.02 * rng.standard_normal(shapes))
    return np.log(800.0) + 0.05 * rng.standard_normal(shapes)


def port_namespace():
    import sdfs_via_autodiff_tpu_torch as P
    return types.SimpleNamespace(
        SSY=P.SSY, GCY=P.GCY, discretize_ssy=P.discretize_ssy,
        discretize_gcy=P.discretize_gcy, build_grid_ssy=P.build_grid_ssy,
        build_grid_gcy=P.build_grid_gcy,
        two_phase_operands_ssy=P.two_phase_operands_ssy,
        two_phase_operands_ssy_continuous=P.two_phase_operands_ssy_continuous,
        two_phase_operands_gcy=P.two_phase_operands_gcy,
        two_phase_operands_gcy_continuous=P.two_phase_operands_gcy_continuous)


# ------------------------------------------------------------ spawning

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn_name, queue):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            queue.put((rank, globals()[fn_name](rank, world)))
        finally:
            dist.destroy_process_group()
    except Exception:                        # reported to the test
        queue.put((rank, {"error": traceback.format_exc()}))


def spawn(fn_name: str, world: int) -> list:
    """Run rank function ``fn_name`` on ``world`` gloo ranks; returns the
    ranks' results in rank order.  Raises ``RuntimeError`` with the
    first rank's traceback when one failed, and when the spawn outlives
    ``SPAWN_TIMEOUT_S`` (its processes are killed)."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn_name, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=SPAWN_TIMEOUT_S)
        while len(results) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, res = q.get(timeout=max(left, 0.1))
            except queue_mod.Empty:
                raise RuntimeError(f"{fn_name} on {world} ranks did not end "
                                   f"within {SPAWN_TIMEOUT_S} s") from None
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for r in range(world):
        if "error" in results[r]:
            raise RuntimeError(f"rank {r} of {fn_name} failed:\n"
                               f"{results[r]['error']}")
    return [results[r] for r in range(world)]


# --------------------------------------------------------- rank helpers

class CollectiveLog:
    """Records each collective the sharded operators issue (its name,
    the global ranks of its group and its input's element count) by
    wrapping ``shard_ops._fc``."""

    def __init__(self):
        import torch.distributed as dist
        from sdfs_via_autodiff_tpu_torch.parallel import shard_ops
        self._dist, self._mod = dist, shard_ops
        self._real = shard_ops._fc
        self.calls = []

    def __enter__(self):
        def counted(name):
            fn = self._real(name)
            if name == "wait_tensor":
                return fn

            def call(*args):
                group = args[-1]
                self.calls.append((name, tuple(
                    self._dist.get_process_group_ranks(group)),
                    int(args[0].numel())))
                return fn(*args)
            return call
        self._mod._fc = counted
        return self

    def __exit__(self, *exc):
        self._mod._fc = self._real

    def count(self, name: str) -> int:
        return sum(c[0] == name for c in self.calls)


def _factory(par, spec, mesh, ops):
    import torch
    if spec["factory"] == "tssy":
        model, disc = ops
        return par.T_ssy_shard_map_factory(model, disc, mesh)
    if spec["factory"] == "two_phase":
        return par.two_phase_shard_map_factory(ops, mesh,
                                               dtype=torch.float64)
    return par.streamed_shard_map_factory(ops, mesh, **spec.get("kw", {}))


def _single(P, spec, ops):
    """The single-device operator of a case (the streamed multi-slice
    cases: one per member)."""
    import torch
    if spec["factory"] == "tssy":
        model, disc = ops
        return P.T_ssy_factory(model, disc, space="log", device="cpu")
    if spec["factory"] == "two_phase":
        return P.make_eager_two_phase_T(ops, torch.float64, device="cpu")
    if isinstance(ops, list):
        return [P.make_streamed_T_log(om, device="cpu") for om in ops]
    return P.make_streamed_T_log(ops, device="cpu")


def parallel_cases(rank: int, world: int) -> dict:
    """Every CASES entry of this world size, the mesh functions, the
    collective counts and the refusals, on this rank."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import config
    from sdfs_via_autodiff_tpu_torch import parallel as par
    from torch.distributed.tensor import DTensor
    out = {"num_devices": config.num_devices()}
    ns = port_namespace()
    for case, spec in CASES.items():
        if spec["world"] != world:
            continue
        mesh = par.make_mesh(world, spec.get("names", ("dp", "tp")),
                             spec["mesh"], device="cpu")
        ops = operand_set(ns, spec["recipe"])
        T = _factory(par, spec, mesh, ops)
        x = torch.as_tensor(field(case, ops))
        if spec["factory"] == "streamed":
            x = x.float()
        with CollectiveLog() as log:
            y = T(x)
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == T.input_sharding
        full = y.full_tensor()
        single = _single(P, spec, ops)
        if isinstance(single, list):
            want = torch.stack([S(xi) for S, xi in zip(single, x)])
        elif spec.get("kw", {}).get("batch_axis"):
            want = torch.stack([single(xi) for xi in x])
        else:
            want = single(x)
        # A DTensor input gives the same as the full field.
        y2 = T(DTensor.from_local(T.to_local(x), mesh, T.input_sharding,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())).full_tensor()
        res = {"single_max_abs": float((full.double() - want.double())
                                       .abs().max()),
               "single_equal": bool(torch.equal(full, want)),
               "dtensor_input_equal": bool(torch.equal(full, y2)),
               "calls": log.calls, "mode": getattr(T, "mode", None),
               "local_shape": T.local_shape}
        if rank == 0:
            res["out"] = full.double().numpy()
        out[case] = res
    out["mesh"] = _mesh_checks(par, world)
    out["refusals"] = _refusals(P, par, world)
    out["groups"] = _group_checks(par, world)
    return out


def _group_checks(par, world: int) -> dict:
    """The process groups of flattened mesh axes: made on first use (one
    per sub-mesh), reused after, and the default group where the axes
    span every rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from sdfs_via_autodiff_tpu_torch.parallel import shard_ops
    made = []
    real = dist.new_group

    def counted(ranks=None, *args, **kw):
        made.append(tuple(ranks))
        return real(ranks, *args, **kw)

    mesh3 = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2, 1),
                       mesh_dim_names=("slice", "dp", "tp"))
    mesh2 = par.make_mesh(world, device="cpu")
    ops = operand_set(port_namespace(), ("ssy", STREAMED_SHAPES))
    dist.new_group = counted
    try:
        first = shard_ops._axis(mesh3, ("dp", "tp"))
        n_first = len(made)
        again = shard_ops._axis(mesh3, ("dp", "tp"))
        for _ in range(3):
            par.two_phase_shard_map_factory(ops, mesh2)
            par.streamed_shard_map_factory(ops, mesh2)
        whole = shard_ops._axis(mesh2, ("dp", "tp"))
    finally:
        dist.new_group = real
    return {"made_first": n_first, "made_after": len(made) - n_first,
            "reused": again.group is first.group,
            "sub_ranks": tuple(dist.get_process_group_ranks(first.group)),
            "whole_is_default": whole.group is dist.group.WORLD}


def _mesh_checks(par, world: int) -> dict:
    import torch
    res = {}
    mesh = par.make_mesh(device="cpu")
    res["default_shape"] = tuple(mesh.mesh.shape)
    res["names"] = tuple(mesh.mesh_dim_names)
    res["grid_sharding"] = str(par.grid_sharding(mesh, 4))
    res["replicated"] = str(par.replicated_sharding(mesh))
    w = torch.arange(8 * 4 * 3 * 2, dtype=torch.float64).reshape(8, 4, 3, 2)
    d = par.shard_grid_array(w, mesh)
    res["shard_local_shape"] = tuple(d.to_local().shape)
    res["shard_roundtrip"] = bool(torch.equal(d.full_tensor(), w))
    res["tall"] = tuple(par.make_mesh(world, shape=(world, 1),
                                      device="cpu").mesh.shape)
    for label, call in (("too_many", lambda: par.make_mesh(world + 1,
                                                           device="cpu")),
                        ("bad_shape", lambda: par.make_mesh(
                            world, shape=(3, world), device="cpu"))):
        try:
            call()
            res[label] = None
        except ValueError as e:
            res[label] = str(e)
    return res


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _refusals(P, par, world: int) -> dict:
    """The ValueErrors of the factories: indivisible shapes, a per-shard
    shape outside a kernel's layout, sweep members that differ in theta
    or structure, a batch of the wrong size, no intra-slice axis, sets
    the two-phase factory does not evaluate."""
    import torch
    ns = port_namespace()
    mesh = par.make_mesh(world, shape=(world, 1), device="cpu")
    ssy = operand_set(ns, ("ssy", STREAMED_SHAPES))
    odd = operand_set(ns, ("ssy", (6, 8, 6, 16)))  # 6 % 4 != 0
    out = {}
    if world == 4:
        out["indivisible_streamed"] = _raises(
            lambda: par.streamed_shard_map_factory(odd, mesh))
        out["indivisible_two_phase"] = _raises(
            lambda: par.two_phase_shard_map_factory(odd, mesh))
        model = P.SSY()
        out["indivisible_tssy"] = _raises(
            lambda: par.T_ssy_shard_map_factory(
                model, P.discretize_ssy(model, (6, 4, 4, 4)), mesh))
        slices = par.make_mesh(world, ("slice", "tp"), (2, 2), device="cpu")
        gamma = dataclasses.replace(P.SSY(), gamma=7.0)
        opsg = P.two_phase_operands_ssy(
            gamma, P.discretize_ssy(gamma, STREAMED_SHAPES))
        out["sweep_theta"] = _raises(lambda: par.streamed_shard_map_factory(
            [ssy, opsg], slices, axis_names=("tp",), batch_axis="slice"))
        norm = operand_set(ns, ("ssy_normalized", STREAMED_SHAPES))
        out["sweep_structure"] = _raises(
            lambda: par.streamed_shard_map_factory(
                [ssy, norm], slices, axis_names=("tp",), batch_axis="slice"))
        out["sweep_needs_batch_axis"] = _raises(
            lambda: par.streamed_shard_map_factory([ssy, ssy], slices))
        T = par.streamed_shard_map_factory(ssy, slices, axis_names=("tp",),
                                           batch_axis="slice")
        out["batch_size"] = _raises(
            lambda: T(torch.zeros((3,) + STREAMED_SHAPES)))
        one = par.make_mesh(world, ("dcn", "x"), (world, 1), device="cpu")
        out["no_intra_axis"] = _raises(lambda: par.streamed_shard_map_factory(
            ssy, one, axis_names=(), batch_axis="dcn"))
        out["f64_streamed"] = _raises(lambda: par.streamed_shard_map_factory(
            ssy, mesh, dtype=torch.float64))
        pair = operand_set(ns, ("gcy_continuous", (8, 4, 4, 2, 128, 2)))
        out["pair_two_phase"] = _raises(
            lambda: par.two_phase_shard_map_factory(pair, mesh))
        out["tpu_option"] = _raises(lambda: par.streamed_shard_map_factory(
            ssy, mesh, interpret=True))
        # n_hz = 2 h_z groups on 4 column shards.
        nb = operand_set(ns, ("gcy_continuous", (8, 4, 2, 4, 128, 2)))
        out["pair_hz"] = _raises(
            lambda: par.streamed_shard_map_factory(nb, mesh))
        # A shard's rows past the deferred pass B's grid limit.
        out["layout"] = _raises(lambda: par.check_shard_layouts(
            "deferred", (4 * 70_000, 1, 64, 512), 4))
    return out


# One entry per sharded solve (world size 4): the factory, the mesh, the
# operand recipe, the method and its options; the reference is the same
# solve through the single-device operator.
SOLVES = {
    "newton_two_phase_2x2": dict(factory="two_phase", mesh=(2, 2),
                                 recipe=("ssy", (8, 8, 4, 4)),
                                 method="newton", opts=dict(tol=1e-10)),
    "gmres_two_phase_2x2": dict(factory="two_phase", mesh=(2, 2),
                                recipe=("ssy", (8, 8, 4, 4)),
                                method="newton",
                                opts=dict(tol=1e-10, inner="gmres",
                                          inner_maxiter=2)),
    "newton_tssy_4x1": dict(factory="tssy", mesh=(4, 1),
                            recipe=("ssy_disc", (8, 6, 4, 4)),
                            method="newton", opts=dict(tol=1e-10)),
    "anderson_two_phase_2x2": dict(factory="two_phase", mesh=(2, 2),
                                   recipe=("ssy", (8, 8, 4, 4)),
                                   method="anderson", opts=dict(tol=1e-9)),
    "sa_streamed_2x2": dict(factory="streamed", mesh=(2, 2),
                            recipe=("ssy", STREAMED_SHAPES),
                            method="successive_approx",
                            opts=dict(tol=-1.0, max_iter=40, trace_len=8)),
    "anderson_streamed_4x1": dict(factory="streamed", mesh=(4, 1),
                                  recipe=("ssy", STREAMED_SHAPES),
                                  method="anderson", opts=dict(tol=1e-5)),
    "newton_streamed_2x2": dict(factory="streamed", mesh=(2, 2),
                                recipe=("ssy", STREAMED_SHAPES),
                                method="newton", opts=dict(tol=2e-5)),
}


def solver_cases(rank: int, world: int) -> dict:
    """Every SOLVES entry through the sharded operator and through the
    single-device one from the same start (log 800 everywhere), and the
    derivatives of the sharded operators against the single-device
    ones."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import parallel as par
    from torch.distributed.tensor import DTensor
    ns = port_namespace()
    out = {}
    for case, spec in SOLVES.items():
        mesh = par.make_mesh(world, shape=spec["mesh"], device="cpu")
        ops = operand_set(ns, spec["recipe"])
        T = _factory(par, spec, mesh, ops)
        shapes = ops[1].shapes if spec["factory"] == "tssy" else ops.shapes
        dtype = torch.float32 if spec["factory"] == "streamed" else \
            torch.float64
        x0 = torch.full(shapes, float(np.log(800.0)), dtype=dtype)
        res = P.solve(T, par.shard_grid_array(x0, mesh), method=spec["method"],
                      **spec["opts"])
        ref = P.solve(_single(P, spec, ops), x0, method=spec["method"],
                      **spec["opts"])
        assert isinstance(res.x, DTensor)
        x = res.x.full_tensor()
        r = {"iterations": res.iterations, "converged": res.converged,
             "residual": res.residual, "ref_iterations": ref.iterations,
             "ref_converged": ref.converged,
             "max_abs_vs_single": float((x.double() - ref.x.double())
                                        .abs().max()),
             "equal_to_single": bool(torch.equal(x, ref.x)),
             "placements": str(res.x.placements),
             "input_sharding": str(T.input_sharding)}
        if res.error_trace is not None:
            r["trace_equal"] = bool(torch.equal(res.error_trace,
                                                ref.error_trace))
        if rank == 0:
            r["x"] = x.double().numpy()
        out[case] = r
    out["derivatives"] = _derivative_checks(P, par, world)
    out["nan_shard"] = _nan_shard_checks(P, par, rank, world)
    return out


def _nan_shard_checks(P, par, rank: int, world: int) -> dict:
    """A NaN on rank 1 only: the sharded sup-norm of a field whose NaN
    lies on one rank, and SA, Newton and Anderson from a start with a NaN
    in rank 1's shard through an elementwise map (x/2 + 1, fixed point 2,
    the start 2 elsewhere), so that the NaN stays on rank 1.  The
    single-device loops report such a start as not converged."""
    import math
    import torch
    from sdfs_via_autodiff_tpu_torch.parallel import shard_ops
    from sdfs_via_autodiff_tpu_torch.solvers.sharding import Reductions
    mesh = par.make_mesh(world, shape=(world, 1), device="cpu")
    ax = shard_ops._axis(mesh, ("dp",))
    out = {}
    red = Reductions(ax.group)
    for at in range(world):
        v = torch.zeros(3, dtype=torch.float64)
        if rank == at:
            v[1] = math.nan
        out[f"sup_nan_on_rank_{at}"] = math.isnan(float(red.sup(v)))
    T = shard_ops.ShardedOperator(
        lambda x: 0.5 * x + 1.0, mesh,
        shard_ops._placements(mesh, {"dp": 0}), SSY_SHAPES, ax)
    x0 = torch.full(SSY_SHAPES, 2.0, dtype=torch.float64)
    x0[SSY_SHAPES[0] // world, 0, 0, 0] = math.nan    # rank 1's first row
    for method in ("sa", "newton", "anderson"):
        res = P.solve(T, par.shard_grid_array(x0, mesh), method=method,
                      tol=1e-10)
        ref = P.solve(T.local, x0, method=method, tol=1e-10)
        out[method] = (res.converged, ref.converged)
    return out


def _derivative_checks(P, par, world: int) -> dict:
    """torch.func.jvp of the two-phase operator's shard and vjp of the
    streamed operator's shard against the single-device twins."""
    import torch
    ns = port_namespace()
    mesh = par.make_mesh(world, device="cpu")
    rng = np.random.default_rng(3)
    out = {}
    ops = operand_set(ns, ("ssy", SSY_SHAPES))
    T = par.two_phase_shard_map_factory(ops, mesh, dtype=torch.float64)
    x = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        SSY_SHAPES))
    v = torch.as_tensor(rng.standard_normal(SSY_SHAPES))
    _, dy = torch.func.jvp(T.local, (T.to_local(x),), (T.to_local(v),))
    _, dy1 = torch.func.jvp(P.make_eager_two_phase_T(ops, torch.float64,
                                                      device="cpu"),
                            (x,), (v,))
    out["jvp_two_phase"] = float((T.from_local(dy).full_tensor() - dy1)
                                 .abs().max())
    _, vjp = torch.func.vjp(T.local, T.to_local(x))
    (g,) = vjp(T.to_local(v))
    _, vjp1 = torch.func.vjp(P.make_eager_two_phase_T(
        ops, torch.float64, device="cpu"), x)
    (g1,) = vjp1(v)
    out["vjp_two_phase"] = float((T.from_local(g).full_tensor() - g1)
                                 .abs().max())
    ops = operand_set(ns, ("ssy", STREAMED_SHAPES))
    T = par.streamed_shard_map_factory(ops, mesh)
    xs = (np.log(800.0) + 0.05 * rng.standard_normal(STREAMED_SHAPES))
    xs = torch.as_tensor(xs, dtype=torch.float32)
    ct = torch.as_tensor(rng.standard_normal(STREAMED_SHAPES),
                         dtype=torch.float32)
    xl = T.to_local(xs).requires_grad_(True)
    (T.local(xl) * T.to_local(ct)).sum().backward()
    T1 = P.make_streamed_T_log(ops, device="cpu")
    _, vjp1 = torch.func.vjp(T1, xs)
    (g1,) = vjp1(ct)
    g = T.from_local(xl.grad).full_tensor()
    out["vjp_streamed_rel"] = float((g - g1).abs().max() / g1.abs().max())
    _, dy = torch.func.jvp(T.local, (T.to_local(xs),), (T.to_local(ct),))
    _, dy1 = torch.func.jvp(T1, (xs,), (ct,))
    out["jvp_streamed_rel"] = float((T.from_local(dy).full_tensor() - dy1)
                                    .abs().max() / dy1.abs().max())
    return out


def sharding_demo(rank: int, world: int) -> dict:
    """The port's sharding demo on this rank (its process group is this
    spawn's)."""
    from sdfs_via_autodiff_tpu_torch.examples import sharding_demo as demo
    diffs, res, res2, res3 = demo.main(device="cpu")
    return {"diffs": diffs, "converged": (res.converged, res2.converged,
                                          res3.converged),
            "iterations": (res.iterations, res2.iterations,
                           res3.iterations)}
