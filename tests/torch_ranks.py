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
import math
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
    "tssy_2x2": dict(world=4, mesh=(2, 2), factory="tssy",
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
        if spec["factory"] == "streamed":
            # Newton's tangent on the shard: the twin's linearization
            # against torch.func.jvp of the same twin.
            xl = T.to_local(x)
            vl = torch.as_tensor(np.random.default_rng(rank).standard_normal(
                tuple(xl.shape)), dtype=torch.float32)
            got = T.local_twin.linearize(xl)(vl)
            jv = torch.func.jvp(T.local_twin, (xl,), (vl,))[1] - vl
            res["linearize_rel_v"] = float((got - jv).abs().max()
                                           / vl.abs().max())
        else:
            # Newton's tangent on the shard (float64): the local
            # linearization against torch.func.jvp of T.local, and,
            # gathered, against the single-device operator's.
            xl = T.to_local(x)
            v = torch.as_tensor(np.random.default_rng(7).standard_normal(
                tuple(x.shape)))
            vl = T.to_local(v)
            got = T.local_twin.linearize(xl)(vl)
            jv = torch.func.jvp(T.local, (xl,), (vl,))[1] - vl
            res["linearize_abs"] = float((got - jv).abs().max())
            res["linearize_vs_single"] = float(
                (T.from_local(got).full_tensor()
                 - single.linearize(x)(v)).abs().max())
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
    "newton_tssy_2x2": dict(factory="tssy", mesh=(2, 2),
                            recipe=("ssy_disc", (8, 6, 4, 4)),
                            method="newton", opts=dict(tol=1e-10)),
    "newton_two_phase_4x1": dict(factory="two_phase", mesh=(4, 1),
                                 recipe=("ssy", (8, 8, 4, 4)),
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
    # Newton's tangent on the shards: the twin's linearization.
    mv = T.local_twin.linearize(T.to_local(xs))
    cl = T.to_local(ct)
    dy = T.from_local(mv(cl) + cl).full_tensor()
    out["lin_streamed_rel"] = float((dy - dy1).abs().max()
                                    / dy1.abs().max())
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


# ------------------------------------- single-device operators on DTensors

# The GSPMD-transparent cases (the single-device factories applied to a
# DTensor iterate): the operator, its grid shapes and the field's level.
# The JAX side builds the same operators (tests/test_torch_gspmd.py).
GSPMD_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
GSPMD_OPS = {
    "ssy_log": ("ssy", (8, 8, 6, 6), dict(space="log")),
    "ssy_w": ("ssy", (8, 8, 6, 6), dict(space="w")),
    "ssy_normalized": ("ssy", (8, 8, 6, 6),
                       dict(space="log", baseline="loglinear")),
    "ssy_normalized_f32": ("ssy", (8, 8, 6, 6),
                           dict(space="log", baseline="loglinear",
                                dtype="float32")),
    "gcy_log": ("gcy", (4, 4, 4, 4, 2, 2), dict(space="log")),
    "gcy_normalized": ("gcy", (4, 4, 4, 4, 2, 2),
                       dict(space="log", baseline="loglinear")),
    "ssy_continuous": ("ssy_continuous", (8, 8, 6, 6), dict(space="log")),
    "gcy_continuous": ("gcy_continuous", (4, 4, 4, 4, 2, 2),
                       dict(space="log")),
    "degroot": ("degroot", (8, 4, 4, 4), dict(space="log", h=0.99)),
    "degroot_continuous": ("degroot_continuous", (8, 8, 6, 6),
                           dict(space="log", h=0.99)),
    "eager_two_phase": ("eager_two_phase", (8, 8, 6, 6), {}),
    "xla_twin": ("xla_twin", (8, 8, 6, 6), {}),
}


def gspmd_operator(P, name):
    """The port's single-device operator of GSPMD case ``name`` (CPU)."""
    import torch
    kind, shapes, kw = GSPMD_OPS[name]
    kw = dict(kw, device="cpu")
    if kw.get("dtype") == "float32":
        kw["dtype"] = torch.float32
    if kind == "ssy":
        m = P.SSY()
        return P.T_ssy_factory(m, P.discretize_ssy(m, shapes), **kw)
    if kind == "gcy":
        m = P.GCY()
        return P.T_gcy_factory(m, P.discretize_gcy(m, shapes), **kw)
    if kind == "ssy_continuous":
        m = P.SSY()
        return P.T_ssy_continuous_factory(m, P.build_grid_ssy(m, *shapes),
                                          interp="pre", **kw)
    if kind == "gcy_continuous":
        m = P.GCY()
        return P.T_gcy_continuous_factory(
            m, P.build_grid_gcy(m, *shapes), method="quadrature",
            interp="pre", quad_degree=3, **kw)
    if kind == "degroot":
        m = P.SSY()
        return P.T_degroot_factory(m, P.discretize_ssy(m, shapes), **kw)
    if kind == "degroot_continuous":
        m = P.SSY()
        return P.T_degroot_continuous_factory(
            m, P.build_grid_ssy(m, *shapes), quad_degree=3, **kw)
    m = P.SSY()
    disc = P.discretize_ssy(m, shapes)
    if kind == "eager_two_phase":
        return P.make_eager_two_phase_T(P.two_phase_operands_ssy(m, disc),
                                        torch.float64, device="cpu")
    M1, M2T, log_kap = P.kron_operands_ssy(m, disc, torch.float64)
    return P.make_xla_T_from_operands(
        M1, M2T, log_kap, m.theta, m.beta, shapes, shapes[0] * shapes[1],
        shapes[2] * shapes[3], torch.float64, device="cpu")


def gspmd_field(name, baseline=None) -> np.ndarray:
    """The input of GSPMD case ``name`` (float64): the baseline plus
    seeded noise of scale 0.02 for a normalized operator, log 800 plus
    noise of scale 0.05 in log space, 800 plus noise of scale 5 in w
    space; de Groot's ln g is theta * log((1 - beta) 800) plus noise."""
    kind, shapes, kw = GSPMD_OPS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    noise = rng.standard_normal(shapes)
    if baseline is not None:
        return np.asarray(baseline, np.float64) + 0.02 * noise
    if kw.get("space") == "w":
        return 800.0 + 5.0 * noise
    if kind.startswith("degroot"):
        from sdfs_via_autodiff_tpu_torch import SSY
        m = SSY()
        return m.theta * np.log((1 - m.beta) * 800.0) + 0.05 * noise
    return np.log(800.0) + 0.05 * noise


def _gspmd_mesh(par, world, label):
    return par.make_mesh(world, shape=GSPMD_MESHES[label], device="cpu")


def gspmd_operators(rank: int, world: int) -> dict:
    """Every GSPMD_OPS case on a DTensor, on each mesh of GSPMD_MESHES:
    the result against the single-device one (rank 0 also returns the
    full field), whether the placements were kept and the sharded and
    automatic SSY operators against each other; the tangent route
    against ``torch.func.jvp``."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import parallel as par
    out = {}
    for label in GSPMD_MESHES:
        mesh = _gspmd_mesh(par, world, label)
        for name in GSPMD_OPS:
            T = gspmd_operator(P, name)
            x = torch.as_tensor(gspmd_field(name, getattr(
                T, "baseline_log_w", None)))
            if GSPMD_OPS[name][2].get("dtype") == "float32":
                x = x.float()
            xd = par.shard_grid_array(x, mesh)
            y = T(xd)
            want = T(x)
            full = y.full_tensor()
            res = {"placements_kept": (tuple(y.placements)
                                       == tuple(xd.placements)),
                   "sharded": not all(p.is_replicate()
                                      for p in y.placements),
                   "max_abs": float((full - want).abs().max()),
                   "max_rel": float(((full - want) / want).abs().max()),
                   "level": float(want.abs().max())}
            if rank == 0:
                res["out"] = full.double().numpy()
            out[(label, name)] = res
        out[(label, "tangent")] = _tangent_route(P, par, mesh)
    out["hand_placed"] = _hand_placed_vs_automatic(P, par, world)
    out["distinct"] = _distinct_shard_reductions(par, world)
    out["fallback"] = _replicated_fallback(par, world)
    out["live_dtensors"] = _live_dtensors_after_applications(P, par, world)
    return out


def _live_dtensors_after_applications(P, par, world, n=50) -> dict:
    """The DTensors alive (``gc``) after one application of the SSY
    log-space operator to a DTensor on the 2x2 mesh, and after ``n`` more:
    the lifted constants and each application's temporaries are held by
    nothing once the application returns."""
    import gc
    import torch
    from torch.distributed.tensor import DTensor
    mesh = _gspmd_mesh(par, world, "2x2")
    T = gspmd_operator(P, "ssy_log")
    xd = par.shard_grid_array(torch.as_tensor(gspmd_field("ssy_log")), mesh)

    def live():
        gc.collect()
        return sum(type(o) is DTensor for o in gc.get_objects())
    T(xd)
    after_one = live()
    for _ in range(n):
        T(xd)
    return {"after_one": after_one, "after_more": live(), "n": n}


def _replicated_fallback(par, world) -> dict:
    """An op whose sharding DTensor cannot propagate (as torch 2.11's
    einsum that flattens two sharded axes) runs on replicated copies and
    its result goes back to the field's placements: a stand-in einsum
    that refuses sharded arguments, called through the lifting mode on
    the 2x2 mesh, against the plain one; its VJP, and the derivative of
    that VJP, against the plain ones; the warnings the gather gives."""
    import warnings
    import torch
    from sdfs_via_autodiff_tpu_torch.ops import dtensor
    from sdfs_via_autodiff_tpu_torch.parallel import gspmd
    mesh = _gspmd_mesh(par, world, "2x2")
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.random((8, 8)))
    x, u, v = (torch.as_tensor(rng.standard_normal((8, 6, 4)))
               for _ in range(3))
    calls = []

    def refusing(eq, M, X):
        calls.append(tuple(X.placements))
        if not all(p.is_replicate() for p in X.placements):
            raise RuntimeError("flatten of a sharded axis\n\nSharding "
                               "propagation failed for the stand-in")
        return torch.einsum(eq, M, X)

    def f(X):
        with dtensor._Lift():
            return dtensor._Lift().__torch_function__(
                refusing, (), ("lm,mkj->lkj", A, torch.exp(X)))

    f1 = lambda X: torch.einsum("lm,mkj->lkj", A, torch.exp(X))
    xd, ud, vd = (par.shard_grid_array(t, mesh) for t in (x, u, v))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = f(xd)
    out = {"kept": tuple(y.placements) == tuple(xd.placements),
           "calls": len(calls),
           "warnings": [(w.category.__name__, str(w.message))
                        for w in caught],
           "max_abs": float((y.full_tensor() - f1(x)).abs().max())}
    xg = xd.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(f(xg), xg, ud)
    (g1,) = torch.autograd.grad(f1(x.requires_grad_(True)), x, u)
    out["vjp_max_abs"] = float((g.full_tensor() - g1).abs().max())
    jv = gspmd.jvp_by_vjp(f, (xd,), (vd,))
    jv1 = torch.func.jvp(f1, (x.detach(),), (v,))[1]
    out["jvp_max_abs"] = float((jv.full_tensor() - jv1).abs().max())
    return out


def _distinct_shard_reductions(par, world) -> dict:
    """The solvers' reductions at a DTensor start that a mesh axis
    replicates ((Shard(0), Replicate()) on the 2x2 mesh): a float64 dot
    product, a norm and the element count against the full field's."""
    import torch
    from sdfs_via_autodiff_tpu_torch.parallel import gspmd
    from sdfs_via_autodiff_tpu_torch.solvers.sharding import Reductions
    mesh = _gspmd_mesh(par, world, "2x2")
    rng = np.random.default_rng(9)
    a, b = (torch.as_tensor(rng.standard_normal((8, 6, 4, 4)))
            for _ in range(2))
    ad = par.shard_grid_array(a, mesh, {0: "dp"})
    op = gspmd.local_operator(lambda x: x, ad)
    red = Reductions(op.reduce_axis.group)
    al, bl = op.to_local(ad), op.to_local(par.shard_grid_array(
        b, mesh, {0: "dp"}))
    return {"placements": str(tuple(ad.placements)),
            "group_size": op.reduce_axis.size,
            "dot_rel": float(abs(red.dot64(al.reshape(-1), bl.reshape(-1))
                                 / torch.dot(a.reshape(-1), b.reshape(-1))
                                 - 1)),
            "norm_rel": float(abs(red.norm(al) / torch.linalg.vector_norm(
                a.reshape(-1)) - 1)),
            "numel": red.numel(al)}


# The tangent route's cases: the operators with a hand linearization run
# it on the DTensor; SSY in w space has none and takes the derivative of
# a VJP.
TANGENT_ROUTES = {"ssy_log": "_LocalLinearization",
                  "gcy_log": "_LocalLinearization",
                  "ssy_continuous": "_LocalLinearization",
                  "ssy_w": "VjpLinearization"}


def _tangent_route(P, par, mesh) -> dict:
    """The solvers' tangent on a DTensor (the local form's
    linearization: the operator's own, run on the DTensor, or the
    derivative of a VJP) against the single-device ``torch.func.jvp``,
    for each case of TANGENT_ROUTES: the max abs difference and the
    class of the local twin."""
    import torch
    from sdfs_via_autodiff_tpu_torch.parallel import gspmd
    out = {}
    for name in TANGENT_ROUTES:
        T = gspmd_operator(P, name)
        x = torch.as_tensor(gspmd_field(name))
        rng = np.random.default_rng(11)
        v = torch.as_tensor(rng.standard_normal(tuple(x.shape)))
        xd, vd = par.shard_grid_array(x, mesh), par.shard_grid_array(v, mesh)
        op = gspmd.local_operator(T, xd)
        j_minus_i = op.local_twin.linearize(op.to_local(xd))
        vl = op.to_local(vd)
        jv = op.from_local(j_minus_i(vl) + vl).full_tensor()
        want = torch.func.jvp(T, (x,), (v,))[1]
        out[name] = (float((jv - want).abs().max()),
                     type(op.local_twin).__name__)
    return out


def _hand_placed_vs_automatic(P, par, world) -> dict:
    """JAX's test_shard_map_explicit_matches_gspmd: the h_lam-sharded
    operator of shard_ops against the single-device operator on a
    DTensor with the same placements, (8, 6, 6, 6) on a (world, 1)
    mesh."""
    import torch
    m = P.SSY()
    disc = P.discretize_ssy(m, (8, 6, 6, 6))
    mesh = par.make_mesh(world, shape=(world, 1), device="cpu")
    T_manual = par.T_ssy_shard_map_factory(m, disc, mesh)
    T_auto = P.T_ssy_factory(m, disc, space="log", device="cpu")
    rng = np.random.default_rng(5)
    x = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        (8, 6, 6, 6)))
    from torch.distributed.tensor import distribute_tensor
    xd = distribute_tensor(x, mesh, T_manual.input_sharding)
    a, b = T_auto(xd), T_manual(xd)
    return {"max_abs": float((a.full_tensor() - b.full_tensor())
                             .abs().max()),
            "auto_kept": tuple(a.placements) == T_manual.input_sharding,
            "manual_kept": tuple(b.placements) == T_manual.input_sharding,
            "sharded": not all(p.is_replicate() for p in a.placements)}


def _gspmd_refusals(P, par, world) -> dict:
    """The kernel-backed operators and solvers given a DTensor, and the
    solver options a DTensor iterate does not take: each message."""
    import torch
    mesh = par.make_mesh(world, device="cpu")
    m = P.SSY()
    shapes = (4, 4, 4, 8)
    disc = P.discretize_ssy(m, shapes)
    ops = P.two_phase_operands_ssy(m, disc)
    xd = par.shard_grid_array(torch.full(shapes, 6.7), mesh)
    fused = P.make_fused_T_log_ssy(m, disc, device="cpu")
    grids = P.build_grid_ssy(m, *shapes)
    gcy = P.GCY()
    gshapes = (4, 3, 3, 2, 3, 2)
    calls = {
        "streamed": lambda: P.make_streamed_T_log(ops, device="cpu")(xd),
        "tiled": lambda: P.make_tiled_T_log_ssy(m, disc, device="cpu")(xd),
        "strip": lambda: P.make_tiled_T_log_ssy(
            m, disc, device="cpu", engine="strip")(xd),
        "tiled_gcy": lambda: P.make_tiled_T_log_gcy(
            gcy, P.discretize_gcy(gcy, gshapes), device="cpu")(
                par.shard_grid_array(torch.full(gshapes, 6.0), mesh)),
        "fused": lambda: fused(xd),
        "post_interp": lambda: P.make_post_interp_kernel_T_ssy(
            m, grids, 3, device="cpu")(xd),
        "fused_sa": lambda: P.make_fused_solver_ssy(m, disc, device="cpu")(
            xd),
        "fused_anderson": lambda: P.make_fused_anderson_ssy(
            m, disc, device="cpu")(xd),
        "solve_streamed": lambda: P.solve(P.make_streamed_T_log(
            ops, device="cpu"), xd, method="newton"),
    }
    out = {k: _raises(f) for k, f in calls.items()}
    T = P.T_ssy_factory(m, P.discretize_ssy(m, (8, 8, 4, 4)), space="log",
                        device="cpu")
    x0 = par.shard_grid_array(torch.full((8, 8, 4, 4), 6.7,
                                         dtype=torch.float64), mesh)
    out["dense"] = _raises(lambda: P.solve(T, x0, method="newton",
                                           inner="dense"))
    out["tangent_T"] = _raises(lambda: P.solve(T, x0, method="newton",
                                               tangent_T=T))
    out["gd"] = _raises(lambda: P.solve(T, x0, method="gd"))
    # The twin of a kernel-backed operator takes the DTensor.
    twin = P.make_streamed_T_log(ops, device="cpu").twin
    y = twin(xd)
    out["twin_kept"] = tuple(y.placements) == tuple(xd.placements)
    return out


# The GSPMD solves (world size 4, on each mesh of GSPMD_MESHES unless
# "meshes" says otherwise): JAX's tests/test_sharding.py solves and their
# sizes; the reference is the same solve from the plain start.
GSPMD_SOLVES = {
    "newton": dict(op=("ssy", (8, 8, 4, 4)), method="newton",
                   opts=dict(tol=1e-10)),
    "newton_gmres": dict(op=("ssy", (8, 8, 4, 4)), method="newton",
                         opts=dict(tol=1e-10, inner="gmres",
                                   inner_maxiter=2), meshes=("2x2",)),
    "anderson": dict(op=("ssy", (8, 8, 4, 4)), method="anderson",
                     opts=dict(tol=1e-9)),
    "sa": dict(op=("ssy", (8, 8, 4, 4)), method="successive_approx",
               opts=dict(tol=-1.0, max_iter=24, trace_len=8)),
    "degroot_newton": dict(op=("degroot", (8, 4, 4, 4)), method="newton",
                           opts=dict(tol=1e-11)),
    # No hand linearization in w space: Newton's tangent on the DTensor is
    # the derivative of a VJP.
    "newton_w": dict(op=("ssy_w", (8, 8, 4, 4)), method="newton",
                     opts=dict(tol=1e-8)),
}


def gspmd_solve_operator(P, kind, shapes):
    """(T, x0) of a GSPMD solve: the float64 log-space SSY operator from
    log 800, the w-space one from 800, or de Groot's (h = 0.99) from
    theta log((1 - beta) 800)."""
    import torch
    m = P.SSY()
    disc = P.discretize_ssy(m, shapes)
    if kind == "ssy":
        return (P.T_ssy_factory(m, disc, space="log", device="cpu"),
                torch.full(shapes, float(np.log(800.0)),
                           dtype=torch.float64))
    if kind == "ssy_w":
        return (P.T_ssy_factory(m, disc, space="w", device="cpu"),
                torch.full(shapes, 800.0, dtype=torch.float64))
    return (P.T_degroot_factory(m, disc, space="log", h=0.99, device="cpu"),
            torch.full(shapes, m.theta * float(np.log((1 - m.beta) * 800.0)),
                       dtype=torch.float64))


def implicit_problem(P, sizes=(8, 8, 6, 6)):
    """JAX's test_implicit_gradient_on_sharded_iterate: mean of the
    continuous SSY fixed point (quadrature degree 3, float64 log space)
    as a function of beta; returns (T_of_p, beta0, x0)."""
    import dataclasses
    import torch
    from sdfs_via_autodiff_tpu_torch.operators.continuous_ssy import (
        _factored_T)
    model = P.SSY()
    grids = P.build_grid_ssy(model, *sizes)

    def T_of_p(p, x):
        return _factored_T(dataclasses.replace(model, beta=p["beta"]), grids,
                           3, "log", torch.float64, None, device="cpu")(x)

    return T_of_p, model.beta, torch.full(sizes, float(np.log(800.0)),
                                          dtype=torch.float64)


def _implicit_gradient(P, T_of_p, beta0, x0):
    import torch
    beta = torch.tensor(beta0, dtype=torch.float64, requires_grad=True)
    x = P.implicit_fixed_point(T_of_p, {"beta": beta}, x0, method="newton",
                               tol=1e-10)
    loss = x.mean()
    if hasattr(loss, "full_tensor"):
        loss = loss.full_tensor()
    (g,) = torch.autograd.grad(loss, beta)
    return x, g


def gspmd_solvers(rank: int, world: int) -> dict:
    """Every GSPMD_SOLVES entry from a DTensor start with the
    single-device operator, and from the plain start; and, on one
    device, how far the same solve moves when its start moves by one
    ulp (the spread any other rounding may give)."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import parallel as par
    out = {}
    for case, spec in GSPMD_SOLVES.items():
        T, x0 = gspmd_solve_operator(P, *spec["op"])
        ref = P.solve(T, x0, method=spec["method"], **spec["opts"])
        if case in ("newton", "anderson"):
            up = torch.nextafter(x0, torch.full_like(x0, math.inf))
            moved = P.solve(T, up, method=spec["method"], **spec["opts"])
            out[(case, "ulp_spread")] = float((moved.x - ref.x).abs().max())
        for label in spec.get("meshes", GSPMD_MESHES):
            mesh = _gspmd_mesh(par, world, label)
            xd = par.shard_grid_array(x0, mesh)
            res = P.solve(T, xd, method=spec["method"], **spec["opts"])
            x = res.x.full_tensor()
            r = {"iterations": res.iterations, "converged": res.converged,
                 "residual": res.residual, "ref_iterations": ref.iterations,
                 "ref_converged": ref.converged,
                 "ref_residual": ref.residual,
                 "max_abs_vs_single": float((x - ref.x).abs().max()),
                 "is_dtensor": par.is_dtensor(res.x),
                 "placements_kept": (tuple(res.x.placements)
                                     == tuple(xd.placements)),
                 "sharded": not all(p.is_replicate()
                                    for p in res.x.placements)}
            if res.error_trace is not None:
                r["trace_max_abs"] = float(
                    (res.error_trace - ref.error_trace).abs().max())
            if rank == 0:
                r["x"] = x.numpy()
            out[(case, label)] = r
    return out


def gspmd_implicit(rank: int, world: int) -> dict:
    """The implicit gradient (JAX's test_implicit_gradient_on_sharded_
    iterate) and the implicit sensitivity from a DTensor start, on each
    mesh of GSPMD_MESHES, against the plain start's."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import parallel as par
    out = {}
    T_of_p, beta0, x0 = implicit_problem(P)
    x_ref, g_ref = _implicit_gradient(P, T_of_p, beta0, x0)
    x_ref = x_ref.detach()
    p0 = {"beta": torch.tensor(beta0, dtype=torch.float64)}
    s_ref = P.implicit_sensitivity(T_of_p, p0, {"beta": 1.0}, x_ref,
                                   rtol=1e-10)
    out["ref_grad"] = float(g_ref)
    for label in GSPMD_MESHES:
        mesh = _gspmd_mesh(par, world, label)
        xd = par.shard_grid_array(x0, mesh)
        x, g = _implicit_gradient(P, T_of_p, beta0, xd)
        x = x.detach()
        s = P.implicit_sensitivity(T_of_p, p0, {"beta": 1.0}, x, rtol=1e-10)
        out[label] = {
            "grad": float(g), "grad_is_plain": type(g) is torch.Tensor,
            "x_is_dtensor": par.is_dtensor(x),
            "x_placements_kept": tuple(x.placements) == tuple(xd.placements),
            "x_max_abs": float((x.full_tensor() - x_ref).abs().max()),
            "sens_max_rel": float((s.full_tensor() - s_ref).abs().max()
                                  / s_ref.abs().max()),
            "sens_placements_kept": (tuple(s.placements)
                                     == tuple(xd.placements))}
    return out


def gspmd_world1(rank: int, world: int) -> dict:
    """World size 1 (a 1 x 1 mesh): the operators on a DTensor and SA,
    Anderson and Newton from a DTensor start against the single-device
    ones; and the refusals (``_gspmd_refusals``)."""
    import torch
    import sdfs_via_autodiff_tpu_torch as P
    from sdfs_via_autodiff_tpu_torch import parallel as par
    mesh = par.make_mesh(device="cpu")
    out = {"refusals": _gspmd_refusals(P, par, world)}
    for name in ("ssy_log", "ssy_normalized_f32", "gcy_log",
                 "ssy_continuous", "degroot"):
        T = gspmd_operator(P, name)
        x = torch.as_tensor(gspmd_field(name, getattr(
            T, "baseline_log_w", None)))
        if GSPMD_OPS[name][2].get("dtype") == "float32":
            x = x.float()
        out[name] = bool(torch.equal(T(par.shard_grid_array(x, mesh))
                                     .full_tensor(), T(x)))
    T, x0 = gspmd_solve_operator(P, "ssy", (8, 8, 4, 4))
    for method, opts in (("sa", dict(tol=-1.0, max_iter=24)),
                         ("anderson", dict(tol=1e-9)),
                         ("newton", dict(tol=1e-10))):
        ref = P.solve(T, x0, method=method, **opts)
        res = P.solve(T, par.shard_grid_array(x0, mesh), method=method,
                      **opts)
        x = res.x.full_tensor()
        out[method] = {"equal": bool(torch.equal(x, ref.x)),
                       "max_abs": float((x - ref.x).abs().max()),
                       "iterations": (res.iterations, ref.iterations)}
    out["tangent"] = _world1_tangent_routes(P, par, mesh)
    return out


def _world1_tangent_routes(P, par, mesh) -> dict:
    """At a DTensor start on one rank: the float32 deep windows' own
    linearization (run on the DTensor) against the single-device one,
    and the float32 node chain, whose linearization is single-device,
    on the derivative of a VJP; then a float64 node-chain Newton solve
    from a DTensor start against the single-device solve (on the
    chain's own linearization).  Each: the local twin's class and the
    max abs difference."""
    import torch
    from sdfs_via_autodiff_tpu_torch.parallel import gspmd
    m = P.SSY()
    grids = P.build_grid_ssy(m, 4, 4, 4, 5)
    ops = {"ssy_normalized_f32": gspmd_operator(P, "ssy_normalized_f32"),
           "node_chain_f32": P.T_ssy_continuous_factory(
               m, grids, interp="post", space="log", quad_degree=3,
               dtype=torch.float32, device="cpu")}
    out = {}
    for name, T in ops.items():
        base = getattr(T, "baseline_log_w", None)
        x = (base.clone() if base is not None
             else torch.full((4, 4, 4, 5), float(np.log(700.0))))
        v = torch.as_tensor(np.random.default_rng(8).standard_normal(
            tuple(x.shape)), dtype=torch.float32)
        xd, vd = par.shard_grid_array(x, mesh), par.shard_grid_array(v, mesh)
        op = gspmd.local_operator(T, xd)
        jv = op.from_local(op.local_twin.linearize(op.to_local(xd))(
            op.to_local(vd))).full_tensor()
        want = T.linearize(x)(v)
        out[name] = (type(op.local_twin).__name__,
                     float((jv - want).abs().max() / v.abs().max()))
    T = P.T_ssy_continuous_factory(m, grids, interp="post", space="log",
                                   quad_degree=3, device="cpu")
    x0 = torch.full((4, 4, 4, 5), float(np.log(700.0)), dtype=torch.float64)
    res = P.solve(T, par.shard_grid_array(x0, mesh), method="newton",
                  tol=1e-11)
    ref = P.solve(T, x0, method="newton", tol=1e-11)
    out["node_chain_newton"] = (
        type(gspmd.local_operator(T, par.shard_grid_array(
            x0, mesh)).local_twin).__name__,
        float((res.x.full_tensor() - ref.x).abs().max()),
        bool(res.converged and ref.converged))
    return out
