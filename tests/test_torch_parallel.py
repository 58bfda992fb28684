"""``parallel/`` on ``torch.distributed``: the port against the JAX package.

Each world size (2 and 4) is one spawn of gloo ranks on the CPU
(``torch_ranks.spawn``) that runs every case of ``torch_ranks.CASES``
for it, plus the mesh functions, the collective log and the refusals;
the tests below read its results, one case each.  The JAX side runs
the same factory on a JAX mesh of the same shape over its first virtual
CPU devices (``tests/conftest.py``), with Pallas in interpret mode.

Tolerances: the float64 factories 1e-13 (absolute, fields near 6.7),
as JAX's ``test_sharded_operator_matches_single_device``.  The streamed
float32 factory is held bitwise to the port's single-device operator
(its per-row and per-column math is the single-device kernels'), where
JAX's ``TestStreamedShardMap`` holds its own to 1e-6; against JAX's
sharded operator it is held to 5e-6, the bound of the single-device
operators against each other (``tests/test_torch_streamed_two_phase.py``:
CPU expf/logf against the JAX package's software float32
transcendentals and other sum orders; up to 2.4e-6, five float32 ulps
at 6.7, measured here).
"""

import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import sdfs_via_autodiff_tpu as J
import torch_ranks as tr
from sdfs_via_autodiff_tpu.operators import two_phase as jtp
from sdfs_via_autodiff_tpu.parallel import mesh as jmesh
from sdfs_via_autodiff_tpu.parallel import shard_ops as jso

JNS = types.SimpleNamespace(
    SSY=J.SSY, GCY=J.GCY, discretize_ssy=J.discretize_ssy,
    discretize_gcy=J.discretize_gcy, build_grid_ssy=J.build_grid_ssy,
    build_grid_gcy=J.build_grid_gcy,
    two_phase_operands_ssy=jtp.two_phase_operands_ssy,
    two_phase_operands_ssy_continuous=jtp.two_phase_operands_ssy_continuous,
    two_phase_operands_gcy=jtp.two_phase_operands_gcy,
    two_phase_operands_gcy_continuous=jtp.two_phase_operands_gcy_continuous)
F64_ATOL, F32_ATOL = 1e-13, 5e-6
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, by world size."""
    return {w: tr.spawn("parallel_cases", w) for w in WORLDS}


def _jax_apply(case):
    spec = tr.CASES[case]
    n = spec["mesh"][0] * spec["mesh"][1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(spec["mesh"]),
                spec.get("names", ("dp", "tp")))
    ops = tr.operand_set(JNS, spec["recipe"])
    x = tr.field(case, ops)
    if spec["factory"] == "tssy":
        T = jso.T_ssy_shard_map_factory(*ops, mesh)
    elif spec["factory"] == "two_phase":
        T = jso.two_phase_shard_map_factory(ops, mesh, dtype=jnp.float64)
    else:
        T = jso.streamed_shard_map_factory(ops, mesh, interpret=True,
                                           **spec.get("kw", {}))
        x = x.astype(np.float32)
    return np.asarray(T(jax.device_put(jnp.asarray(x), T.input_sharding)),
                      np.float64)


@pytest.mark.parametrize("case", sorted(tr.CASES))
def test_factory_matches_jax(ranks, case):
    spec = tr.CASES[case]
    got = ranks[spec["world"]][0][case]["out"]
    want = _jax_apply(case)
    assert got.shape == want.shape
    atol = F32_ATOL if spec["factory"] == "streamed" else F64_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("case", sorted(tr.CASES))
def test_factory_matches_the_single_device_operator(ranks, case):
    spec = tr.CASES[case]
    for r in ranks[spec["world"]]:
        res = r[case]
        assert res["dtensor_input_equal"]
        if spec["factory"] == "streamed":
            assert res["single_equal"], res["single_max_abs"]
        else:
            assert res["single_max_abs"] <= F64_ATOL


def _field_elems(case):
    spec = tr.CASES[case]
    ops = tr.operand_set(JNS, spec["recipe"])
    shapes = (ops[1].shapes if spec["factory"] == "tssy"
              else (ops[0] if isinstance(ops, list) else ops).shapes)
    return int(np.prod(shapes))


@pytest.mark.parametrize("case", [c for c in sorted(tr.CASES)
                                  if tr.CASES[c]["factory"] != "streamed"])
def test_cross_shard_contractions_are_reduce_scatters(ranks, case):
    # One reduce-scatter per sharded row axis (two for the two-phase
    # operator, one for the h_lam-sharded SSY operator), one shift
    # all-reduce per such axis of more than one rank (on one rank the
    # shift is the rank's own), and no all-gather of the field.
    spec = tr.CASES[case]
    sizes = spec["mesh"] if spec["factory"] == "two_phase" else \
        spec["mesh"][:1]
    n_rs, n_ar = len(sizes), sum(n > 1 for n in sizes)
    for r in ranks[spec["world"]]:
        calls = Counter(c[0] for c in r[case]["calls"])
        assert calls == {"reduce_scatter_tensor": n_rs, "all_reduce": n_ar}


@pytest.mark.parametrize("case", [c for c in sorted(tr.CASES)
                                  if tr.CASES[c]["factory"] == "streamed"])
def test_streamed_application_is_two_all_to_alls(ranks, case):
    spec = tr.CASES[case]
    n = _field_elems(case)
    for r in ranks[spec["world"]]:
        res = r[case]
        calls = Counter(c[0] for c in res["calls"])
        want = {"all_to_all_single": 2}
        if res["mode"] == "fast":
            # The global shift S and the per-row scales.
            want.update(all_reduce=1, all_gather_tensor=1)
        assert calls == want
        gathers = [c[2] for c in res["calls"] if c[0] == "all_gather_tensor"]
        assert all(g < n // 8 for g in gathers)


@pytest.mark.parametrize("case", [c for c in sorted(tr.CASES)
                                  if tr.CASES[c]["factory"] == "streamed"])
def test_streamed_local_twin_linearizes_like_its_jvp(ranks, case):
    # Newton's tangent on each rank's shard (one sweep member per slice
    # under batch_axis), relative to sup |v| as in test_torch_linearize.
    for r in ranks[tr.CASES[case]["world"]]:
        assert r[case]["linearize_rel_v"] <= 2e-6


@pytest.mark.parametrize("case", [c for c in sorted(tr.CASES)
                                  if tr.CASES[c]["factory"] != "streamed"])
def test_float64_local_linearizes_like_its_jvp(ranks, case):
    # Newton's tangent on each rank's shard, built once per step: within
    # 1e-13 of torch.func.jvp of T.local and, gathered, of the
    # single-device operator's linearization.
    for r in ranks[tr.CASES[case]["world"]]:
        assert r[case]["linearize_abs"] <= F64_ATOL
        assert r[case]["linearize_vs_single"] <= F64_ATOL


@pytest.mark.parametrize("case", ["streamed_dcn_2x2", "streamed_sweep_2x2"])
def test_no_collective_crosses_the_slice_axis(ranks, case):
    # Mesh ("slice", "tp") of shape (2, 2): slice s holds ranks 2s, 2s+1.
    for r in ranks[tr.CASES[case]["world"]]:
        calls = r[case]["calls"]
        assert len(calls) >= 2
        for name, group, _ in calls:
            assert len({g // 2 for g in group}) == 1, (name, group)
            assert len(group) == 2


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_matches_jax(ranks, world):
    res = ranks[world][0]["mesh"]
    want = jmesh.make_mesh(world)
    assert res["default_shape"] == tuple(want.shape.values())
    assert res["names"] == tuple(want.axis_names)
    assert res["tall"] == (world, 1)
    assert "requested" in res["too_many"]
    assert "!= device count" in res["bad_shape"]
    assert ranks[world][0]["num_devices"] == world
    spec = jmesh.grid_sharding(want, 4).spec
    shards = [f"Shard(dim={d})" for d, a in enumerate(spec) if a is not None]
    assert res["grid_sharding"].count("Shard") == len(shards)
    for s in shards:
        assert s in res["grid_sharding"]
    assert res["replicated"].count("Replicate") == 2
    local = list((8, 4, 3, 2))
    for d, a in enumerate(spec):
        if a is not None:
            local[d] //= want.shape[a]
    assert res["shard_local_shape"] == tuple(local)
    assert res["shard_roundtrip"]


@pytest.mark.parametrize("world", WORLDS)
def test_flattened_axes_make_their_groups_once(ranks, world):
    for rank, r in enumerate(ranks[world]):
        res = r["groups"]
        assert res["made_first"] == 2          # one per sub-mesh
        assert res["made_after"] == 0
        assert res["reused"]
        half = world // 2
        assert res["sub_ranks"] == tuple(range(rank // half * half,
                                               (rank // half + 1) * half))
        assert res["whole_is_default"]


REFUSALS = {
    "indivisible_streamed": "divisible by the mesh size",
    "indivisible_two_phase": "not divisible by mesh",
    "indivisible_tssy": "not divisible by mesh axis",
    "sweep_theta": "share theta",
    "sweep_structure": "share operand structure",
    "sweep_needs_batch_axis": "requires batch_axis",
    "batch_size": "one member per",
    "no_intra_axis": "intra-slice",
    "f64_streamed": "float32 tier",
    "pair_two_phase": "pair-factored",
    "tpu_option": "TPU-only",
    "pair_hz": "n_hz = 2 divisible",
    "layout": "deferred pass B has no layout",
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_factories_refuse(ranks, name):
    for r in ranks[4]:
        assert REFUSALS[name] in r["refusals"][name]
