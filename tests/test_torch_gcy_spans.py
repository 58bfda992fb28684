"""The port's spans on the six-state GCY tiled path: the natural-layout
crossings (``sdfs.layout``) on every primal application and every
tangent matvec, pass B and pass C inside each primal application
(``sdfs.primal.b``, ``sdfs.primal.c``) and the count of applications
that ran the deferred configuration (``sdfs.primal.deferred``), on
small Newton solves on the CPU; the solve reads the same with the
recorder on and off."""

from collections import Counter

import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.utils import profiling as prof

# (30, 8, 16, 2, 8, 2): view (2, 2, 240, 128), the deferred
# configuration, as at the 25.2M-state grid; (16, 8, 8, 4, 8, 4): view
# (4, 4, 128, 64), the full one.
GRIDS = {"deferred": (30, 8, 16, 2, 8, 2), "full": (16, 8, 8, 4, 8, 4)}


@pytest.fixture(autouse=True)
def _recorder_off():
    prof.set_recording(False)
    prof.records()
    yield
    prof.set_recording(False)
    prof.records()


def _solve(shapes):
    m = P.GCY()
    return P.wc_ratio_discrete(m, shapes, kernel="tiled", device="cpu",
                               tol=1.2 * P.f32_tol_floor(m.theta))


@pytest.mark.parametrize("config", sorted(GRIDS))
def test_layout_and_pass_spans_of_a_gcy_newton_solve(config):
    shapes = GRIDS[config]
    disc = P.discretize_gcy(P.GCY(), shapes)
    assert P.streamed_config(P.two_phase_operands_gcy(P.GCY(), disc)) == \
        config
    with prof.recorded() as recs:
        on = _solve(shapes)
    off = _solve(shapes)
    assert on.converged and off.converged
    assert on.result.iterations == off.result.iterations
    assert torch.equal(on.w_star, off.w_star)

    by_id = {r.id: r for r in recs}
    names = Counter(r.name for r in recs)
    children = Counter((by_id[r.parent].name if r.parent else None, r.name)
                       for r in recs)
    n_primal, n_matvec = names["sdfs.primal"], names["sdfs.tangent.matvec"]
    n_build = names["sdfs.tangent.build"]
    assert n_primal > 0 and n_matvec > n_build > 0
    # Pass B and pass C once inside each primal application.
    for part in ("sdfs.primal.b", "sdfs.primal.c"):
        assert names[part] == children[("sdfs.primal", part)] == n_primal
    deferred = sum(r.count for r in recs if r.name == "sdfs.primal.deferred")
    assert deferred == (n_primal if config == "deferred" else 0)
    # Into the view and out of it on every tangent matvec (the tape's
    # replay), in every build's primal and around every primal
    # application; the view twin's chain is one fused step, whose last
    # factor stays inside it (no factor pending at the crossing out).
    per_matvec = Counter(r.parent for r in recs if r.name == "sdfs.layout"
                         and by_id[r.parent].name == "sdfs.tangent.matvec")
    assert len(per_matvec) == n_matvec
    assert set(per_matvec.values()) == {2}
    assert children[("sdfs.tangent.build", "sdfs.layout")] == 2 * n_build
    outside = names["sdfs.layout"] - 2 * n_matvec - 2 * n_build
    assert outside == 2 * n_primal
