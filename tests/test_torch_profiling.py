"""Profiling and chunked stepping: the port's ``utils/profiling.py``
against the JAX package's on the CPU, and ``utils/graphs.run_chunks``
with the chunked simulation around it.

``timed_solve`` keeps JAX's ``TimedSolve`` fields and arithmetic; on
the same float64 operator its solve agrees with JAX's to 1e-10 on the
fixed point (successive approximation: the same iteration count).
``trace`` writes a Chrome trace that names the operations it saw.  The
chunked simulation (chunks of ``SIM_CHUNK`` steps, the last partial) is
the plain step loop's path bit for bit on the CPU; on the card the
replayed CUDA graphs are held to the loop in
``tests/test_torch_gpu_kernels.py``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.utils import profiling as JPR
from sdfs_via_autodiff_tpu_torch.sdf import simulate as sim
from sdfs_via_autodiff_tpu_torch.utils import graphs as graphs_mod
from sdfs_via_autodiff_tpu_torch.utils import profiling as PR
from sdfs_via_autodiff_tpu_torch.utils.graphs import run_chunks

SHAPES = (4, 4, 4, 6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_timed_solve_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(PR.TimedSolve)]
            == [f.name for f in dataclasses.fields(JPR.TimedSolve)])


@pytest.mark.parametrize("warm_up", [True, False])
def test_timed_solve_matches_jax(warm_up):
    pd = P.discretize_ssy(P.SSY(), SHAPES)
    T = P.T_ssy_factory(P.SSY(), pd, space="log", device="cpu")
    x0 = torch.full(SHAPES, float(np.log(800.0)), dtype=torch.float64)
    ts = PR.timed_solve(P.solve, T, x0, warm_up=warm_up,
                        method="successive_approx", tol=1e-9)
    jd = J.discretize_ssy(J.SSY(), SHAPES)
    Tj = J.T_ssy_factory(J.SSY(), jd, space="log")
    tj = JPR.timed_solve(J.solve, Tj, jnp.asarray(x0.numpy()),
                         warm_up=warm_up, method="successive_approx",
                         tol=1e-9)
    assert ts.result.converged and ts.result.iterations == int(
        tj.result.iterations)
    np.testing.assert_allclose(ts.result.x.numpy(), np.asarray(tj.result.x),
                               rtol=0, atol=1e-10)
    assert ts.wall_seconds > 0
    assert (ts.compile_seconds is None) == (not warm_up)
    if warm_up:
        assert ts.compile_seconds >= 0.0
    np.testing.assert_allclose(
        ts.points_per_second,
        np.prod(SHAPES) * ts.result.iterations / ts.wall_seconds)
    assert "point-updates/s" in str(ts)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    a = torch.randn(64, 64, dtype=torch.float64)
    with PR.trace(log_dir) as prof:
        (a @ a).sum()
    path = os.path.join(log_dir, PR.TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def test_trace_is_written_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "prof")
    with pytest.raises(ZeroDivisionError):
        with PR.trace(log_dir):
            torch.ones(3).sum()
            raise ZeroDivisionError
    assert os.path.exists(os.path.join(log_dir, PR.TRACE_FILE))


def test_run_chunks_calls_in_order():
    log = []
    run_chunks(lambda: log.append("run"), 3,
               before=lambda c: log.append(("before", c)),
               after=lambda c: log.append(("after", c)))
    assert log == [("before", 0), "run", ("after", 0),
                   ("before", 1), "run", ("after", 1),
                   ("before", 2), "run", ("after", 2)]


@pytest.mark.parametrize("model,steps", [(P.SSY(), sim.SIM_CHUNK * 2 + 37),
                                         (P.GCY(), 5)])
def test_chunked_simulation_is_the_step_loop(model, steps, monkeypatch):
    # Full chunks and a partial last one (or a single short chunk): the
    # path equals a plain loop of next_state steps bit for bit, and the
    # graph switch changes nothing on the CPU.
    step, dim = sim._next_state_for(model)
    rng = np.random.default_rng(0)
    shocks = rng.standard_normal((steps, dim))
    x0 = 0.01 * rng.standard_normal(dim)
    got = P.simulate_states(model, steps, x0=x0, shocks=shocks, device="cpu")
    monkeypatch.setattr(graphs_mod, "_ENABLED", False)
    same = P.simulate_states(model, steps, x0=x0, shocks=shocks,
                             device="cpu")
    x = torch.as_tensor(x0)
    want = []
    for t in range(steps):
        x = step(x, torch.as_tensor(shocks[t]))
        want.append(x)
    assert tuple(got.shape) == (dim, steps)
    assert torch.equal(got, torch.stack(want).T) and torch.equal(got, same)


def test_simulate_does_not_write_the_callers_start():
    x0 = torch.full((4,), 0.01, dtype=torch.float64)
    P.simulate_states(P.SSY(), 10, x0=x0, device="cpu")
    assert bool((x0 == 0.01).all())
