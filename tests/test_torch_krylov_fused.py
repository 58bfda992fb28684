"""BiCGStab as five fused passes (``solvers/krylov.bicgstab_fused``,
``kernels/krylov_fused.py``, ``kernels/csrc/krylov_fused.cu``).

On the CPU: ``bicgstab_mixed`` runs the eager loop and records no
``sdfs.krylov.fused``, a strided right-hand side included; the passes
refuse vectors their kernels cannot read; the scalar block's slots
mirror the .cu's; the benchmark's two Krylov readers.

Marked ``gpu`` (skipped without a card): the CUDA passes against the
eager loop on the card, on every exit (convergence, ``maxiter`` inside
and at the end of a chunk, ``atol = inf``, a degenerate alpha, a half
step), with a start and a tensor ``atol``, in both dtypes and at offset
and strided right-hand sides; bitwise repeats; the sharded schedule at
world size 1; the SSY tangent; a Newton solve.  They differ from the
eager loop only in the summation order of the float64 dots.  This file
imports neither JAX nor the JAX package, so on a GPU machine without JAX
it runs with ``python -m pytest --noconftest -m gpu
tests/test_torch_krylov_fused.py``.
"""

import math
import re
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.kernels import krylov_fused as kf
from sdfs_via_autodiff_tpu_torch.solvers import krylov
from sdfs_via_autodiff_tpu_torch.solvers.sharding import (LOCAL, Reductions,
                                                           tangent_matvec)
from sdfs_via_autodiff_tpu_torch.utils import profiling as prof

ROOT = Path(__file__).resolve().parent.parent
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prof.set_recording(False)
    prof.records()
    yield
    prof.set_recording(False)
    prof.records()
    torch.set_num_threads(n)


def tridiagonal(n, dtype, device, diag=3.0, seed=0):
    """A diagonally dominant nonsymmetric tridiagonal matvec (periodic),
    and a right-hand side."""
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(diag + rng.random(n), dtype=dtype, device=device)
    b = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
    return (lambda v: d * v + 0.9 * torch.roll(v, 1)
            - 0.7 * torch.roll(v, -1)), b


def _eager(monkeypatch, *args, **kw):
    """``bicgstab_mixed`` with the fused passes switched off."""
    with monkeypatch.context() as m:
        m.setattr(kf, "fusable", lambda b: False)
        return krylov.bicgstab_mixed(*args, **kw)


# Each case: (matvec, right-hand side, solver options), at n.
def _case(name, n, dtype, device):
    mv, b = tridiagonal(n, dtype, device)
    norm = float(torch.linalg.vector_norm(b.double()))
    if name == "converge":
        return mv, b, dict(atol=1e-6 * norm, maxiter=200)
    if name == "chunks":           # weaker dominance: several chunks
        mv, b = tridiagonal(n, dtype, device, diag=1.62)
        return mv, b, dict(atol=1e-9 * norm, maxiter=200)
    if name == "maxiter_inside_chunk":
        return mv, b, dict(atol=0.0, maxiter=5)
    if name == "maxiter_at_chunk_end":
        return mv, b, dict(atol=0.0, maxiter=8)
    if name == "atol_inf":
        return mv, b, dict(atol=math.inf, maxiter=50)
    if name == "degenerate_alpha":     # A = 0: rv = 0 freezes at x = 0
        return torch.zeros_like, b, dict(atol=1e-6 * norm, maxiter=20)
    if name == "half_step":            # A = 2 I: s = 0 after the half step
        return (lambda v: 2.0 * v), b, dict(atol=1e-6 * norm, maxiter=20)
    if name == "start":
        return mv, b, dict(atol=1e-6 * norm, maxiter=200,
                           x0=torch.ones_like(b))
    if name == "tensor_atol":          # Newton's form: a 0-d device tensor
        return mv, b, dict(atol=torch.tensor(1e-6 * norm, dtype=torch.float64,
                                             device=device), maxiter=200)
    raise KeyError(name)


def _close(x_f, x_e, rel):
    scale = float(x_e.abs().max())
    err = float((x_f - x_e).abs().max())
    assert err <= rel * scale, (err, scale)


CASES = ["converge", "chunks", "maxiter_inside_chunk", "maxiter_at_chunk_end",
         "atol_inf", "degenerate_alpha", "half_step", "start", "tensor_atol"]


# ------------------------------------------------------------------ CPU

def test_cpu_vectors_take_the_eager_loop_and_record_no_fused_count():
    mv, b = tridiagonal(101, torch.float32, "cpu")
    assert not kf.fusable(b)
    with prof.recorded() as recs:
        _, n = krylov.bicgstab_mixed(mv, b, atol=1e-6, maxiter=100)
    names = [r.name for r in recs]
    assert "sdfs.krylov.fused" not in names
    assert [r.count for r in recs if r.name == "sdfs.krylov"] == [n] and n > 0


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-5), ("f64", 1e-12)])
def test_cpu_strided_right_hand_side_takes_the_eager_loop(dtype, rel):
    """Every second entry of a buffer: the eager loop's result on the
    dense copy, up to the dots' summation order over a strided vector."""
    mv, b = tridiagonal(1003, DTYPES[dtype], "cpu")
    buf = torch.zeros(2 * b.numel(), dtype=b.dtype)
    buf[::2] = b
    strided = buf[::2]
    assert not strided.is_contiguous() and not kf.fusable(strided)
    with prof.recorded() as recs:
        x_s, n_s = krylov.bicgstab_mixed(mv, strided, atol=1e-6, maxiter=100)
    x_c, n_c = krylov.bicgstab_mixed(mv, b, atol=1e-6, maxiter=100)
    assert n_s == n_c > 0
    _close(x_s, x_c, rel)
    assert not any(r.name == "sdfs.krylov.fused" for r in recs)


def _refused(case):
    x = torch.zeros(1003)
    if case == "cpu":
        return (x, x.clone(), x.clone(), x.clone()), "x"
    if case == "float16":
        h = x.half()
        return (h, h.clone(), h.clone(), h.clone()), "x"
    if case == "length":
        return (x, x.clone(), torch.zeros(1002), x.clone()), "p"
    if case == "strided":
        return (x, x.clone(), x.clone(), torch.zeros(2006)[::2]), "rhat"
    if case == "dtype":
        return (x, x.double(), x.clone(), x.clone()), "r"
    if case == "two_d":
        return (x.reshape(17, 59), x.clone(), x.clone(), x.clone()), "x"
    raise KeyError(case)


@pytest.mark.parametrize("case", ["cpu", "float16", "length", "strided",
                                  "dtype", "two_d"])
def test_passes_refuse_vectors_the_kernels_cannot_read(case):
    """The kernels read each vector as dense entries of one float dtype
    on one card: anything else is refused before a launch (and before
    the library loads)."""
    vecs, name = _refused(case)
    with pytest.raises(ValueError, match=f"^fused Krylov passes: {name} "):
        kf.Passes(*vecs, LOCAL)


def test_scalar_slots_mirror_the_kernel_source():
    src = (ROOT / "sdfs_via_autodiff_tpu_torch/kernels/csrc/"
           "krylov_fused.cu").read_text()
    body = re.search(r"enum Slot \{(.*?)\};", src, re.S).group(1)
    names = [w.strip() for w in body.replace("\n", " ").split(",")]
    camel = lambda s: "k" + "".join(p.capitalize() for p in s.split("_"))
    assert names == [camel(s) for s in kf.SLOTS] + ["kSlots"]


def test_krylov_readers_on_a_tiny_harness_run(tmp_path):
    """On CPU vectors (the eager loop) both Krylov readers are silent:
    ``krylov_fused_share`` finds no ``sdfs.krylov.fused`` count and
    ``krylov_vector_ms`` no device trace; ``krylov_iters`` reads."""
    import test_torch_spans as ts
    eager = ts._run(ts._catalog(tmp_path / "eager", "newton"),
                    ts.SEED_UNTRACED)
    assert eager["krylov_iters"] > 0
    assert "krylov_fused_share" not in eager
    assert "krylov_vector_ms" not in eager


def test_krylov_fused_share_counts_the_fused_iterations_of_the_window():
    from collections import namedtuple

    from wcbench.catalog import load
    from wcbench.spans import Spans
    reader = load(ROOT / "BENCHMARK.json", ROOT / "wcbench").metric(
        "krylov_fused_share")
    Rec = namedtuple("Rec", "name start_ns end_ns count")

    class Run:
        spans = Spans()
    Run.spans.records["wcbench.solve"] = [(0, 0.0, 1.0, None),
                                          (1, 1.0, 2.0, None)]
    krylov_recs = [Rec("sdfs.krylov", 1e8, 2e8, 40),
                   Rec("sdfs.krylov", 1.1e9, 1.2e9, 30),
                   Rec("sdfs.krylov", 1.3e9, 1.4e9, 30),
                   Rec("sdfs.krylov", 5e9, 6e9, 99)]    # outside the window
    Run.port_records = krylov_recs + [Rec("sdfs.krylov.fused", 1e8, 2e8, 40),
                                      Rec("sdfs.krylov.fused", 1.1e9, 1.2e9,
                                          30)]
    assert reader.read(Run) == pytest.approx(0.7)
    Run.port_records = krylov_recs
    assert reader.read(Run) is None


def test_krylov_vector_ms_subtracts_the_matvecs_over_the_iterations():
    from wcbench.catalog import load
    from wcbench.spans import Spans
    reader = load(ROOT / "BENCHMARK.json", ROOT / "wcbench").metric(
        "krylov_vector_ms")

    class Trace:
        def device_seconds(self, name):
            return {"port.krylov": 0.5, "port.tangent.matvec": 0.3}[name]

    class Run:
        spans, trace, traced = Spans(), Trace(), {1}
    Run.spans.records["port.krylov"] = [(0, 0.0, 1.0, 7), (1, 1.0, 2.0, 60),
                                        (1, 2.0, 3.0, 40), (1, 3.0, 4.0, 0)]
    assert reader.read(Run) == pytest.approx(1e3 * 0.2 / 100)
    Run.trace = None
    assert reader.read(Run) is None


# ------------------------------------------------------------------ card

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "offset", "strided"])
@pytest.mark.parametrize("dtype,rel", [("f32", 1e-5), ("f64", 1e-12)])
@pytest.mark.parametrize("case", CASES)
def test_cuda_passes_match_the_eager_loop(cuda, monkeypatch, case, dtype,
                                          rel, layout):
    """At n = 1,000,003 (no vector width or block size divides it).  The
    offset right-hand side starts one entry into a buffer, which sends
    every pass to its scalar loads; the strided one is every second
    entry of a buffer, which the fused solve copies to dense vectors."""
    mv, b, opts = _case(case, 1_000_003, DTYPES[dtype], cuda)
    if layout == "offset":
        buf = torch.empty(b.numel() + 1, dtype=b.dtype, device=cuda)
        buf[1:] = b
        b = buf[1:]
        assert b.data_ptr() % 16
    elif layout == "strided":
        buf = torch.zeros(2 * b.numel(), dtype=b.dtype, device=cuda)
        buf[::2] = b
        b = buf[::2]
        assert not b.is_contiguous()
    x_e, n_e = _eager(monkeypatch, mv, b, **opts)
    before = dict(kf.LAUNCHES)
    with prof.recorded() as recs:
        x_f, n_f = krylov.bicgstab_mixed(mv, b, **opts)
    assert n_f == n_e
    _close(x_f, x_e, rel)
    chunks = math.ceil(n_f / krylov.SYNC_EVERY)
    assert kf.LAUNCHES["krylov_pass"] - before["krylov_pass"] == \
        1 + 5 * krylov.SYNC_EVERY * chunks
    assert kf.LAUNCHES["krylov_epilogue"] == before["krylov_epilogue"]
    assert [r.count for r in recs if r.name == "sdfs.krylov.fused"] == [n_f]
    assert [r.count for r in recs if r.name == "sdfs.krylov"] == [n_f]
    if case in ("atol_inf", "degenerate_alpha"):
        assert not x_f.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_passes_repeat_bitwise(cuda, dtype):
    mv, b, opts = _case("chunks", 1_000_003, DTYPES[dtype], cuda)
    x1, n1 = krylov.bicgstab_mixed(mv, b, **opts)
    x2, n2 = krylov.bicgstab_mixed(mv, b, **opts)
    assert n1 == n2 > krylov.SYNC_EVERY and torch.equal(x1, x2)


@pytest.mark.gpu
def test_cuda_passes_on_a_sharded_iterate(cuda):
    """A world-size-1 NCCL group: every reducing pass leaves its sums for
    the all-reduce and the epilogue launch; the result is the local fused
    solve's bitwise."""
    mv, b, opts = _case("chunks", 1_000_003, torch.float32, cuda)
    x_l, n_l = krylov.bicgstab_mixed(mv, b, **opts)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        before = kf.LAUNCHES["krylov_epilogue"]
        x_s, n_s = krylov.bicgstab_mixed(mv, b, red=Reductions(
            dist.group.WORLD), **opts)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert n_s == n_l and torch.equal(x_s, x_l)
    chunks = math.ceil(n_s / krylov.SYNC_EVERY)
    assert kf.LAUNCHES["krylov_epilogue"] - before == \
        1 + 4 * krylov.SYNC_EVERY * chunks


def _ssy_tangent(shapes, dev):
    m = P.SSY()
    T = P.make_tiled_T_log_ssy(m, P.discretize_ssy(m, shapes,
                                                   method="tauchen"),
                               device=dev)
    x = torch.full(shapes, math.log(800.0), device=dev)
    rhs = T(x) - x
    jac = tangent_matvec(getattr(T, "twin", T), x)
    atol = (1e-4 * torch.linalg.vector_norm(rhs)).to(torch.float64)
    return jac, rhs, atol


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [(8, 8, 16, 64), (32, 32, 32, 384)])
def test_cuda_passes_on_the_ssy_tangent(cuda, monkeypatch, shapes):
    """Newton's first inner solve at the SSY Tauchen grids (12.6M states
    the benchmark's cell) from w = 800: the two loops' iterates part by
    float32 rounding of the steps as the dots' order moves the scalars."""
    jac, rhs, atol = _ssy_tangent(shapes, cuda)
    x_e, n_e = _eager(monkeypatch, jac, rhs, atol=atol, maxiter=50)
    x_f, n_f = krylov.bicgstab_mixed(jac, rhs, atol=atol, maxiter=50)
    assert abs(n_f - n_e) <= 1 and n_f > 0
    _close(x_f, x_e, 1e-3)


@pytest.mark.gpu
def test_cuda_newton_solve_matches_the_eager_inner_loop(cuda, monkeypatch):
    solve = lambda: P.wc_ratio_discrete(P.SSY(), (8, 8, 16, 64),
                                        algorithm="newton", tol=2e-5,
                                        kernel="tiled", device=cuda)
    with monkeypatch.context() as m:
        m.setattr(kf, "fusable", lambda b: False)
        eager = solve()
    with prof.recorded() as recs:
        fused = solve()
    assert fused.converged and eager.converged
    assert fused.result.iterations == eager.result.iterations
    _close(fused.w_star, eager.w_star, 1e-5)
    counts = lambda name: sum(r.count or 0 for r in recs if r.name == name)
    assert counts("sdfs.krylov.fused") == counts("sdfs.krylov") > 0
