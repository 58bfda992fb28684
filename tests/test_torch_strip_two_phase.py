"""The port's strip tier vs the JAX package's strip kernels, on the CPU.

The JAX strip kernels (``make_tiled_T_log(..., engine="strip")``) run in
interpret mode, as the JAX package's own tests run them; the port's
strip operator runs its plain versions for CPU tensors.  Operand sets
cross via ``interop``.  Tolerance: 5e-6 abs on log T(w) near log(800)
(float32, sums in another order, torch's exp/log against the JAX
package's software transcendentals), as in
``test_torch_streamed_two_phase.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import tiled_two_phase as jtt
from sdfs_via_autodiff_tpu.operators import two_phase as jtp
from sdfs_via_autodiff_tpu_torch.kernels import tiled_two_phase as tt

ATOL = 5e-6
GCY_SHAPES = (6, 5, 4, 3, 4, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module and its module-scoped fixtures
    (see ``test_torch_deferred_two_phase.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crossed(jops):
    d = dataclasses.asdict(jops)
    for a in ("perm", "inv_perm", "state_shapes", "lazy_c1", "lazy_c2",
              "dense_placeholder"):
        if hasattr(jops, a):
            d[a] = getattr(jops, a)
    return P.operands_from_numpy(d)


def _jax_set(name, shapes, method, baseline):
    if name == "ssy":
        m = J.SSY()
        return jtp.two_phase_operands_ssy(
            m, J.discretize_ssy(m, shapes, method=method), baseline=baseline)
    m = J.GCY()
    return jtp.two_phase_operands_gcy(
        m, J.discretize_gcy(m, shapes, method=method), baseline=baseline)


def _field(jops, seed=0):
    rng = np.random.default_rng(seed)
    base = (np.log(800.0) if jops.baseline_log_w is None
            else np.asarray(jops.baseline_log_w))
    return (base + 0.02 * rng.standard_normal(jops.shapes)).astype(
        np.float32)


# (model, shapes, method, baseline, lazy_bytes, mode): shared factors,
# dense-batched (the default lazy_bytes at these sizes) and lazy rank 1
# (SSY) and rank 2 (GCY) ones (lazy_bytes 0), with and without the fold.
CASES = [
    ("ssy", (4, 5, 6, 7), "rouwenhorst", None, None, "lse"),
    ("ssy", (4, 5, 6, 7), "rouwenhorst", None, None, "fast"),
    ("ssy", (4, 5, 6, 7), "rouwenhorst", "loglinear", None, "lse"),
    ("ssy", (4, 5, 6, 7), "rouwenhorst", "loglinear", None, "fast"),
    ("ssy", (6, 5, 6, 16), "rouwenhorst", "loglinear", 0, "lse"),
    ("ssy", (6, 5, 6, 16), "rouwenhorst", "loglinear", 0, "fast"),
    ("gcy", GCY_SHAPES, "rouwenhorst", None, None, "lse"),
    ("gcy", GCY_SHAPES, "rouwenhorst", "loglinear", None, "lse"),
    ("gcy", GCY_SHAPES, "rouwenhorst", "loglinear", 0, "lse"),
    ("gcy", GCY_SHAPES, "tauchen", None, None, "fast"),
    ("gcy", GCY_SHAPES, "tauchen", "loglinear", None, "fast"),
    ("gcy", GCY_SHAPES, "tauchen", "loglinear", 0, "lse"),
]


@pytest.mark.parametrize("name,shapes,method,baseline,lazy_bytes,mode",
                         CASES)
def test_strip_operator_matches_jax_strip_kernels(name, shapes, method,
                                                  baseline, lazy_bytes,
                                                  mode):
    jops = _jax_set(name, shapes, method, baseline)
    lb = {} if lazy_bytes is None else {"lazy_bytes": lazy_bytes}
    jT = jtt.make_tiled_T_log(jops, mode=mode, engine="strip",
                              interpret=True, **lb)
    ell = _field(jops)
    want = np.asarray(jT(jnp.asarray(ell)))
    before = dict(tt.LAUNCHES)
    T = P.make_tiled_T_log(_crossed(jops), mode=mode, engine="strip",
                           device="cpu", **lb)
    assert (T.engine, T.mode) == ("strip", mode)
    lazy = (baseline is not None and lazy_bytes == 0)
    assert T.lazy == (lazy, lazy)
    got = T(torch.as_tensor(ell)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert tt.LAUNCHES == before          # CPU tensors: plain versions


@pytest.mark.parametrize("lazy", [False, True])
def test_strip_phases_match_the_twin(lazy):
    jops = _jax_set("gcy", GCY_SHAPES, "rouwenhorst", "loglinear")
    ops = _crossed(jops)
    d = tt.strip_device_operands(ops, 0 if lazy else tt.LAZY_BYTES,
                                 device="cpu")
    assert isinstance(d["W_c1"], tuple) == lazy
    L, K, n1, n2 = ops.shapes
    ell = torch.as_tensor(_field(jops, seed=1), dtype=torch.float64)
    th, be = float(ops.theta), float(ops.beta)
    f64 = lambda W: (tuple(w.double() for w in W) if isinstance(W, tuple)
                     else W.double())
    mid = tt.strip_col_plain(ell.reshape(L * K, n1, n2), f64(d["W_c1"]),
                             f64(d["W_c2"]), th, "lse",
                             d["sub_row"].double(), d["sub_col"].double())
    out = tt.strip_row_plain(mid.reshape(L * K, n1 * n2), None, None,
                             d["W_r1"].double(), d["W_r2"].double(),
                             d["add_row"].double(), d["add_col"].double(),
                             th, be, "lse")
    twin = P.make_eager_two_phase_T(ops, torch.float64, device="cpu")
    # The folded baseline enters the strip phases' float32 operands.
    np.testing.assert_allclose(out.reshape(ops.shapes).numpy(),
                               twin(ell).numpy(), rtol=0, atol=ATOL)


def test_lazy_slices_follow_jax_slice_w():
    jops = _jax_set("gcy", GCY_SHAPES, "rouwenhorst", "loglinear")
    log0, D, t = (np.asarray(a, np.float32) for a in jops.lazy_c1)
    got = tt._slices(tuple(torch.as_tensor(a) for a in (log0, D, t)))
    for b in (0, 3, t.shape[1] - 1):
        want = np.asarray(jtt._slice_W(
            tuple(jnp.asarray(a) for a in (log0, D, t)), b, jnp.exp))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=2e-6)


def test_strip_jvp_is_the_twin_tangent():
    m = P.SSY()
    d = P.discretize_ssy(m, (4, 5, 6, 7))
    T = P.make_tiled_T_log_ssy(m, d, baseline="loglinear", engine="strip",
                               device="cpu")
    x = T.baseline_log_w + 0.01
    v = torch.full_like(x, 0.3)
    _, got = torch.func.jvp(T, (x,), (v,))
    _, want = torch.func.jvp(T.twin, (x,), (v,))
    assert float((got - want).abs().max()) == 0.0
    T64 = P.T_ssy_factory(m, d, space="log", device="cpu")
    _, d64 = torch.func.jvp(T64, (x.double(),), (v.double(),))
    assert float((got.double() - d64).abs().max()) <= 1e-5


# ------------------------------------------------------ tier decision

def _ssy_set(baseline=None, shapes=(4, 8, 6, 64)):
    m = P.SSY()
    return P.two_phase_operands_ssy(m, P.discretize_ssy(m, shapes),
                                    baseline)


def test_tier_decision_is_made_before_any_build():
    plain, norm = _ssy_set(), _ssy_set("loglinear")
    assert P.tiled_engine(plain)[0] == "streamed"
    tier, ops, mode = P.tiled_engine(norm)
    assert (tier, mode) == ("streamed", "lse") and not ops.c1_batched
    assert P.tiled_engine(norm, engine="strip") == ("strip", norm, "lse")
    assert P.tiled_engine(plain, engine="strip")[2] == "fast"
    # A deferred set asked for "fast": the strips under "auto", an error
    # when the streamed tier is forced.
    m = P.SSY()
    big = P.two_phase_operands_ssy(m, P.discretize_ssy(
        m, (2, 2, 64, 512), method="tauchen"))
    assert P.tiled_engine(big, "fast")[0] == "strip"
    with pytest.raises(ValueError, match="LSE only"):
        P.tiled_engine(big, "fast", engine="streamed")
    with pytest.raises(ValueError, match="unknown engine"):
        P.tiled_engine(plain, engine="xla")


def test_strip_tier_refuses_what_it_cannot_run():
    norm = _ssy_set("loglinear")
    with_mid = dataclasses.replace(P.conjugate_to_shared(norm),
                                   mid_col=np.zeros((6, 64)))
    assert P.tiled_engine(with_mid)[0] == "streamed"
    with pytest.raises(ValueError, match="streamed kernels only"):
        P.make_tiled_T_log(with_mid, engine="strip", device="cpu")
    g = P.GCY()
    lean = P.two_phase_operands_gcy(g, P.discretize_gcy(g, GCY_SHAPES),
                                    "loglinear", dense=False)
    assert P.tiled_engine(lean)[0] == "streamed"
    with pytest.raises(ValueError, match="dense=True"):
        P.make_tiled_T_log(lean, engine="strip", device="cpu")
    grids = P.build_grid_gcy(g, 5, 3, 3, 2, 40, 3)
    pair = P.two_phase_operands_gcy_continuous(g, grids,
                                               baseline="loglinear")
    wide = dataclasses.replace(pair, pair_shapes=(2, 4, 2, 512),
                               shapes=(16, 8, 8, 1024))
    with pytest.raises(ValueError, match="pair"):
        P.make_tiled_T_log(wide, device="cpu")


def test_gcy_factory_builds_the_dense_set_for_the_strip_tier_only():
    g = P.GCY()
    d = P.discretize_gcy(g, GCY_SHAPES)
    auto = P.make_tiled_T_log_gcy(g, d, baseline="loglinear", device="cpu")
    strip = P.make_tiled_T_log_gcy(g, d, baseline="loglinear",
                                   engine="strip", lazy_bytes=0,
                                   device="cpu")
    assert auto.engine.startswith("streamed")
    assert (strip.engine, strip.mode, strip.lazy) == ("strip", "lse",
                                                      (True, True))
    x = auto.baseline_log_w + 0.02
    assert torch.equal(auto.baseline_log_w, strip.baseline_log_w)
    assert float((auto(x) - strip(x)).abs().max()) <= 2 * ATOL
    # The strip twin is the dense batched set's, natural layout.
    assert float((strip.twin(x) - strip(x)).abs().max()) <= ATOL
