"""The split-TF32 arithmetic of the deferred pass B's tensor-core layout
(TPU kernel ``_b_kernel_deferred``, CUDA ``pass_b_mma_kernel``), emulated
on the CPU in torch: each operand x becomes hi = tf32(x) (round to
nearest, ties away from zero, on the float32 bits) and lo = tf32(x - hi);
per k-step of 8, three TF32 products lo*hi + hi*lo + hi*hi go into a fresh
accumulator, then one float32 add puts it on the running sum.  The
tensor cores' own accumulation is modelled pessimistically: each
mma.m16n8k8 sums its 8 exact products and its accumulator exactly, then
rounds toward zero to float32.

At a 512-deep contraction with the GCY view's exponent range (and a wider
one), the emulated sum stays within 5e-6 in log of the float64 sum, and
the emulated kernel within the kernel-vs-plain limit (5e-6 plus one
float32 rounding of the value) of ``pass_b_deferred_plain`` and of the
JAX package's deferred pass B (the Pallas kernel in interpret mode).  So
the route can hold the bar before the card is asked.

Pass B's c2 product (TPU kernel ``_b_kernel``, CUDA
``pass_b_mma_kernel<true, .>`` after the c1 pass) runs the same arithmetic
with the field on the left: mid (R*I, J) = U W_c2^T, U the c1 pass's
linear field (fast) or exp(u - row max) (lse).  At a small SSY Tauchen
set with the cell's 384-deep contraction it stays within 5e-6 of float64
(relative in fast mode, in log in lse mode), and within the kernel-vs-
plain limit of ``pass_b_plain``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfs_via_autodiff_tpu.kernels import streamed_two_phase as jst
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module (module-scoped fixtures
    included): torch's CPU worker threads have now and then returned one
    worker's share of a product's rows off (ROADMAP C), and here they
    once moved an emulated sum by 1e-4 relative, which one thread never
    did."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: cvt.rna.tf32.f32 on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_rz(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """c + a @ b for TF32 a (.., M, 8) and b (.., 8, N) and float32 c: the
    products and their sum exact (float64), then rounded toward zero."""
    s = c.double() + a.double() @ b.double()
    y = s.float()
    over = y.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def emulate(ell, W_c1t, theta, sub_row=None, sub_col=None, promote=True):
    """The tensor-core deferred pass B's arithmetic: the exp pass (fold,
    column maxima m, e = exp(a - m) in float32), then per k-step of 8 the
    three TF32 products, promoted to the float32 running sum (or, with
    ``promote=False``, all accumulated on the tensor cores); out = m +
    log(sum)."""
    a = st._folded(ell, theta, sub_row, sub_col)
    m = torch.amax(a, dim=1, keepdim=True)
    e = torch.exp(a - m)
    R, I, J = e.shape
    Ip = -(-I // 8) * 8
    W = torch.zeros((Ip, Ip), dtype=torch.float32)
    W[:I, :I] = W_c1t.mT
    E = torch.zeros((R, Ip, J), dtype=torch.float32)
    E[:, :I] = e
    (wh, wl), (eh, el) = split(W), split(E)
    acc = torch.zeros((R, Ip, J), dtype=torch.float32)
    for k in range(0, Ip, 8):
        ks = slice(k, k + 8)
        t = torch.zeros_like(acc) if promote else acc
        t = mma_rz(t, wl[:, ks], eh[:, ks])
        t = mma_rz(t, wh[:, ks], el[:, ks])
        t = mma_rz(t, wh[:, ks], eh[:, ks])
        acc = acc + t if promote else t
    return m + torch.log(acc[:, :I]), acc[:, :I], a, m


def _gcy_w(I, rng):
    """A row-stochastic (I, I) factor shaped like the GCY view's W_c1: a
    Kronecker product of banded Tauchen-like chains (entries spanning many
    orders of magnitude)."""
    def chain(n, width):
        x = np.arange(n)
        P = np.exp(-0.5 * ((x[:, None] - x[None, :]) / width) ** 2)
        P *= 1.0 + 0.1 * rng.random((n, n))
        return P / P.sum(axis=1, keepdims=True)
    W = np.kron(np.kron(chain(32, 1.5), chain(4, 0.8)), chain(I // 128, 0.7))
    return W / W.sum(axis=1, keepdims=True)


# (spread of ell around log(800), fold): the GCY view's exponent range
# (theta = -36, 0.05 noise: a - m down to about -8), a wider one (down to
# about -60) and the normalized cell's fold (O(1) values, the tightest
# limit).
CASES = [(0.05, False), (0.4, False), (0.05, True)]


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(12)
    R = rng.random((512, 512))
    return {"gcy": _gcy_w(512, rng), "random": R / R.sum(axis=1,
                                                          keepdims=True)}


@pytest.mark.parametrize("kind", ["gcy", "random"])
@pytest.mark.parametrize("spread,fold", CASES)
def test_split_tf32_sum_holds_the_bar(factors, kind, spread, fold):
    rng = np.random.default_rng(int(100 * spread) + fold)
    R, I, J, theta = 2, 512, 24, -36.0
    ell = torch.as_tensor(np.log(800.0) + spread * rng.standard_normal(
        (R, I, J)), dtype=torch.float32)
    W_c1t = torch.as_tensor(factors[kind].T, dtype=torch.float32)
    sub = ((torch.as_tensor(theta * np.log(800.0)
                            + 0.1 * rng.standard_normal(R),
                            dtype=torch.float32),
            torch.as_tensor(0.05 * rng.standard_normal((I, J)),
                            dtype=torch.float32))
           if fold else (None, None))
    out, acc, a, m = emulate(ell, W_c1t, theta, *sub)
    # The sum against the float64 sum of the same float32 exponents and
    # factor: within 5e-6 in log.
    exact = torch.matmul(W_c1t.mT.double(), torch.exp(a.double()
                                                      - m.double()))
    err = float((torch.log(acc.double()) - torch.log(exact)).abs().max())
    assert err <= ATOL
    # The emulated kernel against the plain version: 5e-6 plus one
    # float32 rounding of the value.
    want = st.pass_b_deferred_plain(ell, W_c1t, theta, *sub)
    assert bool(((out - want).abs() <= ATOL + EPS32 * want.abs()).all())


def test_split_tf32_needs_the_promotion(factors):
    # Without the per-k-step float32 promotion, 192 truncating
    # accumulations of the rounded-toward-zero model drift several times
    # further from the float64 sum than with it.
    rng = np.random.default_rng(5)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        (1, 512, 16)), dtype=torch.float32)
    W_c1t = torch.as_tensor(factors["gcy"].T, dtype=torch.float32)
    errs = []
    for promote in (True, False):
        _, acc, a, m = emulate(ell, W_c1t, -36.0, promote=promote)
        exact = torch.matmul(W_c1t.mT.double(),
                             torch.exp(a.double() - m.double()))
        errs.append(float((torch.log(acc.double())
                           - torch.log(exact)).abs().max()))
    assert errs[0] <= ATOL and errs[1] > 3 * errs[0]


def test_tf32_rounding_matches_its_definition():
    # Round to nearest on 10 mantissa bits, ties away from zero, on
    # normal and subnormal-free float32 values of both signs.
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -11), 3.14159265,
                      1e-30, 7.0e30], dtype=torch.float32)
    got = tf32(x).double()
    # Reference: the nearest multiple of 2^(e - 10), ties away from zero.
    xd = x.double()
    e = torch.floor(torch.log2(xd.abs()))
    q = 2.0 ** (e - 10)
    want = torch.sign(xd) * torch.floor(xd.abs() / q + 0.5) * q
    assert torch.equal(got, want)
    hi, lo = split(x)
    assert float(((hi.double() + lo.double() - xd).abs()
                  / xd.abs()).max()) <= 2.0 ** -22


def test_emulated_kernel_matches_the_pallas_kernel(factors):
    # The emulated tensor-core pass B against the JAX package's deferred
    # pass B (the Pallas kernel in interpret mode) on the same float32
    # inputs, with and without a fold: 5e-6 plus one float32 rounding.
    rng = np.random.default_rng(3)
    R, I, J, theta = 2, 512, 8, -36.0
    ell = (np.log(800.0) + 0.05 * rng.standard_normal((R, I, J))).astype(
        np.float32)
    W = factors["gcy"].astype(np.float32)
    sub_row = (theta * np.log(800.0)
               + 0.1 * rng.standard_normal(R)).astype(np.float32)
    sub_col = (0.05 * rng.standard_normal((I, J))).astype(np.float32)
    for has_sub in (False, True):
        call, _ = jst.build_b_call_deferred(
            R_rows=R, I=I, J=J, TB=1, TJ=J, theta=theta,
            prec=jax.lax.Precision.HIGHEST, trx="accurate", has_sub=has_sub,
            dtype=jnp.float32, interpret=True)
        args = [jnp.asarray(ell), jnp.asarray(W)]
        if has_sub:
            args += [jnp.asarray(sub_row[:, None]), jnp.asarray(sub_col)]
        want = np.asarray(call(*args))
        sub = ((torch.as_tensor(sub_row), torch.as_tensor(sub_col))
               if has_sub else (None, None))
        got = emulate(torch.as_tensor(ell), torch.as_tensor(W.T), theta,
                      *sub)[0].numpy()
        assert np.all(np.abs(got - want) <= ATOL + EPS32 * np.abs(want))


def emulate_c2(U, W_c2t, promote=True):
    """The split-TF32 product U (M, K) W_c2t (K, N) as the c2 product
    runs it: K padded to a multiple of 8 with zeros, per k-step of 8 the
    three TF32 products into a fresh accumulator, then one float32 add."""
    M, K = U.shape
    N = W_c2t.shape[1]
    Kp = -(-K // 8) * 8
    A = torch.zeros((M, Kp), dtype=torch.float32)
    A[:, :K] = U
    B = torch.zeros((Kp, N), dtype=torch.float32)
    B[:K] = W_c2t
    (ah, al), (bh, bl) = split(A), split(B)
    acc = torch.zeros((M, N), dtype=torch.float32)
    for k in range(0, Kp, 8):
        ks = slice(k, k + 8)
        t = torch.zeros_like(acc) if promote else acc
        t = mma_rz(t, al[:, ks], bh[ks])
        t = mma_rz(t, ah[:, ks], bl[ks])
        t = mma_rz(t, ah[:, ks], bh[ks])
        acc = acc + t if promote else t
    return acc


@pytest.fixture(scope="module")
def ssy_c2_set():
    """A small SSY Tauchen set with the cell's J = 384 (the c2 depth) and
    its c1 results: the fast field's linear U with row shifts s, and the
    lse field's log-domain u, on a seeded field near log(800)."""
    import sdfs_via_autodiff_tpu_torch as P
    m = P.SSY()
    shapes = (2, 3, 8, 384)
    ops = P.two_phase_operands_ssy(m, P.discretize_ssy(m, shapes,
                                                       method="tauchen"))
    L, K, I, J = shapes
    rng = np.random.default_rng(7)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        (L * K, I, J)), dtype=torch.float32)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32)
    W_c1, W_c2t = f32(ops.W_c1), f32(np.asarray(ops.W_c2).T)
    th = float(ops.theta)
    u_fast, s = st.pass_b_plain(ell, W_c1, None, th, "fast")
    u_lse = st.pass_b_plain(ell, W_c1, None, th, "lse")
    return ell, W_c1, W_c2t, th, u_fast, s, u_lse


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_b_c2_split_tf32_holds_the_bar(ssy_c2_set, mode):
    ell, W_c1, W_c2t, th, u_fast, s, u_lse = ssy_c2_set
    R, I, J = ell.shape
    if mode == "fast":
        U = u_fast.reshape(R * I, J)
    else:
        u = u_lse.reshape(R * I, J)
        sh = torch.amax(u, dim=1, keepdim=True)
        U = torch.exp(u - sh)
    acc = emulate_c2(U, W_c2t)
    exact = U.double() @ W_c2t.double()
    want = st.pass_b_plain(ell, W_c1, W_c2t, th, mode)
    if mode == "fast":
        # The linear field against the float64 product of the same U and
        # W_c2^T, and against the plain version: 5e-6 relative.
        assert float(((acc.double() - exact).abs() / exact).max()) <= 5e-6
        got = acc.reshape(R, I, J)
        assert float(((got - want[0]).abs() / want[0].abs()).max()) <= 5e-6
    else:
        # sh + log(sum): within 5e-6 in log of the float64 sum, and the
        # emulated pass within 5e-6 plus one float32 rounding of the
        # value of the plain version.
        err = float((torch.log(acc.double()) - torch.log(exact)).abs().max())
        assert err <= ATOL
        got = (sh + torch.log(acc)).reshape(R, I, J)
        assert bool(((got - want).abs() <= ATOL + EPS32 * want.abs()).all())
