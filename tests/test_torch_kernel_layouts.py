"""The work partitions of the port's deferred pass B (TPU kernel
``_b_kernel_deferred``), deferred and batched pass C (``_c_kernel``'s
c2_deferred and c2_batched branches) and fused whole-solve kernel
(``_fused_kernel``, ``_solver_kernel``, ``_aa_kernel``), on the CPU
through their Python mirrors: the layout each launcher picks fits a
block's shared memory, and every output has exactly one owning block and
thread (following the kernels' loops as written here; the ``gpu`` tests
hold the layout mirrors against the launchers' own choice).  Also pins
``streamed_config``'s classification of the operand sets the other port
tests build (the kernels' layouts must not move a set between
configurations) and walks the strip column phase's products
(``tiled_two_phase.strip_col_layout``: each output stored once, each
field entry exponentiated once per contraction, each lazy factor entry
built once per column tile).  The kernels themselves run in
``test_torch_gpu_kernels.py`` on the card.
"""

import collections
import types

import numpy as np
import pytest

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st
from sdfs_via_autodiff_tpu_torch.kernels import tiled_two_phase as tt


def _once(writes):
    """True when the (r, ...) outputs of ``writes`` (owner first, then
    the output's index) are each written exactly once."""
    counts = collections.Counter(w[2:] for w in writes)
    return max(counts.values()) == 1, len(counts)


def _pass_b_deferred_writes(R, I, J, grid):
    """Every output (r, i, j) the deferred pass B stores, as (block,
    thread, r, i, j), following the kernel's loops.  ``grid`` is the
    resident layout's persistent grid (the co-resident blocks); the
    K-tiled grid is one block per (32-column strip, row), numbered strip
    + row * strips."""
    layout, bn, threads, _ = st.pass_b_deferred_layout(I, J)
    strips = -(-J // bn)
    out = []

    def tile(block, tid, r, j0, jw, i0, cols):
        for i in range(i0, min(i0 + 8, I)):
            out.extend((block, tid, r, i, j0 + c) for c in cols if c < jw)

    if layout == "resident":
        n_cg, half = bn // 8, bn // 2
        for block in range(min(grid, R * strips)):
            for item in range(block, R * strips, grid):
                r, j0 = item // strips, (item % strips) * bn
                jw = min(bn, J - j0)
                for tid in range(threads):
                    cg, rg = tid % n_cg, tid // n_cg
                    if rg < st._up8(I) // 8:
                        cols = ([4 * cg + b for b in range(4)]
                                + [half + 4 * cg + b for b in range(4)])
                        tile(block, tid, r, j0, jw, 8 * rg, cols)
        return out
    groups = st._DEF_BN // 8
    n_items = -(-I // 8) * groups
    for r in range(R):
        for strip in range(strips):
            j0 = strip * bn
            jw = min(bn, J - j0)
            for item in range(n_items):
                c0, i0 = (item % groups) * 8, (item // groups) * 8
                tile(strip + r * strips, item % threads, r, j0, jw, i0,
                     range(c0, c0 + 8))
    return out


def _fused_writes(R, C, grid):
    """Every output (r, c) a phase of the fused kernel writes, as (block,
    thread, r, c), following its loops: tile t to block t % grid, a warp
    per tile row, lane = column.  ``grid`` is the launch's grid (the tile
    count when resident)."""
    lay = fd.fused_layout(R, C)
    bm, n_ct = lay["bm"], lay["n_ct"]
    warps = fd._THREADS // 32
    out = []
    for t in range(lay["n_tiles"]):
        block = t % grid
        r0, c0 = (t // n_ct) * bm, (t % n_ct) * fd._TILE_COLS
        for tid in range(fd._THREADS):
            warp, lane = divmod(tid, 32)
            c = c0 + lane
            for r in range(r0 + warp, min(r0 + bm, R), warps):
                if c < C:
                    out.append((block, tid, r, c))
    return out


# (R, I, J, grid): I = 144 (the 18.9M-point continuous-GCY view's), 512
# (the 25.2M-point GCY view's), ragged I and J (not multiples of 8, of
# the item width, or of 4), grids smaller than the items.
DEFB_CASES = [(2, 144, 200, 5), (1, 144, 1024, 7), (1, 512, 40, 3),
              (3, 40, 70, 4), (2, 43, 6, 2), (1, 56, 258, 3),
              (2, 240, 9, 1)]


@pytest.mark.parametrize("R,I,J,grid", DEFB_CASES)
def test_pass_b_deferred_layout_owns_every_output_once(R, I, J, grid):
    layout, bn, threads, smem = st.pass_b_deferred_layout(I, J)
    assert smem <= st.SMEM_LIMIT
    assert threads % 32 == 0 and threads <= 384
    once, n = _once(_pass_b_deferred_writes(R, I, J, grid))
    assert once and n == R * I * J
    # The thread owning each output is inside the block.
    assert all(0 <= w[1] < threads for w in
               _pass_b_deferred_writes(R, I, J, grid))


def test_pass_b_deferred_layout_choice():
    # W_c1^T stays resident at I = 144 with 128-column items and 288
    # threads (every 8 x 8 tile busy); I = 512 streams it in K-tiles.
    assert st.pass_b_deferred_layout(144, 1024) == ("resident", 128, 288,
                                                    231_936)
    assert st.pass_b_deferred_layout(512, 256) == ("ktiled", 32, 256,
                                                   99_456)
    assert st.pass_b_deferred_layout(40, 20)[:2] == ("resident", 32)
    assert st.pass_b_deferred_layout(240, 128)[0] == "ktiled"
    # The classification's input is the K-tiled footprint, as before.
    assert st.pass_b_deferred_smem_bytes(144) == 28_800
    assert st.pass_b_deferred_smem_bytes(512) == 99_456


def _slab_walk(L, K, J):
    """One slice of the deferred / batched pass C, following the kernel's
    loops (``pass_c_slab_kernel``) over every column tile and cluster
    rank: Counters of the c2 accumulator entries (r, c) the threads own,
    of the y[l, k, c] entries r1 produces and the exchange reads (as
    (l, k, c) -> ranks), and of the outputs (r, c) the epilogue stores."""
    _, cs, tc, _, threads, _ = st.pass_c_deferred_layout(L, K, J)
    nk, nl = -(-K // cs), -(-L // cs)
    rows, ncg, half, t4 = L * nk, tc // 8, tc // 2, tc // 4
    cols = lambda cq: [4 * cq + u for u in range(4)] + [
        half + 4 * cq + u for u in range(4)]
    acc = collections.Counter()
    made, read = collections.defaultdict(list), collections.defaultdict(list)
    outs = collections.Counter()
    for j0 in range(0, J, tc):
        tcw = min(tc, J - j0)
        for rank in range(cs):
            k0, l0 = rank * nk, rank * nl
            nko, nlo = min(nk, K - k0), max(0, min(nl, L - l0))
            for tid in range(threads):           # c2: one tile a thread
                rg, cq = divmod(tid, ncg)
                for q in range(8 * rg, min(8 * rg + 8, rows)):
                    if q % nk < nko:
                        r = (q // nk) * K + k0 + q % nk
                        acc.update((r, j0 + t) for t in cols(cq) if t < tcw)
            nlg = -(-L // 8)                     # r1 items
            for item in range(nko * nlg * ncg):
                cq, lg = item % ncg, (item // ncg) % nlg
                kk = item // (ncg * nlg)
                for l in range(8 * lg, min(8 * lg + 8, L)):
                    for t in cols(cq):
                        made[(l, k0 + kk, j0 + t)].append(rank)
            if cs > 1:                           # the l-slab's gather
                for x in range(nlo * K * t4):
                    t, m, ll = 4 * (x % t4), (x // t4) % K, x // (t4 * K)
                    for u in range(4):
                        read[(l0 + ll, m, j0 + t + u)].append(
                            (rank, m // nk))
            for x in range(nlo * K * t4):        # the epilogue
                t, lk = 4 * (x % t4), x // t4
                if t < tcw:
                    outs.update((l0 * K + lk, j0 + t + u) for u in range(4)
                                if t + u < tcw)
    return cs, acc, made, read, outs


# (L, K, J) of the deferred and batched pass C: the 25.2M GCY view, the
# 11.2M continuous-SSY cell (a cluster of 8), the 20^4 anchor, the gpu
# test sets (4,8,6,64), (3,5,7,40) and the deferred cases' views, the
# ragged (31,29,5,42) (a cluster of 2: k-slabs 15 + 14, l-slabs 16 +
# 15, J % 4 != 0), clusters of 3-7 with ragged slabs, several column
# tiles.
SLAB_CASES = [(12, 16, 256), (56, 56, 64), (20, 20, 20), (4, 8, 64),
              (3, 5, 40), (2, 3, 30), (2, 4, 258), (4, 8, 128),
              (12, 24, 128), (31, 29, 42), (12, 69, 64), (48, 30, 64),
              (23, 69, 64), (30, 66, 64), (35, 67, 64), (40, 40, 130),
              (9, 11, 37)]


@pytest.mark.parametrize("L,K,J", SLAB_CASES)
def test_pass_c_slab_layout_owns_every_output_once(L, K, J):
    layout, cs, tc, jk, threads, smem = st.pass_c_deferred_layout(L, K, J)
    assert smem <= st.SMEM_LIMIT and jk in (16, 32)
    assert threads % 32 == 0 and threads <= 512 and tc % 8 == 0
    assert layout == ("block" if cs == 1 else "cluster") and cs <= 8
    cs, acc, made, read, outs = _slab_walk(L, K, J)
    R = L * K
    # Each accumulator entry and each output has one owner, all covered.
    assert max(acc.values()) == 1 and len(acc) == R * J
    assert max(outs.values()) == 1 and len(outs) == R * J
    # Each y[l, k, c] is produced once, by the owner of k's slab.
    nk = -(-K // cs)
    assert all(v == [k // nk] for (l, k, c), v in made.items())
    assert len(made) == R * -(-J // tc) * tc
    if cs > 1:
        # ... and read once in the exchange, from that owner, by the
        # owner of l's slab.
        nl = -(-L // cs)
        assert read.keys() == made.keys()
        assert all(v == [(l // nl, k // nk)] for (l, k, c), v in
                   read.items())


def test_pass_c_slab_layout_choice():
    # The GCY view: one block of 192 rows x 128 columns, 384 threads,
    # 32-column chunks; the continuous-SSY cell: a cluster of 8 k-slabs
    # of 7 (392 rows x 64 columns, the whole slice), 16-column chunks.
    assert st.pass_c_deferred_layout(12, 16, 256) == (
        "block", 1, 128, 32, 384, 200_784)
    assert st.pass_c_deferred_layout(56, 56, 64) == (
        "cluster", 8, 64, 16, 416, 219_568)
    assert st.pass_c_deferred_layout(20, 20, 20)[:3] == ("block", 1, 24)
    assert st.pass_c_deferred_layout(31, 29, 42)[:3] == ("cluster", 2, 48)
    # The classification's input is the earlier kernel's footprint.
    assert st.pass_c_deferred_tiles(12, 16) == (64, 16)
    assert st.pass_c_deferred_tiles(56, 56) == (4, 4)


@pytest.mark.parametrize("J", [4, 16, 37, 64, 256])
def test_pass_c_slab_layout_covers_the_classified_sets(J):
    # Every (L, K) up to 96 that the classifier's footprint accepts has a
    # layout that fits.
    for L in range(1, 97, 5):
        for K in range(1, 97, 3):
            if st.pass_c_deferred_tiles(L, K) is None:
                continue
            lay = st.pass_c_deferred_layout(L, K, J)
            assert lay is not None, (L, K, J)
            assert lay[5] <= st.SMEM_LIMIT and lay[4] <= 512


@pytest.mark.parametrize("J", [16, 64, 256])
def test_streamed_config_classes_only_sets_the_slab_kernel_runs(J):
    # Every (L, K) in 1..256: a shared set whose column group is too wide
    # for the full configuration (I = 512) and a batched one (I = 8) are
    # classed "deferred" / "batched" only where the pass-C launcher has a
    # slab layout; the others go to the strip tier.
    for I, batched, want in ((512, False, "deferred"), (8, True, "batched")):
        for L in range(1, 257):
            for K in range(1, 257):
                ops = types.SimpleNamespace(
                    shapes=(L, K, I, J), c1_batched=False, c2_batched=batched,
                    has_mid=False, is_pair=False, pair_shapes=None)
                if st.streamed_config(ops) == want:
                    assert st.pass_c_deferred_layout(L, K, J) is not None, (
                        L, K, I, J)


def test_uncovered_plain_ssy_set_runs_the_strip_tier():
    # The plain SSY Tauchen set (103, 41, 64, 512): the earlier pass-C
    # footprint fits, the slab kernel has no layout, so the decision is
    # the strip tier (fast mode), where JAX runs it too.
    ops = _ssy((103, 41, 64, 512), "tauchen")
    assert st.pass_c_deferred_tiles(103, 41) is not None
    assert st.pass_c_deferred_layout(103, 41, 512) is None
    assert st.streamed_config(ops) is None
    tier, run_ops, mode = tt.tiled_engine(ops)
    assert (tier, mode) == ("strip", "fast") and run_ops is ops


def _ssy(sizes, method="rouwenhorst", baseline=None):
    m = P.SSY()
    return P.two_phase_operands_ssy(
        m, P.discretize_ssy(m, sizes, method=method), baseline)


def _gcy(sizes, method="tauchen", baseline=None):
    m = P.GCY()
    return P.two_phase_operands_gcy(
        m, P.discretize_gcy(m, sizes, method=method), baseline)


def _gcyc(sizes):
    m = P.GCY()
    return P.two_phase_operands_gcy_continuous(
        m, P.build_grid_gcy(m, *sizes), 5, "loglinear")


def _ssyc(sizes):
    m = P.SSY()
    return P.two_phase_operands_ssy_continuous(m, P.build_grid_ssy(m, *sizes),
                                               5)


# The configuration each set had before the deferred pass B gained its
# resident layout and the deferred / batched pass C its slab layout (the
# conjugated form for the normalized sets).
CONFIG_CASES = [
    (lambda: _ssy((4, 8, 6, 64)), "full"),
    (lambda: _ssy((8, 16, 32, 384), "tauchen"), "full"),
    (lambda: _ssy((2, 4, 12, 258), "tauchen"), "full"),
    (lambda: _gcy((15, 2, 5, 2, 6, 3)), "full"),
    (lambda: _gcy((7, 8, 43, 2, 6, 4)), "full"),
    (lambda: _gcy((30, 8, 16, 4, 8, 8)), "deferred"),
    (lambda: _gcy((32, 16, 16, 12, 16, 16)), "deferred"),
    (lambda: _gcyc((8, 3, 2, 4, 128, 2)), "pair"),
    (lambda: _gcyc((5, 3, 3, 2, 40, 3)), "pair"),
    (lambda: _gcyc((4, 5, 3, 3, 33, 2)), "pair"),
    (lambda: _gcyc((5, 3, 2, 2, 40, 12)), "pair"),
    (lambda: _gcy((30, 8, 16, 12, 8, 24)), "deferred"),
    (lambda: _ssyc((4, 8, 6, 64)), "batched"),
    (lambda: _ssyc((3, 5, 7, 40)), "batched"),
    (lambda: _ssyc((20, 20, 20, 20)), "batched"),
    (lambda: _ssyc((31, 29, 5, 42)), "batched"),
    (lambda: _ssyc((56, 56, 56, 64)), "batched"),
    (lambda: st.streamed_coverable(_ssy((4, 5, 6, 7), baseline="loglinear")),
     "full"),
    (lambda: st.streamed_coverable(_gcy((30, 8, 16, 4, 8, 8), "rouwenhorst",
                                        "loglinear")), "deferred"),
]


@pytest.mark.parametrize("k", range(len(CONFIG_CASES)))
def test_streamed_config_classifies_as_before(k):
    build, want = CONFIG_CASES[k]
    ops = build()
    assert st.streamed_config(ops) == want
    if want in ("deferred", "batched"):
        # ... and the pass-C kernel has a layout for it.
        L, K, _, J = ops.shapes
        assert st.pass_c_deferred_layout(L, K, J) is not None


# (R, C) of the fused kernels' operand sets: continuous SSY 20^4 (the
# 20k-iteration cell), continuous GCY 6^6 (36 x 1,296: its operands
# exceed a block, so it runs chunked), the sets of the kernel checks
# (continuous SSY (5,5,5,6), discrete SSY (8,8,6,6), discrete GCY
# (4,3,3,3,3,3)) and a set beyond the resident layout.
FUSED_SHAPES = [(400, 400), (36, 1296), (25, 30), (64, 36), (36, 27),
                (675, 650)]


@pytest.mark.parametrize("R,C", FUSED_SHAPES)
def test_fused_layout_owns_every_output_once(R, C):
    lay = fd.fused_layout(R, C)
    assert lay["smem"] <= fd._SMEM_LIMIT - fd._STATIC_SMEM
    assert lay["bm"] % 4 == 0 and lay["bm"] <= 64
    assert lay["n_tiles"] == -(-R // lay["bm"]) * -(-C // 32)
    # The product's 4 x 2 sub-tiles cover the tile within the block.
    assert lay["product_threads"] * 8 == lay["bm"] * 32 <= 256 * 8
    grid = lay["n_tiles"] if lay["resident"] else fd.SMS_H100
    writes = _fused_writes(R, C, grid)
    once, n = _once(writes)
    assert once and n == R * C
    if lay["resident"]:
        # One tile per block, the same in every iteration: block b owns
        # tile b, whose rows and columns its resident operands hold.
        assert lay["n_tiles"] <= fd.SMS_H100
        owner = {(r // lay["bm"], c // 32): b for b, _, r, c in writes}
        assert all(b == rt * lay["n_ct"] + ct
                   for (rt, ct), b in owner.items())


def test_fused_layout_choice():
    # 20^4: 40-row tiles, 130 on 132 SMs, M1 rows and M2T columns
    # resident (the launcher's first fit); continuous GCY 6^6: chunked,
    # two 32-row tiles by 41 column tiles.
    lay = fd.fused_layout(400, 400)
    assert (lay["bm"], lay["n_tiles"], lay["resident"]) == (40, 130, True)
    lay = fd.fused_layout(36, 1296)
    assert (lay["bm"], lay["n_tiles"], lay["resident"]) == (32, 82, False)
    assert not fd.fused_layout(675, 650)["resident"]


def _strip_gemm_walk(P, M, Q, B, kind, lay):
    """One column-phase product (``strip_gemm_kernel``), following its
    loops over the launcher's grid: counts of the outputs (b, p, q) the
    threads' epilogues store and of the lazy factor entries (b, p, m) the
    blocks build while staging (every staged entry, lazy or not)."""
    TM, TN, pt, nt, nb, NT = lay
    Qp = -(-Q // 4) * 4
    fold = kind == "shared"
    N = B * Qp if fold else Qp
    tid = np.arange(NT)
    warp, lane = np.divmod(tid, 32)       # a warp: 4 x 8 threads' tiles
    ty = (warp // (TN // 64)) * 4 + lane // 8
    tx = (warp % (TN // 64)) * 8 + lane % 8
    assert len(set(zip(ty, tx))) == NT
    assert ty.max() < TM // 8 and tx.max() < TN // 8
    four = np.arange(4)
    rows = np.concatenate([ty[:, None] * 4 + four,
                           TM // 2 + ty[:, None] * 4 + four], 1)
    cols = np.concatenate([tx[:, None] * 4 + four,
                           TN // 2 + tx[:, None] * 4 + four], 1)
    # The staging loops: entry e = tid + r * NT of the TM x 16 chunk.
    staged = (tid[:, None] + NT * np.arange(-(-TM * 16 // NT))).ravel()
    staged = staged[staged < TM * 16]
    assert np.array_equal(np.sort(staged), np.arange(TM * 16))
    out = np.zeros((B, P, Q), int)
    built = np.zeros((nb, P, M), int)
    for bx in range(pt * nt):
        p0, n0 = (bx % pt) * TM, (bx // pt) * TN
        p, n = np.broadcast_arrays(p0 + rows[:, :, None],
                                   n0 + cols[:, None, :])
        for by in range(nb):
            b = n // Qp if fold else np.full_like(n, by)
            q = n % Qp if fold else n
            ok = (p < P) & (n < N) & (q < Q)
            np.add.at(out, (b[ok], p[ok], q[ok]), 1)
            for m0 in range(0, M, 16):
                pp, mm = p0 + staged // 16, m0 + staged % 16
                ok = (pp < P) & (mm < M)
                np.add.at(built, (by, pp[ok], mm[ok]), 1)
    return out, built


def _strip_exp_walk(R, n1, n2):
    """Counts of the field entries (t, i, j) the exp pass
    (``strip_exp_kernel``) exponentiates, over its grid of 32 j x 32 t x
    8 i blocks of 8 x 32 threads, and of the a2 entries (i, j, t) the
    lse shift (``strip_shift_kernel``) exponentiates, over its 32 t x n1
    blocks of 8 groups striding j."""
    exps = np.zeros((R, n1, n2), int)
    ty, tx = np.divmod(np.arange(256), 32)
    for j0 in range(0, n2, 32):
        for t0 in range(0, R, 32):
            for i0 in range(0, n1, 8):
                for i in range(i0, min(i0 + 8, n1)):
                    for r in range(4):
                        t, j = t0 + ty + 8 * r, j0 + tx
                        ok = (t < R) & (j < n2)
                        np.add.at(exps, (t[ok], i, j[ok]), 1)
    shifts = np.zeros((n1, n2, R), int)
    g, tl = np.divmod(np.arange(256), 32)
    for t0 in range(0, R, 32):
        for i in range(n1):
            for gg, t in zip(g, t0 + tl):
                if t < R:
                    shifts[i, gg::8, t] += 1
    return exps, shifts


# (R, n1, n2, kind1, kind2): the gpu tests' strip sets (shared factors
# folded into N with P and N ragged on 128 x 128; dense-batched; lazy on
# 64 x 192, and on 64 x 256 with R = 260 field rows over two column
# tiles), a lazy factor whose Qp = 192 rows fit one column tile, and one
# whose 200 do not.
STRIP_WALKS = [(20, 6, 7, "shared", "shared"),
               (15, 67, 130, "shared", "shared"),
               (12, 70, 9, "dense", "dense"),
               (260, 5, 70, "lazy", "lazy"),
               (12, 37, 70, "lazy", "lazy"),
               (9, 40, 12, "lazy", "lazy"),
               (190, 33, 5, "lazy", "shared"),
               (200, 33, 6, "lazy", "dense")]


@pytest.mark.parametrize("R,n1,n2,kind1,kind2", STRIP_WALKS)
def test_strip_col_layout_owns_every_output_once(R, n1, n2, kind1, kind2):
    lay = tt.strip_col_layout(R, n1, n2, kind1, kind2)
    for c, (P, B, kind) in (("c1", (n1, n2, kind1)),
                            ("c2", (n2, n1, kind2))):
        TM, TN, pt, nt, nb, threads = lay[c]
        assert threads == (TM // 8) * (TN // 8) <= 256
        # Static shared memory: two chunks of both operands.
        assert 4 * 2 * 16 * (TM + 4 + TN + 4) <= 48 * 1024
        out, built = _strip_gemm_walk(P, P, R, B, kind, lay[c])
        # Every output of the contraction is stored once.
        assert out.min() == 1 and out.max() == 1
        # A factor entry is staged (for a lazy one: built, an expf each)
        # once per column tile: once per launch where one tile spans
        # every field row.
        assert built.min() == built.max() == nt
        if kind == "lazy" and -(-R // 4) * 4 <= 192:
            assert nt == 1
    # Each field entry is exponentiated once for c1, each a2 entry once
    # for c2 (lse).
    exps, shifts = _strip_exp_walk(R, n1, n2)
    assert exps.min() == exps.max() == 1
    assert shifts.min() == shifts.max() == 1
    assert tt.strip_col_work_floats(R, n1, n2) == (
        (2 * n1 * n2 + n1 + n2) * (-(-R // 4) * 4))


def test_strip_col_layout_choice():
    # Normalized SSY (c1 dense-batched, c2 lazy rank 1): 384 batches of
    # one 32 x 256 tile row, then 64 x 256 tiles over 32 batches; plain
    # SSY: W_c1 folded into N (1,536 tiles), W_c2 one 384 x 32,768
    # product in 128 x 128 tiles; the normalized GCY view: 64 x 192 tiles
    # whose one column tile spans all 192 field rows, so each lazy entry
    # is built once per launch; the plain GCY view: 128 x 128 tiles.
    lay = tt.strip_col_layout(1024, 32, 384, "dense", "lazy")
    assert lay == {"c1": (32, 256, 1, 4, 384, 128),
                   "c2": (64, 256, 6, 4, 32, 256)}
    lay = tt.strip_col_layout(1024, 32, 384, "shared", "shared")
    assert lay == {"c1": (32, 256, 1, 1536, 1, 128),
                   "c2": (128, 128, 3, 256, 1, 256)}
    lay = tt.strip_col_layout(192, 512, 256, "lazy", "lazy")
    assert lay == {"c1": (64, 192, 8, 1, 256, 192),
                   "c2": (64, 192, 4, 1, 512, 192)}
    lay = tt.strip_col_layout(192, 512, 256, "shared", "shared")
    assert lay == {"c1": (128, 128, 4, 384, 1, 256),
                   "c2": (128, 128, 2, 768, 1, 256)}
