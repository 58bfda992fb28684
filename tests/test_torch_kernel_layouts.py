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
configurations).  The kernels themselves run in
``test_torch_gpu_kernels.py`` on the card.
"""

import collections

import pytest

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st


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
