"""The work partitions of the port's pass B (TPU kernel ``_b_kernel``:
the c1 pass and the split-TF32 c2 product) and deferred pass B
(``_b_kernel_deferred``), deferred and batched pass C (``_c_kernel``'s
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


def _mma_thread_cells():
    """(i, j) offsets inside a 128 x 128 tile of the 64 outputs each of
    the tensor-core pass B's 256 consumer threads own (mma.sync m16n8k8
    accumulators: warp (wm, wn) = (warp % 2, warp // 2) holds rows wm*64..
    in 4 m16 tiles and columns wn*32.. in 4 n8 tiles; lane (g, t) = (lane
    // 4, lane % 4) rows g, g + 8 and columns 2t, 2t + 1 of each)."""
    tid = np.arange(st._MMA_CONSUMERS)
    warp, lane = np.divmod(tid, 32)
    wm, wn, g, t = warp % 2, warp // 2, lane // 4, lane % 4
    mt, nt, h, e = np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                               np.arange(2), indexing="ij")
    i = (wm * 64 + g)[:, None] + (mt * 16 + 8 * h).ravel()[None, :]
    j = (wn * 32 + 2 * t)[:, None] + (nt * 8 + e).ravel()[None, :]
    return i, j


def _pass_b_deferred_writes(R, I, J, grid):
    """Every output (r, i, j) the deferred pass B stores, as (block,
    thread, r, i, j), following the kernel's loops.  ``grid`` is the
    persistent grid (the co-resident blocks) of either layout; the
    tensor-core layout's tile t = block + q * grid is i-tile t % n_i of
    column tile t // n_i (j-tile, then field row)."""
    layout, bn, threads, _ = st.pass_b_deferred_layout(I, J)
    out = []
    if layout == "resident":
        strips = -(-J // bn)

        def tile(block, tid, r, j0, jw, i0, cols):
            for i in range(i0, min(i0 + 8, I)):
                out.extend((block, tid, r, i, j0 + c) for c in cols
                           if c < jw)

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
    assert layout == "mma" and bn == st._MMA_BN
    ci, cj = _mma_thread_cells()
    n_i, n_j = -(-I // st._MMA_BM), -(-J // st._MMA_BN)
    tids = np.broadcast_to(np.arange(st._MMA_CONSUMERS)[:, None], ci.shape)
    for block in range(min(grid, n_i * n_j * R)):
        for t in range(block, n_i * n_j * R, grid):
            i0 = (t % n_i) * st._MMA_BM
            rest = t // n_i
            j0, r = (rest % n_j) * st._MMA_BN, rest // n_j
            i, j = i0 + ci, j0 + cj
            ok = (i < I) & (j < J)
            out.extend((block, int(a), r, int(b), int(c)) for a, b, c in
                       zip(tids[ok], i[ok], j[ok]))
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
# (the 25.2M-point GCY view's), ragged I and J (not multiples of 4, 8,
# 16, of the item or tile width), grids smaller than the items or tiles.
DEFB_CASES = [(2, 144, 200, 5), (1, 144, 1024, 7), (1, 512, 40, 3),
              (3, 40, 70, 4), (2, 43, 6, 2), (1, 56, 258, 3),
              (2, 240, 9, 1), (2, 512, 256, 5), (1, 301, 70, 2),
              (2, 250, 130, 3), (1, 517, 37, 4), (3, 1000, 9, 7)]


@pytest.mark.parametrize("R,I,J,grid", DEFB_CASES)
def test_pass_b_deferred_layout_owns_every_output_once(R, I, J, grid):
    layout, bn, threads, smem = st.pass_b_deferred_layout(I, J)
    assert smem <= st.SMEM_LIMIT
    assert threads % 32 == 0 and threads <= (384 if layout == "resident"
                                             else 512)
    writes = _pass_b_deferred_writes(R, I, J, grid)
    once, n = _once(writes)
    assert once and n == R * I * J
    # The thread owning each output is inside the block.
    assert all(0 <= w[1] < threads for w in writes)


def test_pass_b_deferred_layout_choice():
    # W_c1^T stays resident at I = 144 with 128-column items and 288
    # threads (every 8 x 8 tile busy); I = 512 runs on the tensor cores,
    # one block of 512 threads (8 consumer, 8 producer warps) per SM
    # (151,552 B: two do not fit an SM's 233,472 B), with a workspace of
    # the column maxima and exponentials.
    assert st.pass_b_deferred_layout(144, 1024) == ("resident", 128, 288,
                                                    231_936)
    assert st.pass_b_deferred_layout(512, 256) == ("mma", 128, 512,
                                                   151_552)
    assert 2 * st.pass_b_mma_smem_bytes() > st._SM_SMEM
    assert st.pass_b_deferred_work_floats(192, 512, 256) == 192 * 256 * 513
    assert st.pass_b_deferred_work_floats(8, 144, 1024) == 0
    assert st.pass_b_deferred_layout(40, 20)[:2] == ("resident", 32)
    assert st.pass_b_deferred_layout(240, 128)[0] == "mma"
    # The classification's input is the first kernel's footprint, as
    # before.
    assert st.pass_b_deferred_smem_bytes(144) == 28_800
    assert st.pass_b_deferred_smem_bytes(512) == 99_456


def _pass_b_c1_writes(R, I, J, grid):
    """Pass B's c1 pass, following the kernel's loops: step q = block +
    it * grid holds field rows q*RB.. (a partial last step skips the rest);
    r1-style rounds of G column groups (rr, cg) over every i-block.
    Returns the counts of the outputs (r, i, j), j < J, stored, and checks
    that each round's items cover whole column groups (every i-block of a
    group in the round that reads it) and that a warp's threads span at
    most two i-blocks (two W_c1^T addresses per load) where the round has
    32 groups or more."""
    rb, threads, slabs, wres, smem = st.pass_b_layout(I, J)[:5]
    Jp, Ip = st._up4(J), st._up8(I)
    IB, CG = Ip // 8, Jp // 4
    NG = rb * CG
    G = min(NG, max(1, threads // IB))
    out = np.zeros((R, I, J), int)
    n_steps = -(-R // rb)
    for block in range(min(grid, n_steps)):
        for q in range(block, n_steps, grid):
            r0, rows = q * rb, min(rb, R - q * rb)
            for g0 in range(0, NG, G):
                gw = min(G, NG - g0)
                tid = np.arange(gw * IB)
                assert gw * IB <= threads
                ib = tid // gw
                g = g0 + tid - ib * gw
                assert sorted(zip(g.tolist(), ib.tolist())) == [
                    (x, y) for x in range(g0, g0 + gw) for y in range(IB)]
                if gw >= 32:
                    assert all(len(set(ib[w:w + 32])) <= 2
                               for w in range(0, len(tid), 32))
                rr, j0 = np.divmod(g, CG)
                j0 = 4 * j0
                live = rr < rows
                for a in range(8):
                    for b in range(4):
                        ok = live & (8 * ib + a < I) & (j0 + b < J)
                        np.add.at(out, (r0 + rr[ok], 8 * ib[ok] + a,
                                        j0[ok] + b), 1)
            # lse with c2: the exp pass's float4 items cover the step's
            # rows * I * Jp values exactly.
            assert rows * I * Jp % 4 == 0
    return out


def _pass_b_c2_writes(R, I, J, grid):
    """Pass B's c2 product (pass_b_mma_kernel<true, .> on (M, N) = (R*I, J),
    the N tiles fastest): counts of the outputs (m, n) the consumer
    threads store."""
    M, N = R * I, J
    n_m, n_n = -(-M // st._MMA_BM), -(-N // st._MMA_BN)
    ci, cj = _mma_thread_cells()
    out = np.zeros((M, N), int)
    for block in range(min(grid, n_m * n_n)):
        for t in range(block, n_m * n_n, grid):
            j0, i0 = (t % n_n) * st._MMA_BN, (t // n_n) * st._MMA_BM
            i, j = i0 + ci, j0 + cj
            ok = (i < M) & (j < N)
            np.add.at(out, (i[ok], j[ok]), 1)
    return out


# (R, I, J, grid) of pass B: the SSY cell's (I, J) = (32, 384) (one row a
# step), the continuous-SSY cell's (56, 64) (two rows a step, a partial
# last step), (6, 64) (eight rows a step), ragged I and J (J % 4 != 0, I
# not a multiple of 8), (512, 40) (one slab, W_c1 from global memory),
# (12, 258) and a grid smaller than the steps or tiles.
PASSB_CASES = [(5, 32, 384, 3), (7, 56, 64, 2), (17, 6, 64, 2),
               (5, 56, 42, 3), (4, 13, 37, 1), (3, 1, 1, 2),
               (3, 512, 40, 2), (9, 12, 258, 4), (4, 200, 20, 3)]


@pytest.mark.parametrize("R,I,J,grid", PASSB_CASES)
def test_pass_b_layout_owns_every_output_once(R, I, J, grid):
    lay = st.pass_b_layout(I, J)
    rb, threads, slabs, wres, smem = lay[:5]
    assert smem <= st.SMEM_LIMIT and lay[10] <= st.SMEM_LIMIT
    assert threads % 32 == 0 and threads <= 384 and slabs in (1, 2)
    assert 1 <= rb <= 8
    c1 = _pass_b_c1_writes(R, I, J, grid)
    assert c1.min() == c1.max() == 1
    c2 = _pass_b_c2_writes(R, I, J, grid)
    assert c2.min() == c2.max() == 1


def test_pass_b_layout_choice():
    # The SSY cell: one field row a step, 384 threads of 8 x 4 tiles (all
    # busy), two 48 KB slabs and W_c1^T: two blocks per SM; (56, 64): two
    # rows a step, 224 threads; (512, 40): one slab and W_c1 read from
    # global memory, 384 threads in rounds.  The c2 product: 128 x 128
    # tiles, 16-deep K-chunks, a 4-stage ring, 512 threads, one block per
    # SM.
    assert st.pass_b_layout(32, 384)[:5] == (1, 384, 2, 1, 104_064)
    assert 2 * 104_064 <= st._SM_SMEM - 2 * st._BLOCK_RESERVED
    assert st.pass_b_layout(56, 64)[:5] == (2, 224, 2, 1, 70_848)
    assert st.pass_b_layout(512, 40)[:5] == (1, 384, 1, 0, 84_128)
    assert st.pass_b_layout(32, 384)[5:] == (128, 128, 16, 4, 512, 157_696)
    assert 2 * st.pass_b_mma_smem_bytes(a_mk=True) > st._SM_SMEM
    assert st.pass_b_work_floats(1024, 32, 384, True) == 1024 * 32 * 385
    assert st.pass_b_work_floats(5, 56, 42, True) == 5 * 56 * 45
    assert st.pass_b_work_floats(3136, 56, 64, False) == 0


@pytest.mark.parametrize("I0", range(1, 301, 50))
def test_pass_b_layout_covers_the_first_kernel(I0):
    # Every (I, J) the first pass-B kernel's block took
    # (pass_b_smem_bytes, the footprint streamed_config classifies by)
    # has a layout; the accepted J of an I run from 1 up.
    for I in range(I0, I0 + 50):
        J = 1
        while st.pass_b_smem_bytes(I, J) <= st.SMEM_LIMIT:
            lay = st.pass_b_layout(I, J)
            assert lay is not None and lay[4] <= st.SMEM_LIMIT, (I, J)
            J += 1


@pytest.mark.parametrize("L0", range(1, 301, 60))
def test_strip_row_layout_covers_the_first_pass_c_kernel(L0):
    # Pass C runs the row kernel: every (L, K) the first pass-C kernel's
    # tile took (pass_c_tile, the footprint streamed_config classifies
    # by; R up to ~29,000) has a row layout.
    for L in range(L0, L0 + 60):
        for K in range(1, 301):
            if st.pass_c_tile(L * K, K) is not None:
                lay = st.strip_row_layout(L, K)
                assert lay is not None and lay[2] <= st.SMEM_LIMIT, (L, K)


def _ldmatrix(addr_of_lane):
    """What ldmatrix.x4 (b16, 8 x 8 matrices) hands each lane when every
    row is 4 floats: matrix q's 8 rows start at the addresses lanes 8q..
    8q + 7 give; lane l receives word l % 4 of row l // 4 of each matrix.
    Returns (32, 4) float addresses."""
    lanes = np.arange(32)
    return np.stack([addr_of_lane[8 * q + lanes // 4] + lanes % 4
                     for q in range(4)], axis=1)


def test_pass_b_mma_fragments_follow_the_mma_layout():
    # The hi/lo operands: A[i][k] and B[j][k] at row stride kMmaLdT = 20,
    # read by ldmatrix.
    ld = st._MMA_LD_T
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for mt, k0 in ((0, 0), (3, 8)):
        row0 = 16 * mt
        a_row = (lane & 7) + ((lane >> 3) & 1) * 8
        a_k = (lane >> 4) * 4
        got = _ldmatrix((row0 + a_row) * ld + k0 + a_k)
        # mma.m16n8k8 .tf32 A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
        # a3 (g + 8, t + 4).
        want = np.stack([(row0 + g + 8 * (q & 1)) * ld + k0 + t + 4 * (q >> 1)
                         for q in range(4)], axis=1)
        assert np.array_equal(got, want)
    for np_, k0 in ((0, 0), (1, 8)):
        n0 = 16 * np_
        b_row = (lane & 7) + ((lane >> 4) & 1) * 8
        b_k = ((lane >> 3) & 1) * 4
        got = _ldmatrix((n0 + b_row) * ld + k0 + b_k)
        # B (col): b0 (k = t, n = g), b1 (k = t + 4, n = g); registers 0-1
        # for n-tile 2*np, 2-3 for n-tile 2*np + 1.
        want = np.stack([(n0 + 8 * (q >> 1) + g) * ld + k0 + t + 4 * (q & 1)
                         for q in range(4)], axis=1)
        assert np.array_equal(got, want)
    # Each 8-row matrix read hits 32 distinct banks (rows of 16 bytes at a
    # stride of 80 bytes); so do a producer warp's split stores (row * 20
    # + k) and raw reads (k * 136 + row).
    rows = np.arange(8)[:, None] * ld + np.arange(4)[None, :]
    assert len(set((rows % 32).ravel())) == 32
    rr, kk = lane >> 2, lane & 3
    assert len(set((rr * ld + kk) % 32)) == 32
    assert len(set((kk * st._MMA_LD_RAW + rr) % 32)) == 32


@pytest.mark.parametrize("I,chunks_per_tile,tiles", [(512, 32, 3),
                                                     (301, 19, 2), (16, 1, 5)])
def test_pass_b_mma_pipeline_hands_each_chunk_over_once(
        I, chunks_per_tile, tiles):
    # Producers, chunk g: sync (chunk g - 1's raw stage free), copy chunk
    # g + S - 1 into it, wait until at most S - 1 groups are pending (chunk
    # g landed), sync, wait for buffer g % B's release (g >= B), split, mark
    # it full.  Consumers, chunk g: wait until full, multiply, release it
    # (when a chunk g + B exists).  Simulated as events in program order.
    S, B = st._MMA_STAGES, st._MMA_BUFS
    assert -(-I // st._MMA_BK) == chunks_per_tile
    total = chunks_per_tile * tiles
    issued = {c: -1 for c in range(min(S - 1, total))}
    split, released = {}, {}
    for g in range(total):
        c = g + S - 1
        if c < total:
            # The stage held chunk g - 1, split before this iteration's
            # first barrier.
            assert c % S == (g - 1) % S and (g == 0 or split[g - 1] < g)
            issued[c] = g
        # wait_group(S - 1): the S - 1 groups committed after chunk g's
        # (empty ones past the last chunk) may be pending.
        assert issued[g] <= g
        if g >= B:
            assert released[g - B] < g         # buffer g % B free again
        split[g] = g                           # full: consumers multiply g
        if g + B < total:
            released[g] = g                    # one release per wait
    assert sorted(split) == list(range(total))
    assert sorted(g + B for g in released) == list(range(B, total))
    # Every (row, k) of a 128 x 16 chunk is split by one (producer warp,
    # lane, half, k-block), A and B alike; every raw entry is copied by one
    # producer thread (16-byte copies when I (A) or J (B) is a multiple of
    # 4, else 4-byte ones).
    cells = collections.Counter(
        (16 * w + 8 * h + (ln >> 2), 4 * kb + (ln & 3))
        for w in range(st._MMA_PRODUCERS // 32) for ln in range(32)
        for h in range(2) for kb in range(st._MMA_BK // 4))
    assert len(cells) == st._MMA_BM * st._MMA_BK
    assert set(cells.values()) == {1}
    P = st._MMA_PRODUCERS
    for vec in (True, False):
        n = 128 * 16 // (4 if vec else 1)
        x = (np.arange(P)[:, None] + P * np.arange(-(-n // P))).ravel()
        x = x[x < n]
        got = ({(k, 4 * c + q) for k, c in zip(x >> 5, x & 31)
                for q in range(4)} if vec else set(zip(x >> 7, x & 127)))
        assert len(x) == n and len(got) == 128 * 16


def _strip_row_walk(L, K, C, grid):
    """Follow the row kernel's loops over every tile (tile t to block t %
    grid) on a tagged copy of its shared slab: each stage reads the
    entries it means to (the fetch's (r, c), r1's columns within its
    round), and returns the counts of the outputs (r, c) stored.  Items
    span V = 4 columns in the wide layout, 1 in the narrow one."""
    TC, threads, smem, LS, slabs, wide = tt.strip_row_layout(L, K)
    V = 4 if wide else 1
    R, KT, CG = L * K, K * TC, TC // V
    Lp, Kp = st._up8(L), st._up8(K)
    LB, NG = Lp // 8, KT // V
    G = min(NG, max(1, threads // LB))
    out = np.zeros((R, C), int)
    for t in range(-(-C // TC)):
        c0 = t * TC
        tcw = min(TC, C - c0)
        # fetch: row r = (l, k) at l*LS + k*TC, tagged r*TC + c.
        slab = np.full(L * LS, -1)
        r, c = np.divmod(np.arange(R * TC), TC)
        l, k = np.divmod(r, K)
        addr = l * LS + k * TC + c
        assert len(set(addr)) == R * TC and addr.max() < L * LS
        slab[addr] = r * TC + c
        tag = lambda l_, n: (l_ * K + n // TC) * TC + n % TC
        # 1. a thread per column n = (k, c) reads x[l*LS + n] for every l.
        n = np.arange(KT)
        for l_ in range(L):
            assert np.array_equal(slab[l_ * LS + n], tag(l_, n))
        # 2. r1 in rounds: items (lb, column group) read x[m*LS + n0..]
        # and write y[l*LS + n0..] for their 8 rows; a round reads only its
        # own columns.
        written = np.zeros((L, KT), int)
        for g0 in range(0, NG, G):
            gw = min(G, NG - g0)
            tid = np.arange(gw * LB)
            lb = tid // gw
            n0 = V * (g0 + tid - lb * gw)
            cols = set(n0.tolist())
            assert cols == set(range(V * g0, V * (g0 + gw), V))
            for m in range(L):
                for q in range(V):
                    assert np.array_equal(slab[m * LS + n0 + q],
                                          tag(m, n0 + q))
            for a in range(8):
                ok = 8 * lb + a < L
                for q in range(V):
                    np.add.at(written, (8 * lb[ok] + a, n0[ok] + q), 1)
        assert written.min() == written.max() == 1
        # 3. a thread per (l, c) reads y[l*LS + k*TC + c] for every k: the
        # r1 output of row l, column n = k*TC + c.
        p = np.arange(L * TC)
        l_, c_ = np.divmod(p, TC)
        for k_ in range(K):
            assert np.array_equal(slab[l_ * LS + k_ * TC + c_],
                                  tag(l_, k_ * TC + c_))
        # 4. r2 items (k-block, l, column group) store rows l*K + k0..,
        # columns c0 + V*cq.. below the tile's width.
        item = np.arange((Kp // 8) * L * CG)
        kb, rest = np.divmod(item, L * CG)
        l2, cq = np.divmod(rest, CG)
        for a in range(8):
            for q in range(V):
                ok = (8 * kb + a < K) & (V * cq + q < tcw)
                np.add.at(out, (l2[ok] * K + 8 * kb[ok] + a,
                                c0 + V * cq[ok] + q), 1)
    return out


# (L, K, C, grid): the SSY cell (32, 32, 12288), the GCY view's (12, 16,
# C), C4's (103, 41) (TC = 4, r1 in two rounds), L or K of 1, C ragged
# (not a multiple of TC or of 4, below one tile); narrow: the plain SSY
# Tauchen set one step past C4's (128, 48), (80, 80), L = 300 and K =
# 300 (W^T too large), and (170, 170) (one slab, TC = 1).
ROW_WALKS = [(32, 32, 12288 // 24, 7), (12, 16, 1000, 5), (103, 41, 70, 3),
             (1, 32, 130, 2), (32, 1, 67, 4), (1, 1, 9, 1), (20, 13, 257, 3),
             (16, 12, 66, 2), (128, 48, 7, 2), (80, 80, 5, 3),
             (300, 2, 61, 2), (2, 300, 29, 1), (170, 170, 3, 2)]


@pytest.mark.parametrize("L,K,C,grid", ROW_WALKS)
def test_strip_row_layout_owns_every_output_once(L, K, C, grid):
    TC, threads, smem, LS, slabs, wide = tt.strip_row_layout(L, K)
    assert smem <= st.SMEM_LIMIT and threads == 512 and slabs in (1, 2)
    out = _strip_row_walk(L, K, C, grid)
    assert out.min() == out.max() == 1
    if not wide:
        assert LS == K * TC
        return
    # LS = TC (mod 32): a quarter-warp's float4 reads of r2's operand
    # (TC/4 threads per row l) and the shift passes hit distinct banks.
    assert TC % 4 == 0 and slabs == 2
    assert LS % 32 == TC % 32 and LS >= K * TC
    CG = TC // 4
    addr = (np.arange(8)[:, None] // CG * LS + 4 * (np.arange(8)[:, None] % CG)
            + np.arange(4)[None, :]) if CG < 8 else None
    if addr is not None:
        assert len(set((addr % 32).ravel())) == 32


def test_strip_row_layout_choice():
    # The SSY cell: TC = 16 (R * TC = 16,384; at least 16 at L = K = 32),
    # two 66 KB slabs, one block of 512 threads per SM; the GCY view:
    # TC = 64; C4's (103, 41): TC = 4.
    assert tt.strip_row_layout(32, 32) == (16, 512, 147_456, 528, 2, 1)
    assert 2 * 147_456 > st._SM_SMEM          # one block per SM
    assert tt.strip_row_layout(12, 16) == (64, 512, 107_264, 1024, 2, 1)
    assert tt.strip_row_layout(103, 41) == (4, 512, 188_160, 164, 2, 1)
    assert tt.strip_row_tile(32, 32) == 16
    # Past the wide layout (two slabs at TC >= 4 beside W_r1^T and
    # W_r2^T) the narrow one at the widest TC that fits: (128, 48) and
    # (80, 80) at TC = 4, L = 300 at TC = 38, (170, 170) with one slab.
    assert tt.strip_row_layout(128, 48) == (4, 512, 199_424, 192, 2, 0)
    assert tt.strip_row_layout(80, 80) == (4, 512, 207_360, 320, 2, 0)
    assert tt.strip_row_layout(300, 2) == (38, 512, 228_304, 76, 2, 0)
    assert tt.strip_row_layout(170, 170) == (1, 512, 116_960, 170, 1, 0)


@pytest.mark.parametrize("L0", range(1, 301, 60))
def test_strip_row_layout_covers_the_first_row_kernel(L0):
    # The first row kernel (x and y tiles of R * TC floats each, the
    # shifts over l and k, TC from 64 down to 1) ran every (L, K) whose
    # one column, 4 * (2 * L * K + K + L) bytes, fits a block; each has a
    # layout now (the narrow one at TC = 1 with two slabs takes the same).
    for L in range(L0, L0 + 60):
        for K in range(1, 301):
            if 4 * (2 * L * K + K + L) <= st.SMEM_LIMIT:
                lay = tt.strip_row_layout(L, K)
                assert lay is not None and lay[2] <= st.SMEM_LIMIT, (L, K)


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
