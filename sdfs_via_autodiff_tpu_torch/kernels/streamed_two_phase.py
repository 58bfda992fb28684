"""Streamed two-pass operator: hand-written CUDA pass-B / pass-C kernels.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py``
for operand sets with a shared c1 factor (discrete SSY, discrete GCY,
continuous SSY and GCY).  One application of log T(w) is two passes over
the field, with R = n_r1 * n_r2 rows and C = I * J columns, in one of
four configurations.  A folded baseline (``sub_row``/``sub_col``) is
subtracted in pass B in each of them but the deferred one.

"full" (shared c2; a field row's whole (I, J) column group fits the
first pass-B kernel's block, the footprint the classification keeps):

    pass B (column phase):  ell (R, I, J) -> midway field (R, I, J), as a
                            c1 pass (U and its row shifts into a
                            workspace) and a split-TF32 tensor-core c2
                            product
    pass C (row phase):     midway field (R, C) -> log T(w) (R, C), on the
                            strip tier's row-phase kernel with the linear
                            carry of the TPU kernel's lse

A conjugated-shared set's ``mid_col`` (:func:`..operators.two_phase.
conjugate_to_shared`) is added in pass B between its c1 and c2
contractions, in lse mode ("full" and "batched" configurations).

Mode "fast" takes one shift per field row in pass B and carries the
midway field linearly, with the rescale ``exp(s - max s)`` computed on
the device between the passes; mode "lse" shifts per axis at every
contraction.

"batched" (continuous SSY, whose c2 factor P_z[i] depends on the current
c1 index i), fast or lse:

    pass B, c1 only:  ell (R, I, J) -> c1 contracted (R, I, J)
    pass C batched:   per slice i the c2 contraction with P_z[i], then
                      the row phase and the epilogue -> (R, C)

"deferred" (column groups too large for one block, e.g. the GCY
Kronecker grouping's 512 x 256), per-axis LSE only:

    pass B deferred:  ell (R, I, J) -> c1 contracted (R, I, J)
    pass C deferred:  c2 contraction, row phase, epilogue -> (R, C)

"pair" (continuous GCY, whose c2 factor is the conditioned pair
P_zpi[y, b, B] P_z[i, j, b, J] of the c1 slice (i, y)), per-axis LSE
only, with the folded baseline subtracted in pass B:

    pass B deferred:  theta*ell - sub_row - sub_col -> c1 contracted
    pass C pair:      z_pi' then z' contraction per slice, row phase,
                      epilogue -> (R, C)

Each pass has a plain PyTorch version (``pass_b_plain``, ...) and a
dispatcher (``pass_b``, ...): a CPU tensor goes to the plain version, a
CUDA tensor to the kernel in ``csrc/streamed_two_phase.cu`` (built from
source at first use) or to an error.  ``LAUNCHES`` counts the kernel
launches.

A batched operand set (the baseline-normalized discrete sets) runs here
when its conjugated-shared form is covered (:func:`streamed_coverable`).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import refuse
from ..operators.two_phase import (TwoPhaseOperands, conjugate_to_shared,
                                   make_eager_two_phase_T)
from ..utils.profiling import count, span
from . import _build

__all__ = ["LAUNCHES", "pass_b", "pass_b_plain", "pass_c", "pass_c_plain",
           "pass_b_layout", "pass_b_work_floats", "strip_row_layout",
           "pass_b_deferred_layout",
           "streamed_coverable", "streamed_accepts", "streamed_mode",
           "pass_c_batched", "pass_c_batched_plain", "pass_b_deferred",
           "pass_b_deferred_plain", "pass_c_deferred",
           "pass_c_deferred_plain", "pass_c_pair", "pass_c_pair_plain",
           "pair_device_operands", "pair_cluster_size", "pair_rows",
           "pair_row_owner", "pair_groups", "pass_c_tile",
           "pass_c_deferred_tiles", "pass_c_deferred_layout",
           "streamed_config", "streamed_supported", "make_streamed_T_log"]

# Kernel launches per pass since the last reset (the wrappers add one per
# launch; the plain versions never count).  Pass B counts its c1-only
# branch apart, with and without a folded baseline ("pass_b_c1",
# "pass_b_c1_sub"), and its mid_col branch ("pass_b_mid"); the batched
# pass C its two modes ("pass_c_batched" fast, "pass_c_batched_lse").
LAUNCHES = {"pass_b": 0, "pass_b_c1": 0, "pass_b_c1_sub": 0, "pass_b_mid": 0,
            "pass_c": 0, "pass_c_batched": 0, "pass_c_batched_lse": 0,
            "pass_b_deferred": 0, "pass_c_deferred": 0, "pass_c_pair": 0}

_MODES = {"fast": 0, "lse": 1}
# Shared memory one block may use on sm_90 (227 KB; the .cu's kSmemLimit).
SMEM_LIMIT = 232_448
_PASS_C_TILES = (32, 16, 8, 4, 2, 1)
# Shared memory of one SM (228 KB), of which each resident block reserves
# 1 KB.
_SM_SMEM, _BLOCK_RESERVED = 233_472, 1_024
# The footprint of the first deferred pass-B kernel (a block per row and
# 32 columns, 8-row K-tiles of W_c1^T, 8 partial maxima per column), which
# streamed_config still classifies by; pass C's column tiles (multiples of
# 4) and input chunks.
_DEF_BN, _DEF_BK, _DEF_PARTS = 32, 8, 8
_PASS_C_DEFERRED_TILES = (64, 32, 16, 8, 4)
_PASS_C_DEFERRED_CHUNKS = (32, 16, 8, 4)
# CUDA's limit on a grid's y dimension (rows in pass B, slices in pass C).
_GRID_Y_MAX = 65_535
# The largest int32: pass B's c2 product indexes R*I rows with it.
_INT_MAX = 2**31 - 1
# Rows of P_z per K-tile of the pair kernel (the .cu's kBK), the
# exponent bias of its exp stages and its largest cluster (the portable
# limit).
_PAIR_BK, PAIR_BIAS, PAIR_CLUSTER = 16, 25.0, 8


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def pass_b_smem_bytes(I: int, J: int) -> int:
    """Shared memory of one block of the first pass-B kernel (a block per
    field row: the (I, J) slice, which later held two 16-row K-tiles of
    W_c2, and the c1 result with rows padded to a multiple of 4): the
    footprint :func:`streamed_config` classifies by, so that no set moves
    between configurations with the kernels' layouts."""
    return 4 * (_up4(max(I * J, 32 * J)) + I * _up4(J) + max(I, J) + 32)


def pass_c_tile(R: int, K: int) -> Optional[int]:
    """Columns per block of the first pass-C kernel: the widest tile whose
    (R, TC) working set (two buffers plus the lse shifts) fits one block's
    shared memory, or None when not even one column fits.  Its footprint
    stays the classifier of :func:`streamed_config`; pass C runs the row
    kernel's layout (:func:`strip_row_layout`)."""
    for tc in _PASS_C_TILES:
        if 4 * (2 * R * tc + K * tc + tc) <= SMEM_LIMIT:
            return tc
    return None


# Pass B's c1 pass (mirroring the .cu's pass_b_c1_layout): the most
# threads of a block, the 8 x 4 register tiles per step it aims at and
# the most field rows per step.
_C1_MAX_THREADS, _C1_ITEMS, _C1_MAX_ROWS = 384, 256, 8


def _up32(n: int) -> int:
    return -(-n // 32) * 32


def pass_b_c1_smem_bytes(I: int, J: int, rb: int, slabs: int,
                         wres: int) -> int:
    """Shared memory of one c1-pass block (mirrors the .cu's
    c1_smem_floats): ``slabs`` (rb, I, round_up4(J)) slabs of the field,
    W_c1^T (I rows of round_up8(I)) when resident, the column shifts
    and the row shifts."""
    return 4 * (slabs * rb * I * _up4(J) + (I * _up8(I) if wres else 0)
                + rb * _up4(J) + rb * _up8(I))


def pass_b_layout(I: int, J: int) -> Optional[Tuple[int, ...]]:
    """Pass B's layout at (I, J) with a shared c2 or without, as its
    launchers choose it (mirrors the .cu's ``sdfs_pass_b_layout``): (rows
    per step RB, threads, slabs, W_c1^T resident, shared-memory bytes) of
    the c1 pass, then (rows, columns, K-chunk, ring stages, threads,
    shared-memory bytes) of the c2 product's tiles.  The c1 pass gives
    each thread 8 x 4 outputs (rows i, columns j) of a step of RB field
    rows, RB = 256 // (tiles per row) clamped to 1..8, threads the step's
    tiles rounded up to a warp (at most 384, two blocks an SM by
    registers, in rounds past that); two slabs with W_c1^T resident,
    then one, then W_c1 read from global memory, RB from its target
    down: the first that fits.  The c2 product (``pass_b_mma_kernel<true,
    .>``) runs 128 x 128 tiles of (R*I, J), K-chunks of 16, a 4-stage
    ring, 8 producer and 8 consumer warps.  None when the c1 pass has no
    layout."""
    tiles = (_up8(I) // 8) * (_up4(J) // 4)
    rb0 = min(max(_C1_ITEMS // tiles, 1), _C1_MAX_ROWS)
    for slabs, wres in ((2, 1), (1, 1), (1, 0)):
        for rb in range(rb0, 0, -1):
            smem = pass_b_c1_smem_bytes(I, J, rb, slabs, wres)
            if smem <= SMEM_LIMIT:
                return (rb, min(_C1_MAX_THREADS, _up32(rb * tiles)), slabs,
                        wres, smem, _MMA_BM, _MMA_BN, _MMA_BK, _MMA_STAGES,
                        _MMA_THREADS, pass_b_mma_smem_bytes(a_mk=True))
    return None


def pass_b_work_floats(R: int, I: int, J: int, c2: bool) -> int:
    """float32 workspace of pass B (mirrors the .cu's
    sdfs_pass_b_work_floats): with a shared c2 the c2 product's operand U
    (R*I rows of round_up4(J), zeros past J) and the lse row shifts
    (R*I); 0 without c2."""
    return R * I * _up4(J) + R * I if c2 else 0


def pass_b_deferred_smem_bytes(I: int) -> int:
    """Shared memory of one block of the first deferred pass-B kernel
    (the exponentiated (I, 32) strip, two 8-row K-tiles of W_c1^T with
    rows padded to a multiple of 4, partial column maxima and shifts): the
    footprint :func:`streamed_config` classifies by, so that no set moves
    between configurations with the kernels' layouts."""
    return 4 * (I * _DEF_BN + 2 * _DEF_BK * _up4(I)
                + _DEF_PARTS * _DEF_BN + _DEF_BN)


# The deferred pass B's resident layout (mirroring the .cu): the most
# threads of a block (kResMaxThreads), the partial column maxima per
# column (kResParts) and the item widths pass_b_resident_bn chooses from.
_RES_MAX_THREADS, _RES_PARTS, _RES_WIDTHS = 384, 2, (32, 64, 128)
# The tensor-core layout (mirroring the .cu's kMma* constants): consumer
# and producer threads, rows i and columns j per tile, rows m per K-chunk,
# raw ring stages, hi/lo operand buffers and the shared-memory row strides
# of a raw chunk and of the hi/lo operands.
_MMA_CONSUMERS, _MMA_PRODUCERS = 256, 256
_MMA_THREADS = _MMA_CONSUMERS + _MMA_PRODUCERS
_MMA_BM, _MMA_BN, _MMA_BK, _MMA_STAGES, _MMA_BUFS = 128, 128, 16, 4, 2
_MMA_LD_RAW, _MMA_LD_T = _MMA_BM + 8, _MMA_BK + 4


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def pass_b_resident_smem_bytes(I: int, BN: int) -> int:
    """Shared memory of one resident deferred pass-B block (mirrors the
    .cu: W_c1^T with rows padded to a multiple of 8, two (I, BN) strips,
    the partial column maxima and the shifts)."""
    return 4 * (I * _up8(I) + 2 * I * BN + _RES_PARTS * BN + BN)


def pass_b_resident_threads(I: int, BN: int) -> int:
    """Threads of one resident block: an 8 x 8 output tile each over the
    (I, BN) item, rounded up to whole warps."""
    return -(-(BN // 8) * (_up8(I) // 8) // 32) * 32


def pass_b_mma_smem_bytes(a_mk: bool = False) -> int:
    """Shared memory of one block of the split-TF32 product (mirrors the
    .cu's mma_smem_floats): a ring of raw K-chunks, A's and B's, and two
    buffers of the hi and lo operands, 4 x (128, 20).  B's raw chunk and
    A's in the deferred pass B (W_c1^T) are (16, 136) slabs; A's in pass
    B (``a_mk``: U, stored (M, K)) is (128, 20)."""
    raw_a = _MMA_BM * _MMA_LD_T if a_mk else _MMA_BK * _MMA_LD_RAW
    return 4 * (_MMA_STAGES * (raw_a + _MMA_BK * _MMA_LD_RAW)
                + _MMA_BUFS * 4 * _MMA_BM * _MMA_LD_T)


def pass_b_deferred_work_floats(R: int, I: int, J: int) -> int:
    """float32 workspace of the deferred pass B (mirrors the .cu's
    sdfs_pass_b_deferred_work_floats): the tensor-core layout's column
    maxima (R*J) and exponentials e = exp(a - m) (R*I*J); 0 for the
    resident layout."""
    if pass_b_deferred_layout(I, J)[0] == "resident":
        return 0
    return R * J + R * I * J


def pass_b_deferred_layout(I: int, J: int) -> Tuple[str, int, int, int]:
    """(layout, columns per item or tile, threads, shared-memory bytes)
    of the deferred pass B at (I, J), as its launcher chooses (mirrors the
    .cu's ``sdfs_pass_b_deferred_layout``): "resident" (W_c1^T in shared
    memory, a persistent grid over items of BN columns, BN the narrowest of
    32, 64, 128 covering J, else the widest, that fits) when it fits a
    block, else "mma" (an exp pass writing the column maxima and e =
    exp(a - m) to a workspace, then a persistent grid over tiles of 128
    rows i x 128 columns j of one field row, 8 producer warps copying
    K-chunks of 16 into a ring of 4 stages and splitting them into TF32 hi
    and lo, 8 consumer warps running the split-TF32 products on the tensor
    cores).  The classification of
    :func:`streamed_config` stays on :func:`pass_b_deferred_smem_bytes`."""
    best = 0
    for bn in _RES_WIDTHS:
        if (pass_b_resident_smem_bytes(I, bn) > SMEM_LIMIT
                or pass_b_resident_threads(I, bn) > _RES_MAX_THREADS):
            continue
        best = bn
        if bn >= J:
            break
    if best:
        return ("resident", best, pass_b_resident_threads(I, best),
                pass_b_resident_smem_bytes(I, best))
    return "mma", _MMA_BN, _MMA_THREADS, pass_b_mma_smem_bytes()



def _pass_c_deferred_smem_bytes(L: int, K: int, TC: int, JK: int) -> int:
    """Shared memory of one deferred pass-C block (mirrors the .cu: the
    (R, TC) accumulator, a region holding the transposed chunk or the r1
    result, the raw (R, JK) chunk, the W_c2^T chunk and the shifts)."""
    R = L * K
    return 4 * (R * TC + max(JK * (_up4(R) + 4), R * TC) + R * JK
                + JK * TC + _up4(R) + _up4(K) + 4)


def pass_c_deferred_tiles(L: int, K: int) -> Optional[Tuple[int, int]]:
    """(TC, JK) of the earlier deferred pass-C kernel's block (all R rows,
    the (R, TC) accumulator in shared memory): the widest column tile,
    then the widest input chunk, that leave room for two blocks per SM,
    else that fit one block; None when none fits.  Its footprint stays
    the classifier of :func:`streamed_config`, so that no set moves
    between configurations; the kernel runs the layout of
    :func:`pass_c_deferred_layout`."""
    for limit in (_SM_SMEM // 2 - _BLOCK_RESERVED, SMEM_LIMIT):
        for tc in _PASS_C_DEFERRED_TILES:
            for jk in _PASS_C_DEFERRED_CHUNKS:
                if _pass_c_deferred_smem_bytes(L, K, tc, jk) <= limit:
                    return tc, jk
    return None


# The deferred and batched pass C's slab layout (mirroring the .cu): the
# most threads of a block (kSlabMaxThreads), the widest column tile
# (kSlabMaxTC) and the largest cluster (kSlabMaxCluster, the portable
# limit).
_SLAB_MAX_THREADS, _SLAB_MAX_TC, _SLAB_MAX_CLUSTER = 512, 128, 8


def pass_c_slab_smem_bytes(L: int, K: int, nk: int, nl: int, TC: int,
                           JK: int) -> int:
    """Shared memory of one slab block (mirrors the .cu's
    slab_smem_floats): region A (the slab's accumulator, later the
    l-slab's gathered y) and B, as large (the slab's y, later r2's
    result), which the streamed chunks (two raw with rows padded by 4,
    two transposed, three W_c2^T) alias during the J loop; W_r1^T or
    W_r2^T padded to 8 rows; m1, two chunks' rescale factors, M2, the
    slab maximum and the rows' field-row table."""
    rows = L * nk
    chunks = (2 * rows * (JK + 4) + 2 * JK * (_up8(rows) + 4) + 3 * JK * TC)
    ab = 2 * max(rows, nl * K) * TC
    wt = max(L * _up8(L), K * _up8(K))
    return 4 * (max(chunks, ab) + wt + _up4(rows) + 2 * _up8(rows)
                + _up4(nk) + 4 + _up4(rows))


def pass_c_deferred_layout(
        L: int, K: int,
        J: int) -> Optional[Tuple[str, int, int, int, int, int]]:
    """(layout, cluster size cs, column tile TC, chunk columns JK,
    threads, shared-memory bytes) of the deferred and batched pass C at
    (L, K, J), as its launcher chooses them (mirrors the .cu's
    pass_c_slab_layout): the widest TC (a multiple of 8, at most 128 and
    the J rounded up to 8), then the smallest cluster whose k-slabs of nk
    = ceil(K / cs) give a block of at most 512 threads (an 8 x 8 tile
    each over the slab's L * nk rows and TC columns) that fits shared
    memory, with JK = 32 where that fits, else 16.  "block" when one
    block holds all rows (cs = 1), else "cluster"; None when nothing fits
    (some sets with L or K above 100 that the earlier kernel's footprint,
    :func:`pass_c_deferred_tiles`, accepts).  Block rank rho owns k-slab
    rho (rows (l, k), k in [rho * nk, (rho + 1) * nk)) for the c2 product
    and r1, and l-slab rho (nl = ceil(L / cs)) for r2 and the
    epilogue."""
    for tc in range(min(_SLAB_MAX_TC, _up8(J)), 0, -8):
        for cs in range(1, min(_SLAB_MAX_CLUSTER, K) + 1):
            nk = -(-K // cs)
            if -(-K // nk) != cs:
                continue
            nl = -(-L // cs)
            threads = -(-(-(-L * nk // 8)) * (tc // 8) // 32) * 32
            if threads > _SLAB_MAX_THREADS:
                continue
            for jk in (32, 16):
                smem = pass_c_slab_smem_bytes(L, K, nk, nl, tc, jk)
                if smem <= SMEM_LIMIT:
                    return ("block" if cs == 1 else "cluster", cs, tc, jk,
                            threads, smem)
    return None


def pass_c_pair_smem_bytes(R: int, K: int, n_j: int) -> int:
    """Shared memory of one pair pass-C block (mirrors the .cu: the
    (R, n_j) accumulator with rows padded to a multiple of 4, the (R,
    n_j) product and two 16-row K-tiles of P_z (which first hold the
    cluster's staging area, at most (R + 7) rows of n_j) and the shifts,
    whatever the number of z_pi points)."""
    return 4 * (R * _up4(n_j) + R * n_j + 2 * _PAIR_BK * n_j + _up4(R)
                + _up4(K) + 4)


def pair_cluster_size(n_b: int) -> int:
    """Blocks per slice of the pair kernel, one thread-block cluster
    (mirrors the .cu): n_b, at most the portable cluster size 8."""
    return min(n_b, PAIR_CLUSTER)


def pair_rows(rank: int, R: int, n_b: int) -> range:
    """The rows whose maxima, exponentials and z_pi' sums cluster rank
    ``rank`` computes (mirrors the .cu's pair_row0)."""
    cs = pair_cluster_size(n_b)
    return range(rank * R // cs, (rank + 1) * R // cs)


def pair_row_owner(r: int, R: int, n_b: int) -> int:
    """The cluster rank whose :func:`pair_rows` hold row r (mirrors the
    .cu's pair_row_owner)."""
    return ((r + 1) * pair_cluster_size(n_b) - 1) // R


def pair_groups(rank: int, n_b: int) -> list:
    """The output groups b (slabs of n_j columns) that cluster rank
    ``rank`` contracts, transforms and writes: b = rank in each round of
    cluster-size groups."""
    cs = pair_cluster_size(n_b)
    return list(range(rank, n_b, cs))


# The row phase's layout (mirroring row_phase.cuh's strip_row_layout):
# threads per block, the R * TC a tile aims at and the widest tile.
_ROW_THREADS, _ROW_TILE_FLOATS, _ROW_TC_MAX = 512, 16_384, 64


def strip_row_layout(L: int, K: int) -> Optional[Tuple[int, ...]]:
    """(TC, threads, shared-memory bytes, LS, slabs, wide) of the row
    phase at (L, K), as its launcher chooses (mirrors row_phase.cuh,
    which ``sdfs_strip_row_layout`` reports): the strip tier's row phase
    and the streamed tier's pass C with a shared c2.  With tc0 = min(64,
    16384 // R): "wide" (1), TC a multiple of 4 from max(4, tc0) down,
    two (L, LS) slabs of the midway tile (row l's K*TC columns at a
    stride LS = TC (mod 32)),
    W_r1^T and W_r2^T with rows padded to 8, the shifts over l (K*TC) and
    over k (L*TC); else "narrow" (0), TC from 64 down, LS = K*TC, W_r1
    and W_r2 read from global memory, two slabs, then one.
    The first block that fits; None when none does."""
    R = L * K
    tc0 = min(_ROW_TILE_FLOATS // R, _ROW_TC_MAX)
    for tc in range(max(4, tc0 // 4 * 4), 3, -4):
        ls = K * tc + (tc - K * tc) % 32
        smem = 4 * (2 * L * ls + (K + L) * tc + L * _up8(L) + K * _up8(K))
        if smem <= SMEM_LIMIT:
            return tc, _ROW_THREADS, smem, ls, 2, 1
    for slabs in (2, 1):
        for tc in range(_ROW_TC_MAX, 0, -1):
            smem = 4 * (slabs * L * K * tc + (K + L) * tc)
            if smem <= SMEM_LIMIT:
                return tc, _ROW_THREADS, smem, K * tc, slabs, 0
    return None



def streamed_config(ops: TwoPhaseOperands) -> Optional[str]:
    """The kernels' configuration for this operand set, with or without
    a folded baseline: "pair" for a continuous-GCY set whose blocks fit;
    "batched" for a set whose c2 factor is batched over the current c1
    index (continuous SSY) when a field row's (I, J) group fits a pass-B
    block, the deferred pass-C tiles fit and the slab kernel has a
    layout (:func:`pass_c_deferred_layout`); for shared factors "full"
    when the (I, J) group fits a pass-B block and the pass-C tile fits,
    else "deferred" when the deferred passes' blocks fit and the slab
    kernel has a layout; else None
    (batched c1 factors, mid_col corrections on a pair or deferred set,
    or blocks beyond shared memory or the grid: not covered).  A
    batched set may still be covered through its conjugated-shared form
    (:func:`streamed_coverable`)."""
    L, K, I, J = ops.shapes
    if ops.c1_batched or (ops.has_mid and ops.is_pair):
        return None
    if ops.is_pair:
        n_j = ops.pair_shapes[3]
        if (pass_b_deferred_smem_bytes(I) <= SMEM_LIMIT
                and pass_c_pair_smem_bytes(L * K, K, n_j) <= SMEM_LIMIT
                and max(L * K, I) <= _GRID_Y_MAX):
            return "pair"
        return None
    row_block = pass_b_smem_bytes(I, J) <= SMEM_LIMIT
    # The deferred and batched pass C run the sets the earlier kernel's
    # footprint accepts and the slab kernel has a layout for.
    slab = (pass_c_deferred_tiles(L, K) is not None
            and pass_c_deferred_layout(L, K, J) is not None)
    if ops.c2_batched:
        if row_block and slab and I <= _GRID_Y_MAX:
            return "batched"
        return None
    if row_block and pass_c_tile(L * K, K) is not None:
        return "full"
    if (not ops.has_mid and pass_b_deferred_smem_bytes(I) <= SMEM_LIMIT
            and slab and max(L * K, I) <= _GRID_Y_MAX):
        return "deferred"
    return None


def streamed_supported(ops: TwoPhaseOperands) -> bool:
    """True when the kernels cover this operand set (either
    configuration, see :func:`streamed_config`)."""
    return streamed_config(ops) is not None


def streamed_coverable(ops: TwoPhaseOperands) -> Optional[TwoPhaseOperands]:
    """The operand set the streamed kernels would run for ``ops``: ``ops``
    itself, its conjugated-shared form when that lifts a batched factor
    into coverage, or None."""
    if streamed_supported(ops):
        return ops
    if ops.c1_batched or ops.c2_batched:
        conj = conjugate_to_shared(ops)
        if conj is not None and conj is not ops and streamed_supported(conj):
            return conj
    return None


def _warn_conjugated_f32_floor(conj: TwoPhaseOperands,
                               floor: float = -150.0) -> None:
    """Accuracy-envelope warning for conjugated-shared operand sets.

    The shared column factors are float32 linear-space matrices, so
    entries whose log lies below float32's floor flush to zero; the
    conjugation's sub/add corrections (hundreds of log units on
    wide-Rouwenhorst GCY grids) can make those entries significant again.
    The JAX package measured the one-application sup error against
    float64 at 1.3e-6 for a factor log-range of -144, 1.8e-4 at -182 and
    0.22 at -221: warn past -150."""
    import warnings
    lo = 0.0
    for W in (conj.W_c1, conj.W_c2):
        W = np.asarray(W, np.float64)
        pos = W[W > 0]
        if pos.size:
            lo = min(lo, float(np.log(pos.min())))
    if lo < floor:
        warnings.warn(
            f"conjugated-shared factors span e^{lo:.0f}..e^0: entries "
            "below float32's representable floor flush to zero, and the "
            "conjugation corrections can make them significant — f32 "
            "accuracy degrades on this grid (measured: ~1e-6 sup error "
            "at factor log-range -144, 1.8e-4 at -182, 0.22 at -221). "
            "Use the per-axis normalized chain (kernel='xla', "
            "baseline='loglinear'), discretization='tauchen', or "
            "float64.", stacklevel=3)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (choose 'fast' or 'lse')")


def _lse_only(ops: TwoPhaseOperands) -> bool:
    """The deferred and pair configurations and a set with ``mid_col``
    run per-axis LSE only (the single-shift fast mode is unsafe at their
    column-group spans)."""
    return streamed_config(ops) in ("deferred", "pair") or ops.has_mid


def streamed_accepts(ops: TwoPhaseOperands, mode: str) -> bool:
    """False when ``mode`` is "fast" and the covered set runs per-axis LSE
    only."""
    return not (mode == "fast" and _lse_only(ops))


def streamed_mode(ops: TwoPhaseOperands, mode: str) -> str:
    """The mode the streamed kernels run a covered set in: "auto" is
    "lse" for a set with a folded baseline or ``mid_col`` and for the
    deferred and pair configurations, "fast" otherwise.  Raises
    ``ValueError`` for "fast" where only "lse" is safe."""
    if mode == "auto":
        return "lse" if (_lse_only(ops) or ops.has_sub) else "fast"
    _check_mode(mode)
    if not streamed_accepts(ops, mode):
        raise ValueError(
            "deferred-c2 and pair operand sets and mid_col corrections run "
            "per-axis LSE only (the single-shift fast mode is unsafe at "
            "their column-group spans)")
    return mode


# --------------------------------------------------------------- pass B

def _check_sub(sub_row, sub_col) -> None:
    if (sub_row is None) != (sub_col is None):
        raise ValueError("give both sub_row and sub_col, or neither")


def _folded(ell, theta: float, sub_row, sub_col):
    """a = theta*ell, or with a folded baseline (``sub_row`` (R,),
    ``sub_col`` (I, J)) a = theta*ell - sub_row[r] - sub_col[i, j].

    theta*ell - sub_row is one fused multiply-add (a single rounding, as
    the kernels and the TPU kernel's compiler compute it): the baseline
    cancels theta*ell (~ -107 for SSY, ~ -240 for GCY) down to O(1),
    where a separate rounding of the product would be 1e-5 of error."""
    if sub_row is None:
        return theta * ell
    # float32 theta times float32 ell is exact in float64.
    th = float(torch.tensor(theta, dtype=ell.dtype))
    return (th * ell.double() - sub_row.double()[:, None, None]).to(
        ell.dtype) - sub_col[None, :, :]


def _check_mid(mode: str, mid_col) -> None:
    if mid_col is not None and mode != "lse":
        raise ValueError("mid_col (conjugated-shared) operands need the lse "
                         "mode")


def pass_b_plain(ell, W_c1, W_c2t, theta: float, mode: str, sub_row=None,
                 sub_col=None, mid_col=None):
    """Column phase of ``ell`` (R, I, J): a = theta*ell (less the folded
    baseline ``sub_row`` (R,), ``sub_col`` (I, J), both or neither, see
    :func:`_folded`); contract i' with ``W_c1`` (I, I), add ``mid_col``
    (I, J) when given (lse mode only), then contract j' with ``W_c2t``
    (J', J) = W_c2 transposed, or not at all when ``W_c2t`` is None (a c2
    factor batched over i contracts in :func:`pass_c_batched`).

    fast: returns (mid, s) with s (R, 1) = max over the row's (I, J) of
    a and mid = W_c1 exp(a - s) [W_c2^T] (linear).
    lse:  returns the log-domain mid with per-axis shifts.
    """
    _check_mode(mode)
    _check_sub(sub_row, sub_col)
    _check_mid(mode, mid_col)
    a = _folded(ell, theta, sub_row, sub_col)
    if mode == "fast":
        s = torch.amax(a, dim=(1, 2), keepdim=True)
        u = torch.matmul(W_c1, torch.exp(a - s))
        if W_c2t is not None:
            u = torch.matmul(u, W_c2t)
        return u, s.reshape(-1, 1)
    m = torch.amax(a, dim=1, keepdim=True)
    a = m + torch.log(torch.matmul(W_c1, torch.exp(a - m)))
    if mid_col is not None:
        a = a + mid_col
    if W_c2t is None:
        return a
    m = torch.amax(a, dim=2, keepdim=True)
    return m + torch.log(torch.matmul(torch.exp(a - m), W_c2t))


def _lib():
    lib = _build.load("streamed_two_phase")
    if not getattr(lib, "_sdfs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdfs_pass_b.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f,
                                    i, p]
        lib.sdfs_pass_b.restype = i
        lib.sdfs_pass_b_work_floats.argtypes = [i, i, i, i]
        lib.sdfs_pass_b_work_floats.restype = ctypes.c_longlong
        lib.sdfs_pass_b_layout.argtypes = [i, i, p]
        lib.sdfs_pass_b_layout.restype = i
        lib.sdfs_pass_c_row.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f,
                                        f, i, p]
        lib.sdfs_pass_c_row.restype = i
        lib.sdfs_pass_c_batched.argtypes = [p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, f, f, i, p]
        lib.sdfs_pass_c_batched.restype = i
        lib.sdfs_pass_b_deferred.argtypes = [p, p, p, p, p, p, i, i, i, f,
                                             p]
        lib.sdfs_pass_b_deferred.restype = i
        lib.sdfs_pass_c_deferred.argtypes = [p, p, p, p, p, p, p,
                                             i, i, i, i, f, f, p]
        lib.sdfs_pass_c_deferred.restype = i
        lib.sdfs_pass_c_pair.argtypes = [p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, f, f, p]
        lib.sdfs_pass_c_pair.restype = i
        lib.sdfs_pass_b_deferred_layout.argtypes = [i, i, p]
        lib.sdfs_pass_b_deferred_layout.restype = i
        lib.sdfs_pass_b_deferred_work_floats.argtypes = [i, i, i]
        lib.sdfs_pass_b_deferred_work_floats.restype = ctypes.c_longlong
        lib.sdfs_pass_c_deferred_layout.argtypes = [i, i, i, p]
        lib.sdfs_pass_c_deferred_layout.restype = i
        lib.sdfs_tangent_chain.argtypes = [p] * 14 + [i] * 6 + [p]
        lib.sdfs_tangent_chain.restype = i
        lib.sdfs_error_string.argtypes = [i]
        lib.sdfs_error_string.restype = ctypes.c_char_p
        lib._sdfs_typed = True
    return lib


def _check(name: str, t: torch.Tensor, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.sdfs_error_string(rc).decode()} ({rc})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _pass_b_cuda(ell, W_c1, W_c2t, theta, mode, sub_row, sub_col, mid_col):
    R, I, J = ell.shape
    dev = ell.device
    _check("ell", ell, dev, (R, I, J))
    _check("W_c1", W_c1, dev, (I, I))
    if W_c2t is not None:
        _check("W_c2t", W_c2t, dev, (J, J))
    if sub_row is not None:
        _check("sub_row", sub_row, dev, (R,))
        _check("sub_col", sub_col, dev, (I, J))
    if mid_col is not None:
        _check("mid_col", mid_col, dev, (I, J))
    if (pass_b_smem_bytes(I, J) > SMEM_LIMIT or pass_b_layout(I, J) is None
            or R * I > _INT_MAX):
        raise ValueError(f"pass B at (R, I, J) = ({R}, {I}, {J}) exceeds "
                         "shared memory or the grid")
    mid = torch.empty_like(ell)
    s = (torch.empty((R, 1), dtype=torch.float32, device=dev)
         if mode == "fast" else None)
    # The c2 product's operand U and the lse row shifts.
    n_work = pass_b_work_floats(R, I, J, W_c2t is not None)
    work = (torch.empty((n_work,), dtype=torch.float32, device=dev)
            if n_work else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_b(_ptr(ell), _ptr(W_c1), _ptr(W_c2t),
                             _ptr(sub_row), _ptr(sub_col), _ptr(mid_col),
                             _ptr(mid), _ptr(s), _ptr(work), R, I, J,
                             float(theta), _MODES[mode],
                             ctypes.c_void_p(stream))
    _raise_on(lib, rc, "pass B")
    if mid_col is not None:
        LAUNCHES["pass_b_mid"] += 1
    elif W_c2t is not None:
        LAUNCHES["pass_b"] += 1
    else:
        LAUNCHES["pass_b_c1" if sub_row is None else "pass_b_c1_sub"] += 1
    return (mid, s) if mode == "fast" else mid


def pass_b(ell, W_c1, W_c2t, theta: float, mode: str, sub_row=None,
           sub_col=None, mid_col=None):
    """Pass B on the tensors' device: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (same arguments and results as
    :func:`pass_b_plain`)."""
    _check_mode(mode)
    _check_sub(sub_row, sub_col)
    _check_mid(mode, mid_col)
    if ell.device.type == "cpu":
        return pass_b_plain(ell, W_c1, W_c2t, theta, mode, sub_row, sub_col,
                            mid_col)
    if ell.device.type == "cuda":
        return _pass_b_cuda(ell, W_c1, W_c2t, theta, mode, sub_row, sub_col,
                            mid_col)
    raise ValueError(f"no pass-B kernel for device {ell.device}")


# --------------------------------------------------------------- pass C

def pass_c_plain(mid, scale, S, W_r1, W_r2, add_row, add_col,
                 theta: float, beta: float, mode: str):
    """Row phase of ``mid`` (R, C), R = L*K: contract l' with ``W_r1``
    (L, L), then k' with ``W_r2`` (K, K), add ``add_row`` (L, K) and
    ``add_col`` (C,), and apply the epilogue log1p(beta*exp(lh/theta)).

    fast: ``mid`` is linear; row r is rescaled by ``scale`` (R, 1) =
    exp(s - S) first and ``S`` (1,) is added back after the log.
    lse:  ``mid`` is log-domain; ``scale`` and ``S`` are unused (None).
    """
    _check_mode(mode)
    L, K = W_r1.shape[0], W_r2.shape[0]
    R, C = mid.shape
    if mode == "fast":
        v = torch.matmul(W_r1, (mid * scale).reshape(L, K * C))
        v = torch.matmul(W_r2, v.reshape(L, K, C))
        lh = torch.log(v) + S
    else:
        v = mid.reshape(L, K, C)
        m1 = torch.amax(v, dim=0, keepdim=True)               # (1, K, C)
        u = torch.matmul(W_r1, torch.exp(v - m1).reshape(L, K * C))
        m2 = torch.amax(m1, dim=1, keepdim=True)              # (1, 1, C)
        u = u.reshape(L, K, C) * torch.exp(m1 - m2)
        lh = torch.log(torch.matmul(W_r2, u)) + m2
    lh = lh + add_row[:, :, None] + add_col[None, None, :]
    return torch.log1p(beta * torch.exp(lh / theta)).reshape(R, C)


def _pass_c_cuda(mid, scale, S, W_r1, W_r2, add_row, add_col, theta, beta,
                 mode):
    R, C = mid.shape
    L, K = W_r1.shape[0], W_r2.shape[0]
    dev = mid.device
    _check("mid", mid, dev, (R, C))
    _check("W_r1", W_r1, dev, (L, L))
    _check("W_r2", W_r2, dev, (K, K))
    _check("add_row", add_row, dev, (L, K))
    _check("add_col", add_col, dev, (C,))
    if L * K != R:
        raise ValueError(f"mid has {R} rows, W_r1/W_r2 give {L}*{K}")
    if mode == "fast":
        _check("scale", scale, dev, (R, 1))
        _check("S", S, dev, (1,))
    if strip_row_layout(L, K) is None:
        raise ValueError(f"pass C at (L, K) = ({L}, {K}) exceeds shared "
                         "memory")
    out = torch.empty_like(mid)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_c_row(_ptr(mid), _ptr(scale), _ptr(S),
                                 _ptr(W_r1), _ptr(W_r2), _ptr(add_row),
                                 _ptr(add_col), _ptr(out), L, K, C,
                                 float(theta), float(beta), _MODES[mode],
                                 ctypes.c_void_p(stream))
    _raise_on(lib, rc, "pass C")
    LAUNCHES["pass_c"] += 1
    return out


def pass_c(mid, scale, S, W_r1, W_r2, add_row, add_col, theta: float,
           beta: float, mode: str):
    """Pass C on the tensors' device: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (same arguments and result as
    :func:`pass_c_plain`)."""
    _check_mode(mode)
    if mid.device.type == "cpu":
        return pass_c_plain(mid, scale, S, W_r1, W_r2, add_row, add_col,
                            theta, beta, mode)
    if mid.device.type == "cuda":
        return _pass_c_cuda(mid, scale, S, W_r1, W_r2, add_row, add_col,
                            theta, beta, mode)
    raise ValueError(f"no pass-C kernel for device {mid.device}")


# ------------------------------------------------------ pass C batched

def pass_c_batched_plain(mid, scale, S, W_c2t, W_r1, W_r2, add_row,
                         add_col, theta: float, beta: float, mode: str):
    """Batched row phase of ``mid`` (R, C), R = L*K, C = I*J: contract
    each slice i's j' with its own ``W_c2t[i]`` (J', J) = W_c2[i]
    transposed (``W_c2t`` (I, J', J); a shared (J', J) serves
    :func:`pass_c_deferred_plain`), then l' with ``W_r1`` (L, L) and k'
    with ``W_r2`` (K, K), add ``add_row`` (L, K) and ``add_col`` (C,),
    and apply the epilogue log1p(beta*exp(lh/theta)).

    fast: ``mid`` is pass B's linear c1-only field; row r is rescaled by
    ``scale`` (R, 1) = exp(s - S) first, the chain runs unshifted and
    ``S`` (1,) is added back after the log.
    lse: ``mid`` is log-domain (``scale`` and ``S`` None); the shifts sit
    where the TPU kernel puts them (its exactness argument rests on the
    placement): m1 per (row, slice) over the slice's J values before the
    c2 contraction; then a linear carry with M2 = max over l of m1 before
    the l' contraction and M3 = max over k of M2 before the k'
    contraction; M3 is added back after the log.
    """
    _check_mode(mode)
    L, K, J = W_r1.shape[0], W_r2.shape[0], W_c2t.shape[-2]
    R, C = mid.shape
    I = C // J
    if W_c2t.dim() == 2:
        c2 = lambda e: torch.matmul(e, W_c2t)
    else:
        c2 = lambda e: torch.einsum("lkim,imj->lkij", e, W_c2t)
    if mode == "fast":
        u = c2((mid * scale).reshape(L, K, I, J))
        u = torch.matmul(W_r1, u.reshape(L, K * C))
        u = torch.matmul(W_r2, u.reshape(L, K, C))
        lh = torch.log(u).reshape(L, K, I, J) + S
    else:
        w = mid.reshape(L, K, I, J)
        m1 = torch.amax(w, dim=3, keepdim=True)              # (L, K, I, 1)
        u = c2(torch.exp(w - m1))                            # linear
        M2 = torch.amax(m1, dim=0, keepdim=True)             # (1, K, I, 1)
        u = u * torch.exp(m1 - M2)
        u = torch.matmul(W_r1, u.reshape(L, K * C)).reshape(L, K, I, J)
        M3 = torch.amax(M2, dim=1, keepdim=True)             # (1, 1, I, 1)
        u = u * torch.exp(M2 - M3)
        u = torch.matmul(W_r2, u.reshape(L, K, C))           # (L, K, C)
        lh = torch.log(u).reshape(L, K, I, J) + M3
    lh = lh + add_row[:, :, None, None] + add_col.reshape(1, 1, I, J)
    return torch.log1p(beta * torch.exp(lh / theta)).reshape(R, C)


def _pass_c_batched_cuda(mid, scale, S, W_c2t, W_r1, W_r2, add_row, add_col,
                         theta, beta, mode):
    R, C = mid.shape
    I, J = W_c2t.shape[0], W_c2t.shape[1]
    L, K = W_r1.shape[0], W_r2.shape[0]
    dev = mid.device
    _check("mid", mid, dev, (R, C))
    _check("W_c2t", W_c2t, dev, (I, J, J))
    _check("W_r1", W_r1, dev, (L, L))
    _check("W_r2", W_r2, dev, (K, K))
    _check("add_row", add_row, dev, (L, K))
    _check("add_col", add_col, dev, (C,))
    if mode == "fast":
        _check("scale", scale, dev, (R, 1))
        _check("S", S, dev, (1,))
    if L * K != R or I * J != C:
        raise ValueError(f"mid {tuple(mid.shape)} does not match W_r1/W_r2 "
                         f"({L}*{K} rows) and W_c2t ({I} slices of {J})")
    if pass_c_deferred_layout(L, K, J) is None or I > _GRID_Y_MAX:
        raise ValueError(f"batched pass C with {R} rows, {I} slices "
                         "exceeds shared memory or the grid")
    out = torch.empty_like(mid)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_c_batched(
            _ptr(mid), _ptr(scale), _ptr(S), _ptr(W_c2t), _ptr(W_r1),
            _ptr(W_r2), _ptr(add_row), _ptr(add_col), _ptr(out), L, K, I, J,
            float(theta), float(beta), _MODES[mode],
            ctypes.c_void_p(stream))
    _raise_on(lib, rc, "batched pass C")
    LAUNCHES["pass_c_batched" if mode == "fast"
             else "pass_c_batched_lse"] += 1
    return out


def pass_c_batched(mid, scale, S, W_c2t, W_r1, W_r2, add_row, add_col,
                   theta: float, beta: float, mode: str):
    """Batched pass C on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`pass_c_batched_plain`)."""
    _check_mode(mode)
    if mid.device.type == "cpu":
        return pass_c_batched_plain(mid, scale, S, W_c2t, W_r1, W_r2,
                                    add_row, add_col, theta, beta, mode)
    if mid.device.type == "cuda":
        return _pass_c_batched_cuda(mid, scale, S, W_c2t, W_r1, W_r2,
                                    add_row, add_col, theta, beta, mode)
    raise ValueError(f"no batched pass-C kernel for device {mid.device}")


# ------------------------------------------------------ pass B deferred

def pass_b_deferred_plain(ell, W_c1t, theta: float, sub_row=None,
                          sub_col=None):
    """Deferred column phase of ``ell`` (R, I, J): contract i' only, with
    ``W_c1t`` (I', I) = W_c1 transposed, under a per-(row, column) shift
    m = max over I' of a = theta*ell - sub_row[r] - sub_col[i, j] (the
    folded baseline, ``sub_row`` (R,) and ``sub_col`` (I, J), both or
    neither; one fused multiply-add, see :func:`_folded`).  Returns the
    log-domain m + log(W_c1 exp(a - m)), (R, I, J)."""
    _check_sub(sub_row, sub_col)
    a = _folded(ell, theta, sub_row, sub_col)
    m = torch.amax(a, dim=1, keepdim=True)
    return m + torch.log(torch.matmul(W_c1t.mT, torch.exp(a - m)))


def _pass_b_deferred_cuda(ell, W_c1t, theta, sub_row, sub_col):
    R, I, J = ell.shape
    dev = ell.device
    _check("ell", ell, dev, (R, I, J))
    _check("W_c1t", W_c1t, dev, (I, I))
    if sub_row is not None:
        _check("sub_row", sub_row, dev, (R,))
        _check("sub_col", sub_col, dev, (I, J))
    if pass_b_deferred_smem_bytes(I) > SMEM_LIMIT or R > _GRID_Y_MAX:
        raise ValueError(f"deferred pass B with I = {I}, R = {R} exceeds "
                         "shared memory or the grid")
    out = torch.empty_like(ell)
    # The tensor-core layout's column maxima and exponentials.
    n_work = pass_b_deferred_work_floats(R, I, J)
    work = (torch.empty((n_work,), dtype=torch.float32, device=dev)
            if n_work else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_b_deferred(_ptr(ell), _ptr(W_c1t), _ptr(sub_row),
                                      _ptr(sub_col), _ptr(work), _ptr(out),
                                      R, I, J, float(theta),
                                      ctypes.c_void_p(stream))
    _raise_on(lib, rc, "deferred pass B")
    LAUNCHES["pass_b_deferred"] += 1
    return out


def pass_b_deferred(ell, W_c1t, theta: float, sub_row=None, sub_col=None):
    """Deferred pass B on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`pass_b_deferred_plain`)."""
    _check_sub(sub_row, sub_col)
    if ell.device.type == "cpu":
        return pass_b_deferred_plain(ell, W_c1t, theta, sub_row, sub_col)
    if ell.device.type == "cuda":
        return _pass_b_deferred_cuda(ell, W_c1t, theta, sub_row, sub_col)
    raise ValueError(f"no deferred pass-B kernel for device {ell.device}")


# ------------------------------------------------------ pass C deferred

def pass_c_deferred_plain(mid, W_c2t, W_r1, W_r2, add_row, add_col,
                          theta: float, beta: float):
    """Deferred row phase of the log-domain ``mid`` (R, C), R = L*K,
    C = I*J: contract each slice's j' with ``W_c2t`` (J', J) = W_c2
    transposed, then l' with ``W_r1`` (L, L) and k' with ``W_r2`` (K, K),
    add ``add_row`` (L, K) and ``add_col`` (C,), and apply the epilogue
    log1p(beta*exp(lh/theta)), with the lse shifts of
    :func:`pass_c_batched_plain`.
    """
    return pass_c_batched_plain(mid, None, None, W_c2t, W_r1, W_r2, add_row,
                                add_col, theta, beta, "lse")


def _pass_c_deferred_cuda(mid, W_c2t, W_r1, W_r2, add_row, add_col, theta,
                          beta):
    R, C = mid.shape
    L, K, J = W_r1.shape[0], W_r2.shape[0], W_c2t.shape[0]
    dev = mid.device
    _check("mid", mid, dev, (R, C))
    _check("W_c2t", W_c2t, dev, (J, J))
    _check("W_r1", W_r1, dev, (L, L))
    _check("W_r2", W_r2, dev, (K, K))
    _check("add_row", add_row, dev, (L, K))
    _check("add_col", add_col, dev, (C,))
    if L * K != R or C % J:
        raise ValueError(f"mid {tuple(mid.shape)} does not match W_r1/W_r2 "
                         f"({L}*{K} rows) and W_c2t ({J}-column slices)")
    I = C // J
    if pass_c_deferred_layout(L, K, J) is None or I > _GRID_Y_MAX:
        raise ValueError(f"deferred pass C with {R} rows, {I} slices "
                         "exceeds shared memory or the grid")
    out = torch.empty_like(mid)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_c_deferred(
            _ptr(mid), _ptr(W_c2t), _ptr(W_r1), _ptr(W_r2), _ptr(add_row),
            _ptr(add_col), _ptr(out), L, K, I, J, float(theta),
            float(beta), ctypes.c_void_p(stream))
    _raise_on(lib, rc, "deferred pass C")
    LAUNCHES["pass_c_deferred"] += 1
    return out


def pass_c_deferred(mid, W_c2t, W_r1, W_r2, add_row, add_col, theta: float,
                    beta: float):
    """Deferred pass C on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`pass_c_deferred_plain`)."""
    if mid.device.type == "cpu":
        return pass_c_deferred_plain(mid, W_c2t, W_r1, W_r2, add_row,
                                     add_col, theta, beta)
    if mid.device.type == "cuda":
        return _pass_c_deferred_cuda(mid, W_c2t, W_r1, W_r2, add_row,
                                     add_col, theta, beta)
    raise ValueError(f"no deferred pass-C kernel for device {mid.device}")


# ----------------------------------------------------------- pair pass C

def pair_device_operands(ops: TwoPhaseOperands, dtype=torch.float32, *,
                         device="cuda"):
    """The pair kernel's c2 operands of a continuous-GCY set, in the one
    layout that both :func:`pass_c_pair` and :func:`pass_c_pair_plain`
    take: ``P_zpi`` (n_y, n_b, n_b) as [y, b, B] and ``PzT``
    (n_i, n_b, n_j, n_j) = P_z[i, j, b, J] as [i, b, J, j], so that the
    (i, b) block is the right-hand (J', j) factor of one slice's z'
    product with contiguous rows."""
    dev = resolve_device(device)
    P_z, P_zpi = ops.pair_c2
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=dtype)
    return (cast(P_zpi),
            cast(np.asarray(P_z, np.float64).transpose(0, 2, 3, 1)))


def pass_c_pair_plain(mid, P_zpi, PzT, W_r1, W_r2, add_row, add_col,
                      theta: float, beta: float):
    """Pair row phase of the log-domain ``mid`` (R, C), R = L*K,
    C = (n_i*n_y) * (n_b*n_j), c1 slices q = (i, y) of columns (b, j):
    per slice and row one shift m1 over the whole (B', J') group, the
    z_pi' contraction with ``P_zpi[y]`` and the z' contraction with
    ``PzT[i, b]`` (the layout of :func:`pair_device_operands`), then the
    linear-carry row phase with M2 = max over l of m1 and M3 = max over k
    of M2, add_row (L, K), add_col (C,) and the epilogue
    log1p(beta*exp(lh/theta)).

    Each exp stage is biased by e^25 and 75 is taken off after the log,
    as the TPU kernel does: the chain from the first exp to the last log
    runs un-logged, and the bias widens its float32 window."""
    n_y, n_b = P_zpi.shape[0], P_zpi.shape[1]
    n_i, n_j = PzT.shape[0], PzT.shape[2]
    L, K = W_r1.shape[0], W_r2.shape[0]
    R, C = mid.shape
    IY, C2 = n_i * n_y, n_b * n_j
    B = PAIR_BIAS
    w = mid.reshape(R, IY, C2)
    m1 = torch.amax(w, dim=2, keepdim=True)                  # (R, IY, 1)
    e = torch.exp(w - m1 + B).reshape(R, n_i, n_y, n_b, n_j)
    acc = torch.einsum("ybB,riyBJ->riybJ", P_zpi, e)
    u = torch.einsum("ibJj,riybJ->riybj", PzT, acc).reshape(L, K, IY, C2)
    sh = m1.reshape(L, K, IY, 1)
    M2 = torch.amax(sh, dim=0, keepdim=True)                 # (1, K, IY, 1)
    u = u * torch.exp(sh - M2 + B)
    u = torch.matmul(W_r1, u.reshape(L, K * C)).reshape(L, K, IY, C2)
    M3 = torch.amax(M2, dim=1, keepdim=True)                 # (1, 1, IY, 1)
    u = u * torch.exp(M2 - M3 + B)
    u = torch.matmul(W_r2, u.reshape(L, K, C)).reshape(L, K, IY, C2)
    lh = (torch.log(u) + (M3 - 3.0 * B) + add_row[:, :, None, None]
          + add_col.reshape(1, 1, IY, C2))
    return torch.log1p(beta * torch.exp(lh / theta)).reshape(R, C)


def _pass_c_pair_cuda(mid, P_zpi, PzT, W_r1, W_r2, add_row, add_col, theta,
                      beta):
    R, C = mid.shape
    n_y, n_b = P_zpi.shape[0], P_zpi.shape[1]
    n_i, n_j = PzT.shape[0], PzT.shape[2]
    L, K = W_r1.shape[0], W_r2.shape[0]
    dev = mid.device
    _check("mid", mid, dev, (R, C))
    _check("P_zpi", P_zpi, dev, (n_y, n_b, n_b))
    _check("PzT", PzT, dev, (n_i, n_b, n_j, n_j))
    _check("W_r1", W_r1, dev, (L, L))
    _check("W_r2", W_r2, dev, (K, K))
    _check("add_row", add_row, dev, (L, K))
    _check("add_col", add_col, dev, (C,))
    if L * K != R or n_i * n_y * n_b * n_j != C:
        raise ValueError(f"mid {tuple(mid.shape)} does not match W_r1/W_r2 "
                         f"({L}*{K} rows) and P_zpi/PzT ({n_i}*{n_y} slices "
                         f"of {n_b}*{n_j} columns)")
    if (pass_c_pair_smem_bytes(R, K, n_j) > SMEM_LIMIT
            or n_i * n_y > _GRID_Y_MAX):
        raise ValueError(f"pair pass C with {R} rows, {n_j} z points, "
                         f"{n_i * n_y} slices exceeds shared memory or the "
                         "grid")
    out = torch.empty_like(mid)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdfs_pass_c_pair(
            _ptr(mid), _ptr(P_zpi), _ptr(PzT), _ptr(W_r1), _ptr(W_r2),
            _ptr(add_row), _ptr(add_col), _ptr(out), L, K, n_i, n_y, n_b,
            n_j, float(theta), float(beta), ctypes.c_void_p(stream))
    _raise_on(lib, rc, "pair pass C")
    LAUNCHES["pass_c_pair"] += 1
    return out


def pass_c_pair(mid, P_zpi, PzT, W_r1, W_r2, add_row, add_col, theta: float,
                beta: float):
    """Pair pass C on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments and result
    as :func:`pass_c_pair_plain`)."""
    if mid.device.type == "cpu":
        return pass_c_pair_plain(mid, P_zpi, PzT, W_r1, W_r2, add_row,
                                 add_col, theta, beta)
    if mid.device.type == "cuda":
        return _pass_c_pair_cuda(mid, P_zpi, PzT, W_r1, W_r2, add_row,
                                 add_col, theta, beta)
    raise ValueError(f"no pair pass-C kernel for device {mid.device}")


# ------------------------------------------------------------- operator

def make_streamed_T_log(ops: TwoPhaseOperands,
                        dtype: torch.dtype = torch.float32,
                        mode: str = "auto", *,
                        device="cuda",
                        covered: Optional[TwoPhaseOperands] = None
                        ) -> Callable:
    """Streamed two-pass operator ell (4-D field) -> log T(w) from a
    two-phase operand set, in the configuration :func:`streamed_config`
    picks for the set or, for a batched set, for its conjugated-shared
    form (:func:`streamed_coverable`; a warning when that form's factors
    reach below float32's floor).  An uncovered set raises
    ``ValueError``.  ``covered`` passes a coverable set already computed
    for ``ops`` (the conjugation is host work worth doing once).

    mode "fast": one shift per field row (exact whenever the iterate's
    theta-range within a row fits exp's f32 range — plain SSY operands);
    "lse": per-axis log-sum-exp shifts; "auto" picks "lse" for a set with
    a folded baseline (whose LSE steps renormalize the folded factors)
    and for the deferred and pair configurations, "fast" otherwise.  The
    deferred and pair configurations, and a set with ``mid_col``, run
    per-axis LSE only (``mode="fast"`` raises ``ValueError`` there).

    The returned ``T`` carries ``T.twin`` (the eager evaluator of the same
    math, of the conjugated set when one runs, so that the tangent keeps
    shared factors: :func:`..operators.two_phase.make_eager_two_phase_T`),
    ``T.mode``
    and ``T.engine`` ("streamed" for the full and batched configurations,
    "streamed-deferred" or "streamed-pair": the JAX package's names), and
    for a set with a folded baseline
    ``T.baseline_log_w`` (ell0 on the view, float32 on ``device``).  Its
    derivatives are the twin's at the same point: forward mode
    (``torch.func.jvp``) its tangent, reverse mode (``backward``,
    ``torch.func.vjp``) its transpose; Newton linearizes the twin once
    per step (``T.twin.linearize``, ``ops/tangent.py``).
    """
    if dtype != torch.float32:
        raise ValueError("the streamed kernels are the float32 tier")
    if covered is None:
        covered = streamed_coverable(ops)
    if covered is None:
        raise ValueError(
            "operand set not covered by the streamed kernels (batched "
            "factors without a conjugated-shared form, mid_col on a pair "
            f"or deferred set, or blocks beyond shared memory at shapes "
            f"{ops.shapes}); use make_tiled_T_log")
    mode = streamed_mode(covered, mode)
    if covered is not ops:
        _warn_conjugated_f32_floor(covered)
    ops = covered
    config = streamed_config(ops)
    deferred, pair = config == "deferred", config == "pair"
    dev = resolve_device(device)
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    theta, beta = float(ops.theta), float(ops.beta)
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=dtype)
    with span("sdfs.build.upload"):
        W_r1, W_r2 = cast(ops.W_r1), cast(ops.W_r2)
        add_row = cast(ops.add_row)
        add_col = cast(np.asarray(ops.add_col).reshape(C))
        twin = make_eager_two_phase_T(ops, dtype, device=dev)
        sub_row = sub_col = None
        if ops.has_sub:
            sub_row = cast(np.asarray(ops.sub_row).reshape(R))
            sub_col = cast(ops.sub_col)
        mid_col = cast(ops.mid_col) if ops.has_mid else None
        if pair:
            P_zpi, PzT = pair_device_operands(ops, dtype, device=dev)
        else:
            # (J', J), or (I, J', J) for a c2 factor batched over i.
            W_c2t = cast(np.swapaxes(ops.W_c2, -1, -2))
        if deferred or pair:
            W_c1t = cast(np.asarray(ops.W_c1).T)
        else:
            W_c1 = cast(ops.W_c1)
        baseline_log_w = (None if ops.baseline_log_w is None
                          else cast(ops.baseline_log_w))

    def primal(ell):
        e = ell.to(dtype).reshape(R, I, J).contiguous()
        if pair or deferred:
            if deferred:
                count("sdfs.primal.deferred", 1)
            with span("sdfs.primal.b"):
                mid = pass_b_deferred(e, W_c1t, theta, sub_row, sub_col)
            with span("sdfs.primal.c"):
                if pair:
                    out = pass_c_pair(mid.reshape(R, C), P_zpi, PzT, W_r1,
                                      W_r2, add_row, add_col, theta, beta)
                else:
                    out = pass_c_deferred(mid.reshape(R, C), W_c2t, W_r1,
                                          W_r2, add_row, add_col, theta,
                                          beta)
        else:
            batched = config == "batched"
            with span("sdfs.primal.b"):
                b = pass_b(e, W_c1, None if batched else W_c2t, theta, mode,
                           sub_row, sub_col, mid_col)
                scale = S = None
                if mode == "fast":
                    b, s = b
                    S = torch.amax(s).reshape(1)
                    scale = torch.exp(s - S)
            with span("sdfs.primal.c"):
                if batched:
                    out = pass_c_batched(b.reshape(R, C), scale, S, W_c2t,
                                         W_r1, W_r2, add_row, add_col, theta,
                                         beta, mode)
                else:
                    out = pass_c(b.reshape(R, C), scale, S, W_r1, W_r2,
                                 add_row, add_col, theta, beta, mode)
        return out.reshape(ops.shapes)

    class _StreamedT(torch.autograd.Function):
        # Both derivatives are the eager twin's at the same point, as the
        # JAX package's custom_jvp operator transposes its twin's tangent.
        @staticmethod
        def forward(ell):
            return primal(ell)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0])
            ctx.save_for_backward(inputs[0])

        @staticmethod
        def jvp(ctx, dell):
            (ell,) = ctx.saved_tensors
            return torch.func.jvp(twin, (ell,), (dell,))[1]

        @staticmethod
        def backward(ctx, grad):
            (ell,) = ctx.saved_tensors
            with torch.enable_grad():
                x = ell.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(twin(x), x, grad)
            return g

    def T(ell):
        refuse(ell, "make_streamed_T_log's operator")
        with span("sdfs.primal"):
            return _StreamedT.apply(ell)

    T.twin = twin
    T.mode = mode
    T.engine = ("streamed-pair" if pair else
                "streamed-deferred" if deferred else "streamed")
    if baseline_log_w is not None:
        T.baseline_log_w = baseline_log_w
    return T
