"""Sharded operators with hand-placed collectives on ``torch.distributed``.

PyTorch port of ``sdfs_via_autodiff_tpu/parallel/shard_ops.py``.  The
JAX module writes each operator as one ``shard_map`` program over a mesh;
here every rank runs its shard's part of the same program and the
collectives are ``torch.distributed`` calls on the mesh's process
groups:

* :func:`T_ssy_shard_map_factory`: the float64 per-axis SSY operator
  with w sharded over h_lam; the one contraction that crosses shards
  (next-h_lam) is a local partial matmul against B_lam's column block,
  an ``all_reduce(MAX)`` for its log-sum-exp shift and a reduce-scatter.
* :func:`two_phase_shard_map_factory`: any two-phase operand set on a
  (dp, tp) mesh, w sharded over both row axes: the column phase is
  local, each row contraction is an ``all_reduce(MAX)`` plus a
  reduce-scatter (two per application).
* :func:`streamed_shard_map_factory`: the streamed CUDA kernels per
  shard: pass B on the shard's rows, an all-to-all from rows to
  columns, pass C on the shard's columns and an all-to-all back (plus,
  in fast mode, an ``all_reduce(MAX)`` for the global shift S and an
  all-gather of the per-row scales).

Each returns a :class:`ShardedOperator`: it maps a DTensor (or the full
field, the same on every rank) to a DTensor with the placements
``T.input_sharding``, and carries ``T.local`` (this rank's shard ->
shard) for the solvers, which run their loops on the local shard
(``solvers/sharding.py``).  The collectives have no derivative rules,
so the one a derivative crosses, the reduce-scatter, is a
``torch.autograd.Function`` (:class:`_ReduceScatter`) whose ``jvp`` and
``backward`` place the tangent's collectives by hand (the log-sum-exp
shifts carry no tangent); the streamed
operator's derivatives are those of its eager twin on the same row
layout (``T.twin``), as on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import streamed_two_phase as st
from ..kernels.tiled_two_phase import reject_tpu_options
from ..models.ssy import SSY
from ..operators.discrete_ssy import SSYDiscretization, _ssy_factors
from ..operators.two_phase import (TwoPhaseOperands, check_full_fp32,
                                   eager_column_phase)
from ..ops.contract import lse_matmul
from ..ops.tangent import (Linearization, log1p_epilogue, lse_step,
                           viewed)
from .mesh import mesh_device

__all__ = ["ShardedOperator", "StreamedShardPlan", "T_ssy_shard_map_factory",
           "two_phase_shard_map_factory", "streamed_shard_map_factory",
           "streamed_shard_plan", "check_shard_layouts"]


# ------------------------------------------------------ mesh axes, groups

@dataclasses.dataclass(frozen=True)
class _Axis:
    """This rank's view of a set of mesh axes taken together: their
    process group, the number of ranks on them and this rank's index
    along them (mesh order, which is the group's rank order)."""

    group: object
    size: int
    index: int


# Process groups of flattened axes, by their ranks: every _axis call on
# the same mesh reuses them (a group holds a communicator for the life of
# the default group, so one made per operator would leak).  Cleared when
# the default group changes.
_GROUPS: dict = {"world": None}


def _flat_group(rows, row):
    """The process group of ``row``, one of the mesh's ``rows`` (each a
    list of global ranks); the default group where ``row`` spans it."""
    if row == list(range(dist.get_world_size())):
        return dist.group.WORLD
    if _GROUPS["world"] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    if tuple(row) not in _GROUPS:
        for r in rows:              # every rank creates every sub-group
            _GROUPS[tuple(r)] = dist.new_group(r)
    return _GROUPS[tuple(row)]


def _axis(mesh, names) -> _Axis:
    """The :class:`_Axis` of the mesh axes ``names`` (in mesh order; more
    than one are flattened, the first the slowest).  Every rank of the
    default group must call this with the same arguments: a flattened
    set creates its process groups on first use."""
    names = tuple(names)
    dim_names = tuple(mesh.mesh_dim_names)
    for a in names:
        if a not in dim_names:
            raise ValueError(f"mesh has no axis {a!r} (axes {dim_names})")
    dims = [dim_names.index(a) for a in names]
    if dims != sorted(set(dims)):
        raise ValueError(f"axis names {names} must follow the mesh's axis "
                         f"order {dim_names}")
    others = [d for d in range(mesh.ndim) if d not in dims]
    size = math.prod(mesh.size(d) for d in dims)
    rows = mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    row = next((r for r in rows if me in r), None)
    if row is None:
        raise ValueError(f"rank {me} is not in the mesh")
    if row != sorted(row):
        raise ValueError("mesh ranks must ascend along the sharded axes "
                         "(a process group orders its ranks)")
    group = (mesh.get_group(dims[0]) if len(dims) == 1
             else _flat_group(rows, row))
    return _Axis(group, size, row.index(me))


def _mesh_order(mesh, names) -> tuple:
    dim_names = tuple(mesh.mesh_dim_names)
    return tuple(sorted(names, key=dim_names.index))


# ------------------------------------------------------------ collectives
# Every collective of this module is one of these, on the group of one
# _Axis.  They are the functional (out-of-place) collectives: the tangent
# and transpose rules below call them inside ``torch.func`` transforms,
# which refuse the in-place c10d calls' writes.

def _fc(name: str):
    """The functional collective ``name``."""
    import torch.distributed._functional_collectives as fc
    return getattr(fc, name)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _fc("wait_tensor")(t)


def _all_reduce_max(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _wait(_fc("all_reduce")(t, "max", ax.group))


def _reduce_scatter(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """Sum over the ranks of ``ax``, each keeping its block of dim 0."""
    return _wait(_fc("reduce_scatter_tensor")(x.contiguous(), "sum", 0,
                                              ax.group))


def _all_gather(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    return _wait(_fc("all_gather_tensor")(x.contiguous(), 0, ax.group))


def _all_to_all(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """Block k of ``x`` (dim 0, ``ax.size`` blocks) goes to rank k; block
    k of the result came from rank k."""
    return _wait(_fc("all_to_all_single")(x.contiguous(), None, None,
                                          ax.group))


def _along(fn, x: torch.Tensor, axis: int, ax: _Axis) -> torch.Tensor:
    """A dim-0 collective ``fn`` applied along dim ``axis`` (0 or 1)."""
    if axis == 0:
        return fn(x, ax)
    return fn(x.transpose(0, 1), ax).transpose(0, 1)


_CONTRACT = {0: "lm,mkt->lkt", 1: "km,lmt->lkt"}


class _ReduceScatter(torch.autograd.Function):
    """:func:`_reduce_scatter` (dim 0) as a linear map: its tangent is
    the reduce-scatter of the tangent, its transpose an all-gather."""

    @staticmethod
    def forward(x, ax):
        return _reduce_scatter(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def jvp(ctx, dx, _ax):
        return _reduce_scatter(dx, ctx.ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax), None


def _cross_shard_lse(b: torch.Tensor, W_cols: torch.Tensor, axis: int,
                     ax: _Axis, tape=None) -> torch.Tensor:
    """One LSE contraction over a grid axis sharded on ``ax``: ``b``
    (L_loc, K_loc, C), the factor's column block ``W_cols`` (N, N_loc) of
    the sharded ``axis`` (0 or 1).  m + log u with the shift m the global
    maximum over the axis (``all_reduce(MAX)``) and u the reduce-scatter
    of the local partial matmul against exp(b - m): the single-device
    step's operations with the two collectives between them.  Across
    ranks the shift carries no tangent (its terms in m and in log u
    cancel), so the one derivative rule that crosses shards is
    :class:`_ReduceScatter`'s.  On one rank the shift is the rank's own
    maximum with ``torch.amax``'s derivative, as on one device: the
    result and its derivatives are then bitwise the single-device
    step's, and a solve through the sharded operator takes its steps.
    ``tape`` records the stage for Newton's linearization: its matvec
    runs the partial matmul and the reduce-scatter on the tangent."""
    m = torch.amax(b, dim=axis, keepdim=True)
    if ax.size > 1:
        m = _all_reduce_max(m.detach(), ax)
    return lse_step(b, m, lambda t: _along(
        _ReduceScatter.apply, torch.einsum(_CONTRACT[axis], W_cols, t),
        axis, ax), tape)


# --------------------------------------------------------- the operator

def _local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the full field ``x`` under ``placements``
    (each Shard splits its dim in mesh-axis order, as DTensor does)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(d), dim=p.dim)[coord[d]]
    return x.contiguous()


class ShardedOperator:
    """A log-space operator on a field sharded over a device mesh.

    ``T(ell)`` takes a DTensor (redistributed to ``T.input_sharding`` when
    its placements differ) or the full field, the same on every rank, and
    returns a DTensor with ``T.input_sharding`` on ``T.mesh``.
    ``T.local`` maps this rank's shard (``T.local_shape``) to its shard of
    the result; ``T.local_twin`` is the eager evaluator the tangent
    linearizes (``T.local`` itself for the eager factories) and ``T.twin``
    the same as an operator.  ``T.reduce_axis`` spans the ranks holding
    distinct shards: the solvers all-reduce their norms and dot products
    over its group.  With ``batch_axis`` the field has a leading batch of
    ``n_slice`` sweep members, one per slice of that mesh axis."""

    def __init__(self, local: Callable, mesh, placements, shape,
                 reduce_axis: _Axis, *, local_twin: Optional[Callable] = None,
                 batch_axis: Optional[str] = None, n_slice: int = 0):
        self.local = local
        self.local_twin = local if local_twin is None else local_twin
        self.mesh = mesh
        self.input_sharding = tuple(placements)
        self.shape = tuple(shape)
        self.reduce_axis = reduce_axis
        self.batch_axis, self.n_slice = batch_axis, n_slice
        self.device = mesh_device(mesh)
        probe = torch.empty(self.shape, device="meta")
        self.local_shape = tuple(_local_block(probe, mesh, placements).shape)

    def to_local(self, ell) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(ell, DTensor):
            self._check_shape(tuple(ell.shape))
            if (ell.device_mesh != self.mesh
                    or tuple(ell.placements) != self.input_sharding):
                ell = ell.redistribute(self.mesh, self.input_sharding)
            return ell.to_local()
        ell = torch.as_tensor(ell).to(self.device)
        self._check_shape(tuple(ell.shape))
        return _local_block(ell, self.mesh, self.input_sharding)

    def _check_shape(self, shape) -> None:
        if self.batch_axis is not None and shape[:1] != (self.n_slice,):
            raise ValueError(
                f"multi-slice operator expects a leading batch of "
                f"{self.n_slice} (one member per {self.batch_axis!r} "
                f"slice); got {shape}")
        if shape != self.shape:
            raise ValueError(f"sharded operator expects a field of shape "
                             f"{self.shape}; got {shape}")

    def from_local(self, x: torch.Tensor):
        from torch.distributed.tensor import DTensor
        stride = torch.empty(self.shape, device="meta").stride()
        return DTensor.from_local(x, self.mesh, self.input_sharding,
                                  run_check=False, shape=torch.Size(self.shape),
                                  stride=stride)

    def __call__(self, ell):
        return self.from_local(self.local(self.to_local(ell)))

    @property
    def twin(self) -> "ShardedOperator":
        return ShardedOperator(self.local_twin, self.mesh,
                               self.input_sharding, self.shape,
                               self.reduce_axis, batch_axis=self.batch_axis,
                               n_slice=self.n_slice)


def _placements(mesh, shard_of: dict):
    """Placements with ``Shard(shard_of[name])`` on the named mesh axes
    and ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(shard_of[n]) if n in shard_of else Replicate()
                 for n in mesh.mesh_dim_names)


def _f64_cast(dev, dtype):
    """Host float64 arrays -> contiguous ``dtype`` tensors on ``dev`` (the
    kernels take contiguous operands)."""
    return lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=dtype)


# ------------------------------------------------ the per-axis SSY operator

def T_ssy_shard_map_factory(model: SSY, disc: SSYDiscretization, mesh,
                            axis_name: str = "dp",
                            dtype: Optional[torch.dtype] = None
                            ) -> ShardedOperator:
    """Log-space discrete SSY operator with the iterate sharded over grid
    axis 0 (h_lam) on the mesh axis ``axis_name`` (replicated over the
    others): the next-h_lam contraction crosses shards (a partial matmul
    against B_lam's column block, ``all_reduce(MAX)`` of its shift and a
    reduce-scatter); the other three are local.  ``dtype=None`` keeps the
    discretization's dtype.  Requires n_h_lam % mesh size on
    ``axis_name`` == 0.  Newton linearizes ``T.local`` once per step
    (``T.local.linearize``, ``ops/tangent.py``)."""
    beta, theta = model.beta, model.theta
    L, K, I, J = disc.shapes
    ax = _axis(mesh, (axis_name,))
    if L % ax.size:
        raise ValueError(f"h_lam axis {L} not divisible by mesh axis "
                         f"{axis_name}={ax.size}")
    dev = mesh_device(mesh)
    dtype = dtype or disc.z_P.dtype
    B_lam, A2, A3 = _ssy_factors(model, disc)
    cast = lambda a: a.to(device=dev, dtype=dtype)
    B_lam, A2, A3, Qc, Qhz, zP = map(cast, (B_lam, A2, A3, disc.h_c_Q,
                                            disc.h_z_Q, disc.z_P))
    log_A2, log_A3 = torch.log(A2), torch.log(A3)
    L_loc = L // ax.size
    # B_lam's columns (next-h_lam) match the local rows of the iterate;
    # its rows (current-h_lam) stay whole for the partial matmul, and the
    # reduce-scatter hands each rank its block of them.
    B_cols = B_lam[:, ax.index * L_loc:(ax.index + 1) * L_loc].contiguous()

    def local(ell, tape=None):
        p = theta * viewed(ell, lambda t: t.reshape(L_loc, K, I * J), tape)
        if tape is not None:
            tape.scale(theta)
        a = viewed(_cross_shard_lse(p, B_cols, 0, ax, tape),
                   lambda t: t.reshape(L_loc, K, I, J), tape)
        a = lse_matmul(Qc, a, "km,lmij->lkij", 1, tape=tape)
        a = lse_matmul(Qhz, a, "im,lkmj->lkij", 2, tape=tape)
        a = lse_matmul(zP, a, "jm,lkim->lkij", 3, tape=tape)
        log_hwt = a + log_A2[None, :, None, None] + log_A3[None, None, :, :]
        return log1p_epilogue(log_hwt, theta, beta, tape)

    # Newton's tangent: the tape, one build per step (its matvec runs
    # the next-h_lam contraction's reduce-scatter on the tangent).
    local.linearize = lambda x: Linearization(local, x)
    return ShardedOperator(local, mesh, _placements(mesh, {axis_name: 0}),
                           disc.shapes, ax)


# --------------------------------------------------- two-phase, (dp, tp)

def _sharded_eager_local(ops: TwoPhaseOperands, dtype, dev, ax_r1: _Axis,
                         ax_r2: Optional[_Axis]) -> Callable:
    """The eager two-phase operator on one rank's shard (L/n1, K/n2, n_c1,
    n_c2): rows sharded over ``ax_r1`` on axis 0 and over ``ax_r2`` on
    axis 1 (None: axis 1 whole).  The column phase is local; each sharded
    row contraction is a :func:`_cross_shard_lse`, an unsharded one the
    single-device step.  On one rank it is bitwise the single-device
    operator (``make_eager_two_phase_T``).  The returned
    ``local(ell, tape=None)`` records its tangent on ``tape``
    (``ops/tangent.Tape``), in the single-device twin's steps."""
    column = eager_column_phase(ops, dtype, device=dev)
    L, K, n1, n2 = ops.shapes
    C = n1 * n2
    L_loc = L // ax_r1.size
    K_loc = K // ax_r2.size if ax_r2 is not None else K
    l0 = ax_r1.index * L_loc
    k0 = ax_r2.index * K_loc if ax_r2 is not None else 0
    rows_l, rows_k = slice(l0, l0 + L_loc), slice(k0, k0 + K_loc)
    cast = _f64_cast(dev, dtype)
    W_r1 = cast(np.asarray(ops.W_r1)[:, rows_l])
    W_r2 = cast(np.asarray(ops.W_r2)[:, rows_k] if ax_r2 is not None
                else ops.W_r2)
    add = cast(np.asarray(ops.add_row)[rows_l, rows_k][:, :, None]
               + np.asarray(ops.add_col).reshape(-1)[None, None, :])
    sub = None
    if ops.has_sub:
        sub = cast(np.asarray(ops.sub_row)[rows_l, rows_k].reshape(-1)[
            :, None, None] + np.asarray(ops.sub_col)[None, :, :])
    theta, beta = float(ops.theta), float(ops.beta)

    R_loc, shape = L_loc * K_loc, (L_loc, K_loc, n1, n2)

    def local(ell, tape=None):
        check_full_fp32(ell)
        a = theta * viewed(ell, lambda t: t.to(dtype).reshape(R_loc, n1, n2),
                           tape)
        if tape is not None:
            tape.scale(theta)
        if sub is not None:
            a = a - sub
        b = viewed(column(a, tape), lambda t: t.reshape(L_loc, K_loc, C),
                   tape)
        b = _cross_shard_lse(b, W_r1, 0, ax_r1, tape)
        if ax_r2 is None:
            b = lse_step(b, torch.amax(b, dim=1, keepdim=True),
                         lambda t: torch.einsum("km,lmt->lkt", W_r2, t),
                         tape)
        else:
            b = _cross_shard_lse(b, W_r2, 1, ax_r2, tape)
        out = log1p_epilogue(b + add, theta, beta, tape)
        return viewed(out, lambda t: t.reshape(shape), tape)

    return local


def two_phase_shard_map_factory(ops: TwoPhaseOperands, mesh,
                                dp_axis: str = "dp", tp_axis: str = "tp",
                                dtype: Optional[torch.dtype] = None
                                ) -> ShardedOperator:
    """Two-phase operator (``operators/two_phase.py``) with the iterate
    ell[r1, r2, c1, c2] sharded (dp, tp, -, -) over a 2-D mesh.

    The column contractions are local; each row contraction crosses a
    mesh axis: ``all_reduce(MAX)`` of its shift, a local partial matmul
    against the factor's column block and a reduce-scatter over that
    axis, so two reduce-scatters per application.  Covers every operand
    set with dense factors (discrete SSY and GCY, plain or normalized,
    continuous SSY); pair-factored and ``dense=False`` sets raise
    ``ValueError``.  ``dtype=None`` means float32, as in the JAX package.
    Differentiable in both modes (``T.local`` under ``torch.func``);
    Newton linearizes ``T.local`` once per step (``T.local.linearize``,
    ``ops/tangent.py``)."""
    L, K = ops.shapes[:2]
    ax1, ax2 = _axis(mesh, (dp_axis,)), _axis(mesh, (tp_axis,))
    if L % ax1.size or K % ax2.size:
        raise ValueError(f"row axes {(L, K)} not divisible by mesh "
                         f"{(ax1.size, ax2.size)}")
    if ops.is_pair or ops.dense_placeholder:
        # Their W_c2 is a placeholder: contracting it would be garbage.
        raise ValueError(
            "two_phase_shard_map_factory does not evaluate pair-factored "
            "or dense=False operand sets; use streamed_shard_map_factory "
            "(float32)")
    dev = mesh_device(mesh)
    dtype = dtype or torch.float32
    local = _sharded_eager_local(ops, dtype, dev, ax1, ax2)
    local.linearize = lambda x: Linearization(local, x)
    T = ShardedOperator(local, mesh, _placements(mesh, {dp_axis: 0,
                                                        tp_axis: 1}),
                        ops.shapes,
                        _axis(mesh, _mesh_order(mesh, (dp_axis, tp_axis))))
    if ops.baseline_log_w is not None:
        T.baseline_log_w = _f64_cast(dev, dtype)(ops.baseline_log_w)
    return T


# ----------------------------------------------------------- streamed

def check_shard_layouts(config: str, shapes, n: int, pair_shapes=None
                        ) -> None:
    """Raise ``ValueError`` before any launch when a shard's pass B (R/n
    rows) or pass C (C/n columns) falls outside its kernel's layout: the
    checks of the kernel wrappers at the per-shard shapes."""
    L, K, I, J = shapes
    R_loc, I_loc, R = (L // n) * K, I // n, L * K
    where = (f"per-shard shapes (R/n, C/n) = ({R_loc}, {I_loc * J}) of "
             f"{config} set {tuple(shapes)} on {n} shards")
    hint = "; choose grid sizes with more rows per shard, or a smaller mesh"
    if config in ("full", "batched"):
        if (st.pass_b_smem_bytes(I, J) > st.SMEM_LIMIT
                or st.pass_b_layout(I, J) is None
                or R_loc * I > st._INT_MAX):
            raise ValueError(f"pass B has no layout at {where}{hint}")
    elif (st.pass_b_deferred_smem_bytes(I) > st.SMEM_LIMIT
          or R_loc > st._GRID_Y_MAX):
        raise ValueError(f"the deferred pass B has no layout at {where}"
                         f"{hint}")
    if config == "full" and st.strip_row_layout(L, K) is None:
        raise ValueError(f"pass C has no row layout at {where}{hint}")
    if config in ("batched", "deferred") and (
            st.pass_c_deferred_layout(L, K, J) is None
            or I_loc > st._GRID_Y_MAX):
        raise ValueError(f"the slab pass C has no layout at {where}{hint}")
    if config == "pair" and (
            st.pass_c_pair_smem_bytes(R, K, pair_shapes[3]) > st.SMEM_LIMIT
            or I_loc > st._GRID_Y_MAX):
        raise ValueError(f"the pair pass C has no layout at {where}{hint}")


class StreamedShardPlan:
    """One shard's part of the streamed operator for a covered operand
    set: :meth:`pass_b` on its rows (R/n of them, from row index *
    R/n), :meth:`pass_c` on its columns (C/n, whole c1 slices), with its
    slices of the operands on ``device``.  The kernels and their layouts
    are those of the single-device operator
    (``kernels/streamed_two_phase.py``); only the shapes are the shard's.
    """

    def __init__(self, ops: TwoPhaseOperands, mode: str, n: int, index: int,
                 device):
        self.config = st.streamed_config(ops)
        self.mode, self.n, self.index = mode, n, index
        self.shapes = L, K, I, J = ops.shapes
        self.R, self.C = L * K, I * J
        self.R_loc, self.C_loc = (L // n) * K, (I // n) * J
        self.theta, self.beta = float(ops.theta), float(ops.beta)
        rows = slice(index * self.R_loc, (index + 1) * self.R_loc)
        cols = slice(index * self.C_loc, (index + 1) * self.C_loc)
        slices = slice(index * (I // n), (index + 1) * (I // n))
        cast = _f64_cast(device, torch.float32)
        self.W_r1, self.W_r2 = cast(ops.W_r1), cast(ops.W_r2)
        self.add_row = cast(ops.add_row)
        self.add_col = cast(np.asarray(ops.add_col).reshape(self.C)[cols])
        self.sub_row = self.sub_col = None
        if ops.has_sub:
            self.sub_row = cast(np.asarray(ops.sub_row).reshape(self.R)[rows])
            self.sub_col = cast(ops.sub_col)
        self.mid_col = cast(ops.mid_col) if ops.has_mid else None
        if self.config == "pair":
            # The shard owns whole h_z groups: its c1 slices (i, y) are
            # those of its i range.
            self.P_zpi, PzT = st.pair_device_operands(
                ops, torch.float32, device=device)
            n_i = ops.pair_shapes[0] // n
            self.PzT = PzT[index * n_i:(index + 1) * n_i].contiguous()
        else:
            W_c2t = np.swapaxes(ops.W_c2, -1, -2)
            if self.config == "batched":
                W_c2t = np.asarray(W_c2t)[slices]
            self.W_c2t = cast(W_c2t)
        if self.config in ("deferred", "pair"):
            self.W_c1t = cast(np.asarray(ops.W_c1).T)
        else:
            self.W_c1 = cast(ops.W_c1)

    def pass_b(self, e: torch.Tensor):
        """Pass B of the shard's rows ``e`` (R/n, I, J), float32: the mid
        field (R/n, I, J), with the row shifts s (R/n, 1) in fast mode."""
        if self.config in ("deferred", "pair"):
            return st.pass_b_deferred(e, self.W_c1t, self.theta,
                                      self.sub_row, self.sub_col)
        return st.pass_b(e, self.W_c1, None if self.config == "batched"
                         else self.W_c2t, self.theta, self.mode, self.sub_row,
                         self.sub_col, self.mid_col)

    def pass_c(self, mid: torch.Tensor, scale=None, S=None) -> torch.Tensor:
        """Pass C of the shard's columns ``mid`` (R, C/n) -> log T (R,
        C/n); fast mode takes every row's ``scale`` (R, 1) = exp(s - S)
        and the global shift ``S`` (1,)."""
        args = (self.W_r1, self.W_r2, self.add_row, self.add_col,
                self.theta, self.beta)
        if self.config == "pair":
            return st.pass_c_pair(mid, self.P_zpi, self.PzT, *args)
        if self.config == "deferred":
            return st.pass_c_deferred(mid, self.W_c2t, *args)
        if self.config == "batched":
            return st.pass_c_batched(mid, scale, S, self.W_c2t, *args,
                                     self.mode)
        return st.pass_c(mid, scale, S, *args, self.mode)


def _covered(ops: TwoPhaseOperands) -> TwoPhaseOperands:
    covered = st.streamed_coverable(ops)
    if covered is None:
        raise ValueError("operand set not covered by the streamed kernels")
    if covered is not ops:
        st._warn_conjugated_f32_floor(covered)
    return covered


def streamed_shard_plan(ops: TwoPhaseOperands, n: int, index: int,
                        mode: str = "auto", *,
                        device="cuda") -> StreamedShardPlan:
    """Shard ``index`` of ``n``'s plan of the streamed operator for
    ``ops`` (or its conjugated-shared form), after the checks of
    :func:`streamed_shard_map_factory`: divisibility and the kernels'
    layouts at the per-shard shapes."""
    from ..config import resolve_device
    ops = _covered(ops)
    mode = st.streamed_mode(ops, mode)
    _check_streamed_shards(ops, n)
    return StreamedShardPlan(ops, mode, n, index, resolve_device(device))


def _check_streamed_shards(ops: TwoPhaseOperands, n: int) -> None:
    L, K, I, J = ops.shapes
    if L % n or I % n:
        raise ValueError(f"row axis n_r1={L} and column axis n_c1={I} must "
                         f"each be divisible by the mesh size {n}")
    if ops.is_pair and ops.pair_shapes[0] % n:
        # Column shards must own whole current-h_z groups: pass C indexes
        # P_z by the shard's own i range.
        raise ValueError(f"pair operand sets need n_hz = "
                         f"{ops.pair_shapes[0]} divisible by the mesh size "
                         f"{n}")
    check_shard_layouts(st.streamed_config(ops), ops.shapes, n,
                        ops.pair_shapes)


def _member_twin(twin_local: Callable) -> Callable:
    """The local twin of one sweep member's slice, (1, ...) -> (1, ...),
    and its linearization."""
    def twin(x):
        return twin_local(x[0])[None]

    def linearize(x):
        lin = twin_local.linearize(x[0])
        return lambda v: lin(v[0])[None]

    twin.linearize = linearize
    return twin


def streamed_shard_map_factory(ops, mesh, axis_names=None,
                               dtype: Optional[torch.dtype] = None,
                               mode: str = "auto", batch_axis=None,
                               **tpu_options) -> ShardedOperator:
    """The streamed CUDA kernels composed over a mesh.

    The field ell (L, K, I, J) is sharded over its leading row axis on
    the mesh axes ``axis_names`` (all but ``batch_axis`` by default; more
    than one are flattened in mesh order).  Per rank: pass B on the
    local rows (columns complete), an all-to-all trading column blocks
    for the full row range of the rank's column block, pass C on the
    local columns (rows complete) and an all-to-all back.  Fast mode adds
    an ``all_reduce(MAX)`` for the global shift S and an all-gather of
    the per-row scales.  The per-row and per-column math is the
    single-device kernels', so results are bitwise theirs on the card.

    Every configuration of the single-device operator runs: plain fast,
    normalized (folded baseline), conjugated-shared (``mid_col``),
    batched, deferred and pair.  Requires n_r1 and n_c1 divisible by the
    mesh size (pair sets: n_hz as well); a per-shard shape outside a
    kernel's layout raises ``ValueError`` before any launch.

    ``batch_axis`` names a mesh axis of slices (e.g. hosts): the operator
    then maps a batch (n_slices, L, K, I, J), one sweep member per slice,
    and every collective stays on the intra-slice groups.  ``ops`` may
    then be a list of operand sets, one per slice (a calibration sweep);
    they must share shapes, theta, beta and structure.

    ``T.twin`` is the eager two-phase operator on the same row layout;
    ``torch.func.jvp`` and ``backward`` of ``T.local`` are its
    derivatives, and Newton linearizes it once per step
    (``T.local_twin.linearize``).  ``T.mode`` is the resolved mode,
    ``T.baseline_log_w`` the warm start of a normalized set (stacked or
    broadcast over the slices under ``batch_axis``), ``T.plan`` this
    rank's :class:`StreamedShardPlan`."""
    reject_tpu_options(tpu_options)
    if dtype is not None and dtype != torch.float32:
        raise ValueError("streamed kernels are the float32 tier; use "
                         "two_phase_shard_map_factory for float64")
    members = None
    if isinstance(ops, (list, tuple)):
        if batch_axis is None:
            raise ValueError("a per-slice operand sweep (list of operand "
                             "sets) requires batch_axis")
        if not ops:
            raise ValueError("empty operand sweep")
        members = [_covered(om) for om in ops]
        ops = members[0]
        for om in members[1:]:
            if om.shapes != ops.shapes:
                raise ValueError("sweep members must share grid shapes")
            if (float(om.theta) != float(ops.theta)
                    or float(om.beta) != float(ops.beta)):
                raise ValueError(
                    "sweep members must share theta and beta (the kernels "
                    "take them as scalars of one launch configuration); "
                    "gamma/psi/beta sweeps belong to drivers.wc_ratio_sweep")
            if (om.c2_batched != ops.c2_batched or om.has_sub != ops.has_sub
                    or om.has_mid != ops.has_mid
                    or om.is_pair != ops.is_pair
                    or st.streamed_config(om) != st.streamed_config(ops)):
                raise ValueError(
                    "sweep members must share operand structure "
                    "(baseline/batching/pair configuration)")
    else:
        ops = _covered(ops)
    names = tuple(mesh.mesh_dim_names)
    if axis_names is None:
        axis_names = tuple(a for a in names if a != batch_axis)
    elif isinstance(axis_names, str):
        axis_names = (axis_names,)
    else:
        axis_names = tuple(axis_names)
    if not axis_names:
        raise ValueError(
            "streamed_shard_map_factory needs at least one intra-slice mesh "
            "axis besides the batch axis (a one-device-per-slice sweep has "
            "nothing to shard: run the members as single-device operators)")
    if batch_axis is not None and batch_axis in axis_names:
        raise ValueError(f"batch_axis {batch_axis!r} must not be one of the "
                         f"intra-slice axes {axis_names}")
    mode = st.streamed_mode(ops, mode)
    intra = _axis(mesh, axis_names)
    n = intra.size
    for om in members or [ops]:
        _check_streamed_shards(om, n)
    dev = mesh_device(mesh)
    slice_index = 0
    if batch_axis is not None:
        n_slice = mesh.size(names.index(batch_axis))
        slice_index = mesh.get_local_rank(batch_axis)
    mine = members[slice_index] if members is not None else ops
    plan = StreamedShardPlan(mine, mode, n, intra.index, dev)
    twin_local = _sharded_eager_local(mine, torch.float32, dev, intra, None)
    # Newton's tangent: the twin's tape, one build per step (its matvec
    # runs the row contraction's reduce-scatter on the tangent).
    twin_local.linearize = lambda x: Linearization(twin_local, x)
    fast = mode == "fast"
    L, K, I, J = ops.shapes
    R_loc, C_loc = plan.R_loc, plan.C_loc

    def primal(ell):
        e = ell.to(torch.float32).reshape(R_loc, I, J).contiguous()
        b = plan.pass_b(e)
        scale = S = None
        if fast:
            b, s = b
            S = _all_reduce_max(torch.amax(s).reshape(1), intra)
            scale = _all_gather(torch.exp(s - S), intra)
        # Rows -> columns: block k of the sent tensor is this rank's rows
        # of column block k; block k received is rank k's rows of ours.
        mid = _all_to_all(b.reshape(R_loc, n, C_loc).transpose(0, 1),
                          intra).reshape(n * R_loc, C_loc)
        out = plan.pass_c(mid, scale, S)
        # Columns -> rows.
        out = _all_to_all(out.reshape(n, R_loc, C_loc), intra)
        return out.transpose(0, 1).reshape(L // n, K, I, J)

    class _ShardedStreamedT(torch.autograd.Function):
        # Both derivatives are the eager twin's on the same shards.
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
            return torch.func.jvp(twin_local, (ell,), (dell,))[1]

        @staticmethod
        def backward(ctx, grad):
            (ell,) = ctx.saved_tensors
            with torch.enable_grad():
                x = ell.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(twin_local(x), x, grad)
            return g

    local = _ShardedStreamedT.apply
    cast = _f64_cast(dev, torch.float32)
    if batch_axis is None:
        T = ShardedOperator(local, mesh, _placements(
            mesh, {a: 0 for a in axis_names}), ops.shapes, intra,
            local_twin=twin_local)
        if ops.baseline_log_w is not None:
            T.baseline_log_w = cast(ops.baseline_log_w)
    else:
        # One member per slice: the local shard is (1, L/n, K, I, J).
        T = ShardedOperator(
            lambda x: local(x[0])[None], mesh,
            _placements(mesh, {batch_axis: 0, **{a: 1 for a in axis_names}}),
            (n_slice,) + tuple(ops.shapes),
            _axis(mesh, _mesh_order(mesh, (batch_axis,) + axis_names)),
            local_twin=_member_twin(twin_local),
            batch_axis=batch_axis, n_slice=n_slice)
        if members is not None:
            if all(om.baseline_log_w is not None for om in members):
                T.baseline_log_w = torch.stack(
                    [cast(om.baseline_log_w) for om in members])
        elif ops.baseline_log_w is not None:
            base = cast(ops.baseline_log_w)
            T.baseline_log_w = base.expand((n_slice,) + tuple(base.shape))
    T.mode = mode
    T.plan = plan
    return T
