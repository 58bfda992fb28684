"""BiCGStab's vector work in five fused passes (``csrc/krylov_fused.cu``).

One BiCGStab iteration of :func:`..solvers.krylov.bicgstab_fused` is five
passes around its two matvecs: P1 the search direction, P2 and P3 the
alpha half step, P4 and P5 the omega step and the next residual, each
pass reading its vectors once, accumulating its dot products in float64
and leaving the recurrence scalars (rho, alpha, omega, the breakdown
flags, the stop flag and the count) in a small float64 block on the
vectors' device, :data:`SLOTS`.  P0 reduces <r, r> at the start.

:class:`Passes` launches them on CUDA vectors, one launch a pass; on a
sharded iterate the reducing passes' two local sums go through one
all-reduce and a separate epilogue launch.  Other vectors run the eager
loop (``solvers/krylov._bicgstab_eager``), which the card tests hold
the passes against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from . import _build

__all__ = ["SLOTS", "LAUNCHES", "Passes", "fusable"]

# The scalar block's slots, as the .cu's ``Slot`` enum.
SLOTS = ("atol2", "tiny", "maxiter", "rho", "alpha", "omega", "rho_new",
         "rr", "beta", "rv", "alpha_new", "bad_a", "ss", "tt", "ts",
         "omega_new", "half", "it", "ok", "run")
(ATOL2, TINY, MAXITER, RHO, ALPHA, OMEGA, RHO_NEW, RR, BETA, RV, ALPHA_NEW,
 BAD_A, SS, TT, TS, OMEGA_NEW, HALF, IT, OK, RUN) = range(len(SLOTS))
REDUCING = (0, 2, 3, 4, 5)          # the passes with dot products

LAUNCHES = {"krylov_pass": 0, "krylov_epilogue": 0}


def fusable(b) -> bool:
    """Whether a right-hand side takes the CUDA passes: a plain CUDA
    tensor of float32 or float64 outside any autograd graph (the passes
    write their vectors in place and carry no gradient)."""
    return (type(b) is torch.Tensor and b.is_cuda
            and b.dtype in (torch.float32, torch.float64)
            and not torch._C._functorch.is_functorch_wrapped_tensor(b)
            and not (b.requires_grad and torch.is_grad_enabled()))


def _lib():
    lib = _build.load("krylov_fused")
    if not getattr(lib, "_sdfs_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sdfs_krylov_slots.restype = i
        lib.sdfs_krylov_max_blocks.restype = i
        lib.sdfs_krylov_pass.argtypes = [i, i, ctypes.c_longlong] + [p] * 9 \
            + [i, p]
        lib.sdfs_krylov_pass.restype = i
        lib.sdfs_krylov_epilogue.argtypes = [i, p, p, p]
        lib.sdfs_krylov_epilogue.restype = i
        lib.sdfs_krylov_error_string.argtypes = [i]
        lib.sdfs_krylov_error_string.restype = ctypes.c_char_p
        if lib.sdfs_krylov_slots() != len(SLOTS):
            raise RuntimeError("krylov_fused.cu's scalar block does not "
                               "match SLOTS")
        lib._sdfs_typed = True
    return lib


class Passes:
    """The passes of one solve over its flat state vectors ``x``, ``r``
    (which holds s between P3 and P5), ``p`` and ``rhat``: contiguous
    CUDA tensors of one float32 or float64 dtype and length, with the
    scalar block ``S`` on their device.  ``red`` all-reduces a sharded
    iterate's sums (one collective a pass).  Call :meth:`start`, then
    ``self(k, w)`` for k = 1..5, ``w`` the matvec's output (v for P1-P3,
    t for P4 and P5)."""

    def __init__(self, x, r, p, rhat, red):
        self.vecs = (x, r, p, rhat)
        self.dev, self.n, self.dtype = x.device, x.numel(), x.dtype
        named = tuple(zip(("x", "r", "p", "rhat"), self.vecs))
        for on_device in (False, True):    # the layouts first, then devices
            for name, v in named:
                self._check(name, v, on_device)
        self.red = red
        self.S = torch.zeros(len(SLOTS), dtype=torch.float64, device=self.dev)
        self.sums = torch.zeros(2, dtype=torch.float64, device=self.dev)
        self.lib = _lib()
        with torch.cuda.device(self.dev):
            rows = self.lib.sdfs_krylov_max_blocks()
            self.stream = ctypes.c_void_p(
                torch.cuda.current_stream(self.dev).cuda_stream)
        if rows <= 0:
            raise RuntimeError("fused Krylov passes: cannot query the device")
        self.partials = torch.empty(2 * rows, dtype=torch.float64,
                                    device=self.dev)
        self.counter = torch.zeros(1, dtype=torch.int32, device=self.dev)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        self._vec_ptrs = [ptr(t) for t in self.vecs]
        self._fixed = [ptr(t) for t in (self.S, self.partials, self.counter,
                                        self.sums)]

    def _check(self, name, v, on_device=True) -> None:
        """The kernels read every vector as ``n`` dense entries of the
        solve's dtype (and, ``on_device``, on its card)."""
        if (v.dtype not in (torch.float32, torch.float64)
                or v.dtype != self.dtype or v.numel() != self.n
                or v.dim() != 1 or not v.is_contiguous()
                or on_device and (v.device.type != "cuda"
                                  or v.device != self.dev)):
            raise ValueError(
                f"fused Krylov passes: {name} is {tuple(v.shape)} "
                f"{v.dtype} on {v.device} (contiguous: "
                f"{v.is_contiguous()}); expected a contiguous 1-D float32 "
                f"or float64 CUDA tensor with x's {self.n} entries, dtype "
                f"({self.dtype}) and device ({self.dev})")

    @property
    def running(self):
        """The stop flag's slot: 1.0 while the solve runs."""
        return self.S[RUN]

    @property
    def iterations(self):
        return self.S[IT]

    def start(self, atol, maxiter: int) -> None:
        """P0 on the initial residual: the floors, the first recurrence
        scalars and the first stop condition."""
        # Filled on the device: a copy of a host scalar would wait for it.
        self.S[MAXITER].fill_(float(maxiter))
        self.S[ATOL2] = torch.as_tensor(atol, dtype=torch.float64,
                                        device=self.dev) ** 2
        self(0)

    def __call__(self, k: int, w=None) -> None:
        if w is not None:
            w = w.reshape(-1).contiguous()
            self._check(f"pass {k}'s matvec output", w)
        rc = self.lib.sdfs_krylov_pass(
            k, int(self.dtype == torch.float64), self.n, *self._vec_ptrs[:3],
            None if w is None else ctypes.c_void_p(w.data_ptr()),
            self._vec_ptrs[3], *self._fixed, int(not self.red.sharded),
            self.stream)
        if rc != 0:
            raise RuntimeError(
                f"fused Krylov pass {k} failed: "
                f"{self.lib.sdfs_krylov_error_string(rc).decode()} ({rc})")
        LAUNCHES["krylov_pass"] += 1
        if k in REDUCING and self.red.sharded:
            # One all-reduce of the pass's two sums, then its epilogue.
            dist.all_reduce(self.sums, op=dist.ReduceOp.SUM,
                            group=self.red.group)
            rc = self.lib.sdfs_krylov_epilogue(k, self._fixed[0],
                                               self._fixed[3], self.stream)
            if rc != 0:
                raise RuntimeError(
                    f"fused Krylov epilogue {k} failed: "
                    f"{self.lib.sdfs_krylov_error_string(rc).decode()} "
                    f"({rc})")
            LAUNCHES["krylov_epilogue"] += 1
