"""Chunks of small sequential steps, replayed as CUDA graphs.

A simulation step of the SSY or GCY state is a dozen elementwise
kernels on a few numbers (a path) or a few thousand (a panel): on the
card the host's launch cost, not the device, sets the pace of a Python
loop over such steps.  :func:`run_chunks` runs a chunk of steps eagerly
once and captures the next as a CUDA graph, which each later chunk
replays: the same kernels on the same buffers, so the results are
bitwise the loop's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["run_chunks"]

# False makes :func:`run_chunks` run every chunk eagerly, on any device:
# the plain loop that the graph replays are held against.
_ENABLED = True


def run_chunks(run_chunk: Callable[[], None], n_chunks: int, *,
               before: Optional[Callable[[int], None]] = None,
               after: Optional[Callable[[int], None]] = None,
               graphs: bool = False) -> None:
    """For c in range(n_chunks): ``before(c)``, ``run_chunk()``,
    ``after(c)``.

    ``run_chunk`` reads its inputs from, and writes its results into,
    tensors that live across calls (``before`` fills them, ``after``
    reads them), and does not synchronize with the host.  With
    ``graphs`` (a CUDA device) and :data:`_ENABLED`, the first chunk
    runs eagerly and the rest replay one capture of ``run_chunk``.
    """
    graphs = graphs and _ENABLED
    graph = None
    for c in range(n_chunks):
        if before is not None:
            before(c)
        if graph is not None:
            graph.replay()
        else:
            run_chunk()
            if graphs and c + 1 < n_chunks:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    run_chunk()
        if after is not None:
            after(c)
