"""What the ``gather`` and ``event`` select kernels share
(``csrc/boundary_chain.cuh``): the jump length of their chase and the
chain's scratch.

Both kernels walk the automaton from every place a row can stand after a
candidate's emit (a node) at once, then link the results in one chase a
row: a thread hops along each node's K-th successor, and each hop's K
edges are written out in parallel.  The scratch, indexed by position
(``n + 1`` entries a row, only nodes written), is the design's, not the
function's: the kernels' bounds do not count it.
"""
from __future__ import annotations

import torch


def chain_k(n: int, p) -> int:
    """The chase's jump length for an ``n``-position row: a chain of C
    edges costs about C / K dependent reads in the chase's hops, K in its
    expansions and K in the jump launch, least at K = sqrt(C / 2); C is
    taken as half the row's chunks at ``min_size`` (chunks average about
    twice it).  The least power of two at least that, at most 256."""
    chunks, k = max(1, n // p.min_size), 1
    while 4 * k * k < chunks and k < 256:
        k *= 2
    return k


def chain_tables(B: int, n: int, device):
    """The chain's scratch for ``B`` rows of ``n``: each node's next
    candidate's emit ``(B, n + 1)`` int32 and its K-th successor with the
    emits on the way ``(B, n + 1, 2)`` int32."""
    nxt = torch.empty((B, n + 1), dtype=torch.int32, device=device)
    jmp = torch.empty((B, n + 1, 2), dtype=torch.int32, device=device)
    return nxt, jmp


def check_stats(stats, B: int, device) -> None:
    """Raise ``ValueError`` unless ``stats`` is None or a ``(B, 2)`` int32
    tensor on ``device`` (the chase's serial hops and expanded edges a
    row)."""
    if stats is not None and (stats.dtype != torch.int32
                              or tuple(stats.shape) != (B, 2)
                              or stats.device != device):
        raise ValueError(f"stats must be a ({B}, 2) int32 tensor on "
                         f"{device}, got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")
