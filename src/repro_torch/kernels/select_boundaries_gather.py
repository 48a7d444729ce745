"""CUDA kernel: the ``gather`` W-block boundary automaton over given bitmaps.

The device form of ``repro/core/automaton.py:_scan_gather`` (run through
``select_boundaries``), which the reference runs as a ``lax.scan`` over
tables built in parallel over all W-blocks: it has no Pallas kernel, but
a Python loop over W-blocks is no GPU path.  The kernel
(``csrc/select_boundaries_gather.cu``) is four launches behind one call,
each across every SM but the last: a table launch packs the bitmaps into a
512-byte record per 1024 positions (the words, an opposing prefix and a
next-candidate entry a word); a node launch walks the automaton from every
candidate's emit at once (``kernels/boundary_chain.py``), a thread a node,
resolving the W-block holding the scan position with a constant number of
record reads, block after block, to the next candidate's emit; a jump
launch and one CTA a row chase the nodes into the row's bounds.  Its least
time on an H100 is ``2*B*n + 4*B*mc + 4*B`` bytes at 3.35 TB/s (the
records and the chain's tables are the design's scratch, not counted).  Its plain version is
``core.automaton.select_boundaries(step_impl="gather")``.

It serves the same callers as the ``wide`` select kernel
(``kernels/select_boundaries.py``) when they ask for ``step_impl="gather"``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.automaton import select_boundaries as select_plain

from ._build import Kernel
from .boundary_chain import chain_k, chain_tables, check_stats
from .select_boundaries import check_bitmaps

KERNEL = Kernel(
    "select_boundaries_gather",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 8,
    replaces="src/repro/core/automaton.py:275",
)

#: the CUDA kernels a call launches (tables, nodes, jump, chase), all
#: named ``select_boundaries_gather_*``
LAUNCH_NAMES = 4


def select_boundaries_gather(cand: torch.Tensor, opp: torch.Tensor, n: int,
                             p, *, max_chunks: int | None = None,
                             stats: torch.Tensor | None = None):
    """Resolve chunk boundaries from ``(B, n)`` bool bitmaps with the
    ``gather`` step.

    Returns ``(bounds (B, max_chunks) int32, counts (B,) int32)``,
    bit-identical to :func:`select_plain` with ``step_impl="gather"`` (and,
    at a true ``max_chunks``, to the ``wide`` step).  ``p`` is a
    ``SeqCDCParams`` or anything with its fields.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises).  On the
    card, a ``(B, 2)`` int32 ``stats`` gets each row's chase: its serial
    hops and the edges its expansions wrote (the CPU has no chase).
    """
    mc = max_chunks or max_chunks_for(n, p)
    check_bitmaps(cand, opp, n)
    check_stats(stats, cand.shape[0], cand.device)
    if cand.device.type == "cpu":
        return select_plain(cand, opp, n, p, step_impl="gather",
                            max_chunks=mc)
    dev = cand.device
    cand, opp = cand.contiguous(), opp.contiguous()
    B = cand.shape[0]
    W = p.block_width
    # the plain automaton's padded block range (core/automaton._padded_blocks)
    cover = (n + p.skip_size + W + W - 1) // W * W
    # a record per 1024 positions: 32 candidate words, 32 opposing words,
    # 32 opposing prefixes and 32 next-candidate entries
    tables = torch.empty((B, max(1, -(-n // 1024)), 4, 32),
                         dtype=torch.int32, device=dev)
    nxt, jmp = chain_tables(B, n, dev)
    bounds = torch.empty((B, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            cand.data_ptr(), opp.data_ptr(), tables.data_ptr(),
            nxt.data_ptr(), jmp.data_ptr(), bounds.data_ptr(),
            counts.data_ptr(), 0 if stats is None else stats.data_ptr(),
            B, n, cover, mc, p.seq_length, W, p.skip_trigger, p.skip_size,
            p.sub_min_skip, p.max_size, chain_k(n, p),
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts
