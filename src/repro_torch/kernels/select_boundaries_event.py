"""CUDA kernel: the ``event`` boundary automaton over given bitmaps.

The device form of ``repro/core/automaton.py:_scan_event`` with
``select_boundaries``' fix-up, which the reference runs as a
``lax.while_loop`` from event to event over the two bitmaps' prefix sums:
it has no Pallas kernel, but a Python loop over events (a host sync each)
is no GPU path.  The kernel (``csrc/select_boundaries_event.cu``) is five
launches behind one call: a prefix launch across every SM packs the
bitmaps into words with their in-group prefix counts and each 1024-position
group's totals; one CTA a row scans its group totals; a node launch across
every SM walks the automaton from every candidate's emit at once
(``kernels/boundary_chain.py``), a warp a node, one iteration per event
(an emit or a skip), finding the next candidate and the skip trigger by a
search over the prefix sums, to the next candidate's emit; a jump launch
and one CTA a row chase the nodes into the row's bounds.  Its least time
on an H100 is ``2*B*n + 4*B*mc + 4*B`` bytes at 3.35 TB/s (the prefix sums
and the chain's tables are the design's scratch, not counted).  Its plain version is
``core.automaton.select_boundaries(step_impl="event")``.

Like the reference's ``while_loop``, the walk stops at ``max_chunks``
emits, so at an undersized table its count is not the ``wide`` count.
It serves the same callers as the ``wide`` select kernel
(``kernels/select_boundaries.py``) when they ask for ``step_impl="event"``.
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
    "select_boundaries_event",
    [ctypes.c_void_p] * 9
    + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 7,
    replaces="src/repro/core/automaton.py:339",
)

#: the CUDA kernels a call launches (prefix, scan, nodes, jump, chase), all
#: named ``select_boundaries_event_*``
LAUNCH_NAMES = 5


def select_boundaries_event(cand: torch.Tensor, opp: torch.Tensor, n: int,
                            p, *, max_chunks: int | None = None,
                            stats: torch.Tensor | None = None):
    """Resolve chunk boundaries from ``(B, n)`` bool bitmaps with the
    ``event`` step.

    Returns ``(bounds (B, max_chunks) int32, counts (B,) int32)``,
    bit-identical to :func:`select_plain` with ``step_impl="event"``.
    ``p`` is a ``SeqCDCParams`` or anything with its fields.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or raises).
    On the card, a ``(B, 2)`` int32 ``stats`` gets each row's chase: its
    serial hops and the edges its expansions wrote (the CPU has no chase).
    """
    mc = max_chunks or max_chunks_for(n, p)
    check_bitmaps(cand, opp, n)
    check_stats(stats, cand.shape[0], cand.device)
    if cand.device.type == "cpu":
        return select_plain(cand, opp, n, p, step_impl="event",
                            max_chunks=mc)
    dev = cand.device
    cand, opp = cand.contiguous(), opp.contiguous()
    B = cand.shape[0]
    G = -(-n // 1024)
    # a record per 1024 positions: 32 candidate words, 32 opposing words and
    # their in-group prefix counts; each group's two totals, scanned in
    # place by the scan launch into the row's prefix (the row's totals at
    # [G])
    records = torch.empty((B, max(1, G), 3, 32), dtype=torch.int32,
                          device=dev)
    sums = torch.empty((B, G + 1, 2), dtype=torch.int32, device=dev)
    nxt, jmp = chain_tables(B, n, dev)
    bounds = torch.empty((B, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            cand.data_ptr(), opp.data_ptr(), records.data_ptr(),
            sums.data_ptr(), nxt.data_ptr(), jmp.data_ptr(),
            bounds.data_ptr(), counts.data_ptr(),
            0 if stats is None else stats.data_ptr(), B, n, mc,
            p.seq_length, p.skip_trigger, p.skip_size, p.sub_min_skip,
            p.max_size, chain_k(n, p),
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts
