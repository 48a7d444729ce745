"""CUDA kernel: the ``wide`` W-block boundary automaton over given bitmaps.

The device form of ``repro/core/automaton.py:_scan_wide`` (run through
``select_boundaries``), which the reference runs as a ``lax.scan``: it has
no Pallas kernel, but a Python loop over W-blocks is no GPU path.  The
kernel (``csrc/select_boundaries.cu``) gives each row one thread block
that walks the row's tiles in order, stopping once the row is done.  Its
least time on an H100 is ``2*B*n + 4*B*mc + 4*B`` bytes at 3.35 TB/s.  Its
plain version is ``core.automaton.select_boundaries(step_impl="wide")``.

It serves the seqcdc chunker and the scheduler's split pipeline (SeqCDC
candidate/opposing bitmaps) and the hash-based chunkers' selector (a match
bitmap and ``SelectorParams``): the parameters come in as integers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.automaton import select_boundaries as select_plain

from ._build import Kernel

KERNEL = Kernel(
    "select_boundaries",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 7,
    replaces="src/repro/core/automaton.py:103",
)


def select_boundaries(cand: torch.Tensor, opp: torch.Tensor, n: int, p, *,
                      max_chunks: int | None = None):
    """Resolve chunk boundaries from ``(B, n)`` bool bitmaps with the
    ``wide`` step.

    Returns ``(bounds (B, max_chunks) int32, counts (B,) int32)``,
    bit-identical to :func:`select_plain`.  ``p`` is a ``SeqCDCParams`` or
    anything with its fields.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises).
    """
    mc = max_chunks or max_chunks_for(n, p)
    dev = cand.device
    if dev.type == "cpu":
        return select_plain(cand, opp, n, p, step_impl="wide", max_chunks=mc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (cand.dtype != torch.bool or opp.dtype != torch.bool
            or cand.ndim != 2 or cand.shape != opp.shape
            or cand.shape[1] != n or opp.device != dev):
        raise ValueError(
            f"expected two (B, {n}) bool bitmaps on {dev}, got "
            f"{cand.dtype} {tuple(cand.shape)} and {opp.dtype} "
            f"{tuple(opp.shape)} on {opp.device}")
    cand, opp = cand.contiguous(), opp.contiguous()
    B = cand.shape[0]
    W = p.block_width
    # the plain automaton pads its bitmaps so every event fires in-scan
    # (core/automaton._padded_blocks); the kernel covers those blocks
    cover = (n + p.skip_size + W + W - 1) // W * W
    bounds = torch.empty((B, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            cand.data_ptr(), opp.data_ptr(), bounds.data_ptr(),
            counts.data_ptr(), B, n, cover, mc, p.seq_length, W,
            p.skip_trigger, p.skip_size, p.sub_min_skip, p.max_size,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts
