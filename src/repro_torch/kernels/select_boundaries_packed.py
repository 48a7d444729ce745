"""CUDA kernel: the ``wide`` automaton over packed rows' bitmaps.

The device form of ``repro/core/automaton.py:_scan_wide_packed`` (run
through ``select_boundaries_packed``), which the reference runs as a
``lax.scan`` over W-blocks with a ``while_loop`` a block: it has no Pallas
kernel, but a Python loop over W-blocks is no GPU path.  The kernel
(``csrc/select_boundaries_packed.cu``) is one launch, one CTA a row: the
copy engine brings both bitmap rows into shared memory while the threads
sort the segments, each segment of ``min_size`` or more is walked as its
own stream on a warp (the words of a search window built from the resident
bytes where the walk reaches it, an event's trigger found from the
window's opposing prefix), and a prefix sum over the segments' counts
places their bounds (``csrc/packed_walk.cuh``).  Its least time on an H100
is ``2*B*S + 4*B*G + 4*B*mc + 4*B`` bytes at 3.35 TB/s.  Its plain version
is ``core.automaton.select_boundaries_packed``.

It serves the packed split path (``core.seqcdc.boundaries_packed_batch``
with ``select_impl="cuda"``), which the scheduler's packed dispatches run
when the packed kernel does not: ``pipeline_impl="split"``, or no
fingerprints.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.automaton import _BIG
from repro_torch.core.automaton import (
    select_boundaries_packed as select_packed_plain,
)
from repro_torch.dedup.fingerprint import MAX_CHUNK

from ._build import Kernel

KERNEL = Kernel(
    "select_boundaries_packed",
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 8,
    replaces="src/repro/core/automaton.py:133",
)


#: shared memory a CTA may take (``csrc/select_boundaries_packed.cu``
#: ``kSmemMax``)
SMEM_MAX = 200 << 10


def scratch_ints(n: int, G: int, min_size: int) -> int:
    """The kernel's scratch a row: G counts, its list of segments of
    ``min_size`` or more and each segment's slots
    (``csrc/packed_walk.cuh``)."""
    return 2 * G + 2 * (n // min_size) + 1


def device_scratch_ints(n: int, G: int, min_size: int) -> int:
    """Ints a row of device scratch the kernel needs: 0 where its scratch
    fits in shared memory beside both bitmap rows, else
    :func:`scratch_ints`.  The kernel's rule, repeated here (a launch that
    needs the buffer and is given none is refused): a bitmap row takes its
    16-byte floor and ceiling and 48 bytes its last word's loads may reach,
    ``region_bytes`` in ``csrc/select_boundaries_packed.cu``."""
    region = ((n + 15) & ~15) + 64
    ints = scratch_ints(n, G, min_size)
    return 0 if 2 * region + 4 * ints <= SMEM_MAX else ints


def select_boundaries_packed(cand: torch.Tensor, opp: torch.Tensor,
                             ends: torch.Tensor, p, *, max_chunks: int):
    """Resolve chunk boundaries for ``(B, S)`` packed rows from their bool
    bitmaps and ``(B, G)`` segment ends.

    The bitmaps must be clipped per segment as
    ``core.seqcdc.boundaries_packed_batch`` clips them (candidates at
    ``pos <= end - L`` and opposing pairs at ``pos < end - 1`` of their own
    segment, none past the payload end ``ends[:, -1]``); on such bitmaps
    the result is bit-identical to :func:`select_packed_plain`: ``(bounds
    (B, max_chunks) int32, counts (B,) int32)`` in row coordinates, every
    segment end a bound, sentinel ``1<<30`` past the kept chunks, emits past
    ``max_chunks`` dropped whole and counted.  Rows are at most 65536 wide
    (the reference's bound).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises).
    """
    if (cand.ndim != 2 or ends.ndim != 2 or ends.shape[0] != cand.shape[0]
            or opp.shape != cand.shape):
        raise ValueError(f"expected two (B, S) bitmaps and (B, G) ends, got "
                         f"{tuple(cand.shape)}, {tuple(opp.shape)} and "
                         f"{tuple(ends.shape)}")
    if cand.dtype != torch.bool or opp.dtype != torch.bool:
        raise ValueError(f"expected bool bitmaps, got {cand.dtype} and "
                         f"{opp.dtype}")
    B, n = cand.shape
    G = ends.shape[1]
    mc = max_chunks
    dev = cand.device
    if n == 0:  # no chunks
        return (torch.full((B, mc), _BIG, dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    if n > MAX_CHUNK:
        raise ValueError(f"packed row width {n} exceeds the bound "
                         f"{MAX_CHUNK}; pack into narrower rows")
    if dev.type == "cpu":
        return select_packed_plain(cand, opp, ends, p, max_chunks=mc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (ends.dtype != torch.int32 or not ends.is_contiguous()
            or ends.device != dev or opp.device != dev or G < 1):
        raise ValueError(f"expected contiguous int32 (B, G>=1) ends and both "
                         f"bitmaps on {dev}, got {ends.dtype} "
                         f"{tuple(ends.shape)} on {ends.device}, opp on "
                         f"{opp.device}")
    cand, opp = cand.contiguous(), opp.contiguous()
    min_size = p.min_size
    ints = scratch_ints(n, G, min_size)
    scratch = (torch.empty((B, ints), dtype=torch.int32, device=dev)
               if device_scratch_ints(n, G, min_size) else None)
    out = torch.empty((B * mc + B,), dtype=torch.int32, device=dev)
    bounds, counts = out[:B * mc].view(B, mc), out[B * mc:]
    with torch.cuda.device(dev):
        KERNEL.launch(
            cand.data_ptr(), opp.data_ptr(), ends.data_ptr(),
            bounds.data_ptr(), counts.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), ints, B, n, G, mc,
            p.seq_length, p.block_width, p.skip_trigger, p.skip_size,
            p.sub_min_skip, p.max_size,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts
