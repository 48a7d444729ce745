"""CUDA kernels: segment-packed chunk + fingerprint pipeline, one call.

Replaces ``repro/kernels/fused_pipeline.py:packed_pipeline_batch``.  Each
row of a ``(B, S)`` batch holds several streams back to back; ``ends``
``(B, G)`` lists their exclusive ends, nondecreasing, padded with the
row's payload end.  The kernel (``csrc/packed_pipeline.cu``) walks each
segment of a row as its own stream, the warps of the row's block in
parallel (a segment shorter than ``min_size`` is one chunk, no walk), then
places the segments' bounds by a prefix sum over their counts, and hashes
every chunk slot in a second launch; it is memory-bound (each byte and
each end needed once).  Its plain version is the packed split path
(:func:`packed_pipeline_plain`), as the reference's scheduler composes it:
``boundaries_packed_batch`` followed by the batched
``chunk_fingerprints`` (the fingerprint is translation invariant, so the
packed bounds need no correction).

The per-position segment-end operand of the reference's signature is not
an argument here: it follows from ``ends`` (``core.seqcdc.
segment_end_positions``), which the plain version computes; the kernel
needs only the segments' ends.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.automaton import _BIG
from repro_torch.core.params import SeqCDCParams
from repro_torch.core.seqcdc import (
    boundaries_packed_batch,
    segment_end_positions,
)
from repro_torch.dedup.fingerprint import MAX_CHUNK, pow_tables

from ._build import Kernel
from .fused_pipeline import kept_fingerprints

KERNEL = Kernel(
    "packed_pipeline",
    [ctypes.c_void_p] * 8
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 9,
    replaces="src/repro/kernels/fused_pipeline.py:621",
)


def packed_pipeline_plain(data: torch.Tensor, ends: torch.Tensor,
                          p: SeqCDCParams, *, max_chunks: int,
                          mask_impl: str = "torch", select_impl: str = "torch",
                          fp_impl: str = "torch"):
    """The packed split path over ``(B, S)`` rows: the normative pipeline
    the packed kernel collapses into one launch.  With the default
    ``"torch"`` stages it is the kernel's plain version; the scheduler's
    split pipeline runs it with its own ``mask_impl``/``fp_impl`` and the
    packed select kernel (``select_impl="cuda"``)."""
    sep = segment_end_positions(ends, data.shape[-1])
    bounds, counts = boundaries_packed_batch(
        data, sep, ends, p, mask_impl=mask_impl, select_impl=select_impl,
        max_chunks=max_chunks)
    fps, lens = kept_fingerprints(data, bounds, counts,
                                  max_chunks=max_chunks, fp_impl=fp_impl)
    return bounds, counts, fps, lens


def packed_pipeline_batch(data: torch.Tensor, ends: torch.Tensor,
                          p: SeqCDCParams, *, max_chunks: int):
    """Chunk + fingerprint ``(B, S)`` uint8 packed rows with ``(B, G)``
    segment ends.

    Returns ``(bounds (B, mc) int32, counts (B,) int32, fps (B, mc, 2)
    uint32, lengths (B, mc) int32)`` in row coordinates, bit-identical to
    :func:`packed_pipeline_plain` and, per segment, to chunking each stream
    alone.  Rows are at most 65536 wide (the reference's bound).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises).
    """
    if data.ndim != 2 or ends.ndim != 2 or ends.shape[0] != data.shape[0]:
        raise ValueError(f"expected (B, S) data and (B, G) ends, got "
                         f"{tuple(data.shape)} and {tuple(ends.shape)}")
    B, n = data.shape
    G = ends.shape[1]
    mc = max_chunks
    dev = data.device
    if n == 0:  # no chunks
        return (torch.full((B, mc), _BIG, dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev),
                torch.zeros((B, mc, 2), dtype=torch.uint32, device=dev),
                torch.zeros((B, mc), dtype=torch.int32, device=dev))
    if p.max_size > MAX_CHUNK:
        raise ValueError(
            f"max_size {p.max_size} exceeds the fingerprint power-table "
            f"bound {MAX_CHUNK}"
        )
    if n > MAX_CHUNK:
        raise ValueError(
            f"packed row width {n} exceeds the limb-exactness bound "
            f"{MAX_CHUNK}; pack into narrower rows"
        )
    if dev.type == "cpu":
        return packed_pipeline_plain(data, ends, p, max_chunks=mc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if data.dtype != torch.uint8 or not data.is_contiguous():
        raise ValueError(f"expected contiguous uint8 data, got {data.dtype}")
    if (ends.dtype != torch.int32 or not ends.is_contiguous()
            or ends.device != dev or G < 1):
        raise ValueError(f"expected contiguous int32 (B, G>=1) ends on "
                         f"{dev}, got {ends.dtype} {tuple(ends.shape)} on "
                         f"{ends.device}")
    # the kernel's scratch a row: G counts, its list of segments of
    # min_size or more, and each segment's slots (csrc/packed_pipeline.cu)
    ints = 2 * G + 2 * (n // p.min_size) + 1
    scratch = torch.empty((B, ints), dtype=torch.int32, device=dev)
    bounds = torch.empty((B, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    fps = torch.empty((B, mc, 2), dtype=torch.uint32, device=dev)
    lens = torch.empty((B, mc), dtype=torch.int32, device=dev)
    pw = pow_tables(str(dev), torch.int32)
    with torch.cuda.device(dev):
        KERNEL.launch(
            data.data_ptr(), ends.data_ptr(), pw.data_ptr(),
            bounds.data_ptr(), counts.data_ptr(), fps.data_ptr(),
            lens.data_ptr(), scratch.data_ptr(), ints, B, n, G, mc,
            p.seq_length, int(p.mode == "increasing"), p.block_width,
            p.skip_trigger, p.skip_size,
            p.sub_min_skip, p.max_size,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts, fps, lens
