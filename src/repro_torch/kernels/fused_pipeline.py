"""CUDA kernel: fused chunk + fingerprint pipeline, one launch per batch.

Replaces ``repro/kernels/fused_pipeline.py:fused_pipeline_batch``.  The
kernel (``csrc/fused_pipeline.cu``) is two launches behind one call: a
scan with one two-warp CTA per row (a producer warp streams the row into
a shared-memory ring with bulk copies; the scanning warp computes the mask
words of each W-block the ``wide`` automaton reaches, on demand, and
resolves it), then one warp per chunk slot of the batch hashing the kept
chunks.  The function is memory-bound (each byte needed once); the design
is bound by the scan's serial chain.  Its plain version is the
composed split path (:func:`fused_pipeline_plain`), as
``repro/kernels/ref.py`` defines the TPU kernel's oracle:
``boundaries_batch`` followed by the batched ``chunk_fingerprints``.

With an undersized ``max_chunks`` (below ``core.automaton.
max_chunks_for``, which the scheduler always passes) emits past the table
are dropped whole, as the reference's kernel drops them: the plain version
hashes with one spare slot for the overflow bytes (:func:`kept_fingerprints`),
where the bare split path would fold them into the last slot.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.automaton import _BIG
from repro_torch.core.params import SeqCDCParams
from repro_torch.core.seqcdc import boundaries_batch
from repro_torch.dedup.fingerprint import (
    MAX_CHUNK,
    chunk_fingerprints,
    pow_tables,
)

from ._build import Kernel

KERNEL = Kernel(
    "fused_pipeline",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 8,
    replaces="src/repro/kernels/fused_pipeline.py:251",
)


def kept_fingerprints(data: torch.Tensor, bounds: torch.Tensor,
                      counts: torch.Tensor, *, max_chunks: int,
                      fp_impl: str = "torch"):
    """``chunk_fingerprints`` of the kept chunks, overflow dropped whole.

    With more emits than ``max_chunks`` slots, ``chunk_fingerprints`` folds
    the bytes past the last kept bound into the last slot; the reference's
    fused and packed kernels drop them.  A spare sentinel slot takes those
    bytes and is cut off, so at a true bound nothing changes."""
    spare = F.pad(bounds, (0, 1), value=_BIG)
    fps, lens = chunk_fingerprints(data, spare, counts,
                                   max_chunks=max_chunks + 1, fp_impl=fp_impl)
    return fps[:, :max_chunks].contiguous(), lens[:, :max_chunks].contiguous()


def fused_pipeline_plain(data: torch.Tensor, p: SeqCDCParams, *,
                         max_chunks: int, mask_impl: str = "torch",
                         step_impl: str = "wide", select_impl: str = "torch",
                         fp_impl: str = "torch"):
    """The composed split path over a ``(B, S)`` batch: the normative
    pipeline the fused kernel collapses into one launch.  With the default
    ``"torch"`` stages it is the kernel's plain version; the scheduler's
    split pipeline runs it with its own stages (the select kernel among
    them)."""
    bounds, counts = boundaries_batch(data, p, mask_impl=mask_impl,
                                      step_impl=step_impl,
                                      select_impl=select_impl,
                                      max_chunks=max_chunks)
    fps, lens = kept_fingerprints(data, bounds, counts,
                                  max_chunks=max_chunks, fp_impl=fp_impl)
    return bounds, counts, fps, lens


def fused_pipeline_batch(data: torch.Tensor, p: SeqCDCParams, *,
                         max_chunks: int):
    """Chunk + fingerprint a ``(B, S)`` uint8 batch.

    Returns ``(bounds (B, mc) int32, counts (B,) int32, fps (B, mc, 2)
    uint32, lengths (B, mc) int32)``, bit-identical to
    :func:`fused_pipeline_plain`.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises).
    """
    if data.ndim != 2:
        raise ValueError(f"expected (B, S) data, got {tuple(data.shape)}")
    B, n = data.shape
    mc = max_chunks
    dev = data.device
    if n == 0:  # no chunks, matching the split path's empty case
        return (torch.full((B, mc), _BIG, dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev),
                torch.zeros((B, mc, 2), dtype=torch.uint32, device=dev),
                torch.zeros((B, mc), dtype=torch.int32, device=dev))
    if p.max_size > MAX_CHUNK:
        raise ValueError(
            f"max_size {p.max_size} exceeds the fingerprint power-table "
            f"bound {MAX_CHUNK}"
        )
    if dev.type == "cpu":
        return fused_pipeline_plain(data, p, max_chunks=mc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if data.dtype != torch.uint8 or not data.is_contiguous():
        raise ValueError(f"expected contiguous uint8 data, got {data.dtype}")
    W = p.block_width
    # the split automaton pads its bitmaps so every event fires in-scan
    # (core/automaton._padded_blocks); the kernel covers exactly those
    # blocks
    cover = (n + p.skip_size + W + W - 1) // W * W
    bounds = torch.empty((B, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    fps = torch.empty((B, mc, 2), dtype=torch.uint32, device=dev)
    lens = torch.empty((B, mc), dtype=torch.int32, device=dev)
    pw = pow_tables(str(dev), torch.int32)
    with torch.cuda.device(dev):
        KERNEL.launch(
            data.data_ptr(), pw.data_ptr(), bounds.data_ptr(),
            counts.data_ptr(), fps.data_ptr(), lens.data_ptr(),
            B, n, cover, mc, p.seq_length, int(p.mode == "increasing"),
            W, p.skip_trigger, p.skip_size, p.sub_min_skip, p.max_size,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts, fps, lens
