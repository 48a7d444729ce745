"""CUDA kernel: fused chunk + fingerprint pipeline, one launch per batch.

Replaces ``repro/kernels/fused_pipeline.py:fused_pipeline_batch``.  The
kernel (``csrc/fused_pipeline.cu``) gives each row one thread block that
walks the row's tiles in order: mask words per tile in shared memory, the
``wide`` W-block automaton per block, then the hash of every kept chunk.
It is memory-bound (each byte needed once).  Its plain version is the
composed split path (:func:`fused_pipeline_plain`), as
``repro/kernels/ref.py`` defines the TPU kernel's oracle:
``boundaries_batch`` followed by the batched ``chunk_fingerprints``.

Precondition (the reference's): ``max_chunks`` must be a true upper bound
on the chunk count, ``core.automaton.max_chunks_for``, which the scheduler
always passes.  With an undersized bound the split path folds the overflow
bytes into the last fingerprint slot while the kernel drops overflow
chunks whole, so the two fingerprint tails differ.
"""
from __future__ import annotations

import ctypes

import torch

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
    fps, lens = chunk_fingerprints(data, bounds, counts,
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
