"""CUDA kernel: per-chunk 62-bit fingerprints.

Replaces ``repro/kernels/fingerprint.py:fingerprint_pallas``.  The kernel
(``csrc/fingerprint.cu``) runs one warp per chunk slot and sums
``b_i * r^(e-1-i)`` against the reference's power table, which stays in
L2; it is memory-bound, each byte read once.  Its plain version is
``dedup.fingerprint.chunk_fingerprints_torch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dedup.fingerprint import (
    chunk_fingerprints_torch as chunk_fingerprints_plain,
    pow_tables,
)

from ._build import Kernel

KERNEL = Kernel(
    "fingerprint",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
    replaces="src/repro/kernels/fingerprint.py:122",
)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )


def chunk_fingerprints(data: torch.Tensor, bounds: torch.Tensor,
                       counts: torch.Tensor, *, max_chunks: int):
    """``(fps (B, mc, 2) uint32, lengths (B, mc) int32)`` of ``(B, S)``
    uint8 data chunked by ``(B, mc)`` int32 bounds with ``(B,)`` int32
    counts; slots past a row's count are zero.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if data.device.type == "cpu":
        return chunk_fingerprints_plain(data, bounds, counts,
                                        max_chunks=max_chunks)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.ndim != 2:
        raise ValueError(f"expected (B, S) data, got {tuple(data.shape)}")
    B, S = data.shape
    mc = max_chunks
    _check(data, "data", torch.uint8, (B, S))
    _check(bounds, "bounds", torch.int32, (B, mc))
    _check(counts, "counts", torch.int32, (B,))
    dev = data.device
    fps = torch.empty((B, mc, 2), dtype=torch.uint32, device=dev)
    lens = torch.empty((B, mc), dtype=torch.int32, device=dev)
    if B * mc == 0:
        return fps, lens
    pw = pow_tables(str(dev), torch.int32)
    with torch.cuda.device(dev):
        KERNEL.launch(
            data.data_ptr(), bounds.data_ptr(), counts.data_ptr(),
            pw.data_ptr(), fps.data_ptr(), lens.data_ptr(), B, S, mc,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return fps, lens
