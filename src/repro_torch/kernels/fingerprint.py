"""CUDA kernel: per-chunk 62-bit fingerprints.

Replaces ``repro/kernels/fingerprint.py:fingerprint_pallas``.  The kernel
(``csrc/fingerprint.cu``) runs one CTA per chunk slot and cuts the chunk
into 64-byte pieces, each summed against constant weights ``r^(63-q)`` and
scaled by one factor of :func:`piece_factors` (every 64th power); the
chunk's ragged ends take the reference's power table byte by byte.  It is
memory-bound, each byte read once.  Its plain version is
``dedup.fingerprint.chunk_fingerprints_torch``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.dedup.fingerprint import (
    chunk_fingerprints_torch as chunk_fingerprints_plain,
    pow_tables,
)

from ._build import Kernel

KERNEL = Kernel(
    "fingerprint",
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
    replaces="src/repro/kernels/fingerprint.py:122",
)

#: bytes a piece of the kernel (``kPiece`` in ``csrc/fingerprint.cu``)
PIECE = 64


@functools.lru_cache(maxsize=None)
def piece_factors(device: str) -> torch.Tensor:
    """``(2, MAX_CHUNK // 64)`` int32 ``r^(64 k) mod p`` for (R1, R2) on
    ``device``: the kernel's factor a 64-byte piece.  One cached tensor a
    device; read-only."""
    return pow_tables(device, torch.int32)[:, ::PIECE].contiguous()


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
    pw64 = piece_factors(str(dev))
    with torch.cuda.device(dev):
        KERNEL.launch(
            data.data_ptr(), bounds.data_ptr(), counts.data_ptr(),
            pw.data_ptr(), pw64.data_ptr(), fps.data_ptr(), lens.data_ptr(),
            B, S, mc,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return fps, lens
