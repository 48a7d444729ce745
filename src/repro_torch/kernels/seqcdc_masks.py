"""CUDA kernel: SeqCDC phase-1 candidate/opposing bitmaps.

Replaces ``repro/kernels/seqcdc_masks.py:seqcdc_masks_pallas``.  The
kernel (``csrc/seqcdc_masks.cu``) is memory-bound: 1 byte read and 2
written per position, so its least time on an H100 is ``3 * B * S`` bytes
at 3.35 TB/s.  Up to ``seq_length`` 49 a thread takes 16 positions as bit
masks (the candidate run by log-doubling over a 64-bit window); longer
runs take a second kernel, one thread per 4 positions.  Its plain version
is ``core.masks.seqcdc_masks``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.masks import seqcdc_masks as seqcdc_masks_plain

from ._build import Kernel

KERNEL = Kernel(
    "seqcdc_masks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    replaces="src/repro/kernels/seqcdc_masks.py:49",
)


def seqcdc_masks(data: torch.Tensor, seq_length: int,
                 mode: str = "increasing"):
    """(candidate, opposing) bool bitmaps of ``data`` (``(S,)`` or
    ``(B, S)`` uint8), the tail masked as the reference masks it.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).
    """
    if data.device.type == "cpu":
        return seqcdc_masks_plain(data, seq_length, mode)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.ndim not in (1, 2):
        raise ValueError(
            f"expected (S,) or (B, S) uint8, got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    if mode not in ("increasing", "decreasing"):
        raise ValueError(mode)
    if seq_length < 2:
        raise ValueError(f"seq_length must be at least 2, got {seq_length}")
    x = data.contiguous()
    B, S = (1, x.shape[0]) if x.ndim == 1 else x.shape
    cand = torch.empty_like(x, dtype=torch.bool)
    opp = torch.empty_like(x, dtype=torch.bool)
    if x.numel() == 0:
        return cand, opp
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), cand.data_ptr(), opp.data_ptr(), B, S,
            int(seq_length), int(mode == "increasing"),
            stream=torch.cuda.current_stream(x.device).cuda_stream,
        )
    return cand, opp
