"""CUDA kernel: per-block byte maxima (the VectorCDC range-scan substrate).

Replaces ``repro/kernels/extremum.py:block_max_pallas``, the public op
``repro/kernels/ops.py:block_max``.  As in the reference, no chunker calls
it: the AE/RAM chunkers (``core/baselines/hashless.py``) scan in numpy or
with the native-scan kernel.  The kernel (``csrc/block_max.cu``) is
memory-bound: ``n + ceil(n / block)`` bytes at 3.35 TB/s.  Its plain
version is :func:`block_max_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

KERNEL = Kernel(
    "block_max",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int],
    replaces="src/repro/kernels/extremum.py:32",
)

DEFAULT_BLOCK = 128


def block_max_plain(data: torch.Tensor,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-block maxima of an ``(n,)`` uint8 stream, the tail padded with
    0 (neutral): ``(ceil(n / block),)`` uint8."""
    n = data.shape[0]
    nb = -(-n // block)
    pad = torch.zeros(nb * block - n, dtype=torch.uint8, device=data.device)
    return torch.cat([data, pad]).view(nb, block).amax(dim=1)


def block_max(data: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-block byte maxima of an ``(n,)`` uint8 stream (the reference's
    ``ops.block_max``).  A CPU tensor takes :func:`block_max_plain`; a
    CUDA tensor launches the kernel (or raises)."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if data.device.type == "cpu":
        return block_max_plain(data, block)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.ndim != 1:
        raise ValueError(f"expected (n,) uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    x = data.contiguous()
    n = x.shape[0]
    out = torch.empty((-(-n // block),), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), out.data_ptr(), n, block,
                      stream=torch.cuda.current_stream(x.device).cuda_stream)
    return out
