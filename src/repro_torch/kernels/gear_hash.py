"""CUDA kernel: the per-position Gear rolling hash (SS-CDC substrate).

Replaces ``repro/kernels/gear_hash.py:gear_hash_pallas``.  The Gear
recurrence ``h[i] = (h[i-1] << 1) + G[b[i]]`` (uint32) forgets terms older
than 32 bytes, so ``h[i] = sum_{j<32} G[b[i-j]] << j`` (mod 2^32) and every
position is independent.  The kernel (``csrc/gear_hash.cu``) is
memory-bound: ``5n`` bytes (n in, 4n out) at 3.35 TB/s.

Both of the reference's plain forms are here: :func:`gear_hash_sequential`
(``repro/kernels/ref.py:gear_hash``, the recurrence) and
:func:`gear_hash_parallel` (``ref.gear_hash_parallel``, the window form),
the kernel's plain version.  Torch's CPU build has no uint32 shift or add,
so both compute in int64 and cast to uint32 at the output.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import Kernel

KERNEL = Kernel(
    "gear_hash",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong],
    replaces="src/repro/kernels/gear_hash.py:47",
)

_WIN = 32
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _gear_table_np(seed: int) -> np.ndarray:
    mask = (1 << 64) - 1  # python ints: exact wraparound
    x = seed
    out = []
    for _ in range(256):
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        z = z ^ (z >> 31)
        out.append(z & 0xFFFFFFFF)
    return np.asarray(out, dtype=np.uint32)


def gear_table(seed: int = 0x9E3779B1) -> np.ndarray:
    """The deterministic 256-entry Gear table (splitmix-style, uint32),
    the reference's ``ref.gear_table``."""
    return _gear_table_np(seed)


@functools.lru_cache(maxsize=16)
def _device_table(device: str, words: bytes) -> torch.Tensor:
    """A 256-entry Gear table (its uint32 words as bytes) on ``device`` as
    int32, the kernel's form: one cached tensor a (device, table), so a
    call copies no table to the card; read-only."""
    t = np.frombuffer(words, dtype=np.int32).copy()
    return torch.from_numpy(t).to(device)


def _gear_values(data: torch.Tensor, table: np.ndarray | None):
    t = gear_table() if table is None else np.asarray(table, np.uint32)
    t = torch.from_numpy(t.astype(np.int64)).to(data.device)
    return t[data.to(torch.int64)]


def gear_hash_sequential(data: torch.Tensor,
                         table: np.ndarray | None = None) -> torch.Tensor:
    """The sequential Gear recurrence over an ``(n,)`` uint8 stream, one
    step per byte: the reference's oracle ``ref.gear_hash``."""
    g = _gear_values(data, table).tolist()
    h, out = 0, []
    for gi in g:
        h = ((h << 1) + gi) & _M32
        out.append(h)
    return torch.tensor(out, dtype=torch.int64,
                        device=data.device).to(torch.uint32)


def gear_hash_parallel(data: torch.Tensor,
                       table: np.ndarray | None = None) -> torch.Tensor:
    """The window form, ``h[i] = sum_{j <= min(i, 31)} G[b[i-j]] << j``
    (mod 2^32): the kernel's plain version."""
    g = _gear_values(data, table)
    n = g.shape[-1]
    acc = torch.zeros_like(g)
    for j in range(min(_WIN, n)):  # each term masked: the sum stays < 2^37
        acc[j:] += (g[: n - j] << j) & _M32
    return (acc & _M32).to(torch.uint32)


def gear_hash(data: torch.Tensor,
              table: np.ndarray | None = None) -> torch.Tensor:
    """Per-position uint32 Gear hash of an ``(n,)`` uint8 stream.

    A CPU tensor takes :func:`gear_hash_parallel`; a CUDA tensor launches
    the kernel (or raises).
    """
    if data.device.type == "cpu":
        return gear_hash_parallel(data, table)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.ndim != 1:
        raise ValueError(f"expected (n,) uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    x = data.contiguous()
    t = gear_table() if table is None else np.asarray(table, np.uint32)
    t = _device_table(str(x.device), t.tobytes())
    out = torch.empty(x.shape, dtype=torch.uint32, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), t.data_ptr(), out.data_ptr(), x.shape[0],
                      stream=torch.cuda.current_stream(x.device).cuda_stream)
    return out
