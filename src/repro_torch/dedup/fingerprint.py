"""Chunk fingerprinting in torch (paper SSII "Chunk Hashing").

The port of ``repro/dedup/fingerprint.py``.  A chunk's 62-bit fingerprint
is two independent polynomial hashes mod p = 2^31 - 1:

    h_r(chunk) = sum_i  b_i * r^(len-1-i)   mod p,   r in (R1, R2)

The plain version here does the mod-p arithmetic in int64 (a byte times a
power is < 2^39, a chunk's sum of at most 2^16 such terms fits with room
to spare) and casts to uint32 only at the output, where the reference
returns uint32: torch's CPU build has no uint32 shift, add, compare or
``min``.  ``fp_impl="cuda"`` routes to the CUDA kernel
(``kernels/fingerprint.py``); both are bit-identical to the reference's
``fp_impl="reference"`` and ``"pallas"``.

Constraint: chunk length <= 65536 bytes (the power table); longer chunks
reuse the top power exactly as the reference's clipped table index does.
"""
from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch

#: backend for :func:`chunk_fingerprints`: the plain torch chain ("torch")
#: or the CUDA kernel ("cuda"), guarded by the scheduler's first-dispatch
#: cross-check
FpImpl = Literal["torch", "cuda"]
FP_IMPLS = ("torch", "cuda")

P31 = np.uint32((1 << 31) - 1)
MAX_CHUNK = 1 << 16
#: two independent generators (fixed, arbitrary < p)
R1 = 1_103_515_245
R2 = 747_796_405


@functools.lru_cache(maxsize=None)
def _pow_table_np(r: int, size: int = MAX_CHUNK) -> np.ndarray:
    p = (1 << 31) - 1
    out = np.empty(size, dtype=np.uint32)
    acc = 1
    for e in range(size):
        out[e] = acc
        acc = (acc * r) % p
    return out


@functools.lru_cache(maxsize=None)
def pow_tables(device: str, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``(2, MAX_CHUNK)`` ``r^e mod p`` for (R1, R2) on ``device``.  Every
    entry is below 2^31, so int32 holds it exactly (the CUDA kernels' form).

    One cached tensor a (device, dtype): the kernel wrappers call this on
    every launch and copy nothing after the first.  Callers treat it as
    read-only."""
    t = np.stack([_pow_table_np(R1), _pow_table_np(R2)]).astype(np.int64)
    return torch.from_numpy(t).to(device=device, dtype=dtype).contiguous()


def _as_batch(data, bounds, count):
    if data.ndim == 1:
        c = torch.as_tensor(count, device=data.device).to(torch.int32)
        return data[None], bounds[None], c.reshape(1), True
    return data, bounds, count, False


def chunk_fingerprints_torch(data: torch.Tensor, bounds: torch.Tensor,
                             count: torch.Tensor, *, max_chunks: int):
    """Plain torch fingerprints of ``(B, n)`` data, ``(B, mc)`` bounds.

    The reference's gather chain: chunk id per byte by ``searchsorted``
    over the bounds (clamped into the table), its offset from the chunk end
    (clipped into the power table), ``b * r^offset`` per byte, a segment
    sum per chunk, mod p.  Returns ``(fps (B, mc, 2) uint32,
    lengths (B, mc) int32)``; slots past ``count`` are zero.
    """
    B, n = data.shape
    mc = max_chunks
    dev = data.device
    b64 = bounds.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(B, n)
    seg = torch.searchsorted(b64, idx.contiguous(), right=True)
    seg = torch.clamp(seg, max=mc - 1)
    end = b64.gather(1, seg)
    e = torch.clamp(end - 1 - idx, 0, MAX_CHUNK - 1)
    d = data.to(torch.int64)
    pw = pow_tables(str(dev))
    p = int(P31)
    cols = []
    for g in range(2):
        contrib = d * pw[g][e] % p
        sums = torch.zeros((B, mc), dtype=torch.int64, device=dev)
        sums.scatter_add_(1, seg, contrib)
        cols.append(sums % p)
    fp = torch.stack(cols, dim=-1)
    starts = torch.cat([torch.zeros_like(bounds[:, :1]), bounds[:, :-1]], 1)
    lengths = (bounds - starts).to(torch.int32)
    valid = torch.arange(mc, device=dev)[None, :] < count.to(dev)[:, None]
    fp = torch.where(valid[..., None], fp, 0).to(torch.uint32)
    lengths = torch.where(valid, lengths, 0)
    return fp, lengths


def chunk_fingerprints(
    data: torch.Tensor,
    bounds: torch.Tensor,
    count,
    *,
    max_chunks: int,
    fp_impl: FpImpl = "torch",
):
    """Per-chunk ``(fp (..., max_chunks, 2) uint32, lengths (..., max_chunks)
    int32)`` for one ``(n,)`` stream or a ``(B, n)`` batch.

    ``bounds`` are exclusive chunk ends, sorted, sentinel-padded past
    ``count`` (the layout of ``core.seqcdc``).  Entries past ``count`` have
    fp = 0 and length = 0.
    """
    if fp_impl not in FP_IMPLS:
        raise ValueError(f"unknown fp_impl {fp_impl!r}")
    d, b, c, single = _as_batch(data, bounds, count)
    if fp_impl == "cuda":
        from repro_torch.kernels import fingerprint as kfp

        fp, lens = kfp.chunk_fingerprints(d, b, c, max_chunks=max_chunks)
    else:
        fp, lens = chunk_fingerprints_torch(d, b, c, max_chunks=max_chunks)
    return (fp[0], lens[0]) if single else (fp, lens)


def fingerprints_numpy(data: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Host-side reference (tests): exact same 62-bit fingerprint."""
    p = (1 << 31) - 1
    out = np.zeros((len(bounds), 2), dtype=np.uint32)
    s = 0
    t1 = _pow_table_np(R1)
    t2 = _pow_table_np(R2)
    for j, e in enumerate(np.asarray(bounds, dtype=np.int64)):
        chunk = np.asarray(data[s:e], dtype=np.uint64)
        exp = np.arange(e - s - 1, -1, -1, dtype=np.int64)
        out[j, 0] = np.uint32((chunk * t1[exp].astype(np.uint64)).sum() % p)
        out[j, 1] = np.uint32((chunk * t2[exp].astype(np.uint64)).sum() % p)
        s = e
    return out
