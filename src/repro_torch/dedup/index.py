"""Fingerprint comparison and space-savings accounting (paper SSII, Eq. 1).

The port of ``repro/dedup/index.py``:

* :func:`dedup_stats` — in torch: sort the fingerprint keys, mark first
  occurrences, reduce (space savings = 1 - deduplicated/original, Eq. 1);
* :class:`FingerprintIndex` — the host-side incremental index (a dict)
  the streaming ingest path feeds, unchanged from the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def dedup_stats(fp: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Global dedup over a batch of chunk tables.

    fp: (..., C, 2) uint32; lengths: (..., C) int32 (0 = padding).
    Returns dict with original_bytes, dedup_bytes, unique_chunks,
    total_chunks (0-d int64 tensors).
    """
    f = fp.reshape(-1, 2).to(torch.int64)
    ln = lengths.reshape(-1).to(torch.int64)
    valid = ln > 0
    # one int64 key per (h1, h2) pair: equal keys <=> equal fingerprints
    key = ((f[:, 0] << 32) | f[:, 1])[valid]
    ln = ln[valid]
    key_s, order = torch.sort(key, stable=True)
    lens_s = ln[order]
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return {
        "original_bytes": lens_s.sum(),
        "dedup_bytes": torch.where(first, lens_s, 0).sum(),
        "unique_chunks": first.sum(),
        "total_chunks": valid.sum(),
    }


def space_savings(stats) -> float:
    o = float(stats["original_bytes"])
    d = float(stats["dedup_bytes"])
    return (o - d) / o if o else 0.0


@dataclasses.dataclass
class FingerprintIndex:
    """Host-side incremental fingerprint database (paper SSII step 3)."""

    seen: dict = dataclasses.field(default_factory=dict)
    original_bytes: int = 0
    dedup_bytes: int = 0

    def add(self, fp: tuple, length: int) -> bool:
        """Returns True if the chunk is new (must be stored)."""
        self.original_bytes += int(length)
        if fp in self.seen:
            return False
        self.seen[fp] = int(length)
        self.dedup_bytes += int(length)
        return True

    def add_batch(self, fps: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Vectorized-ish batch add; returns bool array (new per chunk)."""
        out = np.zeros(len(lengths), dtype=bool)
        for i, (f, l) in enumerate(zip(map(tuple, np.asarray(fps)), lengths)):
            if l > 0:
                out[i] = self.add(f, int(l))
        return out

    @property
    def savings(self) -> float:
        if not self.original_bytes:
            return 0.0
        return (self.original_bytes - self.dedup_bytes) / self.original_bytes
