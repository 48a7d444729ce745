"""The distributed fingerprint index's host half: the partition rule.

The port of the host functions of ``repro/dedup/dist_index.py``.  Owners
partition the fingerprint space by hash (HYDRAstor-style):
``owner(fp) = fp.h1 mod num_shards``, so equal chunks always meet on the
same owner and owner-local dedup is globally exact.  The reference's
collective half (a capacity-padded ``all_to_all`` over a device mesh) is
not ported yet (ROADMAP.md, "Modules to port", distribution).
"""
from __future__ import annotations

import numpy as np


def owner_of(fp1, num_shards: int):
    """Shard owner of a fingerprint: ``fp.h1 mod num_shards``, on python
    ints and numpy arrays.  Every routing path uses this one rule."""
    return fp1 % num_shards


def route_host(fps: np.ndarray, num_shards: int) -> np.ndarray:
    """Per-record owner shard ids of a ``(C, 2)`` uint32 fingerprint table
    (only ``h1`` routes): ``(C,)`` int32 in ``[0, num_shards)``."""
    fps = np.asarray(fps)
    return owner_of(fps[:, 0].astype(np.int64), num_shards).astype(np.int32)


def suggested_capacity(rows_per_shard: int, num_shards: int,
                       capacity_factor: float = 1.5) -> int:
    """Per-destination bucket rows for a capacity-padded ``all_to_all``:
    the uniform expectation ``rows_per_shard / num_shards`` times
    ``capacity_factor`` headroom, plus an 8-row floor for tiny shards."""
    return int((rows_per_shard / num_shards) * capacity_factor) + 8
