"""Boundary selection from candidate bitmaps (shared by hash-based baselines).

Hash-based CDC (Rabin/CRC/Gear) reduces, after the two-phase split, to:
given a *position-independent* boundary bitmap (``h & mask == 0``), select
boundaries sequentially subject to min/max chunk sizes.  That is exactly the
SeqCDC block automaton with no skip trigger and run length 1, so the port
reuses it (``core.seqcdc.select``: the select kernel of the step) via a
light parameter shim.

A copy of ``repro/core/baselines/selectors.py`` with ``select_torch`` in
place of the reference's ``select_jax``.

Conventions: a set bit at position k means "chunk may end at k+1" (the hash
window ends at byte k).  min/max semantics: first admissible end is
``s + min_size``; if no match fires before ``s + max_size``, cut there.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SelectorParams:
    """Duck-typed stand-in for SeqCDCParams accepted by core.automaton."""

    min_size: int
    max_size: int
    seq_length: int = 1  # boundary = bit position + 1
    skip_trigger: int = 1 << 30  # never triggers
    skip_size: int = 1 << 20

    @property
    def sub_min_skip(self) -> int:
        return self.min_size - self.seq_length

    @property
    def block_width(self) -> int:
        import math

        lim = min(self.skip_size, self.min_size - self.seq_length)
        return min(1 << int(math.floor(math.log2(lim))), 1024)


def select_torch(bitmap, n: int, min_size: int, max_size: int,
                 step_impl="wide"):
    """(bounds, count) from an ``(n,)`` bool bitmap tensor (bit k =>
    boundary k+1): the select kernel of ``step_impl`` (``wide``, ``gather``
    or ``event``; its plain version for a CPU tensor)."""
    import torch

    from .. import seqcdc

    p = SelectorParams(min_size=min_size, max_size=max_size)
    opp = torch.zeros_like(bitmap)
    bounds, count = seqcdc.select(
        bitmap[None], opp[None], n, p,
        select_impl=seqcdc.select_impl_for(step_impl),
        step_impl=step_impl)
    return bounds[0], count[0]


def select_numpy(match_pos: np.ndarray, n: int, min_size: int, max_size: int):
    """Event-driven selection from sorted match positions (bit k => end k+1)."""
    bounds = []
    s = 0
    while s < n:
        cut = min(s + max_size, n)
        lo = np.searchsorted(match_pos, s + min_size - 1)  # k >= s+min-1
        k = int(match_pos[lo]) if lo < match_pos.size else n + max_size
        if k + 1 <= cut and k + 1 >= s + min_size:
            bounds.append(k + 1)
            s = k + 1
        else:
            bounds.append(cut)
            s = cut
    return np.asarray(bounds, dtype=np.int64)


def select_two_region_numpy(
    small_pos: np.ndarray,
    large_pos: np.ndarray,
    n: int,
    min_size: int,
    avg_size: int,
    max_size: int,
):
    """FastCDC-style normalized selection (NC levels): small mask (harder)
    in [s+min, s+avg), large mask (easier) in [s+avg, s+max)."""
    bounds = []
    s = 0
    while s < n:
        cut = min(s + max_size, n)
        # region 1: end in [s+min, s+avg)  <=> k in [s+min-1, s+avg-1)
        lo = np.searchsorted(small_pos, s + min_size - 1)
        k1 = int(small_pos[lo]) if lo < small_pos.size else n + max_size
        if k1 + 1 < s + avg_size and k1 + 1 <= cut:
            bounds.append(k1 + 1)
            s = k1 + 1
            continue
        # region 2: end in [s+avg, s+max)
        lo = np.searchsorted(large_pos, s + avg_size - 1)
        k2 = int(large_pos[lo]) if lo < large_pos.size else n + max_size
        if k2 + 1 <= cut:
            bounds.append(k2 + 1)
            s = k2 + 1
            continue
        bounds.append(cut)
        s = cut
    return np.asarray(bounds, dtype=np.int64)


def select_tttd_numpy(
    primary_pos: np.ndarray,
    backup_pos: np.ndarray,
    n: int,
    min_size: int,
    max_size: int,
):
    """TTTD: primary divisor boundary if found in [min, max); else the *last*
    backup-divisor match in the range; else cut at max."""
    bounds = []
    s = 0
    while s < n:
        cut = min(s + max_size, n)
        lo = np.searchsorted(primary_pos, s + min_size - 1)
        k = int(primary_pos[lo]) if lo < primary_pos.size else n + max_size
        if k + 1 <= cut:
            bounds.append(k + 1)
            s = k + 1
            continue
        # last backup match with end in [s+min, cut]
        lo = np.searchsorted(backup_pos, s + min_size - 1)
        hi = np.searchsorted(backup_pos, cut - 1, side="right")
        if hi > lo:
            kb = int(backup_pos[hi - 1])
            bounds.append(kb + 1)
            s = kb + 1
            continue
        bounds.append(cut)
        s = cut
    return np.asarray(bounds, dtype=np.int64)
