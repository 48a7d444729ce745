"""Hashless CDC baselines: AE (Asymmetric Extremum) and RAM.

The port of ``repro/core/baselines/hashless.py``.  Native variants are
one-pass per-byte automatons (the native-scan kernel on the card,
``kernels/native_scan.py``, its plain Python loop on the CPU); vectorized
variants use the VectorCDC decomposition on the host in numpy, as the
reference does: strict prefix maxima give the extreme-point sequence
directly, so

  * AE boundary  = first strict prefix-maximum p whose *next* strict maximum
    is more than ``w`` bytes away (no byte in (p, p+w] exceeds it);
  * RAM boundary = first byte >= max(first-w-byte window) past the window,

both of which are bulk array operations.  (The per-block maxima kernel,
``kernels/extremum.py``, is the public op the reference has; like the
reference's chunkers, these do not call it.)

min-size handling (the paper applies min/max to all algorithms, SSVI): a
boundary whose end would fall before ``s + min_size`` is *deferred* — it fires
at ``s + min_size`` unless a new extreme (AE) supersedes it first.  Both
substrates implement this identically (tested bit-equal).
"""
from __future__ import annotations

import math

import numpy as np

from ..chunker import Chunker, register
from .hash_based import _NativeScan

_E_FACTOR = math.e / (math.e - 1.0)  # AE: E[chunk] ~ w * e/(e-1) on random data


def _ae_window(avg_size: int) -> int:
    return max(64, int(round(avg_size / _E_FACTOR)))


def _ram_window(avg_size: int) -> int:
    # RAM: E[chunk] ~ w + E[geom] ~ w + 256 for large windows on random data
    return max(64, avg_size - 256)


class _HashlessBase(Chunker):
    def __init__(self, avg_size=8192, window: int | None = None,
                 device="cuda", **_):
        super().__init__(avg_size, device)
        self.window = window or self._default_window(avg_size)

    @staticmethod
    def _default_window(avg_size: int) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# AE
# ---------------------------------------------------------------------------


@register("ae")
class AEChunker(_HashlessBase):
    """AE, vectorized via strict prefix maxima (VectorCDC extreme-search)."""

    name = "ae"
    _default_window = staticmethod(_ae_window)

    def _boundaries(self, data):
        n = int(data.size)
        w = self.window
        bounds = []
        s = 0
        while s < n:
            cut = min(s + self.max_size, n)
            seg = data[s:cut].astype(np.int32)
            pm = np.maximum.accumulate(seg)
            prev = np.concatenate([[-1], pm[:-1]])
            ext = np.flatnonzero(seg > prev)  # strict prefix maxima positions
            nxt = np.concatenate([ext[1:], [1 << 30]])
            t = np.maximum(ext + w, self.min_size - 1)  # deferred fire time
            ok = (nxt > t) & (t + 1 <= cut - s)
            hit = np.flatnonzero(ok)
            if hit.size:
                bounds.append(s + int(t[hit[0]]) + 1)
            else:
                bounds.append(cut)
            s = bounds[-1]
        return np.asarray(bounds, dtype=np.int64)


@register("ae_seq")
class AESeqChunker(_NativeScan, AEChunker):
    """AE, native one-pass per-byte scan."""

    name = "ae_seq"
    ALGO = "ae"

    def scan_args(self):
        return dict(window=self.window)


# ---------------------------------------------------------------------------
# RAM
# ---------------------------------------------------------------------------


@register("ram")
class RAMChunker(_HashlessBase):
    """RAM, vectorized: window max + first-exceed search (VectorCDC range scan)."""

    name = "ram"
    _default_window = staticmethod(_ram_window)

    def _boundaries(self, data):
        n = int(data.size)
        w = self.window
        bounds = []
        s = 0
        while s < n:
            cut = min(s + self.max_size, n)
            wend = min(s + w, cut)
            m = int(data[s:wend].max()) if wend > s else 0
            start = s + max(w, self.min_size - 1)
            if start < cut:
                seg = data[start:cut]
                hits = np.flatnonzero(seg >= m)
                if hits.size:
                    bounds.append(start + int(hits[0]) + 1)
                    s = bounds[-1]
                    continue
            bounds.append(cut)
            s = cut
        return np.asarray(bounds, dtype=np.int64)


@register("ram_seq")
class RAMSeqChunker(_NativeScan, RAMChunker):
    """RAM, native one-pass per-byte scan."""

    name = "ram_seq"
    ALGO = "ram"

    def scan_args(self):
        return dict(window=self.window)
