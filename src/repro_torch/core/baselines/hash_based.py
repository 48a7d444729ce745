"""Hash-based CDC baselines: GEAR, CRC, RC (Rabin), FastCDC, TTTD.

The port of ``repro/core/baselines/hash_based.py``.  Each algorithm ships
in two substrates (paper SSVI "Alternatives"):

* ``<name>_seq`` — *native*: the reference's per-byte step, one byte at a
  time, carrying the rolling register (the native-scan kernel on the card,
  ``kernels/native_scan.py``; its plain Python loop on the CPU);
* ``<name>``     — *vectorized*: a position-independent hash bitmap
  computed in bulk (the Gear kernel, or the per-offset-table window sum),
  boundaries selected by the shared automaton (the select kernel) or on
  the host (fastcdc, tttd, and crc/rabin's default ``backend="numpy"``).

Both substrates share one hash definition (continuous over the stream, no
per-chunk reset), so they are bit-identical.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...kernels import gear_hash as kgear
from ...kernels import native_scan as kscan
from ..chunker import Chunker, _kept, register
from . import linear_hash as lh
from . import selectors


def _bits_for(avg_size: int) -> int:
    return int(round(math.log2(avg_size)))


def _as_i32(mask: int) -> int:
    """A uint32 mask as the int32 with the same bits."""
    return mask - (1 << 32) if mask >= 1 << 31 else mask


class _NativeScan:
    """The ``_seq`` forms' shared step: the native-scan kernel
    (``kernels/native_scan.py``) running ``ALGO`` over the chunker's stream
    with the arguments :meth:`scan_args` gives."""

    ALGO = ""

    def scan_args(self) -> dict:
        raise NotImplementedError

    def _boundaries(self, data) -> np.ndarray:
        bounds, counts = kscan.native_scan(
            self._on_device(data)[None], self.ALGO, min_size=self.min_size,
            max_size=self.max_size, **self.scan_args())
        return _kept(bounds[0], counts[0])


# ---------------------------------------------------------------------------
# GEAR
# ---------------------------------------------------------------------------


@register("gear")
class GearChunker(Chunker):
    """Gear chunking, vectorized (the Gear kernel + the select kernel)."""

    name = "gear"

    def __init__(self, avg_size=8192, mask_bits: int | None = None,
                 device="cuda", **_):
        super().__init__(avg_size, device)
        bits = mask_bits or _bits_for(avg_size)
        self.mask_bits = bits
        self.mask = np.uint32(((1 << bits) - 1) << (32 - bits))  # high bits

    def _boundaries(self, data):
        h = kgear.gear_hash(self._on_device(data))
        bitmap = (h.view(torch.int32) & _as_i32(int(self.mask))) == 0
        bounds, count = selectors.select_torch(
            bitmap, int(data.size), self.min_size, self.max_size)
        return _kept(bounds, count)


@register("gear_seq")
class GearSeqChunker(_NativeScan, GearChunker):
    """Gear chunking, native per-byte scan."""

    name = "gear_seq"
    ALGO = "gear"

    def scan_args(self):
        return dict(tables=kgear.gear_table(), mask=int(self.mask))


# ---------------------------------------------------------------------------
# CRC and Rabin (windowed linear hashes)
# ---------------------------------------------------------------------------


class _WindowedChunker(Chunker):
    WINDOW = 32

    def __init__(self, avg_size=8192, backend: str = "numpy",
                 mask_bits: int | None = None, device="cuda", **_):
        super().__init__(avg_size, device)
        if backend not in ("numpy", "torch"):
            raise ValueError(
                f"backend must be 'numpy' or 'torch', got {backend!r}")
        bits = mask_bits or _bits_for(avg_size)
        self.mask_bits = bits
        self.mask = np.uint32((1 << bits) - 1)  # low bits (paper SSII-A)
        self.backend = backend

    def _tables(self) -> np.ndarray:
        raise NotImplementedError

    def _boundaries(self, data):
        if self.backend == "numpy":
            h = lh.windowed_hash_np(data, self._tables())
            pos = np.flatnonzero((h & self.mask) == 0)
            return selectors.select_numpy(
                pos, int(data.size), self.min_size, self.max_size
            )
        h = lh.windowed_hash_torch(self._on_device(data), self._tables())
        bitmap = (h.view(torch.int32) & _as_i32(int(self.mask))) == 0
        bounds, count = selectors.select_torch(
            bitmap, int(data.size), self.min_size, self.max_size
        )
        return _kept(bounds, count)


@register("crc")
class CRCChunker(_WindowedChunker):
    name = "crc"
    WINDOW = lh.CRC_WINDOW

    def _tables(self):
        return lh.crc_tables(self.WINDOW)


@register("rabin")
class RabinChunker(_WindowedChunker):
    name = "rabin"
    WINDOW = lh.RABIN_WINDOW

    def _tables(self):
        return lh.rabin_tables(self.WINDOW)


@register("crc_seq")
class CRCSeqChunker(_NativeScan, CRCChunker):
    """CRC chunking, native rolling scan (byte-step + windowed removal)."""

    name = "crc_seq"
    ALGO = "crc"

    def scan_args(self):
        base = lh.crc_byte_table()
        # removal table: the byte at offset WINDOW after the x^8 step ==
        # tables[-1] zero-extended one more byte
        last = self._tables()[-1]
        t_out = ((last << 8) & 0xFFFFFFFF) ^ base[(last >> 24) & 0xFF]
        return dict(window=self.WINDOW,
                    tables=np.stack([base, self._tables()[0], t_out]),
                    mask=int(self.mask))


@register("rabin_seq")
class RabinSeqChunker(_NativeScan, RabinChunker):
    """Rabin chunking, native rolling scan (x^8 multiply + removal)."""

    name = "rabin_seq"
    ALGO = "rabin"

    def scan_args(self):
        last = self._tables()[-1]
        # removal: (v * x^(8*WINDOW)) mod P = the x^8 step of tables[-1]
        t_out = np.zeros(256, dtype=np.uint32)
        for v in range(256):
            t_out[v] = lh._gf2_mod(int(last[v]) << 8, lh.RABIN_POLY, 31)
        return dict(
            window=self.WINDOW,
            tables=np.stack([lh.rabin_red8(), self._tables()[0], t_out]),
            mask=int(self.mask))


# ---------------------------------------------------------------------------
# FastCDC (gear + sub-minimum skipping + 2-level normalization)
# ---------------------------------------------------------------------------


@register("fastcdc")
class FastCDCChunker(Chunker):
    """FastCDC NC=2, vectorized: the Gear kernel x 2 masks + the host's
    two-region select."""

    name = "fastcdc"

    def __init__(self, avg_size=8192, mask_bits: int | None = None,
                 device="cuda", **_):
        super().__init__(avg_size, device)
        bits = mask_bits or _bits_for(avg_size)
        self.mask_bits = bits
        self.mask_s = np.uint32(lh.spread_mask(bits + 2, seed=7))
        self.mask_l = np.uint32(lh.spread_mask(max(bits - 2, 1), seed=11))

    def _boundaries(self, data):
        h = kgear.gear_hash(self._on_device(data)).cpu().numpy()
        small = np.flatnonzero((h & self.mask_s) == 0)
        large = np.flatnonzero((h & self.mask_l) == 0)
        return selectors.select_two_region_numpy(
            small, large, int(data.size), self.min_size, self.avg_size,
            self.max_size)


@register("fastcdc_seq")
class FastCDCSeqChunker(_NativeScan, FastCDCChunker):
    """FastCDC, native per-byte scan (hash continuous)."""

    name = "fastcdc_seq"
    ALGO = "fastcdc"

    def scan_args(self):
        return dict(tables=kgear.gear_table(), mask=int(self.mask_s),
                    mask_l=int(self.mask_l), avg_size=self.avg_size)


# ---------------------------------------------------------------------------
# TTTD (Rabin + backup divisor)
# ---------------------------------------------------------------------------


@register("tttd")
class TTTDChunker(_WindowedChunker):
    """TTTD, vectorized on the host (primary + backup rabin divisors,
    backtracking select).

    The backup-divisor backtrack re-scans bytes after a max-size cut, so
    TTTD has no one-pass native scan; the reference ships the two-phase
    form only, and so does the port.
    """

    name = "tttd"
    WINDOW = lh.RABIN_WINDOW

    def __init__(self, avg_size=8192, mask_bits: int | None = None, **kw):
        super().__init__(avg_size, mask_bits=mask_bits, **kw)
        bits = mask_bits or _bits_for(avg_size)
        self.mask_bits = bits
        self.mask = np.uint32((1 << bits) - 1)
        self.mask_backup = np.uint32((1 << max(bits - 1, 1)) - 1)

    def _tables(self):
        return lh.rabin_tables(self.WINDOW)

    def _boundaries(self, data):
        h = lh.windowed_hash_np(data, self._tables())
        primary = np.flatnonzero((h & self.mask) == 0)
        backup = np.flatnonzero((h & self.mask_backup) == 0)
        return selectors.select_tttd_numpy(
            primary, backup, int(data.size), self.min_size, self.max_size
        )
