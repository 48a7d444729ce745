"""SeqCDC parameters (paper Table I) and chunking-size policy.

The paper's Table I gives (SeqLength, SkipTrigger, SkipSize) per average chunk
size, with min/max chunk sizes of 0.5x/2x the average (min 1 KB at 4 KB avg,
SS VI "Alternatives").  SS VI-B additionally notes that at 4 KB the SkipTrigger is
raised by 10% to constrain skipping; Table I's 55 (vs 50) already reflects it.
"""
from __future__ import annotations

import dataclasses
import math

KiB = 1024

#: Paper Table I: avg_size -> (SeqLength, SkipTrigger, SkipSize)
_TABLE_I = {
    4 * KiB: (5, 55, 256),
    8 * KiB: (5, 50, 256),
    16 * KiB: (5, 50, 512),
}

INCREASING = "increasing"
DECREASING = "decreasing"


@dataclasses.dataclass(frozen=True)
class SeqCDCParams:
    """Normative parameter set for one SeqCDC configuration.

    Attributes mirror SSIII of the paper.  ``min_size``/``max_size`` follow the
    evaluation setup (0.5x / 2x the target average; 1 KB floor at 4 KB).
    """

    avg_size: int = 8 * KiB
    seq_length: int = 5
    skip_trigger: int = 50
    skip_size: int = 256
    min_size: int = 4 * KiB
    max_size: int = 16 * KiB
    mode: str = INCREASING

    def __post_init__(self):
        if self.seq_length < 2:
            raise ValueError("seq_length must be >= 2")
        if self.mode not in (INCREASING, DECREASING):
            raise ValueError(f"mode must be increasing|decreasing, got {self.mode}")
        if self.min_size < self.seq_length:
            raise ValueError("min_size must be >= seq_length")
        if self.max_size < self.min_size:
            raise ValueError("max_size must be >= min_size")
        if self.skip_size < 1 or self.skip_trigger < 1:
            raise ValueError("skip_size and skip_trigger must be positive")

    @property
    def sub_min_skip(self) -> int:
        """Bytes ignored at the start of each chunk (SSIII-B)."""
        return self.min_size - self.seq_length

    @property
    def block_width(self) -> int:
        """Largest power-of-two W with W <= min(skip_size, min_size - seq_length).

        The block automaton (core/automaton.py) relies on: any event inside a
        W-block advances the scan position by at least min(skip_size,
        sub_min_skip) >= W, i.e. beyond the block, so at most one event fires
        per block and the in-block scan is a closed-form vector expression.
        See DESIGN.md SS4.
        """
        lim = min(self.skip_size, self.min_size - self.seq_length)
        w = 1 << int(math.floor(math.log2(lim)))
        return min(w, 1024)


def paper_params(avg_size: int = 8 * KiB, mode: str = INCREASING) -> SeqCDCParams:
    """Parameters for one of the paper's three evaluated average sizes."""
    if avg_size not in _TABLE_I:
        raise KeyError(f"paper Table I has no entry for avg_size={avg_size}")
    L, T, K = _TABLE_I[avg_size]
    min_size = max(KiB, avg_size // 2)
    return SeqCDCParams(
        avg_size=avg_size,
        seq_length=L,
        skip_trigger=T,
        skip_size=K,
        min_size=min_size,
        max_size=2 * avg_size,
        mode=mode,
    )


def derived_params(avg_size: int, mode: str = INCREASING) -> SeqCDCParams:
    """Parameters for arbitrary average sizes (beyond Table I).

    Calibration (benchmarks/bench_calibrate.py) shows that with SeqLength L the
    boundary probability per byte on random data is ~1/L! for strictly monotone
    runs; L=5 gives ~1/120 per position *before* min-size suppression, and the
    effective average is then dominated by min_size + geometric tail.  We keep
    L=5 for 2-32 KB (paper's range), and scale SkipSize with avg_size as the
    paper does (256 B below 16 KB, 512 B at 16 KB, +256 B per doubling after,
    capped at 4 KB).
    """
    if avg_size in _TABLE_I:
        return paper_params(avg_size, mode)
    L = 5
    T = 50
    if avg_size < 8 * KiB:
        T = 55
    doublings = max(0, int(math.log2(max(avg_size, 16 * KiB) / (16 * KiB))))
    K = min(512 * (1 << doublings), 4 * KiB)
    if avg_size < 16 * KiB:
        K = 256
    return SeqCDCParams(
        avg_size=avg_size,
        seq_length=L,
        skip_trigger=T,
        skip_size=K,
        min_size=max(KiB, avg_size // 2),
        max_size=2 * avg_size,
        mode=mode,
    )
