"""Packed-row bitmap cases for the packed select kernel's CPU and card
tests (numpy only).

Each case is a ``(B, G)`` int32 segment-end table in the schedulers'
layout (nondecreasing, pad entries carrying the payload end) and two
seeded random ``(B, S)`` bool bitmaps clipped per segment as
``core.seqcdc.packed_masks`` clips them: candidates at ``pos <= end - L``
and opposing pairs at ``pos < end - 1`` of their own segment, padding
positions clipped against the payload end.  The edges: empty streams
(duplicate ends), segments shorter than L-1, zero padding past the payload
end, one segment filling the row (G = 1), an undersized ``max_chunks``.
"""
import numpy as np

#: the packing tests' small parameters (tests/_packing_cases.py)
SMALL = dict(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
             min_size=64, max_size=512)
#: paper_params(8192)
PAPER8K = dict(avg_size=8192, seq_length=5, skip_trigger=50, skip_size=256,
               min_size=4096, max_size=16384)
#: (candidate, opposing) densities: an emit from a candidate or a skip
#: trigger every few min_size
DENSITY = {"small": (0.02, 0.3), "paper8k": (0.0015, 0.3)}

#: the edge cases at small parameters, 4 KiB rows
EDGES = ("duplicate-ends", "shorter-than-L", "padding", "random", "G1")


def ends_table(rows, G=None) -> np.ndarray:
    """Rows of segment lengths -> the ``(B, G)`` int32 ends table."""
    G = G or max(4, max(len(r) for r in rows))
    ends = np.zeros((len(rows), G), np.int32)
    for bi, row in enumerate(rows):
        e = np.cumsum(row, dtype=np.int64)
        ends[bi, :len(row)] = e
        ends[bi, len(row):] = e[-1] if len(row) else 0
    return ends


def clipped_bitmaps(rng, ends: np.ndarray, S: int, L: int, density):
    """Seeded random ``(B, S)`` bitmaps, clipped per segment of ``ends``."""
    B = ends.shape[0]
    cand = rng.random((B, S)) < density[0]
    opp = rng.random((B, S)) < density[1]
    pos = np.arange(S)
    sep = np.empty((B, S), np.int64)
    for bi in range(B):
        e = ends[bi].astype(np.int64)
        idx = np.searchsorted(e, pos, side="right")
        sep[bi] = np.where(idx < e.size, e[np.minimum(idx, e.size - 1)],
                           e[-1])
    return cand & (pos <= sep - L), opp & (pos < sep - 1)


def edge_rows(name: str, rng, S: int, L: int):
    """Segment lengths of one edge case's rows (each row at most S)."""
    if name == "duplicate-ends":
        return [[0, 0, 300, 0, 700, 0, 0, 1500, 1500, 0],
                [int(n) if rng.random() < 0.6 else 0
                 for n in rng.integers(1, 340, 12)]]
    if name == "shorter-than-L":
        return [[int(n) for n in rng.integers(1, L, 60)] + [1000, 1, 1, 900],
                [1] * 200 + [2] * 100 + [L - 1, L, L + 1] * 20]
    if name == "padding":
        return [[700, 600, 700], [1500, 20, 3]]
    if name == "random":
        out = []
        for _ in range(3):
            row, fill = [], 0
            while True:
                n = int(rng.integers(0, 900))
                if fill + n > S:
                    break
                row.append(n)
                fill += n
            out.append(row)
        return out
    if name == "G1":
        return [[S], [S]]
    raise KeyError(name)


def edge_case(name: str, S: int = 4096):
    """One edge case at small parameters: ``(ends, cand, opp)``; G1's
    table is one column wide."""
    rng = np.random.default_rng(sum(map(ord, name)) + S)
    L = SMALL["seq_length"]
    rows = edge_rows(name, rng, S, L)
    ends = ends_table(rows, 1 if name == "G1" else None)
    cand, opp = clipped_bitmaps(rng, ends, S, L, DENSITY["small"])
    return ends, cand, opp


def true_max_chunks(S: int, min_size: int, G: int) -> int:
    """The schedulers' packed table width, a true bound."""
    return S // min_size + 2 * G + 2
