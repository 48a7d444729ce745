"""Normative SeqCDC oracles (host-side, numpy).

Two exact-equivalent implementations of the semantics in DESIGN.md SS4:

* :func:`boundaries_slow` — a direct byte-at-a-time transcription of the
  sequential algorithm (SSIII of the paper).  This is the ground truth every
  other implementation (numpy event-driven, lax.scan block automaton,
  lax.while_loop, Pallas-backed two-phase) is property-tested against.
* :func:`boundaries_numpy` — an event-driven vectorized version used for
  host-side ingest at corpus scale: precomputes the candidate/opposing bitmaps
  once, then jumps from event to event with prefix sums instead of scanning
  byte by byte.  O(#chunks + #skips) python iterations instead of O(bytes).

Boundary convention: *exclusive* end offsets; chunk i is
``data[bounds[i-1]:bounds[i]]`` with ``bounds[-1] == len(data)``.
"""
from __future__ import annotations

import numpy as np

from .params import DECREASING, INCREASING, SeqCDCParams


def _as_u8(data) -> np.ndarray:
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr.reshape(-1)


def pair_flags(data: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(forward, opposing) pair bitmaps, each of length ``len(data)`` .

    ``forward[k]`` is True iff pair (b[k], b[k+1]) is ordered in the target
    direction, ``opposing[k]`` iff ordered against it.  Index ``n-1`` is
    padded False (no pair starts there).
    """
    d = _as_u8(data)
    n = d.shape[0]
    fwd = np.zeros(n, dtype=bool)
    opp = np.zeros(n, dtype=bool)
    if n >= 2:
        gt = d[1:] > d[:-1]
        lt = d[1:] < d[:-1]
        if mode == INCREASING:
            fwd[: n - 1], opp[: n - 1] = gt, lt
        elif mode == DECREASING:
            fwd[: n - 1], opp[: n - 1] = lt, gt
        else:
            raise ValueError(mode)
    return fwd, opp


def candidate_flags(data: np.ndarray, seq_length: int, mode: str) -> np.ndarray:
    """cand[k] = 1 iff bytes k..k+L-1 are strictly monotone (run *starts* at k)."""
    d = _as_u8(data)
    n = d.shape[0]
    fwd, _ = pair_flags(d, mode)
    cand = np.zeros(n, dtype=bool)
    if n >= seq_length:
        m = n - seq_length + 1
        acc = fwd[:m].copy()
        for j in range(1, seq_length - 1):
            acc &= fwd[j : j + m]
        cand[:m] = acc
    return cand


def boundaries_slow(data, p: SeqCDCParams) -> list[int]:
    """Byte-at-a-time normative oracle.  Small inputs only (tests)."""
    d = _as_u8(data)
    n = d.shape[0]
    if n == 0:
        return []
    L = p.seq_length
    inc_mode = p.mode == INCREASING
    bounds: list[int] = []
    s = 0
    while s < n:
        k = s + p.sub_min_skip
        c = 0
        boundary = None
        while boundary is None:
            if k + L > s + p.max_size:  # max-size cut (checked first)
                boundary = min(s + p.max_size, n)
                break
            if k + L > n:  # file end
                boundary = n
                break
            win = d[k : k + L]
            if inc_mode:
                is_cand = bool(np.all(win[1:] > win[:-1]))
                is_opp = d[k + 1] < d[k]
            else:
                is_cand = bool(np.all(win[1:] < win[:-1]))
                is_opp = d[k + 1] > d[k]
            if is_cand:
                boundary = k + L
                break
            if is_opp:
                c += 1
                if c > p.skip_trigger:
                    k += p.skip_size
                    c = 0
                    continue
            k += 1
        bounds.append(boundary)
        s = boundary
    return bounds


def boundaries_numpy(data, p: SeqCDCParams) -> np.ndarray:
    """Event-driven exact oracle: O(#events) python steps.

    Precomputes the candidate bitmap, the opposing-pair prefix sum, and a
    "position of the m-th opposing pair" table, then resolves each chunk by
    jumping between (candidate | trigger | cut) events with searchsorted-free
    gathers.  Bit-identical to :func:`boundaries_slow` (tested).
    """
    d = _as_u8(data)
    n = d.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    L = p.seq_length
    cand = candidate_flags(d, L, p.mode)
    _, opp = pair_flags(d, p.mode)

    cand_pos = np.flatnonzero(cand)  # sorted candidate start positions
    opp_pos = np.flatnonzero(opp)  # sorted opposing-pair positions
    # opp_pref[k] = number of opposing pairs at positions < k
    # (= np.searchsorted(opp_pos, k), done incrementally below)

    bounds: list[int] = []
    s = 0
    T = p.skip_trigger
    while s < n:
        k = s + p.sub_min_skip
        c = 0
        while True:
            cut_k = min(s + p.max_size, n) - L + 1  # first scan pos that cuts
            cut_b = min(s + p.max_size, n)
            if k >= cut_k:
                bounds.append(cut_b)
                s = cut_b
                break
            # next candidate at position >= k
            ci = np.searchsorted(cand_pos, k)
            kc = int(cand_pos[ci]) if ci < cand_pos.size else n + p.max_size
            # position of the (T - c + 1)-th opposing pair at position >= k
            oi = np.searchsorted(opp_pos, k)
            ti = oi + (T - c)  # 0-indexed position of the pair that *exceeds* T
            kt = int(opp_pos[ti]) if ti < opp_pos.size else n + p.max_size
            event = min(kc, kt, cut_k)
            if event == cut_k and cut_k <= min(kc, kt):
                bounds.append(cut_b)
                s = cut_b
                break
            if kc < kt:  # boundary
                bounds.append(kc + L)
                s = kc + L
                break
            # trigger: skip
            k = kt + p.skip_size
            c = 0
        # loop continues with next chunk
    return np.asarray(bounds, dtype=np.int64)


def chunk_lengths(bounds, n: int | None = None) -> np.ndarray:
    b = np.asarray(bounds, dtype=np.int64).reshape(-1)
    if b.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.diff(np.concatenate([[0], b]))
