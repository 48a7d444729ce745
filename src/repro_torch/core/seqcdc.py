"""SeqCDC public API in torch: the two-phase boundary pipeline.

The port of ``repro/core/seqcdc.py``'s ``two_phase`` backend: phase 1
computes the candidate/opposing bitmaps (plain torch, ``mask_impl="torch"``,
or the CUDA kernel, ``mask_impl="cuda"``), phase 2 runs the ``wide``
W-block automaton (``core/automaton.py``).  Streams of equal length chunk
independently along the leading axis.

Packed rows (``boundaries_packed_batch``) hold several streams back to
back: the bitmaps are clipped per segment and phase 2 is the segment-
resetting automaton (``automaton.select_boundaries_packed``).
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from . import automaton, masks
from .params import SeqCDCParams

MaskImpl = Literal["torch", "cuda"]
MASK_IMPLS = ("torch", "cuda")


def _compute_masks(data: torch.Tensor, p: SeqCDCParams, mask_impl: str):
    if mask_impl == "torch":
        return masks.seqcdc_masks(data, p.seq_length, p.mode)
    if mask_impl == "cuda":
        from repro_torch.kernels import seqcdc_masks as kmasks

        return kmasks.seqcdc_masks(data, p.seq_length, p.mode)
    raise ValueError(f"mask_impl must be one of {MASK_IMPLS}, got {mask_impl!r}")


def boundaries_batch(
    data: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    step_impl: str = "wide",
    max_chunks: int | None = None,
):
    """Two-phase SeqCDC over ``(B, n)`` uint8 streams.

    Returns ``(bounds (B, max_chunks) int32, counts (B,) int32)``:
    exclusive chunk ends, sentinel ``1<<30`` past each row's count.
    """
    if data.ndim != 2:
        raise ValueError(f"expected (B, n) data, got shape {tuple(data.shape)}")
    B, n = data.shape
    mc = max_chunks or automaton.max_chunks_for(n, p)
    if n == 0:  # an empty stream has no chunks
        return (torch.full((B, mc), automaton._BIG, dtype=torch.int32,
                           device=data.device),
                torch.zeros((B,), dtype=torch.int32, device=data.device))
    cand, opp = _compute_masks(data, p, mask_impl)
    return automaton.select_boundaries(
        cand, opp, n, p, step_impl=step_impl, max_chunks=mc
    )


def boundaries_two_phase(
    data: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    step_impl: str = "wide",
    max_chunks: int | None = None,
):
    """Vectorized SeqCDC for one ``(n,)`` stream.  Returns (bounds, count)."""
    b, c = boundaries_batch(data[None], p, mask_impl=mask_impl,
                            step_impl=step_impl, max_chunks=max_chunks)
    return b[0], c[0]


def segment_end_positions(ends: torch.Tensor, S: int) -> torch.Tensor:
    """The per-position segment-end operand of a packed row, from its
    segment-end table.

    ``ends``: ``(B, G)`` nondecreasing exclusive segment ends padded with
    the row's payload end.  Returns ``(B, S)`` int32: for a position below
    the payload end, the first end strictly greater than it (its own
    stream's end); for a padding position, the payload end.  This is the
    ``seg_end_pos`` layout the reference's scheduler builds row by row.
    """
    e = ends.to(torch.int64).contiguous()
    pos = torch.arange(S, dtype=torch.int64, device=ends.device)
    pos = pos.expand(e.shape[0], S).contiguous()
    idx = torch.searchsorted(e, pos, right=True)
    n_row = e[:, -1:].expand_as(pos)
    sep = torch.where(idx < e.shape[1],
                      e.gather(1, idx.clamp(max=e.shape[1] - 1)), n_row)
    return sep.to(torch.int32)


def boundaries_packed_batch(
    data: torch.Tensor,
    seg_end_pos: torch.Tensor,
    ends: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    max_chunks: int,
):
    """Chunk ``(B, S)`` packed rows, bit-identical per segment to chunking
    each stream alone.

    ``data``: uint8 rows of streams laid out back to back, zero padding
    after the last; ``seg_end_pos``: ``(B, S)`` the exclusive end of the
    segment each position belongs to (the payload end for padding);
    ``ends``: ``(B, G)`` nondecreasing segment ends padded with the payload
    end.  The row-wide bitmaps see byte pairs across a segment edge, which
    a stream's solo run never compares; clipping candidates to ``pos <=
    end - L`` and opposing pairs to ``pos < end - 1`` of their own segment
    removes exactly those.  Returns ``(bounds (B, max_chunks) int32, counts
    (B,) int32)`` in row coordinates, every segment end a bound.
    """
    if data.ndim != 2:
        raise ValueError(f"expected (B, S) data, got shape {tuple(data.shape)}")
    B, S = data.shape
    if S == 0:  # an empty row has no chunks
        return (torch.full((B, max_chunks), automaton._BIG,
                           dtype=torch.int32, device=data.device),
                torch.zeros((B,), dtype=torch.int32, device=data.device))
    cand, opp = _compute_masks(data, p, mask_impl)
    pos = torch.arange(S, dtype=torch.int64, device=data.device)
    sep = seg_end_pos.to(torch.int64)
    cand = cand & (pos <= sep - p.seq_length)
    opp = opp & (pos < sep - 1)
    return automaton.select_boundaries_packed(cand, opp, ends, p,
                                              max_chunks=max_chunks)


def boundaries_packed(data, seg_end_pos, ends, p: SeqCDCParams, *,
                      mask_impl: MaskImpl = "torch", max_chunks: int):
    """One ``(S,)`` packed row: :func:`boundaries_packed_batch` on a batch
    of one.  Returns (bounds, count)."""
    b, c = boundaries_packed_batch(data[None], seg_end_pos[None], ends[None],
                                   p, mask_impl=mask_impl,
                                   max_chunks=max_chunks)
    return b[0], c[0]


def bounds_to_numpy(bounds, count) -> list:
    """Strip sentinel padding host-side -> python list(s) of int boundaries.

    Accepts a single stream's ``(max_chunks,)`` bounds with a scalar count
    (returns a flat list) or the batched ``(B, max_chunks)`` + ``(B,)``
    layout of :func:`boundaries_batch` (returns a list of B lists).
    """
    if isinstance(bounds, torch.Tensor):
        bounds = bounds.cpu().numpy()
    if isinstance(count, torch.Tensor):
        count = count.cpu().numpy()
    b = np.asarray(bounds)
    c = np.asarray(count)
    if b.ndim == 1:
        return b[: int(c)].astype(np.int64).tolist()
    if b.ndim != 2 or c.shape != b.shape[:1]:
        raise ValueError(f"bad bounds/count shapes: {b.shape} / {c.shape}")
    return [row[: int(k)].astype(np.int64).tolist() for row, k in zip(b, c)]
