"""SeqCDC public API in torch: the two-phase boundary pipeline and the
sequential scan.

The port of ``repro/core/seqcdc.py``.  ``two_phase``: phase 1 computes the
candidate/opposing bitmaps (plain torch, ``mask_impl="torch"``, or the
CUDA kernel, ``mask_impl="cuda"``), phase 2 runs the W-block automaton
(``core/automaton.py``; ``step_impl`` picks the step) in plain torch
(``select_impl="torch"``) or as that step's select kernel
(``select_impl="cuda"``).  Streams of equal length chunk independently
along the leading axis.  ``sequential``: the scalar algorithm with true
data-dependent skipping (the paper's unaccelerated SEQ), a Python loop
over the stream's bytes for a CPU tensor and the native-scan kernel for
a CUDA one.

Packed rows (``boundaries_packed_batch``) hold several streams back to
back: the bitmaps are clipped per segment and phase 2 is the segment-
resetting automaton (``automaton.select_boundaries_packed``), in plain
torch or (``select_impl="cuda"``) as the packed select kernel.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from . import automaton, masks
from .params import SeqCDCParams

MaskImpl = Literal["torch", "cuda"]
MASK_IMPLS = ("torch", "cuda")
#: phase 2's implementation: the plain torch automaton or the step's select
#: kernel (over packed rows, the packed one: the ``wide`` step)
SELECT_IMPLS = ("torch", "cuda")


def _compute_masks(data: torch.Tensor, p: SeqCDCParams, mask_impl: str):
    if mask_impl == "torch":
        return masks.seqcdc_masks(data, p.seq_length, p.mode)
    if mask_impl == "cuda":
        from repro_torch.kernels import seqcdc_masks as kmasks

        return kmasks.seqcdc_masks(data, p.seq_length, p.mode)
    raise ValueError(f"mask_impl must be one of {MASK_IMPLS}, got {mask_impl!r}")


def select_impl_for(step_impl: str) -> str:
    """The phase-2 implementation the port's callers run for
    ``step_impl``: the select kernel of that step (``"cuda"``; its plain
    version for a CPU tensor).  Every step has one."""
    if step_impl not in automaton.STEP_IMPLS:
        raise ValueError(f"step_impl must be one of {automaton.STEP_IMPLS}, "
                         f"got {step_impl!r}")
    return "cuda"


def select(cand: torch.Tensor, opp: torch.Tensor, n: int, p, *,
           select_impl: str = "torch", step_impl: str = "wide",
           max_chunks: int | None = None):
    """Phase 2 over ``(B, n)`` bitmaps: the plain torch automaton
    (``select_impl="torch"``) or the select kernel of ``step_impl``
    (``"cuda"``: ``kernels/select_boundaries.py`` for ``wide``,
    ``select_boundaries_gather.py`` and ``select_boundaries_event.py`` for
    the others).  ``p`` is a :class:`SeqCDCParams` or anything with its
    fields (the hash selectors' ``SelectorParams``)."""
    if select_impl == "torch":
        return automaton.select_boundaries(cand, opp, n, p,
                                           step_impl=step_impl,
                                           max_chunks=max_chunks)
    if select_impl != "cuda":
        raise ValueError(
            f"select_impl must be one of {SELECT_IMPLS}, got {select_impl!r}")
    select_impl_for(step_impl)  # a known step
    from repro_torch.kernels import (
        select_boundaries,
        select_boundaries_event,
        select_boundaries_gather,
    )

    kernel = {"wide": select_boundaries.select_boundaries,
              "gather": select_boundaries_gather.select_boundaries_gather,
              "event": select_boundaries_event.select_boundaries_event,
              }[step_impl]
    return kernel(cand, opp, n, p, max_chunks=max_chunks)


def boundaries_batch(
    data: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    step_impl: str = "wide",
    select_impl: str = "torch",
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
    return select(cand, opp, n, p, select_impl=select_impl,
                  step_impl=step_impl, max_chunks=mc)


def boundaries_two_phase(
    data: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    step_impl: str = "wide",
    select_impl: str = "torch",
    max_chunks: int | None = None,
):
    """Vectorized SeqCDC for one ``(n,)`` stream.  Returns (bounds, count)."""
    b, c = boundaries_batch(data[None], p, mask_impl=mask_impl,
                            step_impl=step_impl, select_impl=select_impl,
                            max_chunks=max_chunks)
    return b[0], c[0]


def sequential_plain(data, p: SeqCDCParams):
    """The reference's scalar ``while_loop`` (``boundaries_sequential``) as
    a Python loop over one stream's bytes (a sequence of ints of length
    ``n >= max(L, 2)``).  Returns every emitted bound: the caller keeps
    ``max_chunks`` of them, as the reference's ``mode="drop"`` does, and
    counts them all.

    One iteration per *scanned* position: the min-size skip and the
    content-defined skips advance the position without reading bytes.
    """
    n = len(data)
    L = p.seq_length
    T = p.skip_trigger
    inc = p.mode == "increasing"
    out = []
    k, c, s = p.sub_min_skip, 0, 0
    while s < n:
        cut_b = min(s + p.max_size, n)
        hit_cut = k >= cut_b - (L - 1)
        sk = min(k, max(n - L, 0))
        is_cand = False
        if not hit_cut:
            is_cand = True
            for j in range(sk, sk + L - 1):
                a, b = data[j], data[j + 1]
                if not (b > a if inc else b < a):
                    is_cand = False
                    break
        a = data[min(sk, n - 2)]
        b = data[min(sk + 1, n - 1)]
        is_opp = not hit_cut and not is_cand and (b < a if inc else b > a)
        trig = is_opp and c + 1 > T
        if hit_cut or is_cand:
            bound = cut_b if hit_cut else k + L
            out.append(bound)
            s = bound
            k = bound + p.sub_min_skip
            c = 0
        elif trig:
            k += p.skip_size
            c = 0
        else:
            k += 1
            c += int(is_opp)
    return out


def boundaries_sequential(data: torch.Tensor, p: SeqCDCParams, *,
                          max_chunks: int | None = None):
    """Scalar SeqCDC over one ``(n,)`` uint8 stream (true data-dependent
    skipping).  Returns ``(bounds (max_chunks,) int32, count () int32)``,
    sentinel ``1<<30`` past the count, as the reference's does.

    A CPU tensor runs :func:`sequential_plain`; a CUDA tensor launches the
    native-scan kernel (``kernels/native_scan.py``) or raises.
    """
    if data.ndim != 1:
        raise ValueError(f"expected (n,) data, got shape {tuple(data.shape)}")
    n = data.shape[0]
    mc = max_chunks or automaton.max_chunks_for(n, p)
    dev = data.device
    out = torch.full((mc,), automaton._BIG, dtype=torch.int32, device=dev)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    if n < max(p.seq_length, 2):  # too short for any pair or run
        out[0] = n
        return out, torch.ones((), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        from repro_torch.kernels import native_scan

        b, c = native_scan.native_scan(data[None], "seqcdc", params=p,
                                       max_chunks=mc)
        return b[0], c[0]
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    bounds = sequential_plain(data.tolist(), p)
    kept = bounds[:mc]
    out[: len(kept)] = torch.tensor(kept, dtype=torch.int32)
    return out, torch.tensor(len(bounds), dtype=torch.int32)


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


def packed_masks(data: torch.Tensor, seg_end_pos: torch.Tensor,
                 p: SeqCDCParams, *, mask_impl: MaskImpl = "torch"):
    """Phase 1 over ``(B, S)`` packed rows: the row-wide bitmaps clipped
    per segment.  The row-wide bitmaps see byte pairs across a segment
    edge, which a stream's solo run never compares; clipping candidates to
    ``pos <= end - L`` and opposing pairs to ``pos < end - 1`` of their own
    segment (``seg_end_pos``, the payload end for padding) removes exactly
    those.  Returns ``(cand, opp)``, ``(B, S)`` bool."""
    cand, opp = _compute_masks(data, p, mask_impl)
    pos = torch.arange(data.shape[-1], dtype=torch.int64, device=data.device)
    sep = seg_end_pos.to(torch.int64)
    return cand & (pos <= sep - p.seq_length), opp & (pos < sep - 1)


def boundaries_packed_batch(
    data: torch.Tensor,
    seg_end_pos: torch.Tensor,
    ends: torch.Tensor,
    p: SeqCDCParams,
    *,
    mask_impl: MaskImpl = "torch",
    select_impl: str = "torch",
    max_chunks: int,
):
    """Chunk ``(B, S)`` packed rows, bit-identical per segment to chunking
    each stream alone.

    ``data``: uint8 rows of streams laid out back to back, zero padding
    after the last; ``seg_end_pos``: ``(B, S)`` the exclusive end of the
    segment each position belongs to (the payload end for padding);
    ``ends``: ``(B, G)`` nondecreasing segment ends padded with the payload
    end.  Phase 1 is :func:`packed_masks`; phase 2 the segment-resetting
    automaton in plain torch (``select_impl="torch"``) or as the packed
    select kernel (``"cuda"``, ``kernels/select_boundaries_packed.py``).
    Returns ``(bounds (B, max_chunks) int32, counts (B,) int32)`` in row
    coordinates, every segment end a bound.
    """
    if select_impl not in SELECT_IMPLS:
        raise ValueError(
            f"select_impl must be one of {SELECT_IMPLS}, got {select_impl!r}")
    if data.ndim != 2:
        raise ValueError(f"expected (B, S) data, got shape {tuple(data.shape)}")
    B, S = data.shape
    if S == 0:  # an empty row has no chunks
        return (torch.full((B, max_chunks), automaton._BIG,
                           dtype=torch.int32, device=data.device),
                torch.zeros((B,), dtype=torch.int32, device=data.device))
    cand, opp = packed_masks(data, seg_end_pos, p, mask_impl=mask_impl)
    if select_impl == "torch":
        return automaton.select_boundaries_packed(cand, opp, ends, p,
                                                  max_chunks=max_chunks)
    from repro_torch.kernels import select_boundaries_packed as kselp

    return kselp.select_boundaries_packed(cand, opp, ends, p,
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
