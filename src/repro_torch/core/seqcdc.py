"""SeqCDC public API in torch: the two-phase boundary pipeline.

The port of ``repro/core/seqcdc.py``'s ``two_phase`` backend: phase 1
computes the candidate/opposing bitmaps (plain torch, ``mask_impl="torch"``,
or the CUDA kernel, ``mask_impl="cuda"``), phase 2 runs the ``wide``
W-block automaton (``core/automaton.py``).  Streams of equal length chunk
independently along the leading axis.
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
