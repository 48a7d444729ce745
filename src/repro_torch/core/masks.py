"""Candidate / opposing bitmaps in plain torch (phase 1 of SeqCDC).

The port of ``repro/core/masks.py``: pairwise shifted compares, the AND of
``seq_length - 1`` forward-pair bits for the candidate bitmap, one opposite
compare for the opposing bitmap.  Shapes: input ``(..., n)`` uint8, outputs
``(..., n)`` bool.  ``kernels/seqcdc_masks.py`` is the CUDA version and
uses :func:`seqcdc_masks` here as its plain version.
"""
from __future__ import annotations

import torch

from .params import DECREASING, INCREASING


def pair_masks(data: torch.Tensor, mode: str = INCREASING):
    """(forward, opposing) pair bitmaps of shape ``data.shape``.

    ``forward[..., k]`` == pair (b[k], b[k+1]) ordered with the mode,
    ``opposing[..., k]`` == ordered against it; index n-1 padded False.
    """
    if data.dtype != torch.uint8:
        data = data.to(torch.uint8)
    cur = data[..., :-1]
    nxt = data[..., 1:]
    pad = torch.zeros(data.shape[:-1] + (min(1, data.shape[-1]),),
                      dtype=torch.bool, device=data.device)
    gt = torch.cat([nxt > cur, pad], dim=-1)
    lt = torch.cat([nxt < cur, pad], dim=-1)
    if mode == INCREASING:
        return gt, lt
    if mode == DECREASING:
        return lt, gt
    raise ValueError(mode)


def candidate_mask(fwd: torch.Tensor, seq_length: int) -> torch.Tensor:
    """AND of ``seq_length - 1`` consecutive forward-pair bits.

    ``cand[..., k]`` == a run of ``seq_length`` monotone bytes starts at k.
    Positions past ``n - seq_length`` are False: the shifts bring in False.
    """
    n = fwd.shape[-1]
    acc = fwd.clone()
    for j in range(1, seq_length - 1):
        if j >= n:
            acc[...] = False
            break
        acc[..., : n - j] &= fwd[..., j:]
        acc[..., n - j:] = False
    return acc


def seqcdc_masks(data: torch.Tensor, seq_length: int,
                 mode: str = INCREASING):
    """(candidate, opposing) bitmaps for SeqCDC.  Plain torch reference."""
    fwd, opp = pair_masks(data, mode)
    return candidate_mask(fwd, seq_length), opp
