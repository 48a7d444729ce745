"""Phase 2 of SeqCDC: the W-block boundary-selection automaton, plain torch.

The port of ``repro/core/automaton.py``'s ``wide`` step.  The invariant is
the reference's: with ``W <= min(SkipSize, min_size - SeqLength)`` every
event (candidate boundary, skip trigger, max-size/file-end cut) advances
the scan position past the current W-block, so at most one event fires per
block and the in-block scan reduces to a masked min (first candidate), a
masked cumulative sum (the skip trigger) and scalar cut arithmetic.

The reference's ``vmap`` becomes a batch dimension written out: every
state register is a ``(B,)`` tensor and each step works on ``(B, W)``
slices.  Its ``lax.scan`` over blocks becomes a Python loop, one step per
W-block, so this module is the plain version (the tests' reference and
the scheduler's cross-check replay).  The fused CUDA kernel
(``kernels/csrc/fused_pipeline.cu``) runs the same step on the card.

Only ``step_impl="wide"`` is ported; ``gather`` and ``event`` raise.
"""
from __future__ import annotations

import torch

from .params import SeqCDCParams

#: bounds sentinel past ``count`` (and "no event" in the block minima)
_BIG = 1 << 30

#: the step implementations of the reference that this port does not have
#: yet (ROADMAP.md, "Modules to port", item 2)
_UNPORTED_STEPS = ("gather", "event")


def max_chunks_for(n: int, p: SeqCDCParams) -> int:
    """Upper bound on the number of chunks for an n-byte stream (+1 fixup slot)."""
    return max(1, n // p.min_size + 2)


def _padded_blocks(cand: torch.Tensor, opp: torch.Tensor, n: int,
                   p: SeqCDCParams):
    """Pad ``(B, n)`` bitmaps past n so every event fires inside the scan.

    Scan positions never exceed ``cut_k + SkipSize`` for any chunk, and the
    final cut fires at position < n + SkipSize; padding by SkipSize + W
    rounded to a W multiple captures every event.  Returns ``(B, nb, W)``.
    """
    W = p.block_width
    n_pad = ((n + p.skip_size + W) + W - 1) // W * W
    B = cand.shape[0]
    pad = torch.zeros((B, n_pad - n), dtype=torch.bool, device=cand.device)
    candb = torch.cat([cand, pad], dim=-1).reshape(B, -1, W)
    oppb = torch.cat([opp, pad], dim=-1).reshape(B, -1, W)
    return candb, oppb


def _resolve(k, c, s, kc, kt, bend, in_block, n, p: SeqCDCParams):
    """Event resolution given first-candidate ``kc`` / trigger ``kt``.

    All arguments are ``(B,)`` int64 tensors (``in_block`` bool; ``bend``
    and ``n`` may be Python ints).  A trigger whose skip landing reaches the
    cut position is itself a cut (``trig_cuts``): the scalar algorithm
    checks ``k + L > s + max_size`` before reading a window, so the skip
    cuts at ``cut_b`` without consulting any byte in between.  Resolving it
    here keeps the scan position <= cut_k, which is what guarantees every
    event advances past its block.
    """
    L = p.seq_length
    cut_b = torch.clamp(s + p.max_size, max=n)
    cut_k = cut_b - (L - 1)  # first scan position that cuts
    e_cut = torch.maximum(cut_k, k)
    fire_cut = in_block & (e_cut < bend) & (e_cut <= torch.minimum(kc, kt))
    fire_cand = in_block & ~fire_cut & (kc < kt)
    fire_trig = in_block & ~fire_cut & ~fire_cand & (kt < _BIG)
    trig_cuts = fire_trig & (kt + p.skip_size >= cut_k)  # overshooting skip
    emit_cut = fire_cut | trig_cuts
    bound_cand = kc + L
    new_s = torch.where(emit_cut, cut_b, torch.where(fire_cand, bound_cand, s))
    new_k = torch.where(
        emit_cut,
        cut_b + p.sub_min_skip,
        torch.where(
            fire_cand,
            bound_cand + p.sub_min_skip,
            torch.where(fire_trig, kt + p.skip_size,
                        torch.where(in_block, bend, k)),
        ),
    )
    emit = emit_cut | fire_cand
    bound = torch.where(emit_cut, cut_b, bound_cand)
    any_event = fire_cut | fire_cand | fire_trig
    return new_k, new_s, emit, bound, any_event


def _scan_wide(candb: torch.Tensor, oppb: torch.Tensor, n: int,
               p: SeqCDCParams):
    """The ``wide`` step over ``(B, nb, W)`` blocks: O(W) work per block.

    Returns ``(emits, bounds)``, each ``(B, nb)``: whether block j emitted
    a boundary and which.
    """
    B, nb, W = candb.shape
    dev = candb.device
    iota = torch.arange(W, dtype=torch.int64, device=dev)
    T = p.skip_trigger
    big = torch.full((B, W), _BIG, dtype=torch.int64, device=dev)
    k = torch.full((B,), p.sub_min_skip, dtype=torch.int64, device=dev)
    c = torch.zeros((B,), dtype=torch.int64, device=dev)
    s = torch.zeros((B,), dtype=torch.int64, device=dev)
    emits, bounds = [], []
    for j in range(nb):
        bstart = j * W
        bend = bstart + W
        cb, ob = candb[:, j], oppb[:, j]
        in_block = (k < bend) & (s < n)
        o = torch.clamp(k - bstart, min=0)
        active = iota[None, :] >= o[:, None]
        pos = iota + bstart
        kc = torch.where(cb & active, pos, big).amin(dim=-1)
        oa = ob & active
        cum = c[:, None] + torch.cumsum(oa, dim=-1)
        kt = torch.where(oa & (cum > T), pos, big).amin(dim=-1)
        new_k, new_s, emit, bound, any_event = _resolve(
            k, c, s, kc, kt, bend, in_block, n, p
        )
        c = torch.where(any_event, 0, torch.where(in_block, cum[:, -1], c))
        k, s = new_k, new_s
        emits.append(emit)
        bounds.append(bound)
    return torch.stack(emits, dim=-1), torch.stack(bounds, dim=-1)


def select_boundaries(
    cand: torch.Tensor,
    opp: torch.Tensor,
    n: int,
    p: SeqCDCParams,
    *,
    step_impl: str = "wide",
    max_chunks: int | None = None,
):
    """Resolve chunk boundaries from ``(B, n)`` bitmaps.

    Returns ``(bounds, count)``: ``bounds`` is ``(B, max_chunks)`` int32 of
    exclusive end offsets (sentinel ``1<<30`` past ``count``), sorted
    ascending, last real entry == n; ``count`` is ``(B,)`` int32.
    """
    if step_impl in _UNPORTED_STEPS:
        raise NotImplementedError(
            f"step_impl={step_impl!r} is not ported yet (ROADMAP.md, "
            f"'Modules to port', item 2: gather/event steps)"
        )
    if step_impl != "wide":
        raise ValueError(step_impl)
    if max_chunks is None:
        max_chunks = max_chunks_for(n, p)
    B = cand.shape[0]
    dev = cand.device
    candb, oppb = _padded_blocks(cand, opp, n, p)
    emits, blk_bounds = _scan_wide(candb, oppb, n, p)
    count = emits.sum(dim=-1)
    idx = torch.cumsum(emits, dim=-1) - 1
    # the reference's mode="drop" scatter: emits past max_chunks vanish
    keep = emits & (idx < max_chunks)
    out = torch.full((B, max_chunks + 1), _BIG, dtype=torch.int64, device=dev)
    out.scatter_(1, torch.where(keep, idx, max_chunks), blk_bounds)
    # fix-up: guarantee the final boundary n (no-op when already emitted);
    # an index past the table reads its last slot, as a jnp gather clamps
    li = torch.clamp(count - 1, 0, max_chunks - 1)
    last = torch.where(count > 0, out.gather(1, li[:, None])[:, 0], 0)
    need = (last < n) & (n > 0)
    col = torch.where(need & (count < max_chunks), count, max_chunks)
    out.scatter_(1, col[:, None], torch.full_like(col[:, None], n))
    count = count + need.to(count.dtype)
    return out[:, :max_chunks].to(torch.int32), count.to(torch.int32)
