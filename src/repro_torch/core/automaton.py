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

Packed rows (many streams back to back in one row) take
:func:`select_boundaries_packed`, the port of ``_scan_wide_packed``: a
fifth register ``se`` (the current segment's end) replaces the row end in
``_resolve``, one block may host several events, and the post-emit scan
position is clamped to the next pending cut.  Its kernel is
``kernels/csrc/packed_pipeline.cu``.

The reference's two other steps are here too, as the torch ops they are
on either device: ``gather`` (O(1) gathers per block against tables built
in parallel over all blocks, the block loop kept) and ``event`` (a loop
over events, jumping between them by ``searchsorted`` over prefix sums).
Only ``wide`` has a kernel of its own (``kernels/select_boundaries.py``).
"""
from __future__ import annotations

import torch

from .params import SeqCDCParams

#: bounds sentinel past ``count`` (and "no event" in the block minima)
_BIG = 1 << 30

#: the automaton's step implementations, as the reference names them
STEP_IMPLS = ("wide", "gather", "event")


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


def _scan_gather(candb: torch.Tensor, oppb: torch.Tensor, n: int,
                 p: SeqCDCParams):
    """The ``gather`` step over ``(B, nb, W)`` blocks: O(1) gathers per
    block against tables built in parallel over all blocks.

    * ``opp_pref`` ``(B, nb, W)``: inclusive prefix sums of the opposing
      bitmap;
    * ``next_cand`` ``(B, nb, W)``: the first candidate index ``>= j``
      (a reverse cumulative min, ``flip`` + ``cummin``);
    * ``mth_opp`` ``(B, nb, W)``: the index of the m-th (0-indexed)
      opposing pair (``scatter_reduce(amin)``; every index is in range,
      the reference's ``mode="drop"`` never drops).

    Returns ``(emits, bounds)`` like :func:`_scan_wide`.
    """
    B, nb, W = candb.shape
    dev = candb.device
    iota = torch.arange(W, dtype=torch.int64, device=dev)
    T = p.skip_trigger
    opp_pref = torch.cumsum(oppb.to(torch.int64), dim=-1)
    opp_total = opp_pref[..., -1]
    masked = torch.where(candb, iota, _BIG)
    next_cand = torch.flip(
        torch.cummin(torch.flip(masked, dims=[-1]), dim=-1).values, dims=[-1])
    ranks = torch.where(oppb, opp_pref - 1, _BIG).clamp(0, W - 1)
    mth_opp = torch.full((B, nb, W), _BIG, dtype=torch.int64, device=dev)
    mth_opp.scatter_reduce_(-1, ranks, torch.where(oppb, iota, _BIG),
                            reduce="amin")
    k = torch.full((B,), p.sub_min_skip, dtype=torch.int64, device=dev)
    c = torch.zeros((B,), dtype=torch.int64, device=dev)
    s = torch.zeros((B,), dtype=torch.int64, device=dev)
    emits, bounds = [], []
    for j in range(nb):
        bstart = j * W
        bend = bstart + W
        in_block = (k < bend) & (s < n)
        o = torch.clamp(k - bstart, 0, W - 1)
        kc_rel = next_cand[:, j].gather(1, o[:, None])[:, 0]
        kc = torch.where(kc_rel < _BIG, bstart + kc_rel, _BIG)
        # trigger: the first pair with carry + (pref[j] - pref_before_o) > T
        pref_b = opp_pref[:, j]
        pref_before = torch.where(
            o > 0, pref_b.gather(1, (o - 1).clamp(min=0)[:, None])[:, 0], 0)
        m = (T - c) + pref_before  # 0-indexed rank of the exceeding pair
        kt_rel = torch.where(
            m < W, mth_opp[:, j].gather(1, m.clamp(0, W - 1)[:, None])[:, 0],
            _BIG)
        kt = torch.where((kt_rel < _BIG) & (kt_rel >= o), bstart + kt_rel,
                         _BIG)
        new_k, new_s, emit, bound, any_event = _resolve(
            k, c, s, kc, kt, bend, in_block, n, p
        )
        c_pass = c + opp_total[:, j] - pref_before
        c = torch.where(any_event, 0, torch.where(in_block, c_pass, c))
        k, s = new_k, new_s
        emits.append(emit)
        bounds.append(bound)
    return torch.stack(emits, dim=-1), torch.stack(bounds, dim=-1)


def _scan_event(cand: torch.Tensor, opp: torch.Tensor, n: int,
                p: SeqCDCParams, max_chunks: int):
    """The ``event`` step over ``(B, n)`` bitmaps: one loop iteration per
    event (emit or skip), not per block.

    The next candidate at or after ``k`` and the skip trigger come from
    ``searchsorted`` over the exclusive prefix sums of the two bitmaps.
    The loop runs while any row has ``s < n`` and ``cnt < max_chunks``
    (the reference's per-row ``while_loop`` condition); a row whose
    condition fails keeps its state.  Returns ``(out (B, mc+1) int64,
    count (B,) int64)``, column ``mc`` the drop slot.
    """
    B = cand.shape[0]
    dev = cand.device
    L = p.seq_length
    T = p.skip_trigger
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    cand_pref = torch.cat([zero, torch.cumsum(cand.to(torch.int64), -1)], -1)
    opp_pref = torch.cat([zero, torch.cumsum(opp.to(torch.int64), -1)], -1)
    total_cand = cand_pref[:, -1]
    total_opp = opp_pref[:, -1]
    k = torch.full((B,), p.sub_min_skip, dtype=torch.int64, device=dev)
    c = torch.zeros((B,), dtype=torch.int64, device=dev)
    s = torch.zeros((B,), dtype=torch.int64, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int64, device=dev)
    out = torch.full((B, max_chunks + 1), _BIG, dtype=torch.int64,
                     device=dev)
    while True:
        live = (s < n) & (cnt < max_chunks)
        if not bool(live.any()):
            break
        kk = torch.clamp(k, 0, n)[:, None]
        cut_b = torch.clamp(s + p.max_size, max=n)
        cut_k = cut_b - (L - 1)
        # the first candidate at a position >= k
        rank_c = cand_pref.gather(1, kk)
        kc = torch.where(
            rank_c[:, 0] < total_cand,
            torch.searchsorted(cand_pref, rank_c + 1)[:, 0] - 1, _BIG)
        # the first opposing pair (at >= k) whose running count exceeds T
        want = opp_pref.gather(1, kk) + (T - c)[:, None] + 1
        kt = torch.where(
            want[:, 0] <= total_opp,
            torch.searchsorted(opp_pref, want)[:, 0] - 1, _BIG)
        e_cut = torch.maximum(cut_k, k)
        fire_cut = e_cut <= torch.minimum(kc, kt)
        fire_cand = ~fire_cut & (kc < kt)
        bound = torch.where(fire_cut, cut_b, kc + L)
        emit = (fire_cut | fire_cand) & live
        col = torch.where(emit, cnt, max_chunks)
        out.scatter_(1, col[:, None], bound[:, None])
        cnt = cnt + emit.to(torch.int64)
        s = torch.where(emit, bound, s)
        k = torch.where(live, torch.where(emit, bound + p.sub_min_skip,
                                          kt + p.skip_size), k)
        c = torch.where(live, 0, c)  # every event resets the counter
    return out, cnt


def _final_cut(out: torch.Tensor, count: torch.Tensor, n, max_chunks: int):
    """``select_boundaries``' fix-up: guarantee the final boundary ``n``
    (a no-op when already emitted).  ``out`` is ``(B, mc+1)`` with the
    drop slot last; an index past the table reads its last slot, as a jnp
    gather clamps.  ``n`` is an int or a ``(B,)`` tensor."""
    li = torch.clamp(count - 1, 0, max_chunks - 1)
    last = torch.where(count > 0, out.gather(1, li[:, None])[:, 0], 0)
    n_t = torch.as_tensor(n, dtype=torch.int64, device=out.device)
    n_t = n_t.expand(count.shape)
    need = (last < n_t) & (n_t > 0)
    col = torch.where(need & (count < max_chunks), count, max_chunks)
    out.scatter_(1, col[:, None], n_t[:, None])
    count = count + need.to(count.dtype)
    return out[:, :max_chunks].to(torch.int32), count.to(torch.int32)


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
    if step_impl not in STEP_IMPLS:
        raise ValueError(
            f"step_impl must be one of {STEP_IMPLS}, got {step_impl!r}")
    if max_chunks is None:
        max_chunks = max_chunks_for(n, p)
    if step_impl == "event":
        out, count = _scan_event(cand, opp, n, p, max_chunks)
        return _final_cut(out, count, n, max_chunks)
    B = cand.shape[0]
    candb, oppb = _padded_blocks(cand, opp, n, p)
    scan = _scan_wide if step_impl == "wide" else _scan_gather
    emits, blk_bounds = scan(candb, oppb, n, p)
    count = emits.sum(dim=-1)
    idx = torch.cumsum(emits, dim=-1) - 1
    # the reference's mode="drop" scatter: emits past max_chunks vanish
    keep = emits & (idx < max_chunks)
    out = torch.full((B, max_chunks + 1), _BIG, dtype=torch.int64,
                     device=cand.device)
    out.scatter_(1, torch.where(keep, idx, max_chunks), blk_bounds)
    return _final_cut(out, count, n, max_chunks)


def _scan_wide_packed(candb: torch.Tensor, oppb: torch.Tensor,
                      ends: torch.Tensor, n_row: torch.Tensor,
                      p: SeqCDCParams, max_chunks: int):
    """The ``wide`` step over packed rows: ``(B, nb, W)`` blocks whose rows
    hold several streams back to back.

    The reference's argument (``repro/core/automaton.py:_scan_wide_packed``)
    carries over unchanged:

    * ``se``, the end of the segment the scan walks, stands where the
      unpacked scan has the row end, so a max-size or end cut consults its
      own stream's end; an emit landing on ``se`` moves it to the next
      *strictly greater* entry of ``ends`` (duplicate entries are empty
      streams), and the registers the emit leaves behind are a fresh
      stream's init state;
    * a run of tiny segments puts several events in one block, so each
      block re-resolves while any row's ``go`` holds (an emit that leaves
      the scan position inside the block); rows whose ``go`` is false keep
      their state, which is the reference's per-row ``while_loop``;
    * after every emit the scan position is clamped to the next pending
      cut, ``min(new_k, se - (L-1))``; for a segment shorter than ``L-1``
      that makes it negative, hence signed int64 registers throughout.

    ``ends``: ``(B, G)`` int64 nondecreasing segment ends padded with the
    row's payload end ``n_row`` (``(B,)``).  Returns ``(out (B, mc+1)
    int64, count (B,) int64)``: emitted bounds scattered by emit index with
    the reference's ``mode="drop"`` past ``max_chunks`` (column ``mc`` is
    the drop slot), and every emit counted.
    """
    B, nb, W = candb.shape
    dev = candb.device
    L = p.seq_length
    T = p.skip_trigger
    iota = torch.arange(W, dtype=torch.int64, device=dev)
    big = torch.full((B, W), _BIG, dtype=torch.int64, device=dev)

    def next_end(x):
        return torch.where(ends > x[:, None], ends, _BIG).amin(dim=-1)

    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    se = next_end(zero)
    # the same clamp at init: the first segment may be shorter than min_size
    k = torch.clamp(se - (L - 1), max=p.sub_min_skip)
    c, s, cnt = zero.clone(), zero.clone(), zero.clone()
    out = torch.full((B, max_chunks + 1), _BIG, dtype=torch.int64,
                     device=dev)
    for j in range(nb):
        bstart = j * W
        bend = bstart + W
        cb, ob = candb[:, j], oppb[:, j]
        pos = iota + bstart
        go = torch.ones((B,), dtype=torch.bool, device=dev)
        while True:
            in_block = (k < bend) & (s < n_row)
            o = torch.clamp(k - bstart, min=0)
            active = iota[None, :] >= o[:, None]
            kc = torch.where(cb & active, pos, big).amin(dim=-1)
            oa = ob & active
            cum = c[:, None] + torch.cumsum(oa, dim=-1)
            kt = torch.where(oa & (cum > T), pos, big).amin(dim=-1)
            new_k, new_s, emit, bound, any_event = _resolve(
                k, c, s, kc, kt, bend, in_block, se, p
            )
            new_c = torch.where(any_event, 0,
                                torch.where(in_block, cum[:, -1], c))
            new_se = torch.where(emit & (bound >= se), next_end(bound), se)
            # clamp the post-emit position to the next pending cut: the
            # min-size skip may overleap a run of tiny segments entirely
            new_k = torch.where(emit, torch.minimum(new_k, new_se - (L - 1)),
                                new_k)
            emit = emit & go
            col = torch.where(emit & (cnt < max_chunks), cnt, max_chunks)
            out.scatter_(1, col[:, None], bound[:, None])
            k = torch.where(go, new_k, k)
            c = torch.where(go, new_c, c)
            s = torch.where(go, new_s, s)
            se = torch.where(go, new_se, se)
            cnt = cnt + emit.to(torch.int64)
            # a late segment-end cut resets the scan inside this block:
            # go around again (non-emit events always clear the block)
            go = emit & (k < bend) & (s < n_row)
            if not bool(go.any()):
                break
    return out, cnt


def select_boundaries_packed(
    cand: torch.Tensor,
    opp: torch.Tensor,
    ends: torch.Tensor,
    p: SeqCDCParams,
    *,
    max_chunks: int,
):
    """Resolve chunk boundaries for ``(B, S)`` packed rows.

    ``cand``/``opp`` are row-wide bitmaps already clipped per segment
    (``seqcdc.boundaries_packed_batch``); ``ends`` is the ``(B, G)``
    segment-end table.  Returns ``(bounds (B, max_chunks) int32, count (B,)
    int32)`` in row coordinates: ascending exclusive ends with every
    segment end present once, so a host demux slices each stream back out
    with two searchsorteds.
    """
    B, S = cand.shape
    ends = ends.to(torch.int64)
    n_row = ends.amax(dim=-1)  # the row's real payload end
    candb, oppb = _padded_blocks(cand, opp, S, p)
    out, count = _scan_wide_packed(candb, oppb, ends, n_row, p, max_chunks)
    return _final_cut(out, count, n_row, max_chunks)
