"""The packed select kernel's wrapper and its route through the packed
split path, against the JAX reference, on the CPU.

``kernels.select_boundaries_packed.select_boundaries_packed`` takes its
plain version (``core.automaton.select_boundaries_packed``) for CPU
tensors.  Here, on seeded bitmaps clipped per segment
(``_select_packed_cases.py``):

* the wrapper's CPU route against the reference's
  ``select_boundaries_packed`` (vmapped over rows) on ``chip_smoke.py``'s
  three segment mixes, empty streams, segments shorter than L-1, padding
  past the payload end, G = 1 (also against the unpacked
  ``select_boundaries``) and an undersized ``max_chunks``; and against the
  kernel's design emulated in torch: each segment of min_size or more
  chunked alone by the unpacked plain automaton, a shorter one a chunk of
  its own length, the bounds placed in order, emits past ``max_chunks``
  dropped and the fix-up at the payload end;
* the redesigned kernel's walk emulated in numpy (``window_emulated``:
  bitmap rows resident at byte offsets, window words built from their
  bytes, the trigger found from a window's opposing prefix, ``c`` carried
  across windows) against the reference on the same cases and on rows
  built for its edges (segments at every offset mod 32, a trigger on a
  window's last bit, a max-size cut at a segment end, a 65,536-byte
  segment), at a true and a short ``max_chunks``;
* the wrapper's rule for device scratch (only where the kernel's does not
  fit in shared memory);
* ``boundaries_packed_batch(select_impl="cuda")`` equal to ``"torch"``;
* the scheduler's packed split and chunk-only dispatches call the wrapper.

Every output is an integer: tolerance 0.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _packing_cases
import _select_packed_cases as cases

from repro.core import automaton as jautomaton
from repro.core.params import SeqCDCParams as JParams

import repro_torch
from repro_torch.core import automaton as tautomaton
from repro_torch.core.oracle import boundaries_numpy
from repro_torch.core.seqcdc import (
    boundaries_packed_batch,
    segment_end_positions,
)
from repro_torch.kernels import select_boundaries_packed as kselp
from repro_torch.service import ChunkScheduler

ROOT = os.path.join(os.path.dirname(__file__), "..")

JPARAMS = {"small": JParams(**cases.SMALL),
           "paper8k": JParams(**cases.PAPER8K)}


def tp(name):
    return repro_torch.params_from_reference(JPARAMS[name])


@functools.lru_cache(maxsize=None)
def _jselect_packed(pname, mc):
    """The reference's packed automaton over a batch of rows, jitted once
    a parameter set and table width."""
    p = JPARAMS[pname]
    return jax.jit(jax.vmap(
        lambda c, o, e: jautomaton.select_boundaries_packed(
            c, o, e, p, max_chunks=mc)))


def _mixes():
    """Two 16 KiB rows of each of ``chip_smoke.py``'s segment mixes at
    paper 8 KiB parameters, one table wide enough for all."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    S = 16 << 10
    rng = np.random.default_rng(7)
    rows = []
    for mix in smoke.PACKED_MIXES:
        rows += [[seg.size for seg in row]
                 for row in smoke.packed_rows(rng, mix, 2, S)[2]]
    ends = cases.ends_table(rows)
    cand, opp = cases.clipped_bitmaps(rng, ends, S, cases.PAPER8K[
        "seq_length"], cases.DENSITY["paper8k"])
    return ends, cand, opp


def _case(name):
    """``(params name, ends, cand, opp, max_chunks)`` of one test case."""
    if name == "mixes":
        ends, cand, opp = _mixes()
        pname = "paper8k"
    else:
        ends, cand, opp = cases.edge_case(name.split(" ")[0])
        pname = "small"
    S, G = cand.shape[1], ends.shape[1]
    mc = cases.true_max_chunks(S, JPARAMS[pname].min_size, G)
    if name.startswith("random short"):  # the fullest row keeps fewer
        full = kselp.select_boundaries_packed(
            torch.from_numpy(cand), torch.from_numpy(opp),
            torch.from_numpy(ends), tp(pname), max_chunks=mc)[1]
        mc = max(1, int(full.max()) - int(name.split(" ")[-1]))
    return pname, ends, cand, opp, mc


def _segments_alone(cand, opp, ends, p, mc):
    """The kernel's design in torch: each segment of min_size or more
    chunked alone by the unpacked plain automaton on its own bits, a
    shorter one a chunk of its own length, the bounds placed in segment
    order, emits past ``mc`` dropped (and counted), then the fix-up at the
    payload end."""
    B = ends.shape[0]
    bounds = np.full((B, mc), 1 << 30, np.int32)
    counts = np.zeros(B, np.int32)
    for bi in range(B):
        out, st = [], 0
        for e in ends[bi].tolist():
            seg = e - st
            if seg >= p.min_size:
                b, c = tautomaton.select_boundaries(
                    torch.from_numpy(cand[bi:bi + 1, st:e].copy()),
                    torch.from_numpy(opp[bi:bi + 1, st:e].copy()), seg, p)
                out += (b[0, :int(c[0])].numpy().astype(np.int64)
                        + st).tolist()
            elif seg > 0:
                out.append(e)
            st = e
        kept = min(len(out), mc)
        bounds[bi, :kept] = out[:kept]
        c, n_row = len(out), int(ends[bi, -1])
        if (out[kept - 1] if kept else 0) < n_row and n_row > 0:
            if c < mc:
                bounds[bi, c] = n_row
            c += 1
        counts[bi] = c
    return bounds, counts


#: positions a search window of the kernel's walk (wblock.cuh kWin)
WIN = 1024
BIG = 1 << 30


def _resident(bits: np.ndarray, a: int, rng) -> np.ndarray:
    """A bitmap row as the kernel holds it in shared memory: row byte q at
    virtual byte q + a, ``region_bytes(n)`` bytes in all, every byte
    outside the row random (copied from around the tensor, or never
    written)."""
    n = bits.size
    rb = rng.integers(0, 256, ((n + 15) & ~15) + 64, dtype=np.uint8)
    rb[a:a + n] = bits
    return rb


def _word(rb: np.ndarray, vst: int, p0: int, l: int) -> int:
    """word_from_bytes: positions p0 .. p0 + 31 of the segment whose
    position 0 is virtual byte vst, from three aligned 16-byte loads (bit 0
    of each byte), shifted by the byte offset, masked at the length l."""
    if p0 >= l:
        return 0
    v = vst + p0
    f = v & ~15
    bits = int.from_bytes(np.packbits(rb[f:f + 48] & 1,
                                      bitorder="little").tobytes(), "little")
    keep = (1 << min(32, l - p0)) - 1
    return (bits >> (v & 15)) & keep


def _nth_bit(u: int, r: int) -> int:
    """wblock.cuh nth_bit: the position of the r-th set bit of u."""
    pos = 0
    for half in (16, 8, 4, 2, 1):
        cnt = bin(u & ((1 << half) - 1)).count("1")
        if cnt < r:
            r -= cnt
            u >>= half
            pos += half
    return pos


def _window_walk(crb, orb, vc, vo, l, p, stats):
    """One segment of length l walked as the kernel's warp walks it: the
    words of a window built where the walk enters it, each lane's
    exclusive prefix of the opposing popcounts made once a window, each
    event's search from it (the first candidate, the opposing bits below
    k, the lane holding the trigger's rank, its nth_bit), resolve and
    final_cut.  Returns the segment's bounds, every emit kept (its table
    is a true bound)."""
    W, L, T = p.block_width, p.seq_length, p.skip_trigger
    cover = (l + p.skip_size + W + W - 1) // W * W
    k, c, s, out = p.sub_min_skip, 0, 0, []
    wstart, events = -WIN, 0
    while s < l and k < cover:
        if k >= wstart + WIN:
            if wstart >= 0 and not events and c:
                stats["carried"] += 1  # a window left with c, no event
            wstart = k & ~(W - 1)
            cw = [_word(crb, vc, wstart + 32 * i, l) for i in range(32)]
            ow = [_word(orb, vo, wstart + 32 * i, l) for i in range(32)]
            pc = [bin(w).count("1") for w in ow]
            excl = np.concatenate([[0], np.cumsum(pc)[:-1]]).tolist()
            total = sum(pc)
            events = 0
        o = k - wstart
        act = [0xFFFFFFFF if o <= 32 * i else 0 if o >= 32 * i + 32
               else (0xFFFFFFFF << (o - 32 * i)) & 0xFFFFFFFF
               for i in range(32)]
        kcs = [32 * i + ((cw[i] & act[i]) & -(cw[i] & act[i])).bit_length()
               - 1 for i in range(32) if cw[i] & act[i]]
        kc = wstart + min(kcs) if kcs else BIG
        lane = o >> 5
        below = excl[lane] + bin(ow[lane] & ~act[lane] & 0xFFFFFFFF).count(
            "1")
        m = T - c + 1
        rank = below + m
        hit = [i for i in range(32)
               if m >= 1 and excl[i] < rank <= excl[i] + pc[i]]
        kt = (wstart + 32 * hit[0] + _nth_bit(ow[hit[0]], rank - excl[hit[0]])
              if hit else BIG)
        # wblock.cuh resolve
        bend = min(wstart + WIN, cover)
        cut_b = min(s + p.max_size, l)
        cut_k = cut_b - (L - 1)
        e_cut = max(cut_k, k)
        fire_cut = e_cut < bend and e_cut <= min(kc, kt)
        fire_cand = not fire_cut and kc < kt
        fire_trig = not fire_cut and not fire_cand and kt < BIG
        emit_cut = fire_cut or (fire_trig and kt + p.skip_size >= cut_k)
        bound = cut_b if emit_cut else kc + L
        if emit_cut or fire_cand:
            k = bound + p.sub_min_skip
            out.append(bound)
            s = bound
            if emit_cut and bound == l:
                stats["cut_at_end"] += 1
        elif fire_trig:
            k = kt + p.skip_size
            if kt - wstart == WIN - 1:
                stats["last_bit"] += 1
        else:
            k = bend
        c = 0 if (fire_cut or fire_cand or fire_trig) else c + total - below
        events += fire_cut or fire_cand or fire_trig
    if (out[-1] if out else 0) < l:  # final_cut
        out.append(l)
    return out


def window_emulated(cand, opp, ends, p, mc, offsets, seed=0):
    """The redesigned kernel's walk in numpy, row by row: both bitmap rows
    resident at virtual offsets ``offsets`` (ac, ao) with random bytes
    around them, the segments sorted (shorter than min_size: one chunk of
    its own length), each long one walked window by window
    (``_window_walk``), the bounds placed in segment order with emits past
    ``mc`` dropped and counted, then the fix-up at the payload end.
    Returns ``(bounds, counts, stats)``; stats counts the edges the walk
    met: triggers on a window's last bit, windows left with ``c`` carried
    and no event, max-size cuts at a segment end."""
    rng = np.random.default_rng(seed)
    B = ends.shape[0]
    ac, ao = offsets
    bounds = np.full((B, mc), BIG, np.int32)
    counts = np.zeros(B, np.int32)
    stats = dict(last_bit=0, carried=0, cut_at_end=0)
    for bi in range(B):
        crb = _resident(cand[bi], ac, rng)
        orb = _resident(opp[bi], ao, rng)
        out, st = [], 0
        for e in ends[bi].tolist():
            seg = e - st
            if seg >= p.min_size:
                out += [st + b for b in _window_walk(crb, orb, st + ac,
                                                     st + ao, seg, p, stats)]
            elif seg > 0:
                out.append(e)
            st = e
        kept = min(len(out), mc)
        bounds[bi, :kept] = out[:kept]
        c, n_row = len(out), int(ends[bi, -1])
        if (out[kept - 1] if kept else 0) < n_row and n_row > 0:
            if c < mc:
                bounds[bi, c] = n_row
            c += 1
        counts[bi] = c
    return bounds, counts, stats


#: rows built for the redesigned walk's edges
CONSTRUCTED = ("offsets mod 32", "last-bit trigger", "carried c",
               "max-size cut at end", "G1 65536")


def _clip(ends, cand, opp, L):
    """Clip hand-made bitmaps per segment as the packed split path does."""
    rng = np.random.default_rng(0)
    c, o = cases.clipped_bitmaps(rng, ends, cand.shape[1], L, (1.0, 1.0))
    return ends, cand & c, opp & o


def _constructed(name):
    """``(params name, ends, cand, opp)`` of one of ``CONSTRUCTED``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "offsets mod 32":  # long segments starting at every residue
        S, L = 4096, cases.SMALL["seq_length"]
        ends = cases.ends_table([[65] * 40 + [1496], [97] * 42])
        cand, opp = cases.clipped_bitmaps(rng, ends, S, L,
                                          cases.DENSITY["small"])
        return "small", ends, cand, opp
    if name == "last-bit trigger":
        # paper 8 KiB: the walk starts at k = sub_min = 4091 in the window
        # [3840, 4864) (W 256); the 51st opposing pair from k, the trigger
        # at T = 50, is the window's last position, 4863
        S, L = 16384, cases.PAPER8K["seq_length"]
        ends = cases.ends_table([[S], [6000, S - 6000]], 4)
        cand, opp = cases.clipped_bitmaps(rng, ends, S, L,
                                          cases.DENSITY["paper8k"])
        cand[:, 3840:4864] = False
        opp[:, 3840:4864] = False
        opp[:, 4813:4864] = True
        return ("paper8k",) + _clip(ends, cand, opp, L)
    if name == "carried c":  # fewer than T opposing pairs a window
        S, L = 16384, cases.PAPER8K["seq_length"]
        ends = cases.ends_table([[9000, 7000], [5000, 5000, 6384]])
        cand, opp = cases.clipped_bitmaps(rng, ends, S, L, (0.0003, 0.02))
        return "paper8k", ends, cand, opp
    if name == "max-size cut at end":
        # segments of max_size and its multiples with no bit set: every
        # chunk a max-size cut, the last one on the segment end
        S, L = 4096, cases.SMALL["seq_length"]
        ends = cases.ends_table([[512, 1024, 1536, 612, 400], [512] * 8])
        cand, opp = cases.clipped_bitmaps(rng, ends, S, L,
                                          cases.DENSITY["small"])
        cand[:, :3072] = opp[:, :3072] = False
        cand[1] = opp[1] = False
        return "small", ends, cand, opp
    if name == "G1 65536":  # one segment filling a row of the bound's width
        return ("small",) + cases.edge_case("G1", 1 << 16)
    raise KeyError(name)


@pytest.mark.parametrize("name", ("mixes",) + cases.EDGES
                         + ("random short 1",) + CONSTRUCTED)
def test_window_emulated_matches_reference(name):
    """The redesigned kernel's walk (window words from resident bytes at
    byte offsets, the prefix-rank trigger search, ``c`` carried across
    windows) gives the reference's bounds and counts, at a true and at a
    short table; the constructed rows reach the edges they were built
    for."""
    if name in CONSTRUCTED:
        pname, ends, cand, opp = _constructed(name)
        mc = cases.true_max_chunks(cand.shape[1], JPARAMS[pname].min_size,
                                   ends.shape[1])
    else:
        pname, ends, cand, opp, mc = _case(name)
    p = tp(pname)
    offsets = ([(a, 15 - a) for a in range(16)]
               if name == "offsets mod 32" else [(0, 0), (7, 12)])
    full = window_emulated(cand, opp, ends, p, mc, offsets[0])
    short = max(1, int(full[1].max()) - 2)
    for m in (mc, short):
        want_b, want_c = (np.asarray(t) for t in _jselect_packed(pname, m)(
            jnp.asarray(cand), jnp.asarray(opp), jnp.asarray(ends)))
        for i, off in enumerate(offsets):
            got_b, got_c, stats = window_emulated(cand, opp, ends, p, m, off,
                                                  seed=i)
            np.testing.assert_array_equal(got_c, want_c)
            np.testing.assert_array_equal(got_b, want_b)
    stats = full[2]
    if name == "offsets mod 32":
        st = np.concatenate([[0], ends[0, :-1]])
        long_ = (ends[0] - st) >= p.min_size
        assert set((st[long_] % 32).tolist()) == set(range(32))
    if name == "last-bit trigger":
        assert stats["last_bit"] >= 2
    if name == "carried c":
        assert stats["carried"] >= 1
    if name == "max-size cut at end":
        assert stats["cut_at_end"] >= 4 + 8


@pytest.mark.parametrize("name", ("mixes",) + cases.EDGES
                         + ("random short 1", "random short 3"))
def test_select_packed_cpu_route_matches_reference(name):
    pname, ends, cand, opp, mc = _case(name)
    got_b, got_c = kselp.select_boundaries_packed(
        torch.from_numpy(cand), torch.from_numpy(opp),
        torch.from_numpy(ends), tp(pname), max_chunks=mc)
    assert got_b.dtype == torch.int32 and got_c.dtype == torch.int32
    want_b, want_c = _jselect_packed(pname, mc)(
        jnp.asarray(cand), jnp.asarray(opp), jnp.asarray(ends))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    alone_b, alone_c = _segments_alone(cand, opp, ends, tp(pname), mc)
    np.testing.assert_array_equal(got_c.numpy(), alone_c)
    np.testing.assert_array_equal(got_b.numpy(), alone_b)
    if name == "G1":  # one segment filling the row: the unpacked automaton
        S = cand.shape[1]
        ub, uc = jax.jit(jax.vmap(lambda c, o: jautomaton.select_boundaries(
            c, o, S, JPARAMS[pname], max_chunks=mc)))(
                jnp.asarray(cand), jnp.asarray(opp))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(uc))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(ub))
    if name.startswith("random short"):
        assert int(got_c.max()) > mc  # emits were dropped


@pytest.mark.parametrize("select_impl", ["cuda", "bogus"])
def test_boundaries_packed_batch_select_impl(select_impl):
    """On CPU tensors ``select_impl="cuda"`` (the packed select kernel's
    wrapper, its plain version here) gives ``"torch"``'s bounds and
    counts; a name that is neither raises."""
    pname, S, rows = _packing_cases.case("random-increasing")
    p = repro_torch.params_from_reference(
        JParams(**_packing_cases.PARAMS[pname]))
    data, _, ends, _ = _packing_cases.pack(rows, S)
    x, e = torch.from_numpy(data), torch.from_numpy(ends)
    sep = segment_end_positions(e, S)
    mc = cases.true_max_chunks(S, p.min_size, ends.shape[1])
    if select_impl == "bogus":
        with pytest.raises(ValueError, match="select_impl"):
            boundaries_packed_batch(x, sep, e, p, select_impl=select_impl,
                                    max_chunks=mc)
        return
    got = boundaries_packed_batch(x, sep, e, p, select_impl=select_impl,
                                  max_chunks=mc)
    want = boundaries_packed_batch(x, sep, e, p, max_chunks=mc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_select_packed_wrapper_rejects_what_the_kernel_does_not_take():
    p = tp("small")
    e = torch.full((1, 4), 100, dtype=torch.int32)
    wide = torch.zeros((1, 1 << 17), dtype=torch.bool)
    with pytest.raises(ValueError, match="narrower"):
        kselp.select_boundaries_packed(wide, wide, e, p, max_chunks=8)
    x = torch.zeros((1, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bool"):
        kselp.select_boundaries_packed(x, x, e, p, max_chunks=8)
    b = torch.zeros((1, 1024), dtype=torch.bool)
    with pytest.raises(ValueError, match="bitmaps"):
        kselp.select_boundaries_packed(b, b[:, :512], e, p, max_chunks=8)


@pytest.mark.parametrize("n,G,min_size,device_ints", [
    (16 << 10, 16, 4096, 0),  # the scheduler's 16 KiB rows
    (1 << 16, 64, 4096, 0),  # a 64 KiB row at paper 8 KiB
    (1 << 16, 8175, 64, 0),  # the last G whose scratch fits beside the rows
    (1 << 16, 8176, 64, 2 * 8176 + 2 * 1024 + 1),
    (1 << 16, 1 << 16, 64, 2 * 65536 + 2 * 1024 + 1),  # one-byte segments
    (1, 1, 64, 0)])
def test_select_packed_wrapper_scratch_rule(n, G, min_size, device_ints):
    """The wrapper allocates device scratch only where the kernel's does
    not fit in shared memory beside both bitmap rows (the kernel's rule:
    2 * (ceil16(n) + 64) + 4 * ints bytes against 200 KiB)."""
    ints = kselp.scratch_ints(n, G, min_size)
    assert ints == 2 * G + 2 * (n // min_size) + 1
    assert kselp.device_scratch_ints(n, G, min_size) == device_ints
    region = ((n + 15) // 16) * 16 + 64
    assert (2 * region + 4 * ints <= kselp.SMEM_MAX) == (device_ints == 0)


@pytest.mark.parametrize("pipeline_impl,with_fp,calls", [
    ("split", True, True), ("split", False, True), ("fused", False, True),
    ("fused", True, False)])
def test_packed_dispatches_run_the_packed_select(monkeypatch, pipeline_impl,
                                                 with_fp, calls):
    """The scheduler's packed split and chunk-only dispatches run the
    automaton through the packed select kernel's wrapper (interposed
    here); with fingerprints the fused pipeline takes the packed kernel
    instead.  The streams' chunks equal each stream chunked alone."""
    seen = []
    real = kselp.select_boundaries_packed

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(kselp, "select_boundaries_packed", spy)
    p = tp("small")
    sched = ChunkScheduler(p, device="cpu", slots=2, min_bucket=4096,
                           packing_impl="segments",
                           pipeline_impl=pipeline_impl,
                           with_fingerprints=with_fp)
    rng = np.random.default_rng(9)
    streams = [rng.integers(0, 256, int(n), dtype=np.uint8)
               for n in rng.integers(100, 900, 12)]
    for s in streams:
        sched.submit(s)
    results = sched.drain()
    assert bool(seen) == calls
    assert sched.stats.packed_streams == len(streams)
    for s, r in zip(streams, results):
        assert r.bounds.tolist() == boundaries_numpy(s, p).tolist()
