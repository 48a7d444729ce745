"""The ``gather`` and ``event`` select kernels' wrappers against the JAX
reference, bit for bit, and their routes.

On the CPU each wrapper (``kernels/select_boundaries_gather.py``,
``kernels/select_boundaries_event.py``) takes its plain version,
``core.automaton.select_boundaries(step_impl=...)``, which these tests hold
against the reference's two-phase ``boundaries_batch`` and its hash
selector ``select_jax`` at a true and an undersized ``max_chunks``.  They
also check that every entry point reaches the wrapper of its step, that
the wrappers refuse what the kernels do not take, and, emulated in Python
integer arithmetic, the kernels' own table and search formulas (the
records of 1024 positions, the in-group prefixes, the next-candidate
entries, the rank searches) against the plain versions, and the node table
and chase the two kernels share (``chain_emulated``: every candidate's
emit walked on its own, the jump table, the anchored chase) against the
reference's ``select_boundaries``, on adversarial rows and at true and
undersized tables: a CUDA kernel cannot run here.  Every output is an
integer: tolerance 0.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import automaton as jautomaton
from repro.core import seqcdc as jseqcdc
from repro.core.baselines.selectors import SelectorParams as JSelectorParams
from repro.core.baselines.selectors import select_jax
from repro.core.params import SeqCDCParams as JParams

import repro_torch
from repro_torch.core import make_chunker
from repro_torch.core import seqcdc as tseqcdc
from repro_torch.core.automaton import _BIG, max_chunks_for
from repro_torch.core.automaton import select_boundaries as select_plain
from repro_torch.core.baselines import selectors as tselectors
from repro_torch.core.baselines.selectors import SelectorParams
from repro_torch.core.params import SeqCDCParams
from repro_torch.kernels import select_boundaries_event as kevent
from repro_torch.kernels import select_boundaries_gather as kgather
from repro_torch.kernels.boundary_chain import chain_k
from repro_torch.service import DedupService

STEPS = ("gather", "event")
WRAPPERS = {"gather": (kgather, "select_boundaries_gather"),
            "event": (kevent, "select_boundaries_event")}

# tests/test_torch_core.py's parameter sets
P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)
ALL_PARAMS = {
    "P": P,
    "P5": dataclasses.replace(P, seq_length=5),
    "dec": dataclasses.replace(P, mode="decreasing"),
    "skid": JParams(avg_size=4096, seq_length=5, skip_trigger=3,
                    skip_size=3000, min_size=2048, max_size=8192),
    "w16": JParams(avg_size=128, seq_length=6, skip_trigger=2, skip_size=16,
                   min_size=32, max_size=256),
    "w4": JParams(avg_size=128, seq_length=3, skip_trigger=1, skip_size=4,
                  min_size=32, max_size=256),
}
DENSITIES = [0.0, 1 / 2048, 1 / 16, 1.0]


def tp(p):
    return repro_torch.params_from_reference(p)


def adversarial_rows(rng, n: int) -> np.ndarray:
    """tests/test_torch_core.py's rows: random, constant, max-byte, both
    sawtooths and period-2."""
    idx = np.arange(n)
    return np.stack([
        rng.integers(0, 256, n, dtype=np.uint8),
        np.zeros(n, dtype=np.uint8),
        np.full(n, 255, dtype=np.uint8),
        (idx % 256).astype(np.uint8),
        (255 - idx % 256).astype(np.uint8),
        np.tile(np.array([1, 2], dtype=np.uint8), (n + 1) // 2)[:n],
    ])


def wrapper(step):
    mod, name = WRAPPERS[step]
    return getattr(mod, name)


def seqcdc_case(name, seed=0):
    p = ALL_PARAMS[name]
    d = adversarial_rows(np.random.default_rng(seed),
                         20000 if name == "skid" else 3000)
    cand, opp = tseqcdc._compute_masks(torch.from_numpy(d), tp(p), "torch")
    return p, d, cand, opp


def selector_bits(density, n=40_000):
    return np.random.default_rng(3).random(n) < density


# -- the wrappers against the reference ---------------------------------------

@pytest.mark.parametrize("name", sorted(ALL_PARAMS))
@pytest.mark.parametrize("step", STEPS)
def test_wrapper_matches_reference_on_seqcdc_bitmaps(step, name):
    p, d, cand, opp = seqcdc_case(name)
    n = d.shape[1]
    for mc in (None, 5):
        got_b, got_c = wrapper(step)(cand, opp, n, tp(p), max_chunks=mc)
        want_b, want_c = jseqcdc.boundaries_batch(
            jnp.asarray(d), p, step_impl=step, max_chunks=mc)
        assert got_b.dtype == torch.int32 and got_c.dtype == torch.int32
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("step", STEPS)
def test_wrapper_matches_reference_on_selector_bitmaps(step, density):
    """The hash chunkers' selector: a match bitmap, no opposing pairs, run
    length 1, T = 2^30 and skip 2^20."""
    bits = selector_bits(density)
    n = bits.size
    for mn, mx in ((1024, 4096), (2048, 3000)):
        x = torch.from_numpy(bits)[None]
        got_b, got_c = wrapper(step)(x, torch.zeros_like(x), n,
                                     SelectorParams(mn, mx))
        want_b, want_c = select_jax(jnp.asarray(bits), n, mn, mx,
                                    step_impl=step)
        np.testing.assert_array_equal(got_c.numpy(), [int(want_c)])
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b)[None])
        tb, tc = tselectors.select_torch(x[0], n, mn, mx, step_impl=step)
        assert torch.equal(tb, got_b[0]) and torch.equal(tc, got_c[0])


# -- the routes -----------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Each step's wrapper wrapped in a counter that calls through."""
    calls = {s: 0 for s in STEPS}
    for step, (mod, name) in WRAPPERS.items():
        real = getattr(mod, name)

        def spy(*a, _real=real, _step=step, **kw):
            calls[_step] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("step", STEPS)
def test_entry_points_reach_their_steps_wrapper(step, spies):
    assert tseqcdc.select_impl_for(step) == "cuda"
    p, d, cand, opp = seqcdc_case("P")
    n = d.shape[1]
    want = select_plain(cand, opp, n, tp(p), step_impl=step)
    got = tseqcdc.select(cand, opp, n, tp(p), select_impl="cuda",
                         step_impl=step)
    assert spies == {s: int(s == step) for s in STEPS}
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    data = np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.uint8)
    chunker = make_chunker("seqcdc", 4096, device="cpu", step_impl=step)
    assert np.array_equal(chunker.chunk(data),
                          make_chunker("seqcdc", 4096, device="cpu")
                          .chunk(data))
    assert spies[step] == 2

    bits = torch.from_numpy(selector_bits(1 / 16))
    tselectors.select_torch(bits, bits.numel(), 1024, 4096, step_impl=step)
    assert spies[step] == 3

    objs = [np.random.default_rng(i).integers(0, 256, m, dtype=np.uint8)
            for i, m in enumerate((700, 3000, 9000, 20000))]
    svc = DedupService(params=tp(P), device="cpu", slots=2, min_bucket=1024,
                       pipeline_impl="split", step_impl=step,
                       cross_check_pipeline=True)
    for i, o in enumerate(objs):
        svc.submit(str(i), o)
    svc.flush()
    assert spies[step] > 3
    assert spies[next(s for s in STEPS if s != step)] == 0
    for i, o in enumerate(objs):
        assert svc.get(str(i)) == o.tobytes()


@pytest.mark.parametrize("step", STEPS)
def test_wrappers_reject_what_the_kernels_do_not_take(step):
    fn = wrapper(step)
    p = tp(P)
    b = torch.zeros((2, 100), dtype=torch.bool)
    with pytest.raises(ValueError, match="bool"):
        fn(b.to(torch.uint8), b, 100, p)
    with pytest.raises(ValueError, match="bool"):
        fn(b, b.to(torch.int32), 100, p)
    with pytest.raises(ValueError, match="bool"):
        fn(b, b[:1], 100, p)  # shapes differ
    with pytest.raises(ValueError, match="bool"):
        fn(b, b, 99, p)  # not (B, n)
    with pytest.raises(ValueError, match="bool"):
        fn(b[0], b[0], 100, p)  # one row, no batch axis
    meta = torch.zeros((2, 100), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn(meta, meta, 100, p)
    with pytest.raises(ValueError, match="bool"):
        fn(b, meta, 100, p)  # on two devices


# -- the kernels' arithmetic, emulated ----------------------------------------

GROUP = 1024
NONE = 1 << 16  # the gather records' "no candidate in the words"


def words_of(row: np.ndarray, G: int) -> list:
    """bitmap_words.cuh's packing: (G, 32) words, bit q of word i of group
    g at position 1024g + 32i + q, zero past the row."""
    bits = np.zeros(G * GROUP, dtype=np.uint64)
    bits[: row.size] = row
    w = (bits.reshape(G, 32, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    return w.astype(np.uint64).tolist()


def popc(x: int) -> int:
    return bin(x).count("1")


def nth_bit(u: int, r: int) -> int:
    """wblock::nth_bit: the position of the r-th (1-based) set bit."""
    pos = 0
    for half in (16, 8, 4, 2, 1):
        cnt = popc(u & ((1 << half) - 1))
        if cnt < r:
            r -= cnt
            u >>= half
            pos += half
    return pos


def resolve(st, kc, kt, total, bend, p, n, mc, bnd):
    """wblock::resolve: the reference's ``_resolve`` and carry update for
    the W-block ending at ``bend`` that holds the scan position; returns
    0 (no emit), 1 (a cut) or 2 (a candidate's emit)."""
    k, c, s = st["k"], st["c"], st["s"]
    cut_b = min(s + p.max_size, n)
    cut_k = cut_b - (p.seq_length - 1)
    e_cut = max(cut_k, k)
    fire_cut = e_cut < bend and e_cut <= min(kc, kt)
    fire_cand = not fire_cut and kc < kt
    fire_trig = not fire_cut and not fire_cand and kt < _BIG
    emit_cut = fire_cut or (fire_trig and kt + p.skip_size >= cut_k)
    emit = emit_cut or fire_cand
    bound = cut_b if emit_cut else kc + p.seq_length
    st["k"] = (bound + p.sub_min_skip if emit else
               kt + p.skip_size if fire_trig else bend)
    st["c"] = 0 if (fire_cut or fire_cand or fire_trig) else c + total
    if emit:
        if st["cnt"] < mc:
            bnd[st["cnt"]] = bound
            st["last"] = bound
        st["cnt"] += 1
        st["s"] = bound
    return 0 if not emit else 1 if emit_cut else 2


def final_cut(st, n, mc, bnd):
    """wblock::final_cut: select_boundaries' fix-up."""
    cnt = st["cnt"]
    if (st["last"] if cnt > 0 else 0) < n:
        if cnt < mc:
            bnd[cnt] = n
        cnt += 1
    return cnt


class GatherTables:
    """select_boundaries_gather.cu's tables launch for one row: a record
    (cand, opp, ex, next) a group of 1024 positions."""

    def __init__(self, cand_row, opp_row, n):
        G = self.G = -(-n // GROUP)
        self.cw, self.ow = words_of(cand_row, G), words_of(opp_row, G)
        self.ex, self.nxt = [], []
        for g in range(G):
            e, acc = [], 0
            for i in range(32):
                e.append(acc)
                acc += popc(self.ow[g][i])
            self.ex.append(e)
            row, best = [0] * 32, NONE
            for i in range(31, -1, -1):
                if self.cw[g][i]:
                    best = min(best, 32 * i + nth_bit(self.cw[g][i], 1))
                row[i] = best
            self.nxt.append(row)

    def opp_before(self, g, x):
        if x >= GROUP:
            return self.ex[g][31] + popc(self.ow[g][31])
        w = x >> 5
        return self.ex[g][w] + popc(self.ow[g][w] & ((1 << (x & 31)) - 1))

    def first_cand(self, g, q):
        """The group-relative first candidate at or after q, or NONE."""
        m = self.cw[g][q >> 5] & ((0xFFFFFFFF << (q & 31)) & 0xFFFFFFFF)
        if m:
            return (q & ~31) + nth_bit(m, 1)
        return self.nxt[g][(q >> 5) + 1] if (q >> 5) < 31 else NONE

    def block(self, st, p):
        """The walk's reads for the W-block holding the scan position:
        (kc, kt, total, bend)."""
        W = p.block_width
        bstart = st["k"] & ~(W - 1)
        g, gb = bstart // GROUP, bstart % GROUP
        o = st["k"] - bstart
        kc = kt = _BIG
        total = 0
        if g < self.G:
            q = gb + o
            kcg = self.first_cand(g, q)
            if kcg < gb + W:
                kc = bstart + (kcg - gb)
            p_b, p_q = self.opp_before(g, gb), self.opp_before(g, q)
            p_e = self.opp_before(g, gb + W)
            rank = p.skip_trigger - st["c"] + (p_q - p_b)
            if rank < p_e - p_b:
                want = p_b + rank
                lo, hi = gb >> 5, (gb + W - 1) >> 5
                while lo < hi:
                    mid = (lo + hi + 1) >> 1
                    if self.ex[g][mid] <= want:
                        lo = mid
                    else:
                        hi = mid - 1
                ktg = 32 * lo + nth_bit(self.ow[g][lo],
                                        want - self.ex[g][lo] + 1)
                if ktg - gb >= o:
                    kt = bstart + (ktg - gb)
            total = p_e - p_q
        return kc, kt, total, bstart + W


def gather_cover(n, p):
    """The plain automaton's padded block range (core/automaton.py)."""
    W = p.block_width
    return (n + p.skip_size + W + W - 1) // W * W


def gather_emulated(cand_row, opp_row, n, p, mc):
    """The gather step as one serial walk a row: the tables launch's
    records and the per-block reads, block after block (what every node of
    chain_emulated runs from its own start)."""
    t = GatherTables(cand_row, opp_row, n)
    cover = gather_cover(n, p)
    bnd = [_BIG] * mc
    st = dict(k=p.sub_min_skip, c=0, s=0, cnt=0, last=0)
    while st["s"] < n and st["k"] < cover:
        kc, kt, total, bend = t.block(st, p)
        resolve(st, kc, kt, total, bend, p, n, mc, bnd)
    return bnd, final_cut(st, n, mc, bnd)


class EventTables:
    """select_boundaries_event.cu's prefix and scan launches for one row:
    the words, their in-group prefixes and the groups' scanned totals,
    and the walk's searches (the first 32-group probe, then the 32-way
    search)."""

    def __init__(self, cand_row, opp_row, n):
        G = self.G = -(-n // GROUP)
        self.words = [words_of(cand_row, G), words_of(opp_row, G)]
        self.ex = [[[sum(popc(wf[g][j]) for j in range(i))
                     for i in range(32)] for g in range(G)]
                   for wf in self.words]
        self.sums = [[0] * (G + 1) for _ in range(2)]
        for f in range(2):
            for g in range(G):
                self.sums[f][g + 1] = (self.sums[f][g] + self.ex[f][g][31]
                                       + popc(self.words[f][g][31]))
        self.total = [self.sums[0][G], self.sums[1][G]]

    def prefix_at(self, x, f):
        g = x // GROUP
        if g >= self.G:
            return self.sums[f][self.G]
        w = (x >> 5) & 31
        return (self.sums[f][g] + self.ex[f][g][w]
                + popc(self.words[f][g][w] & ((1 << (x & 31)) - 1)))

    def find_rank(self, g0, r, f):
        G, sums = self.G, self.sums[f]
        past = [g0 + 1 + lane >= G or sums[g0 + 1 + lane] > r
                for lane in range(32)]
        if any(past):
            g = g0 + past.index(True)
        else:
            lo, hi = g0 + 32, G
            while hi - lo > 1:
                stride = (hi - lo + 31) // 32
                over = [lo + stride * (lane + 1) >= hi
                        or sums[lo + stride * (lane + 1)] > r
                        for lane in range(32)]
                lane = over.index(True)
                lo, hi = lo + stride * lane, min(lo + stride * (lane + 1), hi)
            g = lo
        rr = r - sums[g]
        w = sum(e <= rr for e in self.ex[f][g]) - 1
        return g * GROUP + 32 * w + nth_bit(self.words[f][g][w],
                                           rr - self.ex[f][g][w] + 1)

    def event(self, k, s, n, p):
        """One iteration of the walk from (k, s): ("cut", bound),
        ("cand", bound) or ("skip", new k)."""
        L = p.seq_length
        kk = min(max(k, 0), n)
        g0 = kk // GROUP
        kc = kt = None
        if g0 < self.G:  # group_events: the group holding kk, no prefix
            keep = [0 if i < (kk % GROUP) >> 5 else 0xFFFFFFFF
                    if i > (kk % GROUP) >> 5 else
                    (0xFFFFFFFF << (kk & 31)) & 0xFFFFFFFF
                    for i in range(32)]
            cm = [w & m for w, m in zip(self.words[0][g0], keep)]
            om = [w & m for w, m in zip(self.words[1][g0], keep)]
            lanes = [i for i in range(32) if cm[i]]
            if lanes:
                kc = g0 * GROUP + 32 * lanes[0] + nth_bit(cm[lanes[0]], 1)
            need, excl = p.skip_trigger + 1, 0
            for i in range(32):
                if excl < need <= excl + popc(om[i]):
                    kt = g0 * GROUP + 32 * i + nth_bit(om[i], need - excl)
                excl += popc(om[i])
        if kc is None:
            rank_c = self.prefix_at(kk, 0)
            kc = (self.find_rank(g0, rank_c, 0) if rank_c < self.total[0]
                  else _BIG)
        if kt is None:
            want = self.prefix_at(kk, 1) + p.skip_trigger + 1
            kt = (self.find_rank(g0, want - 1, 1) if want <= self.total[1]
                  else _BIG)
        cut_b = min(s + p.max_size, n)
        e_cut = max(cut_b - (L - 1), k)
        if e_cut <= min(kc, kt):
            return "cut", cut_b
        if kc < kt:
            return "cand", kc + L
        return "skip", kt + p.skip_size


def event_emulated(cand_row, opp_row, n, p, mc):
    """The event step as one serial walk a row: one iteration an event,
    to max_chunks emits (what every node of chain_emulated runs from its
    own start)."""
    t = EventTables(cand_row, opp_row, n)
    bnd = [_BIG] * mc
    k, s, cnt, last = p.sub_min_skip, 0, 0, 0
    while s < n and cnt < mc:
        kind, v = t.event(k, s, n, p)
        if kind == "skip":
            k = v
            continue
        bnd[cnt] = v
        cnt += 1
        s = last = v
        k = v + p.sub_min_skip
    if (last if cnt > 0 else 0) < n and n > 0:
        if cnt < mc:
            bnd[cnt] = n
        cnt += 1
    return bnd, cnt


# -- the node table and the chase (boundary_chain.cuh), emulated -------------

END = -1  # a node whose walk ends the row without a candidate's emit
CHAIN_WINDOW = 4096  # positions a node CTA enumerates
CHASE_THREADS = 256  # anchors a batch of the chase


def gather_node_walk(t, n, p, cover):
    """The gather node launch's walk from an emit at b: the one-row walk
    from (b + sub_min, 0, b) to the first candidate's emit, skipping a
    group whose rest holds no candidate, no trigger and no cut."""
    def walk(b):
        st = dict(k=b + p.sub_min_skip, c=0, s=b, cnt=0, last=0)
        while st["s"] < n and st["k"] < cover:
            k = st["k"]
            g = k // GROUP
            gend = (g + 1) * GROUP
            cut_b = min(st["s"] + p.max_size, n)
            if max(cut_b - (p.seq_length - 1), k) >= gend:
                if g >= t.G:
                    st["k"] = gend
                    continue
                q = k - g * GROUP
                rest = t.opp_before(g, GROUP) - t.opp_before(g, q)
                if (t.first_cand(g, q) == NONE
                        and st["c"] + rest <= p.skip_trigger):
                    st["c"] += rest
                    st["k"] = gend
                    continue
            kc, kt, total, bend = t.block(st, p)
            if resolve(st, kc, kt, total, bend, p, n, 0, None) == 2:
                return st["s"]
        return END
    return walk


def event_node_walk(t, n, p):
    """The event node launch's walk from an emit at b: events from
    (b + sub_min, 0, b) to the first candidate's emit."""
    def walk(b):
        k, s = b + p.sub_min_skip, b
        while s < n:
            kind, v = t.event(k, s, n, p)
            if kind == "cand":
                return v
            if kind == "cut":
                s, k = v, v + p.sub_min_skip
            else:
                k = v
        return END
    return walk


def chain_emulated(step, cand_row, opp_row, n, p, mc, stats=None):
    """Both kernels' three stages for one row, as boundary_chain.cuh runs
    them: every node's next candidate's emit (the node launch, window by
    window), every node's K-th successor with the emits on the way (the
    jump launch), then the chase: anchors a jump apart, each expanded K
    edges (cuts b + j * max_size between an emit at b and the next), the
    last node's run of cuts, select_boundaries' fix-up.  ``stats`` gets
    the nodes, the chase's serial hops and the edges expanded."""
    L, mx = p.seq_length, p.max_size
    if step == "gather":
        walk = gather_node_walk(GatherTables(cand_row, opp_row, n), n, p,
                                gather_cover(n, p))
        lim = min(n, gather_cover(n, p) - p.sub_min_skip)
    else:
        walk = event_node_walk(EventTables(cand_row, opp_row, n), n, p)
        lim = n
    count_all = step == "gather"
    nodes = [0] if lim > 0 else []
    cands = np.flatnonzero(cand_row[:n])
    nodes += [int(c) + L for c in cands if c + L < lim]
    nxt = {x: walk(x) for x in nodes}
    K = chain_k(n, p)
    jmp = {}
    for x in nodes:
        z, cnt = x, 0
        for _ in range(K):
            if z >= lim or nxt[z] == END:
                break
            cnt += -(-(nxt[z] - z) // mx)
            z = nxt[z]
        jmp[x] = (z, cnt)

    bnd = [_BIG] * mc

    def put(i, v):
        if i < mc:
            bnd[i] = v

    x = idx = hops = edges = 0
    done = last_end = False
    while not done:
        anchors = []
        while len(anchors) < CHASE_THREADS:
            if x >= lim or (not count_all and idx >= mc):
                done = True
                break
            z, cnt = jmp[x]
            hops += 1
            if z == x:  # x's walk ends the row
                done = last_end = True
                break
            if idx < mc:
                anchors.append((x, idx))
            idx, x = idx + cnt, z
        for z, i in anchors:  # the batch's expansions, a thread each
            for _ in range(K):
                if z >= lim or i >= mc or nxt[z] == END:
                    break
                v = nxt[z]
                for cut in range(z + mx, v, mx):
                    put(i, cut)
                    i += 1
                put(i, v)
                i += 1
                z = v
                edges += 1
    total = idx
    if last_end:  # cuts to n, or to the gather walk's cover stop
        j = -(-(lim - x) // mx)
        for jj in range(1, min(j, mc - idx) + 1):
            put(idx + jj - 1, min(x + jj * mx, n))
        total += j
    count = total if count_all else min(total, mc)
    last = bnd[min(count, mc) - 1] if count > 0 else 0
    if last < n:
        put(count, n)
        count += 1
    if stats is not None:
        stats.update(nodes=len(nodes), hops=hops, edges=edges, K=K)
    return bnd, count


EMULATED = {"gather": gather_emulated, "event": event_emulated}


def _emulated_equal(step, cand, opp, n, p, mc):
    want_b, want_c = select_plain(cand, opp, n, p, step_impl=step,
                                  max_chunks=mc)
    for r in range(cand.shape[0]):
        b, c = EMULATED[step](cand[r].numpy(), opp[r].numpy(), n, p, mc)
        assert c == int(want_c[r]), (r, c, int(want_c[r]))
        assert b == want_b[r].tolist(), r


@pytest.mark.parametrize("name", sorted(ALL_PARAMS))
@pytest.mark.parametrize("step", STEPS)
def test_kernel_arithmetic_on_seqcdc_bitmaps(step, name):
    """The kernels' formulas on the adversarial rows' bitmaps (W from 4 to
    1024 positions, blocks below one word among them), at a true and an
    undersized table, and on a ragged row shorter than one group."""
    p, d, cand, opp = seqcdc_case(name, seed=1)
    p = tp(p)
    n = d.shape[1]
    for mc in (max_chunks_for(n, p), 5):
        _emulated_equal(step, cand, opp, n, p, mc)
    _emulated_equal(step, cand[:, :1000].contiguous(),
                    opp[:, :1000].contiguous(), 1000, p,
                    max_chunks_for(1000, p))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("step", STEPS)
def test_kernel_arithmetic_on_selector_bitmaps(step, density):
    """Selector rows: T = 2^30 (the trigger's rank far past any total) and
    sparse rows whose next candidate lies more than 32 groups ahead (the
    event walk's 32-way search)."""
    n = 70_001
    bits = torch.from_numpy(selector_bits(density, n))[None]
    p = SelectorParams(min_size=1024, max_size=60_000)
    _emulated_equal(step, bits, torch.zeros_like(bits), n, p,
                    max_chunks_for(n, p))


@pytest.mark.parametrize("step", STEPS)
def test_kernel_arithmetic_edges(step):
    """All-zero and all-one bitmaps, rows shorter than one W-block, an
    exact group multiple, and a first W-block behind the min-size skip."""
    p = tp(ALL_PARAMS["skid"])  # sub_min_skip 2043 > W
    for n in (1, 5, 300, 1024, 2048, 5000):
        for fill in (False, True):
            cand = torch.full((1, n), fill, dtype=torch.bool)
            for opp in (torch.zeros_like(cand), cand.clone()):
                _emulated_equal(step, cand, opp, n, p, max_chunks_for(n, p))


@pytest.mark.parametrize("step", STEPS)
def test_kernel_arithmetic_far_events(step):
    """A next candidate and a trigger pair more than 32 groups past the
    scan position (the event walk's 32-way search), in sparse rows."""
    n = 200_000
    cand = torch.zeros((1, n), dtype=torch.bool)
    cand[0, [50_000, 69_000, 150_001]] = True
    sel = SelectorParams(min_size=100, max_size=120_000)
    _emulated_equal(step, cand, torch.zeros_like(cand), n, sel,
                    max_chunks_for(n, sel))
    opp = torch.zeros_like(cand)
    opp[0, [40_000, 41_000, 90_500, 90_501, 180_000]] = True
    p = SeqCDCParams(avg_size=8192, seq_length=3, skip_trigger=1,
                     skip_size=512, min_size=1024, max_size=120_000)
    for mc in (max_chunks_for(n, p), 2):
        _emulated_equal(step, cand, opp, n, p, mc)


# -- the node table and the chase against the reference ------------------------

@functools.partial(jax.jit, static_argnames=("n", "p", "step", "mc"))
def _reference_rows(cand, opp, n, p, step, mc):
    """The reference's select_boundaries on each row of (B, n) bitmaps."""
    return jax.vmap(lambda c, o: jautomaton.select_boundaries(
        c, o, n, p, step_impl=step, max_chunks=mc))(cand, opp)


def _chain_equal(step, cand, opp, n, p, reference, mcs=(None, 5, 1)):
    """chain_emulated on every row against ``reference(mc)``'s (bounds,
    counts), at each table (None: a true one)."""
    cand, opp = np.asarray(cand, bool), np.asarray(opp, bool)
    for mc in mcs:
        mc = mc or max_chunks_for(n, p)
        want_b, want_c = (np.asarray(t) for t in reference(mc))
        for r in range(cand.shape[0]):
            b, c = chain_emulated(step, cand[r], opp[r], n, p, mc)
            assert c == int(want_c[r]), (r, mc, c, int(want_c[r]))
            assert b == want_b[r].tolist(), (r, mc)


@pytest.mark.parametrize("name", sorted(ALL_PARAMS))
@pytest.mark.parametrize("step", STEPS)
def test_chain_matches_reference_on_seqcdc_bitmaps(step, name):
    """The node table and chase on the adversarial rows' SeqCDC bitmaps
    (W from 4 to 1024 positions) against the reference's two-phase
    boundaries_batch, at a true table and at 5 and 1."""
    p, d, cand, opp = seqcdc_case(name)
    n = d.shape[1]
    _chain_equal(step, cand.numpy(), opp.numpy(), n, tp(p),
                 lambda mc: jseqcdc.boundaries_batch(
                     jnp.asarray(d), p, step_impl=step, max_chunks=mc))


def _reference(step, cand, opp, n, jp):
    return lambda mc: _reference_rows(jnp.asarray(cand), jnp.asarray(opp),
                                      n, jp, step, mc)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("step", STEPS)
def test_chain_matches_reference_on_selector_bitmaps(step, density):
    """The hash chunkers' selector rows (L = 1, T = 2^30, skip 2^20): no
    opposing pair, every candidate a node."""
    bits = selector_bits(density)[None]
    n, zeros = bits.shape[1], np.zeros_like(bits)
    jp = JSelectorParams(min_size=1024, max_size=4096)
    _chain_equal(step, bits, zeros, n, SelectorParams(1024, 4096),
                 _reference(step, bits, zeros, n, jp))


#: the edge rows' parameter sets: W 32; a cover stop (sub_min 125 past
#: skip 8 + W 8: the gather walk's padded range ends before n); the
#: selector's T = 2^30 (W 512)
CHAIN_EDGE_PARAMS = {
    "P": P,
    "cover": JParams(avg_size=256, seq_length=3, skip_trigger=2,
                     skip_size=8, min_size=128, max_size=200),
    "selector": JSelectorParams(min_size=1024, max_size=1500),
}


@pytest.mark.parametrize("pname", sorted(CHAIN_EDGE_PARAMS))
@pytest.mark.parametrize("step", STEPS)
def test_chain_matches_reference_on_edge_rows(step, pname):
    """All-candidate rows (a node at every position), candidate-free rows
    (cut runs to n, with and without opposing pairs), dense and sparse
    random rows; n = 0 (not for the selector: its 2^20 padding folds to
    constants), n below W, and n = 3 * max_size (the candidate-free rows
    cut exactly at n; not a multiple of 1024); at a true table and at 5
    and 1."""
    jp = CHAIN_EDGE_PARAMS[pname]
    p = (SelectorParams(jp.min_size, jp.max_size) if pname == "selector"
         else tp(jp))
    rng = np.random.default_rng(11)
    for n in (0, 5, 3 * jp.max_size)[pname == "selector":]:
        ones, zeros = np.ones((1, n), bool), np.zeros((1, n), bool)
        cand = np.concatenate([ones, zeros, zeros, rng.random((2, n)) < 0.05,
                               rng.random((1, n)) < 0.002])
        opp = np.concatenate([zeros, zeros, ones, rng.random((2, n)) < 0.3,
                              zeros])
        _chain_equal(step, cand, opp, n, p,
                     _reference(step, cand, opp, n, jp))
