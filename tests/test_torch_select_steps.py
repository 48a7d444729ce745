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
entries, the rank searches) against the plain versions: a CUDA kernel
cannot run here.  Every output is an integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import seqcdc as jseqcdc
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
    the W-block ending at ``bend`` that holds the scan position."""
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


def final_cut(st, n, mc, bnd):
    """wblock::final_cut: select_boundaries' fix-up."""
    cnt = st["cnt"]
    if (st["last"] if cnt > 0 else 0) < n:
        if cnt < mc:
            bnd[cnt] = n
        cnt += 1
    return cnt


def gather_emulated(cand_row, opp_row, n, p, mc):
    """select_boundaries_gather.cu for one row: the tables launch's records
    (cand, opp, ex, next) and the walk's per-block reads."""
    G = -(-n // GROUP)
    cw, ow = words_of(cand_row, G), words_of(opp_row, G)
    ex, nxt = [], []
    for g in range(G):
        e, acc = [], 0
        for i in range(32):
            e.append(acc)
            acc += popc(ow[g][i])
        ex.append(e)
        row, best = [0] * 32, NONE
        for i in range(31, -1, -1):
            if cw[g][i]:
                best = min(best, 32 * i + nth_bit(cw[g][i], 1))
            row[i] = best
        nxt.append(row)

    def opp_before(g, x):
        if x >= GROUP:
            return ex[g][31] + popc(ow[g][31])
        w = x >> 5
        return ex[g][w] + popc(ow[g][w] & ((1 << (x & 31)) - 1))

    W = p.block_width
    cover = (n + p.skip_size + W + W - 1) // W * W
    bnd = [_BIG] * mc
    st = dict(k=p.sub_min_skip, c=0, s=0, cnt=0, last=0)
    while st["s"] < n and st["k"] < cover:
        bstart = st["k"] & ~(W - 1)
        g, gb = bstart // GROUP, bstart % GROUP
        o = st["k"] - bstart
        kc = kt = _BIG
        total = 0
        if g < G:
            q = gb + o
            m = cw[g][q >> 5] & ((0xFFFFFFFF << (q & 31)) & 0xFFFFFFFF)
            kcg = ((q & ~31) + nth_bit(m, 1) if m else
                   nxt[g][(q >> 5) + 1] if (q >> 5) < 31 else NONE)
            if kcg < gb + W:
                kc = bstart + (kcg - gb)
            p_b, p_q = opp_before(g, gb), opp_before(g, q)
            p_e = opp_before(g, gb + W)
            rank = p.skip_trigger - st["c"] + (p_q - p_b)
            if rank < p_e - p_b:
                want = p_b + rank
                lo, hi = gb >> 5, (gb + W - 1) >> 5
                while lo < hi:
                    mid = (lo + hi + 1) >> 1
                    if ex[g][mid] <= want:
                        lo = mid
                    else:
                        hi = mid - 1
                ktg = 32 * lo + nth_bit(ow[g][lo], want - ex[g][lo] + 1)
                if ktg - gb >= o:
                    kt = bstart + (ktg - gb)
            total = p_e - p_q
        resolve(st, kc, kt, total, bstart + W, p, n, mc, bnd)
    return bnd, final_cut(st, n, mc, bnd)


def event_emulated(cand_row, opp_row, n, p, mc):
    """select_boundaries_event.cu for one row: the prefix launch's words,
    in-group prefixes and group totals, the walk's scan of the totals and
    its searches (the first 32-group probe, then the 32-way search)."""
    G = -(-n // GROUP)
    words = [words_of(cand_row, G), words_of(opp_row, G)]
    ex = [[[sum(popc(wf[g][j]) for j in range(i)) for i in range(32)]
           for g in range(G)] for wf in words]
    sums = [[0] * (G + 1) for _ in range(2)]
    for f in range(2):
        for g in range(G):
            sums[f][g + 1] = sums[f][g] + ex[f][g][31] + popc(words[f][g][31])
    total = [sums[0][G], sums[1][G]]

    def prefix_at(x, f):
        g = x // GROUP
        if g >= G:
            return sums[f][G]
        w = (x >> 5) & 31
        return (sums[f][g] + ex[f][g][w]
                + popc(words[f][g][w] & ((1 << (x & 31)) - 1)))

    def find_rank(g0, r, f):
        past = [g0 + 1 + lane >= G or sums[f][g0 + 1 + lane] > r
                for lane in range(32)]
        if any(past):
            g = g0 + past.index(True)
        else:
            lo, hi = g0 + 32, G
            while hi - lo > 1:
                stride = (hi - lo + 31) // 32
                over = [lo + stride * (lane + 1) >= hi
                        or sums[f][lo + stride * (lane + 1)] > r
                        for lane in range(32)]
                lane = over.index(True)
                lo, hi = lo + stride * lane, min(lo + stride * (lane + 1), hi)
            g = lo
        rr = r - sums[f][g]
        w = sum(e <= rr for e in ex[f][g]) - 1
        return g * GROUP + 32 * w + nth_bit(words[f][g][w], rr - ex[f][g][w]
                                           + 1)

    L, T = p.seq_length, p.skip_trigger
    bnd = [_BIG] * mc
    k, s, cnt, last = p.sub_min_skip, 0, 0, 0
    while s < n and cnt < mc:
        kk = min(max(k, 0), n)
        g0 = kk // GROUP
        rank_c, rank_o = prefix_at(kk, 0), prefix_at(kk, 1)
        kc = find_rank(g0, rank_c, 0) if rank_c < total[0] else _BIG
        want = rank_o + T + 1
        kt = find_rank(g0, want - 1, 1) if want <= total[1] else _BIG
        cut_b = min(s + p.max_size, n)
        e_cut = max(cut_b - (L - 1), k)
        fire_cut = e_cut <= min(kc, kt)
        if fire_cut or kc < kt:
            bound = cut_b if fire_cut else kc + L
            bnd[cnt] = bound
            cnt += 1
            s = last = bound
            k = bound + p.sub_min_skip
        else:
            k = kt + p.skip_size
    if (last if cnt > 0 else 0) < n and n > 0:
        if cnt < mc:
            bnd[cnt] = n
        cnt += 1
    return bnd, cnt


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
