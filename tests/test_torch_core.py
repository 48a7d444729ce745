"""The port's chunking core against the JAX reference, bit for bit.

Parameters, the numpy oracle, the phase-1 masks (plain torch and the CUDA
kernel's wrapper, which takes the plain version for CPU tensors) and the
two-phase ``boundaries_batch`` (the ``wide``, ``gather`` and ``event``
automaton steps) are fed the same seeded numpy inputs as ``repro``'s
functions; every output is an integer or a bit, so the tolerance is 0.
The JAX mask kernel runs as its own tests run it, in Pallas interpret
mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import masks as jmasks
from repro.core import oracle as joracle
from repro.core import seqcdc as jseqcdc
from repro.core.params import SeqCDCParams as JParams
from repro.core.params import derived_params as jderived
from repro.core.params import paper_params as jpaper
from repro.dedup.index import dedup_stats as jdedup_stats
from repro.kernels.seqcdc_masks import seqcdc_masks_pallas

import repro_torch
from repro_torch.core import masks as tmasks
from repro_torch.core import oracle as toracle
from repro_torch.core import seqcdc as tseqcdc
from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.params import derived_params, paper_params
from repro_torch.dedup.index import dedup_stats, space_savings
from repro_torch.kernels import seqcdc_masks as kmasks

# the small parameter sets of tests/test_fused_pipeline.py
P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)
P5 = JParams(avg_size=256, seq_length=5, skip_trigger=6, skip_size=32,
             min_size=64, max_size=512)
P_DEC = dataclasses.replace(P, mode="decreasing")
#: skip_size > min_size: overshooting skips resolved as cuts
P_SKID = JParams(avg_size=4096, seq_length=5, skip_trigger=3,
                 skip_size=3000, min_size=2048, max_size=8192)
#: block_width 16 and 4: W below one 32-bit mask word
P_W16 = JParams(avg_size=128, seq_length=6, skip_trigger=2, skip_size=16,
                min_size=32, max_size=256)
P_W4 = JParams(avg_size=128, seq_length=3, skip_trigger=1, skip_size=4,
               min_size=32, max_size=256)

ALL_PARAMS = {"P": P, "P5": P5, "dec": P_DEC, "skid": P_SKID,
              "w16": P_W16, "w4": P_W4}


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done.  The reference's
    module-level jits (its scheduler's ``_device_chunk_packed`` among them)
    would keep this file's traces, and a reference test that runs later in
    the same process and monkeypatches what such a jit calls would hit the
    cached trace and never see its patch."""
    yield
    jax.clear_caches()


def tp(p):
    return repro_torch.params_from_reference(p)


def adversarial_rows(rng, n: int) -> np.ndarray:
    """Random, constant, max-byte, both sawtooths and period-2 rows."""
    idx = np.arange(n)
    return np.stack([
        rng.integers(0, 256, n, dtype=np.uint8),
        np.zeros(n, dtype=np.uint8),  # forced max-size cuts only
        np.full(n, 255, dtype=np.uint8),
        (idx % 256).astype(np.uint8),
        (255 - idx % 256).astype(np.uint8),
        np.tile(np.array([1, 2], dtype=np.uint8), (n + 1) // 2)[:n],
    ])


# -- parameters and oracle ----------------------------------------------------

@pytest.mark.parametrize("mode", ["increasing", "decreasing"])
def test_params_match_reference(mode):
    for avg in (4096, 8192, 16384):
        want = jpaper(avg, mode)
        got = paper_params(avg, mode)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.sub_min_skip, got.block_width) == (
            want.sub_min_skip, want.block_width)
        assert tp(want) == got
    for avg in (2048, 12288, 32768, 65536):
        assert dataclasses.asdict(derived_params(avg, mode)) == \
            dataclasses.asdict(jderived(avg, mode))
    for p in ALL_PARAMS.values():
        assert tp(p).block_width == p.block_width
        assert tp(dataclasses.asdict(p)) == tp(p)
    with pytest.raises(KeyError):
        paper_params(1234)
    with pytest.raises(ValueError):
        repro_torch.SeqCDCParams(seq_length=1)


@pytest.mark.parametrize("name", ["P", "dec", "skid"])
def test_oracle_matches_reference(name, rng):
    p = ALL_PARAMS[name]
    for n in (0, 1, 5, 64, 65, 3000):
        for row in adversarial_rows(rng, max(n, 1))[:, :n]:
            assert toracle.boundaries_slow(row, tp(p)) == \
                joracle.boundaries_slow(row, p)
            np.testing.assert_array_equal(
                toracle.boundaries_numpy(row, tp(p)),
                joracle.boundaries_numpy(row, p))


# -- phase 1: masks -------------------------------------------------------------

@pytest.mark.parametrize("L", [2, 3, 5])
@pytest.mark.parametrize("mode", ["increasing", "decreasing"])
def test_masks_match_reference(L, mode, rng):
    # an empty stream has empty bitmaps (the reference's pad would give
    # them one padding column; its callers never pass n = 0)
    empty = tmasks.seqcdc_masks(torch.zeros((6, 0), dtype=torch.uint8), L,
                                mode)
    assert [tuple(m.shape) for m in empty] == [(6, 0), (6, 0)]
    for n in (1, 2, L, 1000):
        d = adversarial_rows(rng, max(n, 1))[:, :n]
        want_c, want_o = jmasks.seqcdc_masks(jnp.asarray(d), L, mode)
        got_c, got_o = tmasks.seqcdc_masks(torch.from_numpy(d), L, mode)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        assert got_c.dtype == torch.bool and got_o.dtype == torch.bool


@pytest.mark.parametrize("n", [1, 5, 1023, 5000])
def test_mask_kernel_wrapper_matches_pallas(n, rng):
    """The CUDA kernel's wrapper, given a CPU tensor, takes the plain
    version; it equals the Pallas kernel row by row (interpret mode)."""
    d = adversarial_rows(rng, n)
    for L, mode in ((3, "increasing"), (5, "decreasing")):
        got_c, got_o = kmasks.seqcdc_masks(torch.from_numpy(d), L, mode)
        for i, row in enumerate(d):
            wc, wo = seqcdc_masks_pallas(jnp.asarray(row), L, mode,
                                         interpret=True)
            np.testing.assert_array_equal(got_c[i].numpy(), np.asarray(wc))
            np.testing.assert_array_equal(got_o[i].numpy(), np.asarray(wo))
    # the 1-D form the reference kernel takes
    c1, o1 = kmasks.seqcdc_masks(torch.from_numpy(d[0]), 3)
    wc, wo = seqcdc_masks_pallas(jnp.asarray(d[0]), 3, interpret=True)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(wo))


def _shift_zero(w: torch.Tensor, c: int) -> torch.Tensor:
    """``w >> c`` on bit windows stored as bool columns (bit 0 first)."""
    out = torch.zeros_like(w)
    if c < w.shape[1]:
        out[:, : w.shape[1] - c] = w[:, c:]
    return out


def _run_and(w: torch.Tensor, n: int) -> torch.Tensor:
    """Bit q of the result is the AND of bits q..q+n-1 of ``w``, by
    log-doubling then one last shift: csrc/seqcdc_masks.cu ``run_and``."""
    c = 1
    while 2 * c <= n:
        w = w & _shift_zero(w, c)
        c *= 2
    if c < n:
        w = w & _shift_zero(w, n - c)
    return w


def _masks_by_windows(d: np.ndarray, L: int, mode: str, m: int):
    """The masks kernel's arithmetic in torch: the (B, S) batch as one flat
    stream starting m bytes past a 16-byte boundary; block t holds flat
    bytes [16t - m, 16t - m + 16) (zero outside the stream) and gives 16
    forward and 16 opposing pair bits; output lane t's window is the next
    five blocks' forward bits shifted down by m, its candidates the
    log-doubled AND of L - 1 window bits, its opposing bits blocks t and t+1
    shifted by m; row tails are zeroed by position mod S.  The kernel's
    window is 64 bits (L - 1 <= 48); a longer L takes as many blocks as it
    needs here."""
    B, S = d.shape
    N = B * S
    T = -(-N // 16)  # output lanes
    ahead = max(4, -(-(15 + L - 1) // 16))  # blocks a window reads
    buf = torch.zeros(16 * (T + ahead + 2), dtype=torch.int16)
    buf[m: m + N] = torch.from_numpy(d.reshape(-1).astype(np.int16))
    gt = buf[1:] > buf[:-1]
    lt = buf[1:] < buf[:-1]
    fwd, opp = (gt, lt) if mode == "increasing" else (lt, gt)
    blocks = T + ahead + 1
    F = fwd[: 16 * blocks].view(blocks, 16)  # F[t, j]: pair at 16t - m + j
    O = opp[: 16 * blocks].view(blocks, 16)
    cat = torch.cat([F[k: k + T] for k in range(ahead + 1)], dim=1)
    width = 64 if L - 1 <= 48 else 16 * ahead
    win = cat[:, m: m + width]
    cand = _run_and(win, L - 1)[:, :16]
    o = torch.cat([O[:T], O[1: T + 1]], dim=1)[:, m: m + 16]
    k = torch.arange(16 * T).view(T, 16)
    r = k % S
    cand = (cand & (r + L <= S)).reshape(-1)[:N].view(B, S)
    o = (o & (r + 2 <= S)).reshape(-1)[:N].view(B, S)
    return cand, o


@pytest.mark.parametrize("L", [2, 5, 16, 17, 18, 33, 49, 64])
@pytest.mark.parametrize("mode", ["increasing", "decreasing"])
def test_mask_kernel_bit_windows_match_pallas(L, mode, rng):
    """The identities the masks kernel rests on (a flat stream with
    row-tail masks, blocks aligned to the input's memory with the window
    shifted by the offset, the log-doubled AND run) give the Pallas
    kernel's bitmaps (interpret mode), row by row, at rows shorter and
    longer than a block and at offsets 0, 3 and 13 from 16 bytes."""
    for S in (7, 700):
        d = adversarial_rows(rng, S)
        want = [seqcdc_masks_pallas(jnp.asarray(row), L, mode,
                                    interpret=True) for row in d]
        for m in (0, 3, 13):
            cand, opp = _masks_by_windows(d, L, mode, m)
            for i, (wc, wo) in enumerate(want):
                np.testing.assert_array_equal(cand[i].numpy(),
                                              np.asarray(wc))
                np.testing.assert_array_equal(opp[i].numpy(), np.asarray(wo))


# -- phase 2: the automaton through boundaries_batch -----------------------------

def _assert_batch_parity(d: np.ndarray, p, mc: int | None = None):
    mc = mc or max_chunks_for(d.shape[-1], tp(p))
    wb, wc = jseqcdc.boundaries_batch(jnp.asarray(d), p, step_impl="wide",
                                      max_chunks=mc)
    gb, gc = tseqcdc.boundaries_batch(torch.from_numpy(d), tp(p),
                                      max_chunks=mc)
    assert gb.dtype == torch.int32 and gc.dtype == torch.int32
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    return gb, gc


@pytest.mark.parametrize("name", sorted(ALL_PARAMS))
def test_boundaries_batch_matches_reference(name, rng):
    p = ALL_PARAMS[name]
    n = 20000 if name == "skid" else 3000
    d = adversarial_rows(rng, n)
    gb, gc = _assert_batch_parity(d, p)
    for i, row in enumerate(d):
        assert tseqcdc.bounds_to_numpy(gb, gc)[i] == \
            joracle.boundaries_numpy(row, p).tolist()


@pytest.mark.parametrize("n", [0, 1, 2, 63, 64, 65, 512, 513])
def test_boundaries_batch_edge_lengths(n, rng):
    """Empty, 1-byte, shorter than seq_length, exactly min_size and exactly
    max_size streams, and one byte past each."""
    d = adversarial_rows(rng, max(n, 1))[:, :n]
    gb, gc = _assert_batch_parity(d, P)
    for i, row in enumerate(d):
        assert tseqcdc.bounds_to_numpy(gb, gc)[i] == \
            joracle.boundaries_slow(row, P)


def test_boundaries_two_phase_and_slow_oracle(rng):
    d = rng.integers(0, 256, 20000, dtype=np.uint8)
    for p in (P, P_DEC, P_SKID):
        b, c = tseqcdc.boundaries_two_phase(torch.from_numpy(d), tp(p))
        assert tseqcdc.bounds_to_numpy(b, c) == \
            joracle.boundaries_slow(d, p)


def test_undersized_max_chunks_drops_like_reference(rng):
    """Emits past max_chunks vanish and the count still counts them, as
    the reference's mode="drop" scatter and clamped fixup gather do."""
    _assert_batch_parity(adversarial_rows(rng, 3000), P, mc=5)


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("name", sorted(ALL_PARAMS))
def test_gather_and_event_steps_match_reference(name, step, rng):
    """The reference's two other automaton steps, on the adversarial rows,
    with a true and an undersized max_chunks."""
    p = ALL_PARAMS[name]
    d = adversarial_rows(rng, 20000 if name == "skid" else 3000)
    for mc in (None, 5):
        want_b, want_c = jseqcdc.boundaries_batch(
            jnp.asarray(d), p, step_impl=step, max_chunks=mc)
        got_b, got_c = tseqcdc.boundaries_batch(
            torch.from_numpy(d), tp(p), step_impl=step, max_chunks=mc)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    x = torch.from_numpy(d[:1])
    with pytest.raises(ValueError):
        tseqcdc.boundaries_batch(x, tp(p), mask_impl="pallas")
    # every step has a select kernel: its wrapper takes the plain version
    # for a CPU tensor
    want_b, want_c = tseqcdc.boundaries_batch(x, tp(p), step_impl=step)
    got_b, got_c = tseqcdc.boundaries_batch(x, tp(p), step_impl=step,
                                            select_impl="cuda")
    assert torch.equal(got_b, want_b) and torch.equal(got_c, want_c)


def test_bounds_to_numpy_shapes():
    b = torch.tensor([[10, 20, 1 << 30], [5, 1 << 30, 1 << 30]],
                     dtype=torch.int32)
    c = torch.tensor([2, 1], dtype=torch.int32)
    assert tseqcdc.bounds_to_numpy(b, c) == [[10, 20], [5]]
    assert tseqcdc.bounds_to_numpy(b[0], c[0]) == [10, 20]
    assert tseqcdc.bounds_to_numpy(b[0], 0) == []
    with pytest.raises(ValueError):
        tseqcdc.bounds_to_numpy(b, torch.tensor([1, 2, 3]))


# -- the index --------------------------------------------------------------------

def test_dedup_stats_matches_reference(rng):
    fp = rng.integers(0, 40, (3, 50, 2), dtype=np.uint32)
    # equal fingerprints carry equal lengths (as real chunks do), so the
    # first occurrence is the same whatever order a sort leaves ties in
    ln = ((fp[..., 0] * 7 + fp[..., 1]) % 97 + 1).astype(np.int32)
    ln[rng.random(ln.shape) < 0.2] = 0  # padding slots
    want = jdedup_stats(jnp.asarray(fp), jnp.asarray(ln))
    got = dedup_stats(torch.from_numpy(fp), torch.from_numpy(ln))
    for key in ("original_bytes", "dedup_bytes", "unique_chunks",
                "total_chunks"):
        assert int(got[key]) == int(want[key]), key
    assert 0.0 < space_savings(got) < 1.0
