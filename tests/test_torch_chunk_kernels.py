"""The chunker registry's kernels, by their plain versions, against the JAX
reference, bit for bit.

On the CPU each wrapper takes its plain version, which these tests hold
against the reference on seeded numpy inputs:

* the Gear hash (``kernels/gear_hash.py``) against the Pallas
  ``gear_hash_pallas`` in interpret mode and the sequential oracle
  ``ref.gear_hash``, on ``tests/test_kernels.py``'s lengths;
* per-block maxima (``kernels/extremum.py``) against ``block_max_pallas``
  in interpret mode;
* the select kernel's wrapper (``kernels/select_boundaries.py``) against
  the reference's ``select_boundaries`` on SeqCDC bitmaps and on the hash
  selectors' match bitmaps;
* ``boundaries_sequential`` against the reference's on adversarial rows;
* each native scan (``kernels/native_scan.py``) against the reference's
  ``_seq`` chunker, on random and low-entropy streams.

Every output is an integer or a bit: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import automaton as jautomaton
from repro.core import make_chunker as jmake
from repro.core import seqcdc as jseqcdc
from repro.core.baselines.selectors import SelectorParams as JSelectorParams
from repro.core.params import SeqCDCParams as JParams
from repro.kernels import ref
from repro.kernels.extremum import block_max_pallas
from repro.kernels.gear_hash import gear_hash_pallas

import repro_torch
from repro_torch.core import make_chunker
from repro_torch.core import seqcdc as tseqcdc
from repro_torch.core.baselines.selectors import SelectorParams
from repro_torch.kernels import extremum as kext
from repro_torch.kernels import gear_hash as kgear
from repro_torch.kernels import native_scan as kscan
from repro_torch.kernels import select_boundaries as kselect

#: tests/test_kernels.py's lengths
LENGTHS = [1, 2, 31, 32, 100, 1023, 1024, 1025, 4096, 70000]

P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)
PARAMS = {
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


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no reference
    trace made here serves a later test in the same process."""
    yield
    jax.clear_caches()


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


# -- the Gear hash ----------------------------------------------------------

def test_gear_table_matches_reference():
    np.testing.assert_array_equal(kgear.gear_table(),
                                  np.asarray(ref.gear_table()))


@pytest.mark.parametrize("n", LENGTHS)
def test_gear_hash_matches_reference(n, rng):
    d = rng.integers(0, 256, n, dtype=np.uint8)
    want = np.asarray(gear_hash_pallas(jnp.asarray(d), interpret=True))
    np.testing.assert_array_equal(want, np.asarray(ref.gear_hash(
        jnp.asarray(d))))
    x = torch.from_numpy(d)
    got = kgear.gear_hash(x)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kgear.gear_hash_sequential(x).numpy(), want)


# -- per-block maxima -------------------------------------------------------

@pytest.mark.parametrize("n", [128, 1000, 65536, 70001])
@pytest.mark.parametrize("block", [64, 128])
def test_block_max_matches_reference(n, block, rng):
    d = rng.integers(0, 256, n, dtype=np.uint8)
    want = np.asarray(block_max_pallas(jnp.asarray(d), block=block,
                                       interpret=True))
    got = kext.block_max(torch.from_numpy(d), block)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# -- the select kernel's wrapper --------------------------------------------

def _jselect(p, n, mc):
    """The reference's ``select_boundaries`` over a batch of rows, jitted
    once."""
    return jax.jit(jax.vmap(lambda c, o: jautomaton.select_boundaries(
        c, o, n, p, max_chunks=mc)))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_select_matches_reference_on_seqcdc_bitmaps(name, rng):
    p = PARAMS[name]
    d = adversarial_rows(rng, 20000 if name == "skid" else 3000)
    n = d.shape[1]
    cand, opp = tseqcdc._compute_masks(torch.from_numpy(d), tp(p), "torch")
    for mc in (None, 5):
        got_b, got_c = kselect.select_boundaries(cand, opp, n, tp(p),
                                                 max_chunks=mc)
        want_b, want_c = _jselect(p, n, mc)(jnp.asarray(cand.numpy()),
                                            jnp.asarray(opp.numpy()))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("density", [0.0, 1 / 2048, 1 / 16, 1.0])
def test_select_matches_reference_on_selector_bitmaps(density):
    """The hash chunkers' selector shim: a match bitmap, no opposing
    pairs, run length 1, a trigger that never fires."""
    n = 40_000
    bits = np.random.default_rng(3).random(n) < density
    for mn, mx in ((1024, 4096), (2048, 3000)):
        p = SelectorParams(min_size=mn, max_size=mx)
        assert p.block_width == JSelectorParams(mn, mx).block_width
        x = torch.from_numpy(bits)[None]
        got_b, got_c = kselect.select_boundaries(x, torch.zeros_like(x), n, p)
        want_b, want_c = _jselect(JSelectorParams(mn, mx), n, None)(
            jnp.asarray(bits[None]), jnp.zeros((1, n), bool))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


# -- boundaries_sequential and the native scans -----------------------------

@pytest.mark.parametrize("name", sorted(PARAMS))
def test_boundaries_sequential_matches_reference(name, rng):
    p = PARAMS[name]
    d = adversarial_rows(rng, 20000 if name == "skid" else 3000)
    for row in d:
        for n in (0, 1, 2, p.seq_length, row.size):
            for mc in (None, 3):
                want_b, want_c = jseqcdc.boundaries_sequential(
                    jnp.asarray(row[:n]), p, max_chunks=mc)
                got_b, got_c = tseqcdc.boundaries_sequential(
                    torch.from_numpy(row[:n].copy()), tp(p), max_chunks=mc)
                assert int(got_c) == int(want_c), (n, mc)
                np.testing.assert_array_equal(got_b.numpy(),
                                              np.asarray(want_b))


@pytest.mark.parametrize("kind", ["random", "low-entropy"])
@pytest.mark.parametrize("algo", ["gear", "crc", "rabin", "fastcdc", "ae",
                                  "ram", "seqcdc"])
def test_native_scan_matches_reference(algo, kind):
    """Each native-scan plain form, through the port's ``<algo>_seq``
    chunker and directly over a batch of rows, against the reference's
    ``_seq`` chunker."""
    rng = np.random.default_rng(5)
    hi = 256 if kind == "random" else 3
    rows = rng.integers(0, hi, (2, 1 << 16), dtype=np.uint8)
    name = f"{algo}_seq"
    for avg in (4096, 8192):
        c = make_chunker(name, avg, device="cpu")
        want = [jmake(name, avg).chunk(r) for r in rows]
        for r, w in zip(rows, want):
            np.testing.assert_array_equal(c.chunk(r), w)
        if algo == "seqcdc":
            got_b, got_c = kscan.native_scan(torch.from_numpy(rows), algo,
                                             params=c.params)
        else:
            got_b, got_c = kscan.native_scan(
                torch.from_numpy(rows), algo, min_size=c.min_size,
                max_size=c.max_size, **c.scan_args())
        for r, w in enumerate(want):
            assert int(got_c[r]) == w.size
            np.testing.assert_array_equal(got_b[r, : w.size].numpy(), w)


def test_native_scan_rejects_what_it_does_not_take():
    x = torch.zeros((1, 100), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kscan.native_scan(x[0], "gear", min_size=64, max_size=128)
    with pytest.raises(ValueError):
        kscan.native_scan(x, "zstd", min_size=64, max_size=128)
    with pytest.raises(ValueError):
        kscan.native_scan(x, "seqcdc")
    with pytest.raises(ValueError):
        kscan.native_scan(x[:, :1], "seqcdc", params=tp(P))
