"""The port's chunk fingerprints against the JAX reference, bit for bit.

``repro_torch.dedup.fingerprint.chunk_fingerprints`` (plain torch, int64
mod-p arithmetic) and the CUDA kernel's wrapper (which takes the plain
version for CPU tensors) are held against the reference's jnp chain
(``fp_impl="reference"``), its Pallas kernel in interpret mode, and the
host ``fingerprints_numpy`` ground truth, on the cases of
tests/test_fingerprint_kernel.py: random chunkings, the empty stream, a
single max-size 64 KiB chunk, the 65535-byte limb boundary, count=0
padding rows, and real SeqCDC bounds.  Outputs are integers: tolerance 0.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.params import SeqCDCParams as JParams
from repro.dedup.fingerprint import chunk_fingerprints as jcf
from repro.dedup.fingerprint import fingerprints_numpy as jfp_numpy
from repro.kernels.fingerprint import fingerprint_pallas

import repro_torch
from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.seqcdc import boundaries_batch
from repro_torch.dedup import fingerprint as tfp
from repro_torch.kernels import fingerprint as kfp

P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done.  The reference's
    module-level jits (its scheduler's ``_device_chunk_packed`` among them)
    would keep this file's traces, and a reference test that runs later in
    the same process and monkeypatches what such a jit calls would hit the
    cached trace and never see its patch."""
    yield
    jax.clear_caches()


_SENTINEL = 1 << 30


def _padded_bounds(cuts: np.ndarray, max_chunks: int) -> np.ndarray:
    out = np.full(max_chunks, _SENTINEL, dtype=np.int32)
    out[: len(cuts)] = cuts
    return out


def _random_cuts(rng, n: int, max_len: int = tfp.MAX_CHUNK) -> np.ndarray:
    cuts = []
    s = 0
    while s < n:
        s = min(n, s + int(rng.integers(1, max_len + 1)))
        cuts.append(s)
    return np.asarray(cuts, dtype=np.int64)


def _assert_parity(data: np.ndarray, cuts: np.ndarray, max_chunks: int,
                   pallas: bool = True):
    bounds = _padded_bounds(cuts, max_chunks)
    count = len(cuts)
    want_fp, want_len = jcf(jnp.asarray(data), jnp.asarray(bounds),
                            jnp.asarray(count), max_chunks=max_chunks,
                            fp_impl="reference")
    want_fp, want_len = np.asarray(want_fp), np.asarray(want_len)
    tb = torch.from_numpy(bounds)
    td = torch.from_numpy(data)
    for impl in tfp.FP_IMPLS:  # "cuda" takes the plain version on the CPU
        fp, ln = tfp.chunk_fingerprints(td, tb, count, max_chunks=max_chunks,
                                        fp_impl=impl)
        assert fp.dtype == torch.uint32 and ln.dtype == torch.int32
        np.testing.assert_array_equal(fp.numpy(), want_fp, err_msg=impl)
        np.testing.assert_array_equal(ln.numpy(), want_len, err_msg=impl)
    if pallas:
        kf, kl = fingerprint_pallas(jnp.asarray(data), jnp.asarray(bounds),
                                    jnp.asarray(count),
                                    max_chunks=max_chunks, interpret=True)
        np.testing.assert_array_equal(np.asarray(kf), want_fp)
        np.testing.assert_array_equal(np.asarray(kl), want_len)
    truth = tfp.fingerprints_numpy(data, cuts)
    np.testing.assert_array_equal(truth, jfp_numpy(data, cuts))
    np.testing.assert_array_equal(want_fp[:count], truth)


@pytest.mark.parametrize("n", [1, 2, 1025, 70000])
def test_random_chunkings(n, rng):
    data = rng.integers(0, 256, n, dtype=np.uint8)
    cuts = _random_cuts(rng, n, max_len=max(1, n // 3))
    _assert_parity(data, cuts, max_chunks=len(cuts) + 3, pallas=n > 2)


def test_single_max_chunk(rng):
    """One chunk next to the 64 KiB power-table bound."""
    n = 65535
    data = rng.integers(0, 256, n, dtype=np.uint8)
    _assert_parity(data, np.array([n], dtype=np.int64), max_chunks=4,
                   pallas=False)


def test_limb_boundary():
    """All-0xFF 65536/65535-byte chunks: the largest per-chunk sums."""
    data = np.full(65536 + 65535, 0xFF, dtype=np.uint8)
    cuts = np.array([65536, 65536 + 65535], dtype=np.int64)
    _assert_parity(data, cuts, max_chunks=5)


def test_empty_stream():
    for impl in tfp.FP_IMPLS:
        fp, lens = tfp.chunk_fingerprints(
            torch.zeros((0,), dtype=torch.uint8),
            torch.full((4,), _SENTINEL, dtype=torch.int32), 0,
            max_chunks=4, fp_impl=impl)
        assert tuple(fp.shape) == (4, 2) and not fp.to(torch.int64).any()
        assert tuple(lens.shape) == (4,) and not lens.any()


def test_count_zero_padding_rows(rng):
    """Batched rows with count = 0 (and one real row) come back zeroed
    exactly like the reference's vmapped path."""
    data = np.stack([np.zeros(4096, np.uint8),
                     rng.integers(0, 256, 4096, dtype=np.uint8)])
    bounds = np.stack([_padded_bounds(np.array([4096]), 4),
                       _padded_bounds(np.array([1000, 4096]), 4)])
    counts = np.array([0, 2], dtype=np.int32)
    for row in range(2):
        want_fp, want_len = jcf(jnp.asarray(data[row]),
                                jnp.asarray(bounds[row]),
                                jnp.asarray(counts[row]), max_chunks=4)
        fp, ln = kfp.chunk_fingerprints(torch.from_numpy(data),
                                        torch.from_numpy(bounds),
                                        torch.from_numpy(counts),
                                        max_chunks=4)
        np.testing.assert_array_equal(fp[row].numpy(), np.asarray(want_fp))
        np.testing.assert_array_equal(ln[row].numpy(), np.asarray(want_len))
    assert not fp[0].to(torch.int64).any() and not ln[0].any()


def test_undersized_table_folds_like_reference(rng):
    """Bytes past the table's last bound fold into its last slot, as the
    reference's clamped chunk id does."""
    data = rng.integers(0, 256, 5000, dtype=np.uint8)
    cuts = np.array([1000, 2500, 4000, 5000])
    bounds = cuts[:2].astype(np.int32)
    want = jcf(jnp.asarray(data), jnp.asarray(bounds), jnp.asarray(2),
               max_chunks=2)
    got = tfp.chunk_fingerprints(torch.from_numpy(data),
                                 torch.from_numpy(bounds), 2, max_chunks=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seqcdc_bounds_layout(rng):
    """Parity on real SeqCDC output (sentinel padding, final cut at n)."""
    data = rng.integers(0, 256, (3, 30_000), dtype=np.uint8)
    tparams = repro_torch.params_from_reference(P)
    mc = max_chunks_for(data.shape[-1], tparams)
    b, c = boundaries_batch(torch.from_numpy(data), tparams, max_chunks=mc)
    fp, ln = kfp.chunk_fingerprints(torch.from_numpy(data), b, c,
                                    max_chunks=mc)
    for row in range(3):
        wf, wl = jcf(jnp.asarray(data[row]), jnp.asarray(b[row].numpy()),
                     jnp.asarray(int(c[row])), max_chunks=mc)
        np.testing.assert_array_equal(fp[row].numpy(), np.asarray(wf))
        np.testing.assert_array_equal(ln[row].numpy(), np.asarray(wl))


def test_unknown_fp_impl_rejected(rng):
    data = torch.from_numpy(rng.integers(0, 256, 100, dtype=np.uint8))
    with pytest.raises(ValueError):
        tfp.chunk_fingerprints(data, torch.tensor([100], dtype=torch.int32),
                               1, max_chunks=1, fp_impl="pallas")


def test_power_table_matches_reference():
    from repro.dedup.fingerprint import _pow_table_np

    for r in (tfp.R1, tfp.R2):
        np.testing.assert_array_equal(tfp._pow_table_np(r), _pow_table_np(r))
    t = tfp.pow_tables("cpu", torch.int32)
    assert t.dtype == torch.int32 and int(t.min()) >= 0
    np.testing.assert_array_equal(t[0].numpy(), _pow_table_np(tfp.R1))


# -- the CUDA kernel's piece decomposition -----------------------------------

_P31 = (1 << 31) - 1


def _fold(v: torch.Tensor) -> torch.Tensor:
    """csrc/fingerprint.cu ``fold``: below 2^63 to below 2^33, mod p."""
    return (v & _P31) + (v >> 31)


def _fps_by_pieces(data: np.ndarray, bounds: np.ndarray, counts: np.ndarray,
                   mc: int, m: int):
    """The fingerprint kernel's arithmetic in torch (int64): rows of a
    (B, S) batch whose first byte lies m bytes past a 64-byte boundary; per
    slot the whole 64-byte pieces (aligned in memory) inside the chunk
    below the clamp as (sum_u b_u r^(63-u)) * r^(64 (d >> 6)), the inner
    sum built from the weights' bytes (four dp4a sums shifted together),
    with the chunk's r^(d mod 64) taken once, d the piece's last byte's
    exponent; pieces wholly past the clamp as their byte sum times
    r^65535; the ends (under 64 bytes each) and the piece that straddles
    the clamp byte by byte; the last slot's bytes past its end at weight
    1."""
    B, S = data.shape
    K = kfp.PIECE
    pw = tfp.pow_tables("cpu")  # (2, MAX_CHUNK) int64
    pw64 = kfp.piece_factors("cpu").to(torch.int64)
    weights = pw[:, K - 1 - torch.arange(K)]  # (2, 64): r^(63-u)
    wbytes = torch.stack([(weights >> (8 * k)) & 0xFF for k in range(4)], 1)
    top = tfp.MAX_CHUNK - 1
    fps = torch.zeros((B, mc, 2), dtype=torch.int64)
    lens = torch.zeros((B, mc), dtype=torch.int32)
    for b in range(B):
        row = torch.from_numpy(data[b].astype(np.int64))
        at = m + b * S  # the row's offset from an aligned base
        for j in range(min(int(counts[b]), mc)):
            e = int(bounds[b, j])
            s_raw = int(bounds[b, j - 1]) if j else 0
            s, stop = max(s_raw, 0), min(e, S)
            acc = torch.zeros(2, dtype=torch.int64)

            def by_byte(lo, hi):
                i = torch.arange(lo, hi)
                ex = torch.clamp(e - 1 - i, max=top)
                return (row[lo:hi] * pw[:, ex]).sum(1)

            lo = s + (K - (at + s) % K) % K
            hi = stop - (at + stop) % K
            i0 = min(lo, stop)
            i1 = max(hi, i0)
            assert i0 - s < K and stop - i1 < K
            acc += by_byte(s, i0) + by_byte(i1, stop)
            p = torch.zeros(2, dtype=torch.int64)
            for q0 in range(i0, i1, K):
                d = e - q0 - K
                piece = row[q0: q0 + K]
                if d + K - 1 <= top:
                    c = (piece[None, None] * wbytes).sum(-1)  # (2, 4)
                    inner = (c << (8 * torch.arange(4))).sum(1)
                    p += _fold(_fold(inner) * pw64[:, d >> 6])
                elif d >= top:
                    acc += piece.sum() * pw[:, top]
                else:
                    acc += by_byte(q0, q0 + K)
            acc += _fold(_fold(p) * pw[:, (e - i0) % K])
            if j == mc - 1:
                acc += row[max(e, s):].sum()
            fps[b, j] = acc % _P31
            lens[b, j] = e - s_raw
    return fps.to(torch.uint32), lens


def _piece_cases(rng):
    """(data, bounds, counts, mc, refs): the 64 KiB chunk, the 65,535-byte
    boundary, chunks of 1-47 bytes, count=0 rows, a chunk past the clamp
    and an undersized table.  ``refs``: the references whose preconditions
    the case meets.  Past 65,536 bytes a chunk overflows the reference
    chain's 16-bit limb sums (its stated bound) and the Pallas kernel's
    factor table, so the clamp case is held to the plain version alone;
    the Pallas kernel and ``fingerprints_numpy`` drop the bytes past an
    undersized table, which the reference chain folds into its last
    slot."""
    every = ("reference", "pallas", "numpy")
    n = 65536 + 65535
    yield (np.full((1, n), 0xFF, np.uint8),
           np.array([[65536, n, _SENTINEL]], np.int32), np.array([2]), 3,
           every)
    d = rng.integers(0, 256, (1, 65536), dtype=np.uint8)
    yield d, np.array([[65536]], np.int32), np.array([1]), 1, every
    cuts = np.cumsum(rng.integers(1, 48, 120))
    d = rng.integers(0, 256, (2, int(cuts[-1])), dtype=np.uint8)
    b = np.stack([_padded_bounds(cuts, 124), _padded_bounds(cuts[:3], 124)])
    yield d, b, np.array([120, 0]), 124, every
    d = rng.integers(0, 256, (1, 200_000), dtype=np.uint8)
    yield (d, np.array([[70, 140_000, 200_000]], np.int32), np.array([3]),
           3, ())
    d = rng.integers(0, 256, (2, 5000), dtype=np.uint8)
    yield (d, np.array([[1000, 2500], [4999, 5000]], np.int32),
           np.array([2, 2]), 2, ("reference",))


def _seqcdc_case(rng):
    data = rng.integers(0, 256, (3, 30_000), dtype=np.uint8)
    tparams = repro_torch.params_from_reference(P)
    mc = max_chunks_for(data.shape[-1], tparams)
    b, c = boundaries_batch(torch.from_numpy(data), tparams, max_chunks=mc)
    return data, b.numpy(), c.numpy(), mc, ("reference", "pallas", "numpy")


@pytest.mark.parametrize("case", range(6))
def test_fingerprint_kernel_pieces_match_pallas(case, rng):
    """The identities the fingerprint kernel rests on (64-byte pieces
    aligned in memory with constant inner weights taken a byte at a time
    and one factor from every 64th power, the chunk's r^(d mod 64) once,
    per-byte ends, the clamp, the last slot's tail) give the plain
    version's fingerprints, with rows at offsets 0, 1, 3, 13 and 37 from
    64 bytes; the plain version
    gives, within their preconditions, the reference's jnp chain's, the
    Pallas kernel's (interpret mode) and ``fingerprints_numpy``'s."""
    cases = list(_piece_cases(rng)) + [_seqcdc_case(rng)]
    data, bounds, counts, mc, within = cases[case]
    want_fp, want_len = kfp.chunk_fingerprints(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(counts.astype(np.int32)), max_chunks=mc)
    for b in range(data.shape[0]):
        args = (jnp.asarray(data[b]), jnp.asarray(bounds[b]),
                jnp.asarray(int(counts[b])))
        refs = []
        if "reference" in within:
            refs.append(jcf(*args, max_chunks=mc, fp_impl="reference"))
        if "pallas" in within:
            refs.append(fingerprint_pallas(*args, max_chunks=mc,
                                           interpret=True))
        if "numpy" in within:
            c = int(counts[b])
            np.testing.assert_array_equal(
                want_fp[b, :c].numpy(),
                tfp.fingerprints_numpy(data[b], bounds[b, :c]))
        for kf, kl in refs:
            np.testing.assert_array_equal(want_fp[b].numpy(), np.asarray(kf))
            np.testing.assert_array_equal(want_len[b].numpy(),
                                          np.asarray(kl))
    for m in (0, 1, 3, 13, 37):
        fp, ln = _fps_by_pieces(data, bounds, counts, mc, m)
        np.testing.assert_array_equal(fp.numpy(), want_fp.numpy())
        np.testing.assert_array_equal(ln.numpy(), want_len.numpy())


def test_constant_tables_are_cached_per_device():
    """The kernels' constant tables are made once a (device, dtype): a
    second call returns the same tensor, equal to the reference's."""
    from repro.dedup.fingerprint import _pow_table_np
    from repro_torch.kernels import gear_hash as kgear

    t = tfp.pow_tables("cpu", torch.int32)
    assert tfp.pow_tables("cpu", torch.int32) is t
    assert tfp.pow_tables("cpu") is tfp.pow_tables("cpu")
    for g, r in enumerate((tfp.R1, tfp.R2)):
        np.testing.assert_array_equal(t[g].numpy(), _pow_table_np(r))
        np.testing.assert_array_equal(kfp.piece_factors("cpu")[g].numpy(),
                                      _pow_table_np(r)[::kfp.PIECE])
    assert kfp.piece_factors("cpu") is kfp.piece_factors("cpu")
    words = kgear.gear_table().tobytes()
    g = kgear._device_table("cpu", words)
    assert kgear._device_table("cpu", words) is g
    np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                  kgear.gear_table())


def test_piece_weights_in_the_kernel_source():
    """csrc/fingerprint.cu's constant piece weights are the bytes of
    r^(63-u) mod p of the reference's power table, packed as the kernel
    reads them (byte k of the weights of bytes 4 wd .. 4 wd + 3 in word
    kPieceB[g][k][wd]), and its piece size is the wrapper's."""
    import re

    from repro.dedup.fingerprint import _pow_table_np

    src = (Path(kfp.__file__).parent / "csrc" / "fingerprint.cu").read_text()
    assert f"constexpr int kPiece = {kfp.PIECE};" in src
    body = re.search(r"kPieceB\[2\]\[4\]\[16\] = \{(.*?)\};", src,
                     re.S).group(1)
    got = [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]
    want = []
    for r in (tfp.R1, tfp.R2):
        w = [int(_pow_table_np(r)[63 - u]) for u in range(64)]
        for k in range(4):
            for wd in range(16):
                want.append(sum(((w[4 * wd + i] >> (8 * k)) & 0xFF)
                                << (8 * i) for i in range(4)))
    assert got == want
