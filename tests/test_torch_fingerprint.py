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
