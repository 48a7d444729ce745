"""The port's data layer against the JAX package, on the CPU.

``repro_torch.data`` keeps numpy copies of the corpus builders and the
token loader, and runs ``DedupIngest``'s chunking and fingerprinting on a
device (here the CPU: the kernels' plain versions).  Every corpus, loader
batch, unique-byte stream, token batch and savings figure must equal the
reference's on the same inputs.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

from repro import data as rdata
from repro.core.params import SeqCDCParams as RefParams
from repro.data import corpus as rcorpus

from repro_torch import data as pdata
from repro_torch import params_from_reference
from repro_torch.data import corpus as pcorpus

#: small parameters that chunk densely (avg 256, windows of 3)
SMALL = dict(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
             min_size=64, max_size=512)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=np.uint8).tobytes())
        h.update(b"|")
    return h.hexdigest()


@pytest.mark.parametrize("name,mb", [("DEB", 1), ("DEV", 1), ("RDS", 1),
                                     ("TPCC", 1)])
def test_datasets_equal_reference(name, mb):
    np.testing.assert_array_equal(pcorpus.load_dataset(name, mb),
                                  rcorpus.load_dataset(name, mb))


def test_snapshot_series_equals_reference():
    kw = dict(base_bytes=20_000, snapshots=4, edit_rate=1e-3, seed=5)
    got = list(pcorpus.snapshot_series(**kw))
    want = list(rcorpus.snapshot_series(**kw))
    assert _digest(got) == _digest(want)


@pytest.mark.parametrize("steps", [(0, 1, 2), (7, 123, 4096)])
def test_token_loader_equals_reference(steps):
    corpus = np.random.default_rng(0).integers(0, 256, 10_000, dtype=np.uint8)
    cfg = dict(batch_size=4, seq_len=16, seed=3)
    got = pdata.TokenLoader(corpus, pdata.LoaderConfig(**cfg))
    want = rdata.TokenLoader(corpus, rdata.LoaderConfig(**cfg))
    for step in steps:
        for a, b in zip(got.batch_at(step), want.batch_at(step)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_token_loader_restart_and_host_sharding():
    corpus = np.random.default_rng(1).integers(0, 256, 10_000, dtype=np.uint8)
    full = pdata.TokenLoader(corpus, pdata.LoaderConfig(batch_size=8,
                                                        seq_len=16))
    hosts = [pdata.TokenLoader(corpus, pdata.LoaderConfig(
        batch_size=8, seq_len=16, host_index=i, host_count=2))
        for i in range(2)]
    ref = [rdata.TokenLoader(corpus, rdata.LoaderConfig(
        batch_size=8, seq_len=16, host_index=i, host_count=2))
        for i in range(2)]
    it = iter(full)
    for step in range(4):
        f, _ = next(it)  # the iterator walks the same steps as batch_at
        np.testing.assert_array_equal(f, full.batch_at(step)[0])
        parts = [h.batch_at(step)[0] for h in hosts]
        np.testing.assert_array_equal(np.concatenate(parts), f)
        for h, r in zip(parts, ref):
            np.testing.assert_array_equal(h, r.batch_at(step)[0])


def _corpus():
    """Four snapshots of a mutating 48 KB store back to back, plus a tail
    shorter than a segment."""
    snaps = list(pcorpus.snapshot_series(base_bytes=48_000, snapshots=4,
                                         edit_rate=4e-4, seed=2))
    return np.concatenate(snaps + [snaps[0][:5_000]])


@pytest.mark.parametrize("drop_duplicates", [True, False])
def test_dedup_ingest_equals_reference(drop_duplicates):
    corpus = _corpus()
    kw = dict(avg_chunk=256, segment_bytes=16 << 10, batch_segments=4,
              seq_len=63, batch_size=4, drop_duplicates=drop_duplicates)
    got = pdata.DedupIngest(pdata.PipelineConfig(**kw),
                            params_from_reference(RefParams(**SMALL)),
                            device="cpu")
    want = rdata.DedupIngest(rdata.PipelineConfig(**kw), RefParams(**SMALL))
    g = list(got.unique_bytes(corpus))
    w = list(want.unique_bytes(corpus))
    assert len(g) == len(w) > 100
    assert _digest(g) == _digest(w)
    assert got.savings == want.savings
    if drop_duplicates:
        assert got.savings > 0.5
    else:
        assert np.array_equal(np.concatenate(g), corpus)


def test_dedup_ingest_token_batches_equal_reference():
    corpus = _corpus()
    kw = dict(avg_chunk=256, segment_bytes=16 << 10, batch_segments=3,
              seq_len=127, batch_size=4)
    got = pdata.DedupIngest(pdata.PipelineConfig(**kw),
                            params_from_reference(RefParams(**SMALL)),
                            device="cpu")
    want = rdata.DedupIngest(rdata.PipelineConfig(**kw), RefParams(**SMALL))
    g = list(got.token_batches(corpus))
    w = list(want.token_batches(corpus))
    assert len(g) == len(w) > 10
    for a, b in zip(g, w):
        assert a.shape == b.shape == (4, 128)
        np.testing.assert_array_equal(a, b)
    assert got.savings == want.savings


def test_pipeline_config_and_default_params_equal_reference():
    assert dataclasses.asdict(pdata.PipelineConfig()) == dataclasses.asdict(
        rdata.PipelineConfig())
    got = pdata.DedupIngest(pdata.PipelineConfig(), device="cpu")
    want = rdata.DedupIngest(rdata.PipelineConfig())
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)


def test_dedup_config_matches_reference_but_for_impls():
    from repro.configs import seqcdc_pipeline as rconf
    from repro_torch.configs import seqcdc_pipeline as pconf

    got = dataclasses.asdict(pconf.CONFIG)
    want = dataclasses.asdict(rconf.CONFIG)
    assert got.pop("mask_impl") == "cuda" and want.pop("mask_impl") == "jnp"
    assert got == want
    assert dataclasses.asdict(pconf.CONFIG.params()) == dataclasses.asdict(
        rconf.CONFIG.params())
