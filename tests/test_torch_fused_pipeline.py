"""The port's fused pipeline against the JAX reference, bit for bit.

``repro_torch.kernels.fused_pipeline.fused_pipeline_batch`` takes its plain
version (the composed split path) for CPU tensors; it is held against the
reference's Pallas ``fused_pipeline_batch`` in interpret mode and its
oracle ``kernels/ref.fused_pipeline`` on the edge regimes of
tests/test_fused_pipeline.py: random streams, forced max-size cuts,
decreasing mode, skip overshoots that spill bounds past a tile, the 64 KiB
limb boundary, empty and 1-byte streams.  Then the port's scheduler:
fused against split, and the divergence guards with a corrupted kernel.
Outputs are integers: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.params import SeqCDCParams as JParams
from repro.core.params import derived_params as jderived
from repro.kernels import ref
from repro.kernels.fused_pipeline import fused_pipeline_batch as jfused

import repro_torch
from repro_torch.core.automaton import max_chunks_for
from repro_torch.kernels import fused_pipeline as kfused
from repro_torch.service import scheduler as sched_mod
from repro_torch.service.scheduler import (
    ChunkScheduler,
    FingerprintDivergenceError,
    MaskDivergenceError,
    PipelineDivergenceError,
)

P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)
P5 = JParams(avg_size=256, seq_length=5, skip_trigger=6, skip_size=32,
             min_size=64, max_size=512)
P_SKID = JParams(avg_size=4096, seq_length=5, skip_trigger=3,
                 skip_size=3000, min_size=2048, max_size=8192)


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
_NAMES = ("bounds", "counts", "fps", "lengths")


def tp(p):
    return repro_torch.params_from_reference(p)


def _assert_parity(d2: np.ndarray, p, *, pallas: bool = False,
                   tile: int = 32 * 1024):
    mc = max_chunks_for(d2.shape[-1], tp(p))
    got = kfused.fused_pipeline_batch(torch.from_numpy(d2), tp(p),
                                      max_chunks=mc)
    want = ref.fused_pipeline(jnp.asarray(d2), p, max_chunks=mc)
    for g, w, name in zip(got, want, _NAMES):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if pallas:
        kern = jfused(jnp.asarray(d2), p, max_chunks=mc, tile=tile,
                      interpret=True)
        for g, w, name in zip(got, kern, _NAMES):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"pallas {name}")


@pytest.mark.parametrize("n", [2, 100, 5000, 33000])
def test_random(n, rng):
    _assert_parity(rng.integers(0, 256, (2, n), dtype=np.uint8), P)


def test_forced_max_size_cuts():
    _assert_parity(np.zeros((2, 20000), dtype=np.uint8), P)


def test_decreasing_mode(rng):
    pd = dataclasses.replace(P5, mode="decreasing")
    _assert_parity(rng.integers(0, 256, (2, 20000), dtype=np.uint8), pd)


def test_skip_overshoot_spill(rng):
    """skip_size 3000 against 1024-byte tiles: overshooting skips resolved
    as cuts emit bounds far past the firing block.  The Pallas kernel
    (interpret mode, ~10 s a call) runs on this multi-tile case;
    ref.fused_pipeline, its oracle, holds every other case."""
    _assert_parity(rng.integers(0, 256, (2, 30000), dtype=np.uint8), P_SKID,
                   pallas=True, tile=1024)
    _assert_parity(rng.integers(0, 4, (2, 30000), dtype=np.uint8), P_SKID)


def test_limb_boundary():
    """All-0xFF bytes at max_size 64 KiB: chunk lengths at the power-table
    bound."""
    p64 = jderived(32768)
    assert p64.max_size == 65536
    _assert_parity(np.full((1, 65536 + 65535), 0xFF, dtype=np.uint8), p64)


def test_empty_and_single_byte(rng):
    b, c, f, ln = kfused.fused_pipeline_batch(
        torch.zeros((2, 0), dtype=torch.uint8), tp(P), max_chunks=3)
    assert c.tolist() == [0, 0]
    assert (b == _SENTINEL).all()
    assert not f.to(torch.int64).any() and not ln.any()
    _assert_parity(rng.integers(0, 256, (1, 1), dtype=np.uint8), P)
    # exactly min_size
    _assert_parity(rng.integers(0, 256, (3, 64), dtype=np.uint8), P)


def test_max_size_beyond_power_table_rejected():
    big = repro_torch.SeqCDCParams(avg_size=65536, min_size=32768,
                                   max_size=131072)
    with pytest.raises(ValueError, match="power-table"):
        kfused.fused_pipeline_batch(torch.zeros((1, 10), dtype=torch.uint8),
                                    big, max_chunks=2)


def test_cpu_wrapper_is_the_plain_version(rng):
    d = torch.from_numpy(rng.integers(0, 256, (2, 3000), dtype=np.uint8))
    mc = max_chunks_for(3000, tp(P))
    for g, w in zip(kfused.fused_pipeline_batch(d, tp(P), max_chunks=mc),
                    kfused.fused_pipeline_plain(d, tp(P), max_chunks=mc)):
        assert torch.equal(g, w)


# -- the scheduler ---------------------------------------------------------------

def _streams(rng):
    return [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (0, 1, 100, 1000, 1024, 3000, 5000)]


def test_scheduler_fused_matches_split(rng):
    """pipeline_impl='fused' with every guard armed: results identical to
    the split scheduler, and the cross-checks actually ran."""
    kw = dict(device="cpu", slots=2, min_bucket=1024)
    fused = ChunkScheduler(tp(P), pipeline_impl="fused",
                           cross_check_pipeline=True, cross_check_masks=True,
                           cross_check_fps=True, **kw)
    split = ChunkScheduler(tp(P), pipeline_impl="split", mask_impl="torch",
                           fp_impl="torch", **kw)
    for i, s in enumerate(_streams(rng)):
        fused.submit(s, tag=i)
        split.submit(s, tag=i)
    got = {r.tag: r for r in fused.drain()}
    for r in split.drain():
        assert got[r.tag].bounds.tolist() == r.bounds.tolist()
        np.testing.assert_array_equal(got[r.tag].fps, r.fps)
        np.testing.assert_array_equal(got[r.tag].lengths, r.lengths)
    assert fused._pipeline_checked_buckets
    assert fused._checked_buckets and fused._fp_checked_buckets
    assert fused.stats.cross_check_s > 0


def test_scheduler_rejects_unknown_and_unported_impls():
    for kw in (dict(pipeline_impl="bogus"), dict(mask_impl="pallas"),
               dict(fp_impl="reference"), dict(packing_impl="zip")):
        with pytest.raises(ValueError):
            ChunkScheduler(tp(P), device="cpu", **kw)
    # segment packing is ported (tests/test_torch_packing.py holds it)
    assert ChunkScheduler(tp(P), device="cpu",
                          packing_impl="segments").packing_impl == "segments"


def _guarded(**kw):
    return ChunkScheduler(tp(P), device="cpu", slots=1, min_bucket=1024,
                          pipeline_impl="split", **kw)


def test_pipeline_divergence_boundary_stage(rng, monkeypatch):
    real = sched_mod._run_fused

    def lying(x, p, mc):
        b, c, f, ln = real(x, p, mc)
        return b + (b < _SENTINEL).to(b.dtype), c, f, ln

    monkeypatch.setattr(sched_mod, "_run_fused", lying)
    with pytest.raises(PipelineDivergenceError) as ei:
        _guarded(cross_check_pipeline=True).submit(
            rng.integers(0, 256, 900, dtype=np.uint8))
    assert ei.value.stage == "boundaries"


def test_pipeline_divergence_fingerprint_stage(rng, monkeypatch):
    real = sched_mod._run_fused

    def lying(x, p, mc):
        b, c, f, ln = real(x, p, mc)
        return b, c, (f.to(torch.int64) ^ 1).to(torch.uint32), ln

    monkeypatch.setattr(sched_mod, "_run_fused", lying)
    with pytest.raises(PipelineDivergenceError) as ei:
        _guarded(cross_check_pipeline=True).submit(
            rng.integers(0, 256, 900, dtype=np.uint8))
    assert ei.value.stage == "fingerprints"


def test_mask_and_fp_divergence(rng, monkeypatch):
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import seqcdc_masks as kmasks

    real_m = kmasks.seqcdc_masks
    monkeypatch.setattr(kmasks, "seqcdc_masks",
                        lambda d, L, mode="increasing": tuple(
                            ~m for m in real_m(d, L, mode)))
    with pytest.raises(MaskDivergenceError):
        _guarded(cross_check_masks=True, mask_impl="torch").submit(
            rng.integers(0, 256, 900, dtype=np.uint8))
    monkeypatch.undo()
    real_f = kfp.chunk_fingerprints

    def lying(*a, **k):
        f, ln = real_f(*a, **k)
        return (f.to(torch.int64) ^ 1).to(torch.uint32), ln

    monkeypatch.setattr(kfp, "chunk_fingerprints", lying)
    with pytest.raises(FingerprintDivergenceError):
        _guarded(cross_check_fps=True, fp_impl="torch").submit(
            rng.integers(0, 256, 900, dtype=np.uint8))
