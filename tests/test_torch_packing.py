"""The port's segment packing against the JAX reference, bit for bit.

Packed rows hold several streams back to back, and every layer must give
each stream what chunking it alone gives:

* ``core.seqcdc.boundaries_packed_batch`` against the reference's on the
  adversarial cases of tests/test_packing.py (``_packing_cases.py``:
  directed edges, skip overshoots at segment ends, ends on tile edges, the
  64 KiB limb row, random mixes in both modes, segments shorter than L, a
  row of about 160 tiny streams with G = 256);
* ``kernels.packed_pipeline.packed_pipeline_batch`` (its plain version on
  the CPU) against the reference's Pallas ``packed_pipeline_batch`` in
  interpret mode and its per-stream oracle ``kernels/ref.packed_pipeline``;
* the scheduler: packed equals off, its stats equal the reference's, the
  queue flushes at capacity, and the divergence guard fires;
* ``DedupService(packing_impl="segments")``: recipes, accounting and
  restores equal the reference service's, and depots interchange.

Every output is an integer: tolerance 0.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _packing_cases as cases_mod

from repro.core.automaton import max_chunks_for as jmax_chunks_for
from repro.core.oracle import boundaries_numpy as oracle_boundaries
from repro.core.params import SeqCDCParams as JParams
from repro.core.seqcdc import boundaries_packed as jboundaries_packed_row
from repro.core.seqcdc import boundaries_packed_batch as jboundaries_packed
from repro.kernels import ops, ref
from repro.kernels.fused_pipeline import packed_pipeline_batch as jpacked
from repro.service import ChunkScheduler as JChunkScheduler
from repro.service import DedupService as JDedupService

import repro_torch
from repro_torch.core.seqcdc import (
    boundaries_packed,
    boundaries_packed_batch,
    segment_end_positions,
)
from repro_torch.kernels import packed_pipeline as kpacked
from repro_torch.service import scheduler as sched_mod
from repro_torch.service import (
    ChunkScheduler,
    DedupService,
    PackingDivergenceError,
)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done.  The reference's
    module-level jits (its scheduler's ``_device_chunk_packed`` among them)
    would keep this file's traces, and a reference test that runs later in
    the same process and monkeypatches what such a jit calls would hit the
    cached trace and never see its patch."""
    yield
    jax.clear_caches()


ROOT = os.path.join(os.path.dirname(__file__), "..")

PARAMS = {name: JParams(**fields) for name, fields in
          cases_mod.PARAMS.items()}
P = PARAMS["small"]
PAPER = PARAMS["paper8k"]
CASES = cases_mod.CASES

_NAMES = ("bounds", "counts", "fps", "lengths")


def tp(p):
    return repro_torch.params_from_reference(p)


def _case(name):
    pname, S, streams = cases_mod.case(name)
    return PARAMS[pname], S, streams


def _operands(name):
    p, S, streams = _case(name)
    data, sep, ends, seg_lens = cases_mod.pack(streams, S)
    mc = S // p.min_size + 2 * ends.shape[1] + 2
    return p, S, data, sep, ends, seg_lens, mc


def _port_kernel(data, ends, p, mc):
    return kpacked.packed_pipeline_batch(
        torch.from_numpy(data), torch.from_numpy(ends), tp(p), max_chunks=mc)


def _assert_equal(got, want, label):
    for g, w, name in zip(got, want, _NAMES):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, f"{label} {name}"
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("name", CASES)
def test_boundaries_packed_and_oracle(name):
    """Packed boundaries against the reference's split path, and the whole
    packed pipeline against the per-stream oracle."""
    p, S, data, sep, ends, seg_lens, mc = _operands(name)
    np.testing.assert_array_equal(
        segment_end_positions(torch.from_numpy(ends), S).numpy(), sep)
    gb, gc = boundaries_packed_batch(
        torch.from_numpy(data), torch.from_numpy(sep),
        torch.from_numpy(ends), tp(p), max_chunks=mc)
    wb, wc = jboundaries_packed(jnp.asarray(data), jnp.asarray(sep),
                                jnp.asarray(ends), p, max_chunks=mc)
    _assert_equal((gb, gc), (wb, wc), f"{name} boundaries")
    rb, rc = boundaries_packed(torch.from_numpy(data[-1]),
                               torch.from_numpy(sep[-1]),
                               torch.from_numpy(ends[-1]), tp(p),
                               max_chunks=mc)
    _assert_equal((rb, rc), jboundaries_packed_row(
        jnp.asarray(data[-1]), jnp.asarray(sep[-1]), jnp.asarray(ends[-1]),
        p, max_chunks=mc), f"{name} one row")
    oracle = ref.packed_pipeline(data, seg_lens, p, max_chunks=mc)
    _assert_equal(_port_kernel(data, ends, p, mc), oracle, f"{name} oracle")


def _chip_mix_operands(mix):
    """Two rows of ``chip_smoke.py``'s packed phase layout for one segment
    mix (16 KiB rows, paper 8 KiB parameters), from the script itself."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    S = 16 << 10
    data, ends, rows = smoke.packed_rows(
        np.random.default_rng(sum(map(ord, mix))), mix, 2, S)
    sep = segment_end_positions(torch.from_numpy(ends), S).numpy()
    streams = [[seg.tobytes() for seg in row] for row in rows]
    return PAPER, S, data, sep, ends, streams


@pytest.mark.parametrize("name", CASES + ("chip all-tiny", "chip 512-2048",
                                          "chip heavy-tail<16KiB"))
def test_packed_bounds_are_each_segment_chunked_alone(name):
    """The two facts the packed kernel's segment-parallel scan rests on,
    held against the reference: its packed bounds are each segment's own
    bounds (the oracle on the segment alone) plus the segment's offset,
    and a segment of l bytes emits at most ``max_chunks_for(l) - 1`` of
    them, so per-segment slots summing to at most S / min_size + 2G
    always hold a row's emits.  Also the kernel's shortcut: a segment
    shorter than min_size is one chunk."""
    if name.startswith("chip "):
        p, S, data, sep, ends, streams = _chip_mix_operands(name[5:])
    else:
        p, S, streams = _case(name)
        data, sep, ends, _ = cases_mod.pack(streams, S)
    G = ends.shape[1]
    mc = S // p.min_size + 2 * G + 2
    wb, wc = jboundaries_packed(jnp.asarray(data), jnp.asarray(sep),
                                jnp.asarray(ends), p, max_chunks=mc)
    wb, wc = np.asarray(wb), np.asarray(wc)
    for bi, row in enumerate(streams):
        alone, off, need = [], 0, 0
        for seg in row:
            ob = (oracle_boundaries(np.frombuffer(seg, np.uint8), p)
                  if seg else np.zeros(0, np.int64))
            assert len(ob) <= jmax_chunks_for(len(seg), p) - 1
            if 0 < len(seg) < p.min_size:
                assert ob.tolist() == [len(seg)]
            alone.extend((ob + off).tolist())
            off += len(seg)
            need += jmax_chunks_for(len(seg), p)
        need += 2 * (G - len(row))  # the pad entries: empty segments
        assert need <= S // p.min_size + 2 * G
        assert int(wc[bi]) == len(alone), f"{name} row {bi}"
        assert wb[bi, :len(alone)].tolist() == alone, f"{name} row {bi}"


@pytest.mark.parametrize("group,tile", [
    (("directed-edges", "skip-overshoot", "shorter-than-L"), None),
    (("tile-edges", "random-increasing"), 1024),
    (("all-tiny-G256",), None),
])
def test_packed_kernel_matches_pallas_interpret(group, tile):
    """The port's packed pipeline against the reference's Pallas kernel in
    interpret mode (as tests/test_packing.py runs it).  Cases that share
    parameters and row width ride one batch, so each group compiles the
    interpret kernel once."""
    parts = [_case(name) for name in group]
    p, S = parts[0][0], parts[0][1]
    streams = []
    for q, width, rows in parts:
        assert (q, width) == (p, S)
        streams.extend(rows)
    data, sep, ends, _ = cases_mod.pack(streams, S)
    mc = S // p.min_size + 2 * ends.shape[1] + 2
    got = _port_kernel(data, ends, p, mc)
    if tile is None:
        want = ops.packed_pipeline(jnp.asarray(data), jnp.asarray(sep),
                                   jnp.asarray(ends), p, max_chunks=mc)
    else:
        want = jpacked(jnp.asarray(data), jnp.asarray(sep),
                       jnp.asarray(ends), p, max_chunks=mc, tile=tile,
                       interpret=True)
    _assert_equal(got, want, "/".join(group))


@pytest.mark.parametrize("ends,mc", [
    ([1000, 2500, 4096, 4096], 3),
    ([1000, 2500, 4096, 4096], 1),
    ([4096, 4096, 4096, 4096], 5),
    ([700, 2000, 2050, 4096], 9),
])
def test_undersized_max_chunks_drops_overflow_whole(ends, mc):
    """Below a true bound the reference's Pallas packed kernel drops emits
    past ``max_chunks`` whole; the port's plain version gives its fps,
    bounds, counts and lengths.  The first case is the smallest input
    found that told its tail from the split path's."""
    data = np.random.default_rng(0).integers(0, 256, (1, 4096),
                                             dtype=np.uint8)
    e = np.asarray([ends], np.int32)
    sep = segment_end_positions(torch.from_numpy(e), 4096).numpy()
    got = _port_kernel(data, e, P, mc)
    want = jpacked(jnp.asarray(data), jnp.asarray(sep), jnp.asarray(e), P,
                   max_chunks=mc, interpret=True)
    _assert_equal(got, want, f"ends {ends} mc {mc}")


def test_packed_row_too_wide_rejected():
    data = torch.zeros((1, 1 << 17), dtype=torch.uint8)
    ends = torch.full((1, 2), 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="narrower"):
        kpacked.packed_pipeline_batch(data, ends, tp(P), max_chunks=8)


# -- scheduler --------------------------------------------------------------

def _all_tiny(rng):
    return int(rng.integers(100, 1000))


def _bimodal(rng):
    if rng.random() < 0.8:
        return int(rng.integers(512, 2048))
    return int(rng.integers(256 << 10, 1 << 20))


_STATS = ("dispatches", "device_bytes", "device_rows", "stream_bytes",
          "tail_bytes", "packed_streams")


@pytest.mark.parametrize("mix,count", [(_all_tiny, 300), (_bimodal, 12)])
def test_scheduler_packed_equals_off_and_reference(mix, count):
    """At paper 8 KiB parameters: the packed scheduler returns the
    packing-off scheduler's results stream for stream, and its stats equal
    the reference's packed scheduler's for the same submission order."""
    rng = np.random.default_rng(17)
    streams = [rng.integers(0, 256, mix(rng), dtype=np.uint8)
               for _ in range(count)]

    def chunk(sched):
        for i, s in enumerate(streams):
            sched.submit(s, tag=i)
        return sched.drain()

    on_sched = ChunkScheduler(tp(PAPER), device="cpu", slots=8,
                              packing_impl="segments",
                              cross_check_packing=True)
    on = chunk(on_sched)
    off = chunk(ChunkScheduler(tp(PAPER), device="cpu", slots=8))
    ref_sched = JChunkScheduler(PAPER, slots=8, packing_impl="segments",
                                pipeline_impl="split")
    ref_res = chunk(ref_sched)
    assert [r.tag for r in on] == [r.tag for r in off] == list(range(count))
    for a, b, c in zip(off, on, ref_res):
        for field in ("bounds", "lengths", "fps"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
            np.testing.assert_array_equal(getattr(c, field),
                                          getattr(b, field))
    for field in _STATS:
        assert getattr(on_sched.stats, field) == \
            getattr(ref_sched.stats, field), field
    assert on_sched.stats.packed_streams > 0
    assert on_sched._packing_checked
    snap = on_sched.obs.snapshot()
    assert snap["counters"]["sched.cross_checks{kind=packing}"] == 1
    assert any("packed=1" in k for k in snap["gauges"]), snap["gauges"]


def test_scheduler_pack_queue_flushes_on_capacity():
    """The pack queue dispatches by itself once a device batch of packed
    rows is payload-full: 2 slots x 1024 bytes fill at the third 800-byte
    stream."""
    sched = ChunkScheduler(tp(P), device="cpu", slots=2, min_bucket=1024,
                           packing_impl="segments")
    rng = np.random.default_rng(1)
    n = 0
    while sched.stats.dispatches == 0:
        sched.submit(rng.integers(0, 256, 800, dtype=np.uint8))
        n += 1
        assert n < 100, "pack queue never dispatched"
    assert n == 3
    assert sched.stats.packed_streams == 3


def test_scheduler_knobs():
    """min_bucket past the packed row bound is refused (with packing off it
    is fine); the default is off."""
    with pytest.raises(ValueError, match="min_bucket"):
        ChunkScheduler(tp(P), device="cpu", min_bucket=1 << 17,
                       packing_impl="segments")
    ChunkScheduler(tp(P), device="cpu", min_bucket=1 << 17)
    assert ChunkScheduler(tp(P), device="cpu").packing_impl == "off"


def _tiny_streams(rng, count, lo=100, hi=900):
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8)
            for _ in range(count)]


def test_guard_off_by_default():
    sched = ChunkScheduler(tp(P), device="cpu", slots=2, min_bucket=1024,
                           packing_impl="segments")
    for s in _tiny_streams(np.random.default_rng(2), 3, 200, 400):
        sched.submit(s)
    sched.drain()
    assert "sched.cross_checks{kind=packing}" not in \
        sched.obs.snapshot()["counters"]
    assert not sched._packing_checked


def _corrupt_bound(out):
    b, c, f, l = out
    b = b.clone()
    b[:, 0] += 1
    return b, c, f, l


def _corrupt_fp(out):
    b, c, f, l = out
    f = f.clone()
    f[:, 0, 0] = (f[:, 0, 0].to(torch.int64) + 1).to(torch.uint32)
    return b, c, f, l


@pytest.mark.parametrize("impl,runner,corrupt", [
    ("split", "_run_packed_split", _corrupt_bound),
    ("fused", "_run_packed_fused", _corrupt_bound),
    ("fused", "_run_packed_fused", _corrupt_fp),
])
def test_divergence_injection(monkeypatch, impl, runner, corrupt):
    """A packed runner that corrupts one bound (or one fingerprint) trips
    PackingDivergenceError on the first packed dispatch; the error
    propagates out of drain."""
    real = getattr(sched_mod, runner)
    monkeypatch.setattr(sched_mod, runner,
                        lambda *args: corrupt(real(*args)))
    sched = ChunkScheduler(tp(P), device="cpu", slots=2, min_bucket=4096,
                           packing_impl="segments", pipeline_impl=impl,
                           cross_check_packing=True)
    for s in _tiny_streams(np.random.default_rng(3), 3):
        sched.submit(s)
    with pytest.raises(PackingDivergenceError, match="diverged"):
        sched.drain()


# -- the service ------------------------------------------------------------

def _heavy_tail_corpus(seed, objects, cap):
    """Two versions of ``objects`` files, sizes lognormal(9.0, 1.6) clipped
    to 256 bytes-``cap`` (the repo's heavy-tail draw, capped for CPU
    time); version 2 edits a span in every other file."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.lognormal(9.0, 1.6, objects), 256, cap).astype(int)
    v1 = [rng.integers(0, 256, int(n), dtype=np.uint8) for n in sizes]
    v2 = []
    for i, obj in enumerate(v1):
        if i % 2:
            obj = obj.copy()
            pos = int(rng.integers(0, obj.size))
            obj[pos:pos + 64] = rng.integers(0, 256, 64, dtype=np.uint8)[
                : obj.size - pos]
        v2.append(obj)
    return [v1, v2]


def _ingest(svc, corpus):
    for v, objs in enumerate(corpus):
        for i, obj in enumerate(objs):
            svc.submit(f"v{v}/f{i}", obj)
        svc.flush()


def test_packed_service_matches_reference_and_depots_interchange(tmp_path):
    corpus = _heavy_tail_corpus(5, objects=24, cap=32 << 10)
    kw = dict(slots=4, min_bucket=4096, packing_impl="segments")
    proot, jroot = str(tmp_path / "port"), str(tmp_path / "ref")
    port = DedupService.open(proot, params=tp(P), device="cpu",
                             cross_check_packing=True, **kw)
    ref_svc = JDedupService.open(jroot, params=P, pipeline_impl="split",
                                 **kw)
    _ingest(port, corpus)
    _ingest(ref_svc, corpus)
    assert port.scheduler.stats.packed_streams > 0
    assert port.names() == ref_svc.names()
    for name in ref_svc.names():
        assert port.recipes.get(name).to_json() == \
            ref_svc.recipes.get(name).to_json(), name
    for v, objs in enumerate(corpus):
        for i, obj in enumerate(objs):
            assert port.get(f"v{v}/f{i}") == obj.tobytes()
    ps, rs = port.stats(), ref_svc.stats()
    for field in ("logical_bytes", "stored_bytes", "total_chunks",
                  "unique_chunks", "batches"):
        assert getattr(ps, field) == getattr(rs, field), field
    assert ps.dedup_ratio == rs.dedup_ratio > 1.0
    del port, ref_svc
    # each package reopens the other's depot and restores it SHA-verified
    for root, other in ((jroot, DedupService), (proot, JDedupService)):
        if other is DedupService:
            svc = other.open(root, params=tp(P), device="cpu", **kw)
        else:
            svc = other.open(root, params=P, **kw)
        for v, objs in enumerate(corpus):
            for i, obj in enumerate(objs):
                assert svc.get(f"v{v}/f{i}") == obj.tobytes()
        assert svc.gc().freed_blocks == 0
