"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA card: they
are marked ``cuda`` and skip with a reason elsewhere.  On the card, run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports neither jax nor the JAX package: the plain torch
versions, which the CPU tests hold against the reference, are the oracle
here, every output compared bit for bit.
"""
import dataclasses
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import _packing_cases
import _select_packed_cases
from repro_torch.core import available, make_chunker
from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.automaton import select_boundaries as select_plain
from repro_torch.core.automaton import (
    select_boundaries_packed as select_packed_plain,
)
from repro_torch.core.baselines.selectors import SelectorParams, select_numpy
from repro_torch.core.calibrate import calibrated_kwargs
from repro_torch.core.oracle import boundaries_numpy
from repro_torch.core.params import SeqCDCParams, paper_params
from repro_torch.core.seqcdc import (
    boundaries_sequential,
    packed_masks,
    segment_end_positions,
)
from repro_torch.dedup.fingerprint import fingerprints_numpy
from repro_torch.kernels import extremum as kext
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import fused_pipeline as kfused
from repro_torch.kernels import gear_hash as kgear
from repro_torch.kernels import native_scan as kscan
from repro_torch.kernels import packed_pipeline as kpacked
from repro_torch.kernels import select_boundaries as kselect
from repro_torch.kernels import select_boundaries_event as ksele
from repro_torch.kernels import select_boundaries_gather as kselg
from repro_torch.kernels import select_boundaries_packed as kselp
from repro_torch.kernels import seqcdc_masks as kmasks
from repro_torch.service import (
    ChunkScheduler,
    DedupService,
    ShardedDedupService,
)

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(__file__), "..")

P = SeqCDCParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
                 min_size=64, max_size=512)
PARAMS = {
    "P": P,
    "P5": dataclasses.replace(P, seq_length=5),
    "dec": dataclasses.replace(P, mode="decreasing"),
    "skid": SeqCDCParams(avg_size=4096, seq_length=5, skip_trigger=3,
                         skip_size=3000, min_size=2048, max_size=8192),
    "w16": SeqCDCParams(avg_size=128, seq_length=6, skip_trigger=2,
                        skip_size=16, min_size=32, max_size=256),
    "w4": SeqCDCParams(avg_size=128, seq_length=3, skip_trigger=1,
                       skip_size=4, min_size=32, max_size=256),
    "paper8k": paper_params(8192),
    "paper16k-dec": paper_params(16384, "decreasing"),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _rows(rng, n: int) -> np.ndarray:
    idx = np.arange(n)
    return np.stack([
        rng.integers(0, 256, n, dtype=np.uint8),
        rng.integers(0, 4, n, dtype=np.uint8),
        np.zeros(n, dtype=np.uint8),
        (idx % 256).astype(np.uint8),
        np.tile(np.array([1, 2], dtype=np.uint8), (n + 1) // 2)[:n],
    ])


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 63, 1000, 4099, 70001])
@pytest.mark.parametrize("L,mode", [(2, "increasing"), (5, "increasing"),
                                    (5, "decreasing")])
def test_masks_kernel(dev, n, L, mode):
    x = torch.from_numpy(_rows(np.random.default_rng(n), n)).to(dev)
    _equal(kmasks.seqcdc_masks(x, L, mode),
           kmasks.seqcdc_masks_plain(x, L, mode))
    _equal(kmasks.seqcdc_masks(x[0], L, mode),
           kmasks.seqcdc_masks_plain(x[0], L, mode))


def _offset_view(dev, host: np.ndarray, off: int, rng) -> torch.Tensor:
    """``host`` (B, n) on the card as a view that starts ``off`` bytes past
    a 16-byte boundary, random bytes before and after it."""
    flat = rng.integers(0, 256, off + host.size + 32, dtype=np.uint8)
    flat[off: off + host.size] = host.ravel()
    return torch.from_numpy(flat).to(dev)[off: off + host.size].view(
        host.shape)


@pytest.mark.parametrize("L", [2, 5, 16, 17, 18, 33, 49, 64])
@pytest.mark.parametrize("n", [15, 16, 17, 31, 32, 33, 511, 512, 513, 4099,
                               70001])
def test_masks_kernel_windows_offsets_and_long_runs(dev, L, n):
    """Runs up to the 64-bit window's 48 pairs and past it (L = 64 takes
    the second kernel), rows shorter and longer than a block, a warp and a
    CTA's span, batches of 1 and 5 rows starting 0, 1 and 3 bytes off 16:
    random, constant, both ramps and a 4-value row."""
    rng = np.random.default_rng(100 * n + L)
    idx = np.arange(n)
    host = np.stack([rng.integers(0, 256, n, dtype=np.uint8),
                     np.full(n, 0x5A, np.uint8),
                     (idx % 256).astype(np.uint8),
                     (255 - idx % 256).astype(np.uint8),
                     rng.integers(0, 4, n, dtype=np.uint8)])
    for B in (1, 5):
        for off in (0, 1, 3):
            x = _offset_view(dev, host[:B], off, rng)
            for mode in ("increasing", "decreasing"):
                _equal(kmasks.seqcdc_masks(x, L, mode),
                       kmasks.seqcdc_masks_plain(x, L, mode))


def _fingerprint_cases(rng):
    """(host, bounds, counts, mc): chunks of 1-47 bytes (bounds at every
    residue mod 16) beside a count=0 row; a 65,536-byte chunk, one of
    200,000 (past the clamp) and a 5-byte one; an undersized table."""
    cuts = np.cumsum(rng.integers(1, 48, 700))
    assert set(cuts % 16) == set(range(16))
    n = int(cuts[-1])
    b = np.full((2, len(cuts) + 2), 1 << 30, np.int32)
    b[0, : len(cuts)] = cuts
    yield (rng.integers(0, 256, (2, n), dtype=np.uint8), b,
           np.array([len(cuts), 0]), len(cuts) + 2)
    n = 65536 + 200_000 + 5
    yield (rng.integers(0, 256, (1, n), dtype=np.uint8),
           np.array([[65536, 265536, n, 1 << 30]], np.int32),
           np.array([3]), 4)
    yield (np.full((1, n), 0xFF, np.uint8),
           np.array([[65536, 265536, n, 1 << 30]], np.int32),
           np.array([3]), 4)
    yield (rng.integers(0, 256, (3, 9000), dtype=np.uint8),
           np.array([[1000, 9000], [4000, 8000], [70, 1 << 30]], np.int32),
           np.array([2, 2, 0]), 2)


@pytest.mark.parametrize("off", [0, 1, 3])
def test_fingerprint_kernel_pieces_ends_and_clamp(dev, off):
    """The kernel's 16-byte pieces against the plain version: chunk ends
    at every residue mod 16, chunks shorter than a piece, a 64 KiB chunk
    and one past the clamp, count=0 rows and an undersized table, with
    rows 0, 1 and 3 bytes off 16."""
    rng = np.random.default_rng(off)
    for host, bounds, counts, mc in _fingerprint_cases(rng):
        x = _offset_view(dev, host, off, rng)
        b = torch.from_numpy(bounds).to(dev)
        c = torch.from_numpy(counts.astype(np.int32)).to(dev)
        got = kfp.chunk_fingerprints(x, b, c, max_chunks=mc)
        want = kfp.chunk_fingerprints_plain(x, b, c, max_chunks=mc)
        torch.cuda.synchronize()
        _equal(got, want)


def test_fingerprint_kernel_on_seqcdc_bounds_at_1mib_x8(dev):
    """Phase 3's shape: 8 random 1 MiB rows over their SeqCDC bounds
    (paper 8 KiB parameters), every row against fingerprints_numpy."""
    p = PARAMS["paper8k"]
    host = np.random.default_rng(8).integers(0, 256, (8, 1 << 20),
                                             dtype=np.uint8)
    x = torch.from_numpy(host).to(dev)
    mc = max_chunks_for(host.shape[1], p)
    b, c = kfused.fused_pipeline_batch(x, p, max_chunks=mc)[:2]
    fps, lens = kfp.chunk_fingerprints(x, b, c, max_chunks=mc)
    torch.cuda.synchronize()
    bounds, counts = b.cpu().numpy(), c.cpu().numpy()
    fps = fps.cpu().numpy()
    for r in range(8):
        ob = bounds[r, : counts[r]]
        assert ob.tolist() == boundaries_numpy(host[r], p).tolist()
        np.testing.assert_array_equal(fps[r, : counts[r]],
                                      fingerprints_numpy(host[r], ob))
        assert not fps[r, counts[r]:].any()


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", [1, 64, 5000, 40000])
def test_fused_and_fingerprint_kernels(dev, name, n):
    p = PARAMS[name]
    host = _rows(np.random.default_rng(n), n)
    x = torch.from_numpy(host).to(dev)
    mc = max_chunks_for(n, p)
    got = kfused.fused_pipeline_batch(x, p, max_chunks=mc)
    want = kfused.fused_pipeline_plain(x, p, max_chunks=mc)
    torch.cuda.synchronize()
    _equal(got, want)
    b, c = want[0], want[1]
    _equal(kfp.chunk_fingerprints(x, b, c, max_chunks=mc),
           kfp.chunk_fingerprints_plain(x, b, c, max_chunks=mc))
    bounds, counts, fps = (t.cpu().numpy() for t in got[:3])
    for r in range(host.shape[0]):
        ob = boundaries_numpy(host[r], p)
        assert bounds[r, : counts[r]].tolist() == ob.tolist()
        np.testing.assert_array_equal(fps[r, : counts[r]],
                                      fingerprints_numpy(host[r], ob))


#: rows long enough that the fused kernel's ring of shared-memory slabs
#: wraps many times, and the adversarial contents of a row
BIG_ROWS = [1 << 20, 2 << 20]
ROW_KINDS = ("constant", "ramp", "period", "random")


def _big_row(rng, p, n: int, kind: str) -> np.ndarray:
    if kind == "constant":  # no candidates, no opposing pairs
        return np.full(n, 0x5A, np.uint8)
    if kind == "ramp":  # strictly increasing, wrapping every 256 bytes
        return (np.arange(n) % 256).astype(np.uint8)
    if kind == "period":  # a random pattern of period max_size
        return np.resize(rng.integers(0, 256, p.max_size, dtype=np.uint8), n)
    return rng.integers(0, 256, n, dtype=np.uint8)


def _fused_against_plain(x, host, p):
    """The fused kernel against fused_pipeline_plain bit for bit (its
    automaton stage the plain torch loop where that walks at most 8,192
    W-blocks, else the select kernel, which the select tests hold against
    that loop), and every row's bounds against the numpy oracle."""
    n = x.shape[1]
    mc = max_chunks_for(n, p)
    sel = "torch" if n // p.block_width <= 8192 else "cuda"
    got = kfused.fused_pipeline_batch(x, p, max_chunks=mc)
    want = kfused.fused_pipeline_plain(x, p, max_chunks=mc, select_impl=sel)
    torch.cuda.synchronize()
    _equal(got, want)
    bounds, counts, fps = (t.cpu().numpy() for t in got[:3])
    for r in range(host.shape[0]):
        ob = boundaries_numpy(host[r], p)
        assert bounds[r, : counts[r]].tolist() == ob.tolist(), r
    ob = bounds[0, : counts[0]]
    np.testing.assert_array_equal(fps[0, : counts[0]],
                                  fingerprints_numpy(host[0], ob))


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", BIG_ROWS)
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_fused_kernel_one_big_row(dev, name, n, kind):
    p = PARAMS[name]
    host = _big_row(np.random.default_rng(n), p, n, kind)[None]
    _fused_against_plain(torch.from_numpy(host).to(dev), host, p)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", BIG_ROWS)
def test_fused_kernel_big_batch(dev, name, n):
    """Eight rows of every adversarial kind at once, 7 bytes past the
    size, so each row starts at another offset from 16 bytes (the ring's
    copy width)."""
    p = PARAMS[name]
    rng = np.random.default_rng(n + 1)
    host = np.stack([_big_row(rng, p, n + 7, kind)
                     for kind in ROW_KINDS + ROW_KINDS[::-1]])
    host[6] = 255 - host[6]  # a decreasing ramp
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(3, np.uint8), host.ravel()])).to(dev)
    x = flat[3:].view(host.shape)  # rows start off 16 bytes
    _fused_against_plain(x, host, p)


def test_fingerprint_kernel_counts_and_undersized_table(dev):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (3, 9000),
                                      dtype=np.uint8)).to(dev)
    bounds = torch.tensor([[1000, 9000, 1 << 30], [4000, 8000, 9000],
                           [70, 1 << 30, 1 << 30]], dtype=torch.int32,
                          device=dev)
    counts = torch.tensor([2, 3, 0], dtype=torch.int32, device=dev)
    for mc in (3, 2):
        b = bounds[:, :mc].contiguous()
        _equal(kfp.chunk_fingerprints(x, b, counts.clamp(max=mc),
                                      max_chunks=mc),
               kfp.chunk_fingerprints_plain(x, b, counts.clamp(max=mc),
                                            max_chunks=mc))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((2, 100), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kmasks.seqcdc_masks(x, 3)
    with pytest.raises(ValueError):
        kfused.fused_pipeline_batch(x, P, max_chunks=4)
    # a halo past the kernel's shared tile: the launcher refuses it
    wide_l = dataclasses.replace(P, seq_length=66, min_size=1024,
                                 max_size=2048)
    with pytest.raises(RuntimeError, match="failed to launch"):
        kfused.fused_pipeline_batch(x.to(torch.uint8), wide_l, max_chunks=4)
    with pytest.raises(ValueError):
        kfp.chunk_fingerprints(x.to(torch.uint8), torch.zeros(
            (2, 4), dtype=torch.int64, device=dev), torch.zeros(
            2, dtype=torch.int32, device=dev), max_chunks=4)


def test_service_on_the_card_counts_launches(dev):
    # the unpacked path's kernels (packing is off by default)
    KERNELS = (kmasks.KERNEL, kfp.KERNEL, kfused.KERNEL)
    rng = np.random.default_rng(9)
    svc = DedupService(params=P, device=dev, slots=2, min_bucket=1024,
                       cross_check_masks=True, cross_check_fps=True,
                       cross_check_pipeline=True)
    for k in KERNELS:
        k.launches = 0
    objs = [rng.integers(0, 256, int(m), dtype=np.uint8)
            for m in rng.integers(0, 9000, 12)]
    for i, o in enumerate(objs):
        svc.submit(str(i), o)
    svc.flush()
    assert all(k.launches > 0 for k in KERNELS), [
        (k.name, k.launches) for k in KERNELS]
    for i, o in enumerate(objs):
        assert svc.get(str(i)) == o.tobytes()
        r = svc.recipes.get(str(i))
        ob = boundaries_numpy(o, P)
        assert r.chunk_lens == np.diff(np.concatenate([[0], ob])).tolist()


def _packed_cases(rng, p, S):
    """Segment mixes: directed edges, constant and low-entropy segments
    that end mid-skip, segments shorter than L, and random mixes."""
    r = lambda n: rng.integers(0, 256, n, dtype=np.uint8)
    z = lambda n: np.zeros(n, np.uint8)
    low = lambda n: rng.integers(0, 3, n, dtype=np.uint8)
    rows = [[r(1), z(0), r(p.min_size), r(300), r(1)],
            [z(0), z(0), r(700)],
            [r(1)] * 40,
            [z(70), z(100), z(130), low(200), z(65)],
            [z(64 + q) for q in range(0, 200, 5)],
            [r(int(n)) for n in rng.integers(1, p.seq_length + 1, 60)],
            [],
            [r(S)]]
    for mode in range(4):
        row, fill = [], 0
        while True:
            n = int(rng.integers(0, max(2, S // 8)))
            if fill + n > S:
                break
            seg = (r(n), z(n), low(n), r(n) if n % 2 else z(n))[mode]
            row.append(seg)
            fill += n
        rows.append(row)
    out = []
    for row in rows:
        fill, cut = 0, []
        for seg in row:
            if fill + seg.size > S:
                break
            cut.append(seg)
            fill += seg.size
        out.append(cut or [z(0)])
    return out


@pytest.mark.parametrize("name,S", [("P", 1024), ("P", 4096),
                                    ("P5", 8192), ("dec", 2048),
                                    ("skid", 16384), ("w16", 3000),
                                    ("w4", 1500), ("paper8k", 16384),
                                    ("paper16k-dec", 32768)])
def test_packed_kernel(dev, name, S):
    p = PARAMS[name]
    rng = np.random.default_rng(S)
    streams = _packed_cases(rng, p, S)
    data, _, ends, _ = _packing_cases.pack(
        [[seg.tobytes() for seg in row] for row in streams], S)
    x = torch.from_numpy(data).to(dev)
    e = torch.from_numpy(ends).to(dev)
    mc = S // p.min_size + 2 * ends.shape[1] + 2
    got = kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)
    want = kpacked.packed_pipeline_plain(x, e, p, max_chunks=mc)
    torch.cuda.synchronize()
    _equal(got, want)
    bounds, counts, fps = (t.cpu().numpy() for t in got[:3])
    for bi, row in enumerate(streams):  # per stream, the numpy oracle
        off, j = 0, 0
        for seg in row:
            ob = boundaries_numpy(seg, p) if seg.size else np.zeros(0, int)
            k = len(ob)
            assert bounds[bi, j:j + k].tolist() == (ob + off).tolist()
            np.testing.assert_array_equal(fps[bi, j:j + k],
                                          fingerprints_numpy(seg, ob))
            off += seg.size
            j += k
        assert counts[bi] == j


@pytest.mark.parametrize("name", _packing_cases.CASES)
def test_packed_kernel_on_the_cpu_tests_cases(dev, name):
    """The cases tests/test_torch_packing.py holds against the reference,
    held here against the plain version."""
    pname, S, rows = _packing_cases.case(name)
    p = SeqCDCParams(**_packing_cases.PARAMS[pname])
    data, _, ends, _ = _packing_cases.pack(rows, S)
    x = torch.from_numpy(data).to(dev)
    e = torch.from_numpy(ends).to(dev)
    mc = S // p.min_size + 2 * ends.shape[1] + 2
    got = kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)
    torch.cuda.synchronize()
    _equal(got, kpacked.packed_pipeline_plain(x, e, p, max_chunks=mc))


def _chip_mix(mix: str, seed: int):
    """``chip_smoke.py``'s packed phase rows for one segment mix: 8 rows of
    16 KiB at paper 8 KiB parameters, ``(data, ends, streams)``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.packed_rows(np.random.default_rng(seed), mix, 8, 16 << 10)


@pytest.mark.parametrize("name,S", [("P", 4096), ("w4", 1500),
                                    ("paper8k", 16384),
                                    ("chip all-tiny", 16384),
                                    ("chip 512-2048", 16384),
                                    ("chip heavy-tail<16KiB", 16384)])
@pytest.mark.parametrize("short", [1, 3])
def test_packed_kernel_drops_overflow_at_undersized_max_chunks(dev, name, S,
                                                                short):
    """Below a true bound on the chunk count the kernel drops emits past
    max_chunks whole, as its plain version and the reference's kernel do:
    the fullest row keeps ``short`` chunks fewer than it has (also on the
    three segment mixes ``chip_smoke.py`` times the kernel on)."""
    if name.startswith("chip "):
        p = PARAMS["paper8k"]
        data, ends, _ = _chip_mix(name[5:], S + short)
    else:
        p = PARAMS[name]
        streams = _packed_cases(np.random.default_rng(S + short), p, S)
        data, _, ends, _ = _packing_cases.pack(
            [[seg.tobytes() for seg in row] for row in streams], S)
    x = torch.from_numpy(data).to(dev)
    e = torch.from_numpy(ends).to(dev)
    true_mc = S // p.min_size + 2 * ends.shape[1] + 2
    counts = kpacked.packed_pipeline_plain(x, e, p, max_chunks=true_mc)[1]
    mc = max(1, int(counts.max()) - short)
    got = kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)
    torch.cuda.synchronize()
    _equal(got, kpacked.packed_pipeline_plain(x, e, p, max_chunks=mc))


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("short", [1, 4])
def test_kernels_drop_overflow_at_undersized_max_chunks(dev, name, short):
    """The fused, select and native seqcdc kernels below a true bound: the
    fullest row keeps ``short`` chunks fewer than it has, emits past the
    table are counted and dropped whole, as the plain versions do."""
    p = PARAMS[name]
    n = 20000
    x = torch.from_numpy(_rows(np.random.default_rng(n + short), n)).to(dev)
    counts = kfused.fused_pipeline_plain(
        x, p, max_chunks=max_chunks_for(n, p))[1]
    mc = max(1, int(counts.max()) - short)
    _equal(kfused.fused_pipeline_batch(x, p, max_chunks=mc),
           kfused.fused_pipeline_plain(x, p, max_chunks=mc))
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    _equal(kselect.select_boundaries(cand, opp, n, p, max_chunks=mc),
           select_plain(cand, opp, n, p, max_chunks=mc))
    _equal(kscan.native_scan(x, "seqcdc", params=p, max_chunks=mc),
           kscan.native_scan_plain(x, "seqcdc", params=p, max_chunks=mc))


def _packed_against_oracle(dev, p, streams, S, G=None):
    """The packed kernel on ``streams`` packed into rows of ``S``, each
    segment's bounds and fingerprints held against the numpy oracle on the
    segment alone, lengths against the bounds, the rest of the table
    against the sentinels; returns the kernel's outputs."""
    data, _, ends, _ = _packing_cases.pack(
        [[seg.tobytes() for seg in row] for row in streams], S, G)
    x = torch.from_numpy(data).to(dev)
    e = torch.from_numpy(ends).to(dev)
    mc = S // p.min_size + 2 * ends.shape[1] + 2
    got = kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)
    torch.cuda.synchronize()
    bounds, counts, fps, lens = (t.cpu().numpy() for t in got)
    for bi, row in enumerate(streams):
        want, fp_want, off = [], [], 0
        for seg in row:
            if seg.size:
                ob = boundaries_numpy(seg, p)
                want.extend((ob + off).tolist())
                fp_want.append(fingerprints_numpy(seg, ob))
            off += seg.size
        k = len(want)
        assert counts[bi] == k
        assert bounds[bi, :k].tolist() == want
        assert (bounds[bi, k:] == 1 << 30).all()
        assert lens[bi, :k].tolist() == np.diff([0] + want).tolist()
        assert (lens[bi, k:] == 0).all() and (fps[bi, k:] == 0).all()
        if k:
            np.testing.assert_array_equal(fps[bi, :k],
                                          np.concatenate(fp_want))
    return got, x, e, mc


@pytest.mark.parametrize("name,S", [("P", 4096), ("w4", 2048),
                                    ("dec", 4096), ("paper8k", 65536)])
def test_packed_kernel_segment_edges(dev, name, S):
    """Segments at the edges of the segment-parallel scan, against the
    oracle per segment and the plain version: empty segments (repeated
    ends) around others, segments shorter than L-1, one segment filling
    the row, constant-byte segments (max-size cuts only), a segment whose
    last max-size cut lands exactly on its end, and a row of segments of
    exactly min_size and min_size - 1."""
    p = PARAMS[name]
    rng = np.random.default_rng(S + len(name))
    r = lambda n: rng.integers(0, 256, n, dtype=np.uint8)
    z = lambda n: np.zeros(n, np.uint8)
    c = lambda n, v: np.full(n, v, np.uint8)
    L, mn, mx = p.seq_length, p.min_size, p.max_size
    rows = [
        [z(0), r(100), z(0), z(0), r(mn + 3), z(0), z(0), r(1), z(0)],
        [r(int(k)) for k in rng.integers(1, max(2, L - 1), 50)] + [r(300)],
        [r(S)],
        [c(S, 7)],
        [c(2 * mx, 3), r(mn), c(mx + 1, 9)],
        [r(mn), r(mn - 1), r(mn), z(mn - 1), r(mn)],
    ]
    for row in rows:
        assert sum(seg.size for seg in row) <= S, name
    got, x, e, mc = _packed_against_oracle(dev, p, rows, S)
    _equal(got, kpacked.packed_pipeline_plain(x, e, p, max_chunks=mc))


@pytest.mark.parametrize("name", ["P", "paper8k"])
def test_packed_kernel_65536_one_byte_segments(dev, name):
    """A 64 KiB row of 65,536 one-byte streams (G = 65,536: the kernel's
    scratch no longer fits in shared memory and lies in device memory),
    beside a row of two long segments around 40,000 empty ones, against
    the oracle per segment."""
    p = PARAMS[name]
    S = 1 << 16
    rng = np.random.default_rng(5)
    ones = [rng.integers(0, 256, 1, dtype=np.uint8) for _ in range(S)]
    empty = np.zeros(0, np.uint8)
    long_row = ([rng.integers(0, 256, 30000, dtype=np.uint8)]
                + [empty] * 40000
                + [rng.integers(0, 256, S - 30000, dtype=np.uint8)])
    got, *_ = _packed_against_oracle(dev, p, [ones, long_row], S, G=S)
    assert int(got[1][0]) == S


def test_packed_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros((2, 1024), dtype=torch.uint8, device=dev)
    e = torch.full((2, 4), 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kpacked.packed_pipeline_batch(x, e.to(torch.int64), P, max_chunks=40)
    with pytest.raises(ValueError, match="narrower"):
        kpacked.packed_pipeline_batch(
            torch.zeros((1, 1 << 17), dtype=torch.uint8, device=dev),
            e[:1], P, max_chunks=8)


def test_sharded_packed_service_on_the_card_counts_launches(dev):
    from repro_torch.kernels import KERNELS

    rng = np.random.default_rng(11)
    with ShardedDedupService(
            2, params=P, device=dev, slots=2, min_bucket=1024,
            packing_impl="segments", cross_check_packing=True,
            cross_check_pipeline=True) as svc:
        for k in KERNELS:
            k.launches = 0
        objs = [rng.integers(0, 256, int(m), dtype=np.uint8)
                for m in rng.integers(0, 3000, 30)]
        for i, o in enumerate(objs):
            svc.submit(str(i), o)
        svc.flush()
        assert kpacked.KERNEL.launches > 0
        assert svc.scheduler.stats.packed_streams > 0
        for i, o in enumerate(objs):
            assert svc.get(str(i)) == o.tobytes()


# -- the packed select kernel ----------------------------------------------

def _bitmap_at(dev, t: torch.Tensor, off: int, rng) -> torch.Tensor:
    """A copy of the (B, n) bool bitmap ``t`` as a view that starts ``off``
    bytes into an allocation of its own, random bits before it; the last
    row ends where the allocation's requested bytes end."""
    buf = torch.from_numpy(rng.random(off + t.numel()) < 0.5).to(dev)
    buf[off:] = t.reshape(-1)
    view = buf[off:].view(t.shape)
    assert view.data_ptr() % 16 == off % 16
    return view


def _select_packed_equal(dev, p, data, ends, short=0, offsets=None):
    """The packed select kernel on the masks kernel's bitmaps of packed
    ``data``, clipped per segment, against its plain version and against
    the packed kernel's bounds and counts; ``short`` > 0 cuts the table to
    the fullest row's count less ``short`` (emits dropped); ``offsets``
    (oc, oo) gives the kernel the bitmaps as views starting oc and oo bytes
    past a 16-byte boundary."""
    x = torch.from_numpy(data).to(dev)
    e = torch.from_numpy(ends).to(dev)
    S = data.shape[1]
    mc = _select_packed_cases.true_max_chunks(S, p.min_size, ends.shape[1])
    cand, opp = packed_masks(x, segment_end_positions(e, S), p,
                             mask_impl="cuda")
    if short:
        counts = select_packed_plain(cand, opp, e, p, max_chunks=mc)[1]
        mc = max(1, int(counts.max()) - short)
    kc, ko = cand, opp
    if offsets is not None:
        rng = np.random.default_rng(sum(offsets))
        kc, ko = (_bitmap_at(dev, t, o, rng)
                  for t, o in zip((cand, opp), offsets))
    got = kselp.select_boundaries_packed(kc, ko, e, p, max_chunks=mc)
    torch.cuda.synchronize()
    _equal(got, select_packed_plain(cand, opp, e, p, max_chunks=mc))
    _equal(got, kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)[:2])
    return got


@pytest.mark.parametrize("name,S", [("P", 1024), ("P", 4096),
                                    ("P5", 8192), ("dec", 2048),
                                    ("skid", 16384), ("w16", 3000),
                                    ("w4", 1500), ("paper8k", 16384),
                                    ("paper16k-dec", 32768), ("P", 65536),
                                    ("paper8k", 65536)])
@pytest.mark.parametrize("short", [0, 2])
def test_select_packed_kernel(dev, name, S, short):
    """test_packed_kernel's rows (empty, tiny, shorter-than-L, constant,
    low-entropy and random segments), 64 KiB rows too, with a true and an
    undersized table."""
    p = PARAMS[name]
    streams = _packed_cases(np.random.default_rng(S), p, S)
    data, _, ends, _ = _packing_cases.pack(
        [[seg.tobytes() for seg in row] for row in streams], S)
    _select_packed_equal(dev, p, data, ends, short)


@pytest.mark.parametrize("mix", ["all-tiny", "512-2048",
                                 "heavy-tail<16KiB"])
@pytest.mark.parametrize("short", [0, 1, 3])
def test_select_packed_kernel_on_the_chip_mixes(dev, mix, short):
    """``chip_smoke.py``'s three segment mixes, 8 x 16 KiB, at a true and
    at undersized tables."""
    data, ends, _ = _chip_mix(mix, 16 + short)
    _select_packed_equal(dev, PARAMS["paper8k"], data, ends, short)


@pytest.mark.parametrize("name", _packing_cases.CASES
                         + tuple("bitmaps " + c
                                 for c in _select_packed_cases.EDGES))
def test_select_packed_kernel_on_the_cpu_tests_cases(dev, name):
    """The packing tests' cases, and the CPU tests' random bitmaps clipped
    per segment (empty streams, segments shorter than L-1, padding, G =
    1) at 4 and 64 KiB, with a true and an undersized table."""
    if not name.startswith("bitmaps "):
        pname, S, rows = _packing_cases.case(name)
        p = SeqCDCParams(**_packing_cases.PARAMS[pname])
        data, _, ends, _ = _packing_cases.pack(rows, S)
        for short in (0, 1):
            _select_packed_equal(dev, p, data, ends, short)
        return
    p = SeqCDCParams(**_select_packed_cases.SMALL)
    for S in (4096, 1 << 16):
        ends, cand, opp = _select_packed_cases.edge_case(name[8:], S)
        e = torch.from_numpy(ends).to(dev)
        c, o = torch.from_numpy(cand).to(dev), torch.from_numpy(opp).to(dev)
        mc = _select_packed_cases.true_max_chunks(S, p.min_size,
                                                  ends.shape[1])
        counts = select_packed_plain(c, o, e, p, max_chunks=mc)[1]
        for m in (mc, max(1, int(counts.max()) - 1)):
            got = kselp.select_boundaries_packed(c, o, e, p, max_chunks=m)
            torch.cuda.synchronize()
            _equal(got, select_packed_plain(c, o, e, p, max_chunks=m))


@pytest.mark.parametrize("name", ["P", "paper8k"])
def test_select_packed_kernel_65536_one_byte_segments(dev, name):
    """A 64 KiB row of 65,536 one-byte streams (the scratch in device
    memory) beside two long segments around 40,000 empty ones."""
    p = PARAMS[name]
    S = 1 << 16
    rng = np.random.default_rng(5)
    rows = [[rng.integers(0, 256, 1, dtype=np.uint8).tobytes()
             for _ in range(S)],
            [rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()]
            + [b""] * 40000
            + [rng.integers(0, 256, S - 30000, dtype=np.uint8).tobytes()]]
    data, _, ends, _ = _packing_cases.pack(rows, S, S)
    got = _select_packed_equal(dev, p, data, ends)
    assert int(got[1][0]) == S


@pytest.mark.parametrize("oc,oo", [(1, 15), (15, 1), (3, 8), (0, 13),
                                   (9, 0), (6, 6)])
@pytest.mark.parametrize("short", [0, 2])
def test_select_packed_kernel_bitmaps_at_byte_offsets(dev, oc, oo, short):
    """Bitmap rows whose candidate and opposing rows start at independent
    byte offsets (views into a wider buffer, the last row ending at the
    buffer's end): the kernel copies each from its 16-byte floor."""
    p = PARAMS["P"]
    streams = _packed_cases(np.random.default_rng(oc + 16 * oo), p, 4096)
    data, _, ends, _ = _packing_cases.pack(
        [[seg.tobytes() for seg in row] for row in streams], 4096)
    _select_packed_equal(dev, p, data, ends, short, (oc, oo))
    data, ends, _ = _chip_mix("heavy-tail<16KiB", 40 + oc)
    _select_packed_equal(dev, PARAMS["paper8k"], data, ends, short, (oc, oo))


@pytest.mark.parametrize("S", [1, 15, 16, 17, 1 << 16])
@pytest.mark.parametrize("B", [1, 64])
def test_select_packed_kernel_row_widths_and_batches(dev, S, B):
    """Rows of 1, 15, 16, 17 and 65,536 bytes at B 1 and 64, each row its
    own random mix of segment lengths (long ones walked at S 65,536), at a
    true and an undersized table."""
    p = PARAMS["P"]
    rng = np.random.default_rng(S + B)
    rows = []
    for _ in range(B):
        row, fill = [], 0
        top = int(rng.choice([4, 200, 3000]))
        while True:
            n = int(rng.integers(0, top))
            if fill + n > S:
                break
            row.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            fill += n
        rows.append(row or [b""])
    data, _, ends, _ = _packing_cases.pack(rows, S)
    for short in (0, 1):
        _select_packed_equal(dev, p, data, ends, short)


@pytest.mark.parametrize("mix", ["all-tiny", "512-2048",
                                 "heavy-tail<16KiB"])
@pytest.mark.parametrize("seed", range(5))
def test_select_packed_kernel_on_the_chip_mixes_at_seeds(dev, mix, seed):
    """``chip_smoke.py``'s three segment mixes, 8 x 16 KiB, at five more
    seeds, at a true and an undersized table."""
    data, ends, _ = _chip_mix(mix, 100 + seed)
    for short in (0, 1):
        _select_packed_equal(dev, PARAMS["paper8k"], data, ends, short)


def _switch_rows(G: int, S: int = 1 << 16):
    """Two 64 KiB rows of exactly G segments (most of 1-3 bytes, eight of
    about 3,000 walked at P's min_size 64)."""
    rng = np.random.default_rng(G)
    rows = []
    for _ in range(2):
        lens = [int(n) for n in rng.integers(1, 4, G - 8)]
        lens += [int(n) for n in rng.integers(2800, 3200, 8)]
        rng.shuffle(lens)
        rows.append([rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                     for n in lens])
    return _packing_cases.pack(rows, S, G)


@pytest.mark.parametrize("G", [8175, 8176])
def test_select_packed_kernel_at_the_shared_scratch_switch(dev, G):
    """Just below and just above the G where the scratch stops fitting in
    shared memory beside both 64 KiB bitmap rows (P's min_size 64): the
    wrapper's rule and the kernel's agree, and both sides give the plain
    version's bounds."""
    p = PARAMS["P"]
    S = 1 << 16
    ints = kselp.scratch_ints(S, G, p.min_size)
    assert kselp.device_scratch_ints(S, G, p.min_size) == (
        0 if G == 8175 else ints)
    data, _, ends, _ = _switch_rows(G, S)
    assert ends.shape[1] == G
    for short in (0, 3):
        _select_packed_equal(dev, p, data, ends, short)


def test_select_packed_kernel_refuses_a_missing_scratch(dev):
    """A launch whose scratch does not fit in shared memory and that gets
    no device buffer is refused (the kernel's check of the wrapper's
    rule), and counts no launch."""
    p = PARAMS["P"]
    S = G = 1 << 16
    ints = kselp.scratch_ints(S, G, p.min_size)
    assert kselp.device_scratch_ints(S, G, p.min_size) == ints
    cand = torch.zeros((1, S), dtype=torch.bool, device=dev)
    ends = torch.full((1, G), S, dtype=torch.int32, device=dev)
    mc = _select_packed_cases.true_max_chunks(S, p.min_size, G)
    bounds = torch.empty((1, mc), dtype=torch.int32, device=dev)
    counts = torch.empty((1,), dtype=torch.int32, device=dev)
    before = kselp.KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        kselp.KERNEL.launch(
            cand.data_ptr(), cand.data_ptr(), ends.data_ptr(),
            bounds.data_ptr(), counts.data_ptr(), 0, ints, 1, S, G, mc,
            p.seq_length, p.block_width, p.skip_trigger, p.skip_size,
            p.sub_min_skip, p.max_size,
            stream=torch.cuda.current_stream(dev).cuda_stream)
    assert kselp.KERNEL.launches == before


def test_select_packed_wrapper_rejects_what_the_kernel_does_not_take(dev):
    b = torch.zeros((2, 1024), dtype=torch.bool, device=dev)
    e = torch.full((2, 4), 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kselp.select_boundaries_packed(b, b, e.to(torch.int64), P,
                                       max_chunks=40)
    with pytest.raises(ValueError, match="bool"):
        kselp.select_boundaries_packed(b.to(torch.uint8), b, e, P,
                                       max_chunks=40)
    wide = torch.zeros((1, 1 << 17), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="narrower"):
        kselp.select_boundaries_packed(wide, wide, e[:1], P, max_chunks=8)


def test_packed_split_service_equals_fused_on_the_card(dev):
    """Segment packing through the split pipeline (the masks, packed
    select and fingerprint kernels) gives the fused pipeline's recipes
    (the packed kernel), and without fingerprints the same bounds; the
    split runs launch the packed select kernel, no W-block loop."""
    rng = np.random.default_rng(12)
    objs = [rng.integers(0, 256, int(m), dtype=np.uint8)
            for m in rng.integers(0, 6000, 60)]
    recipes = {}
    for impl in ("fused", "split"):
        kselp.KERNEL.launches = 0
        svc = DedupService(params=P, device=dev, slots=2, min_bucket=8192,
                           packing_impl="segments", pipeline_impl=impl,
                           cross_check_packing=True)
        for i, o in enumerate(objs):
            svc.submit(str(i), o)
        svc.flush()
        recipes[impl] = [svc.recipes.get(str(i)).to_json()
                         for i in range(len(objs))]
        assert svc.scheduler.stats.packed_streams > 0
        assert (kselp.KERNEL.launches > 0) == (impl == "split")
        for i, o in enumerate(objs):
            assert svc.get(str(i)) == o.tobytes()
    assert recipes["split"] == recipes["fused"]
    bounds = {}
    for fp in (True, False):
        kselp.KERNEL.launches = 0
        sched = ChunkScheduler(P, device=dev, slots=2, min_bucket=8192,
                               packing_impl="segments", with_fingerprints=fp)
        for o in objs:
            sched.submit(o)
        bounds[fp] = [r.bounds.tolist() for r in sched.drain()]
        assert (kselp.KERNEL.launches > 0) == (not fp)
    assert bounds[True] == bounds[False]


# -- the chunker registry's kernels ---------------------------------------

#: tests/test_kernels.py's lengths, and two past a kernel tile
LENGTHS = [1, 2, 31, 32, 100, 1023, 1024, 1025, 4096, 70000, (1 << 20) + 7]


@pytest.mark.parametrize("n", LENGTHS)
def test_gear_kernel(dev, n):
    host = np.random.default_rng(n).integers(0, 256, n + 3, dtype=np.uint8)
    x = torch.from_numpy(host).to(dev)
    for view in (x[:n], x[3:]):  # an aligned and an offset stream
        got = kgear.gear_hash(view)
        torch.cuda.synchronize()
        _equal([got], [kgear.gear_hash_parallel(view)])
    if n <= 4096:
        _equal([kgear.gear_hash(x[:n])], [kgear.gear_hash_sequential(x[:n])])


#: lengths at the kernel's edges: a lane's 4 positions, a warp's block of
#: 128, a warp's step of 1024, half and all of a 32-warp CTA's first steps
#: (16 and 32 KiB), and 2^26 + 7 (persistent CTAs, several steps a warp,
#: a ragged tail)
GEAR_LENGTHS = [1, 3, 4, 5, 31, 32, 33, 127, 128, 129, 1023, 1024, 1025,
                16383, 16384, 16385, 32767, 32768, 32769, (1 << 26) + 7]


@pytest.mark.parametrize("n", GEAR_LENGTHS)
def test_gear_kernel_lengths_and_offsets(dev, n):
    """The gear kernel against its plain version on an aligned stream and
    on views off by 1 and 3 bytes (misaligned 4-byte loads), each of n
    bytes."""
    host = np.random.default_rng(n + 1).integers(0, 256, n + 3,
                                                 dtype=np.uint8)
    x = torch.from_numpy(host).to(dev)
    for off in (0, 1, 3):
        view = x[off:off + n]
        got = kgear.gear_hash(view)
        torch.cuda.synchronize()
        _equal([got], [kgear.gear_hash_parallel(view)])


@pytest.mark.parametrize("n", [1, 128, 1000, 65536, 70001])
@pytest.mark.parametrize("block", [64, 100, 128])
def test_block_max_kernel(dev, n, block):
    host = np.random.default_rng(n).integers(0, 256, n + 1, dtype=np.uint8)
    x = torch.from_numpy(host).to(dev)
    for view in (x[:n], x[1:]):  # 16-byte aligned and not
        got = kext.block_max(view, block)
        torch.cuda.synchronize()
        _equal([got], [kext.block_max_plain(view, block)])


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", [1, 64, 5000, 40000])
def test_select_kernel_on_seqcdc_bitmaps(dev, name, n):
    p = PARAMS[name]
    x = torch.from_numpy(_rows(np.random.default_rng(n), n)).to(dev)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    for mc in (max_chunks_for(n, p), 3):  # a true and an undersized bound
        got = kselect.select_boundaries(cand, opp, n, p, max_chunks=mc)
        torch.cuda.synchronize()
        _equal(got, select_plain(cand, opp, n, p, max_chunks=mc))


@pytest.mark.parametrize("density", [0.0, 1 / 4096, 1 / 64, 1.0])
def test_select_kernel_on_selector_bitmaps(dev, density):
    """The hash chunkers' selector: a match bitmap, no opposing pairs,
    L = 1, T = 2^30 and 2^20 bytes of padding the kernel never reads."""
    rng = np.random.default_rng(7)
    n = 300_000
    bits = torch.from_numpy(rng.random((2, n)) < density).to(dev)
    for mn, mx in ((1024, 4096), (4096, 16384)):
        p = SelectorParams(min_size=mn, max_size=mx)
        got = kselect.select_boundaries(bits, torch.zeros_like(bits), n, p)
        torch.cuda.synchronize()
        _equal(got, select_plain(bits, torch.zeros_like(bits), n, p))


def _select_against_oracle(x, p):
    """The select kernel on the masks of ``x`` against the plain automaton
    where it walks at most 8,192 W-blocks, else against the fused kernel's
    bounds and counts (which its own tests hold against that automaton)."""
    n = x.shape[1]
    mc = max_chunks_for(n, p)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    got = kselect.select_boundaries(cand, opp, n, p, max_chunks=mc)
    if n // p.block_width <= 8192:
        want = select_plain(cand, opp, n, p, max_chunks=mc)
    else:
        want = kfused.fused_pipeline_batch(x, p, max_chunks=mc)[:2]
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", BIG_ROWS)
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_select_kernel_one_big_row(dev, name, n, kind):
    """Rows long enough that the kernel's ring of packed words wraps many
    times, with every adversarial content (W < 32 among the sets)."""
    p = PARAMS[name]
    host = _big_row(np.random.default_rng(n + 2), p, n, kind)[None]
    _select_against_oracle(torch.from_numpy(host).to(dev), p)


@pytest.mark.parametrize("name", ["P", "w4", "paper8k"])
def test_select_kernel_big_batch(dev, name):
    """Eight rows of 1 MiB + 5 bytes at once: each row's packed words start
    on their own group, and the row ends inside one."""
    p = PARAMS[name]
    rng = np.random.default_rng(9)
    n = (1 << 20) + 5
    host = np.stack([_big_row(rng, p, n, kind)
                     for kind in ROW_KINDS + ROW_KINDS[::-1]])
    _select_against_oracle(torch.from_numpy(host).to(dev), p)


@pytest.mark.parametrize("density", [0.0, 1 / 8192, 1 / 700, 1.0])
@pytest.mark.parametrize("mn,mx", [(2048, 16384), (4096, 65536)])
def test_select_kernel_selector_rows_against_select_numpy(dev, density, mn,
                                                          mx):
    """The hash chunkers' selector (T = 2^30, skip 2^20) on a 2 MiB row
    with an odd tail, against the event-driven numpy selection."""
    n = (2 << 20) + 13
    rng = np.random.default_rng(mn + int(density * 8192))
    bits = rng.random(n) < density
    p = SelectorParams(min_size=mn, max_size=mx)
    t = torch.from_numpy(bits)[None].to(dev)
    bounds, counts = kselect.select_boundaries(t, torch.zeros_like(t), n, p)
    want = select_numpy(np.flatnonzero(bits), n, mn, mx)
    assert int(counts[0]) == len(want)
    np.testing.assert_array_equal(bounds[0, : len(want)].cpu().numpy(), want)


# -- the gather and event select kernels -------------------------------------

STEP_KERNELS = {"gather": (kselg, kselg.select_boundaries_gather),
                "event": (ksele, ksele.select_boundaries_event)}


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("n", [1, 64, 5003, 40000])
def test_step_kernel_on_seqcdc_bitmaps(dev, step, name, n):
    """Each step's kernel bit-equal to its plain version on the masks
    kernel's bitmaps, at a true and an undersized table (where the event
    walk stops at max_chunks and the gather walk counts every emit)."""
    p = PARAMS[name]
    x = torch.from_numpy(_rows(np.random.default_rng(n + 3), n)).to(dev)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    fn = STEP_KERNELS[step][1]
    for mc in (max_chunks_for(n, p), 3):
        got = fn(cand, opp, n, p, max_chunks=mc)
        torch.cuda.synchronize()
        _equal(got, select_plain(cand, opp, n, p, step_impl=step,
                                 max_chunks=mc))


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("density", [0.0, 1 / 2048, 1 / 16, 1.0])
def test_step_kernel_on_selector_bitmaps(dev, step, density):
    """The hash chunkers' selector (L = 1, T = 2^30, skip 2^20) through
    each step's kernel, against its plain version and select_numpy."""
    rng = np.random.default_rng(8)
    n = 300_001
    host = rng.random((2, n)) < density
    bits = torch.from_numpy(host).to(dev)
    zeros = torch.zeros_like(bits)
    fn = STEP_KERNELS[step][1]
    for mn, mx in ((1024, 4096), (4096, 16384)):
        p = SelectorParams(min_size=mn, max_size=mx)
        got = fn(bits, zeros, n, p)
        torch.cuda.synchronize()
        _equal(got, select_plain(bits, zeros, n, p, step_impl=step))
        want = select_numpy(np.flatnonzero(host[1]), n, mn, mx)
        assert int(got[1][1]) == len(want)
        np.testing.assert_array_equal(got[0][1, : len(want)].cpu().numpy(),
                                      want)


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_step_kernel_one_big_row(dev, step, kind):
    """One 4 MiB row at paper 8 KiB parameters: against the wide select
    kernel (the plain gather loop walks 16,400 W-blocks here) and, for the
    event step, its plain loop too."""
    p = PARAMS["paper8k"]
    n = 4 << 20
    host = _big_row(np.random.default_rng(11), p, n, kind)[None]
    x = torch.from_numpy(host).to(dev)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    mc = max_chunks_for(n, p)
    got = STEP_KERNELS[step][1](cand, opp, n, p, max_chunks=mc)
    _equal(got, kselect.select_boundaries(cand, opp, n, p, max_chunks=mc))
    if step == "event":
        _equal(got, select_plain(cand, opp, n, p, step_impl="event",
                                 max_chunks=mc))
    ob = boundaries_numpy(host[0], p)
    assert got[0][0, : int(got[1][0])].cpu().numpy().tolist() == ob.tolist()


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("name", ["P", "w4", "paper8k"])
def test_step_kernel_big_batch(dev, step, name):
    """64 rows of 64 KiB + 5 bytes (every row kind) at once: against the
    plain version, and against the wide select kernel at a true table and
    at an undersized one for the gather step (both count every emit)."""
    p = PARAMS[name]
    rng = np.random.default_rng(13)
    n = (64 << 10) + 5
    host = np.stack([_big_row(rng, p, n, ROW_KINDS[i % 4])
                     for i in range(64)])
    x = torch.from_numpy(host).to(dev)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    fn = STEP_KERNELS[step][1]
    for mc in (max_chunks_for(n, p), 4):
        got = fn(cand, opp, n, p, max_chunks=mc)
        _equal(got, select_plain(cand, opp, n, p, step_impl=step,
                                 max_chunks=mc))
        if step == "gather" or mc > 4:
            _equal(got, kselect.select_boundaries(cand, opp, n, p,
                                                  max_chunks=mc))


@pytest.mark.parametrize("step", ["gather", "event"])
def test_step_kernel_never_takes_the_plain_version(dev, step, monkeypatch):
    """A CUDA tensor launches the kernel, one launch a call, through the
    wrapper and through every entry point; the plain version is never
    called on the card."""
    import repro_torch.core.automaton as tautomaton

    mod, fn = STEP_KERNELS[step]
    p = PARAMS["P"]
    x = torch.from_numpy(_rows(np.random.default_rng(2), 5000)).to(dev)
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    want = select_plain(cand, opp, 5000, p, step_impl=step)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(mod, "select_plain", refuse)
    monkeypatch.setattr(tautomaton, "select_boundaries", refuse)
    for i in range(1, 4):
        mod.KERNEL.launches = 0
        for _ in range(i):
            got = fn(cand, opp, 5000, p)
        assert mod.KERNEL.launches == i
    _equal(got, want)
    mod.KERNEL.launches = 0
    data = np.random.default_rng(4).integers(0, 256, 300_000, np.uint8)
    got = make_chunker("seqcdc", 4096, device=dev, step_impl=step).chunk(data)
    assert mod.KERNEL.launches == 1
    assert np.array_equal(got, make_chunker("seqcdc", 4096,
                                            device=dev).chunk(data))
    bits = torch.from_numpy(data % 64 == 0).to(dev)
    from repro_torch.core.baselines.selectors import select_torch

    select_torch(bits, bits.numel(), 1024, 4096, step_impl=step)
    assert mod.KERNEL.launches == 2
    svc = DedupService(params=p, device=dev, slots=2, min_bucket=1024,
                       pipeline_impl="split", step_impl=step,
                       cross_check_pipeline=True)
    for i in range(6):
        svc.submit(str(i), data[i * 7000: i * 7000 + 9000 + 1000 * i])
    svc.flush()
    assert mod.KERNEL.launches > 2
    for i in range(6):
        assert svc.get(str(i)) == data[i * 7000:
                                       i * 7000 + 9000 + 1000 * i].tobytes()


#: the node table's edge rows' parameter sets (tests/test_torch_select_steps
#: .py holds the chain's model against the reference on the same rows): W
#: 32; a cover stop (the gather walk's padded range ends before n); the
#: selector's T = 2^30; paper 8 KiB
STEP_EDGE_PARAMS = {
    "P": P,
    "cover": SeqCDCParams(avg_size=256, seq_length=3, skip_trigger=2,
                          skip_size=8, min_size=128, max_size=200),
    "selector": SelectorParams(min_size=1024, max_size=1500),
    "paper8k": PARAMS["paper8k"],
}


def _edge_rows(rng, n: int):
    """All-candidate, candidate-free (with and without opposing pairs),
    dense and sparse random bitmaps, (6, n) each."""
    ones, zeros = np.ones((1, n), bool), np.zeros((1, n), bool)
    cand = np.concatenate([ones, zeros, zeros, rng.random((2, n)) < 0.05,
                           rng.random((1, n)) < 0.002])
    opp = np.concatenate([zeros, zeros, ones, rng.random((2, n)) < 0.3,
                          zeros])
    return cand, opp


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("pname", sorted(STEP_EDGE_PARAMS))
def test_step_kernel_edge_rows(dev, step, pname):
    """Each step's kernel against its plain version on the node table's
    edge rows: a node at every position, cut runs to n (n = 3 * max_size
    cuts exactly at n), n = 0, n below W, n not a multiple of 1024; at a
    true table and at 5 and 1, with the chase's statistics asked for."""
    p = STEP_EDGE_PARAMS[pname]
    rng = np.random.default_rng(21)
    fn = STEP_KERNELS[step][1]
    for n in (0, 5, 3001, 3 * p.max_size):
        cand, opp = (torch.from_numpy(a).to(dev) for a in _edge_rows(rng, n))
        for mc in (max_chunks_for(n, p), 5, 1):
            stats = torch.zeros((6, 2), dtype=torch.int32, device=dev)
            got = fn(cand, opp, n, p, max_chunks=mc, stats=stats)
            torch.cuda.synchronize()
            _equal(got, select_plain(cand, opp, n, p, step_impl=step,
                                     max_chunks=mc))
            assert bool((stats >= 0).all())


@pytest.mark.parametrize("step", ["gather", "event"])
def test_step_kernel_64_short_rows_of_mixed_lengths(dev, step):
    """64 rows of 1-20,000 bytes (every row kind, paper 8 KiB and the
    small set), each its own call, against the plain version."""
    rng = np.random.default_rng(23)
    fn = STEP_KERNELS[step][1]
    for i, n in enumerate(rng.integers(1, 20_001, 64)):
        n = int(n)
        p = PARAMS["paper8k"] if i % 2 else P
        host = _big_row(rng, p, n, ROW_KINDS[i % 4])[None]
        cand, opp = kmasks.seqcdc_masks(torch.from_numpy(host).to(dev),
                                        p.seq_length, p.mode)
        got = fn(cand, opp, n, p)
        torch.cuda.synchronize()
        _equal(got, select_plain(cand, opp, n, p, step_impl=step))


@pytest.mark.parametrize("step", ["gather", "event"])
@pytest.mark.parametrize("kind,n", [("random", 64 << 20), ("zero", 4 << 20)])
def test_step_kernel_against_the_wide_kernel(dev, step, kind, n):
    """One 64 MiB random row (about 540,000 nodes) and one all-zero 4 MiB
    row (node 0 walks the whole row, cut after cut), paper 8 KiB, against
    the wide select kernel at a true table."""
    p = PARAMS["paper8k"]
    x = (torch.from_numpy(np.random.default_rng(25).integers(
        0, 256, (1, n), dtype=np.uint8)).to(dev) if kind == "random"
        else torch.zeros((1, n), dtype=torch.uint8, device=dev))
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    mc = max_chunks_for(n, p)
    got = STEP_KERNELS[step][1](cand, opp, n, p, max_chunks=mc)
    _equal(got, kselect.select_boundaries(cand, opp, n, p, max_chunks=mc))


def test_step_wrappers_reject_what_the_kernels_do_not_take(dev):
    b = torch.zeros((2, 100), dtype=torch.bool, device=dev)
    for _, fn in STEP_KERNELS.values():
        with pytest.raises(ValueError, match="bool"):
            fn(b.to(torch.uint8), b, 100, P)
        with pytest.raises(ValueError, match="bool"):
            fn(b, b.cpu(), 100, P)
        with pytest.raises(ValueError, match="bool"):
            fn(b, b, 101, P)
    wide_w = types.SimpleNamespace(  # W = 2048: a block past one group
        seq_length=3, block_width=2048, skip_trigger=6, skip_size=4096,
        min_size=4096, sub_min_skip=4093, max_size=16384)
    with pytest.raises(RuntimeError, match="failed to launch"):
        kselg.select_boundaries_gather(b, b, 100, wide_w)


def _scan_cases():
    gear = kgear.gear_table()
    return {
        "gear": dict(tables=gear, mask=0xFFF00000),
        "crc": dict(tables=np.stack([gear, gear[::-1], gear ^ 0x5A5A]),
                    mask=0x7FF, window=32),
        "rabin": dict(tables=np.stack([gear, gear[::-1], gear ^ 0x5A5A]),
                      mask=0x7FF, window=48),
        "fastcdc": dict(tables=gear, mask=0x0F0F0000, mask_l=0x00030000,
                        avg_size=3000),
        "ae": dict(window=1500),
        "ram": dict(window=1800),
    }


@pytest.mark.parametrize("algo", ["gear", "crc", "rabin", "fastcdc", "ae",
                                  "ram"])
def test_native_scan_kernel(dev, algo):
    n = 1 << 16
    x = torch.from_numpy(_rows(np.random.default_rng(3), n)).to(dev)
    kw = dict(_scan_cases()[algo], min_size=1024, max_size=6000)
    for mc in (None, 4):
        got = kscan.native_scan(x, algo, max_chunks=mc, **kw)
        torch.cuda.synchronize()
        _equal(got, kscan.native_scan_plain(x, algo, max_chunks=mc, **kw))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_native_scan_kernel_seqcdc(dev, name):
    p = PARAMS[name]
    host = _rows(np.random.default_rng(4), 20000)
    x = torch.from_numpy(host).to(dev)
    got = kscan.native_scan(x, "seqcdc", params=p)
    torch.cuda.synchronize()
    _equal(got, kscan.native_scan_plain(x, "seqcdc", params=p))
    for r in range(host.shape[0]):
        b, c = boundaries_sequential(x[r], p)
        assert b[: int(c)].tolist() == boundaries_numpy(host[r], p).tolist()


NATIVE_ALGOS = ("gear", "crc", "rabin", "fastcdc", "ae", "ram", "seqcdc")
#: a SeqCDC run longer than the native scan's 8-byte register window
P_LONG = SeqCDCParams(avg_size=4096, seq_length=10, skip_trigger=5,
                      skip_size=256, min_size=1024, max_size=8192)


def _native_kw(algo, p=P):
    if algo == "seqcdc":
        return dict(params=p)
    return dict(_scan_cases()[algo], min_size=1024, max_size=6000)


@pytest.mark.parametrize("algo", NATIVE_ALGOS)
@pytest.mark.parametrize("B,n,offset", [(1, 4099, 0), (1, 20011, 5),
                                        (5, 33, 3), (5, 70001, 11)])
def test_native_scan_kernel_streams_and_offsets(dev, algo, B, n, offset):
    """One and five streams a launch, rows that start off the ring's
    16-byte copy unit (each row at another offset) and lengths that are no
    multiple of 16, against the plain loop."""
    host = _rows(np.random.default_rng(n), n)[:B]
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.uint8), host.ravel()])).to(dev)
    x = flat[offset:].view(host.shape)
    kw = _native_kw(algo)
    got = kscan.native_scan(x, algo, **kw)
    torch.cuda.synchronize()
    _equal(got, kscan.native_scan_plain(x, algo, **kw))


@pytest.mark.parametrize("algo", NATIVE_ALGOS)
@pytest.mark.parametrize("byte", [0, 0x5A, 0xFF])
def test_native_scan_kernel_constant_bytes(dev, algo, byte):
    """Constant streams, against the plain loop; seqcdc finds no run and
    no opposing pair there, so it cuts at max_size only."""
    n = 100_003
    x = torch.full((1, n), byte, dtype=torch.uint8, device=dev)
    kw = _native_kw(algo)
    got = kscan.native_scan(x, algo, **kw)
    torch.cuda.synchronize()
    _equal(got, kscan.native_scan_plain(x, algo, **kw))
    if algo == "seqcdc":
        b = got[0][0, : int(got[1][0])].cpu().numpy()
        assert (np.diff(b[:-1]) == P.max_size).all() and b[0] == P.max_size


def test_native_scan_kernel_seqcdc_longer_than_its_register(dev):
    host = _rows(np.random.default_rng(10), 20000)
    x = torch.from_numpy(host).to(dev)
    got = kscan.native_scan(x, "seqcdc", params=P_LONG)
    torch.cuda.synchronize()
    _equal(got, kscan.native_scan_plain(x, "seqcdc", params=P_LONG))
    for r in range(host.shape[0]):
        ob = boundaries_numpy(host[r], P_LONG)
        assert got[0][r, : int(got[1][r])].tolist() == ob.tolist()


@pytest.mark.parametrize("algo", NATIVE_ALGOS)
def test_native_scan_kernel_16mib_against_the_vectorized_chunker(dev, algo):
    """At the size phase 6 launches it (16 MiB, calibrated 8 KiB knobs),
    each ``_seq`` chunker against the vectorized chunker of its pair."""
    data = np.random.default_rng(16).integers(0, 256, 16 << 20,
                                              dtype=np.uint8)
    extra = {"backend": "torch"} if algo in ("crc", "rabin") else {}
    want = make_chunker(algo, 8192, device=dev,
                        **calibrated_kwargs(algo, 8192), **extra).chunk(data)
    got = make_chunker(f"{algo}_seq", 8192, device=dev,
                       **calibrated_kwargs(f"{algo}_seq", 8192)).chunk(data)
    np.testing.assert_array_equal(got, want)


def test_native_scan_refuses_a_window_past_its_ring(dev):
    x = torch.zeros((1, 100), dtype=torch.uint8, device=dev)
    kw = dict(_scan_cases()["crc"], min_size=64, max_size=128)
    kw["window"] = kscan.MAX_WINDOW + 1
    with pytest.raises(ValueError, match="window"):
        kscan.native_scan(x, "crc", **kw)


def test_chunk_kernel_wrappers_refuse(dev):
    i32 = torch.zeros(100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kgear.gear_hash(i32)
    with pytest.raises(ValueError):
        kext.block_max(i32)
    with pytest.raises(ValueError):
        kext.block_max(i32.to(torch.uint8), 0)
    b = torch.zeros((1, 100), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        kselect.select_boundaries(b.to(torch.uint8), b, 100, P)
    with pytest.raises(ValueError):
        kselect.select_boundaries(b, b[:, :50], 100, P)
    # a W-block wider than the kernel's 32 mask words: the launcher refuses
    with pytest.raises(RuntimeError, match="failed to launch"):
        kselect.select_boundaries(b, b, 100, _WideW())
    with pytest.raises(ValueError):
        kscan.native_scan(i32[None], "gear", min_size=64, max_size=128)
    with pytest.raises(ValueError):
        kscan.native_scan(i32.to(torch.uint8)[None], "zstd", min_size=64,
                          max_size=128)
    with pytest.raises(ValueError):  # too short for a seqcdc scan
        kscan.native_scan(i32.to(torch.uint8)[None, :1], "seqcdc", params=P)


class _WideW:
    """SeqCDC-shaped parameters whose W-block (2048) exceeds the kernel's."""

    seq_length, skip_trigger, skip_size = 3, 6, 4096
    min_size, max_size, sub_min_skip, block_width = 8192, 16384, 8189, 2048


def test_chunkers_on_the_card_count_launches(dev):
    """Every registered chunker on the card gives the CPU's bounds, and
    the registry's kernels launch."""
    kernels = (kgear.KERNEL, kselect.KERNEL, kscan.KERNEL, kmasks.KERNEL)
    for k in kernels:
        k.launches = 0
    rng = np.random.default_rng(12)
    data = {"random": rng.integers(0, 256, 300_000, dtype=np.uint8),
            "low": rng.integers(0, 3, 300_000, dtype=np.uint8)}
    for name in available():
        for avg in (4096, 8192):
            kw = calibrated_kwargs(name, avg)
            extra = ({"backend": "torch"} if name in ("crc", "rabin")
                     else {})
            for d in data.values():
                want = make_chunker(name, avg, device="cpu", **kw).chunk(d)
                got = make_chunker(name, avg, device=dev, **kw,
                                   **extra).chunk(d)
                np.testing.assert_array_equal(got, want, err_msg=name)
    assert all(k.launches > 0 for k in kernels), [
        (k.name, k.launches) for k in kernels]


# -- flash attention (the LM serving path's kernel) ------------------------


def _flash_inputs(seed, B, S, H, KV, hd, dtype, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        (rng.standard_normal(shape) * 0.5).astype(np.float32)).to(dev, dtype)
        for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("B,S,H,KV", [(2, 1, 4, 2), (1, 63, 2, 2),
                                      (2, 96, 4, 1), (1, 257, 8, 2)])
def test_flash_kernel_matches_plain(dev, no_tf32, dtype, hd, B, S, H, KV):
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(hd + S, B, S, H, KV, hd, dtype, dev)
    for causal, window in ((True, 0), (False, 0), (True, 24), (False, 40)):
        got = kflash.flash_attention(q, k, v, causal=causal, window=window)
        want = kflash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **kflash.TOLERANCE[dtype],
                                   err_msg=f"causal={causal} window={window}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [40, 1024, 1500, 2048])
def test_flash_kernel_long_sequences(dev, no_tf32, dtype, hd, S):
    """Serving lengths (and one below a 64-query tile), B = 2, causal,
    full and windowed masks, under the same elementwise tolerance."""
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(S + hd, 2, S, 4, 2, hd, dtype, dev)
    for causal, window in ((True, 0), (False, 0), (True, 300), (False, 500)):
        got = kflash.flash_attention(q, k, v, causal=causal, window=window)
        want = kflash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_block=256,
                                            kv_block=256)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **kflash.TOLERANCE[dtype],
                                   err_msg=f"causal={causal} window={window}")


def test_flash_kernel_takes_misaligned_bf16_inputs(dev):
    """A contiguous bf16 view that does not start on 16 bytes (the
    kernel's copy width) gives the aligned input's output."""
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(11, 1, 130, 4, 2, 32, torch.bfloat16, dev)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    qo = buf[1:].view(q.shape)
    qo.copy_(q)
    assert qo.is_contiguous() and qo.data_ptr() % 16
    got = kflash.flash_attention(qo, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, kflash.flash_attention(q, k, v))


def test_flash_kernel_takes_strided_inputs_and_counts_launches(dev, no_tf32):
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(7, 1, 128, 8, 2, 64, torch.float32, dev)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    kflash.KERNEL.launches = 0
    got = kflash.flash_attention(qt, k, v, scale=0.1)
    want = kflash.flash_attention_plain(q, k, v, scale=0.1)
    torch.cuda.synchronize()
    assert kflash.KERNEL.launches == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **kflash.TOLERANCE[torch.float32])


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(8, 1, 16, 4, 2, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="head width"):
        kflash.flash_attention(q, k, v)
    q, k, v = _flash_inputs(8, 1, 16, 4, 2, 16, torch.float16, dev)
    with pytest.raises(ValueError, match="bfloat16"):
        kflash.flash_attention(q, k, v)
    q, k, v = _flash_inputs(8, 1, 16, 4, 2, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="one type"):
        kflash.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="one device"):
        kflash.flash_attention(q, k.cpu(), v)


def test_reduced_model_and_engine_on_the_card_match_the_cpu(dev, no_tf32):
    """Reduced llama3.2-1b (float32, attn_kv_block=16): forward logits on
    the card (the flash kernel in every layer) equal the CPU's (its plain
    version), and the engine's greedy tokens are the CPU engine's."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attn as kflash
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_reduced("llama3.2-1b").replace(attn_q_block=16,
                                             attn_kv_block=16)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    on_dev = {"segments": [{k: {n: t.to(dev) for n, t in v.items()}
                            if isinstance(v, dict) else v.to(dev)
                            for k, v in seg.items()}
                           for seg in params["segments"]],
              "final_norm": params["final_norm"].to(dev),
              "embed": params["embed"].to(dev)}
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 48)))
    kflash.KERNEL.launches = 0
    got = lm.forward(cfg, on_dev, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert kflash.KERNEL.launches == cfg.n_layers
    want = lm.forward(cfg, params, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=3e-4,
                               atol=3e-4)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, n) for n in (48, 9, 32, 16, 64)]
    out = {}
    for device, p in (("cpu", params), (dev, on_dev)):
        eng = Engine(cfg, p, ServeConfig(max_slots=2, cache_len=96,
                                         max_new_tokens=6), device=device)
        for pr in prompts:
            eng.submit(pr)
        out[str(device)] = eng.run()
    assert out["cpu"] == out[str(dev)]


def test_flash_autograd_route_gradient_equals_plain_at_llama_shapes(dev):
    """At llama3.2-1b's training shapes (a microbatch of 2 rows of 2048,
    as batch 8 in microbatches of 4 gives, 32 query and 8 KV heads of 64,
    bf16, the config's 1024-token tiles) a flash call that needs a
    gradient launches the kernel once for the forward and returns the
    plain loop's gradient: q, k, v gradients within the kernel's
    elementwise ``TOLERANCE`` of the plain version's under autograd (the
    same recompute, so in practice equal), the forward within it too.
    Without a gradient the same call launches the kernel and gives the
    kernel's output bit for bit."""
    from repro_torch.kernels import flash_attn as kflash

    tiles = dict(q_block=1024, kv_block=1024)
    q, k, v = _flash_inputs(21, 2, 2048, 32, 8, 64, torch.bfloat16, dev)
    cot = _flash_inputs(22, 2, 2048, 32, 8, 64, torch.bfloat16, dev)[0]
    kflash.KERNEL.launches = 0
    plain_out = kflash.flash_attention(q, k, v, **tiles)
    assert kflash.KERNEL.launches == 1 and plain_out.grad_fn is None

    grads = []
    for route in ("kernel", "plain"):
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        if route == "kernel":
            out = kflash.flash_attention(qa, ka, va, **tiles)
            assert kflash.KERNEL.launches == 2
            assert torch.equal(out.detach(), plain_out)
        else:
            out = kflash.flash_attention_plain(qa, ka, va, **tiles)
            want_out = out.detach()
        out.backward(cot)
        grads.append((qa.grad, ka.grad, va.grad))
    torch.cuda.synchronize()
    assert kflash.KERNEL.launches == 2  # the backward launches no kernel
    np.testing.assert_allclose(plain_out.float().cpu().numpy(),
                               want_out.float().cpu().numpy(),
                               **kflash.TOLERANCE[torch.bfloat16])
    for got, want, name in zip(*grads, "qkv"):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **kflash.TOLERANCE[torch.bfloat16],
                                   err_msg=f"d{name}")


def test_dedup_ingest_on_the_card_equals_the_cpu(dev):
    """``DedupIngest`` on the card runs the masks, select and fingerprint
    kernels and yields the CPU run's unique bytes (its plain versions),
    token batches and savings."""
    from repro_torch.data import DedupIngest, PipelineConfig
    from repro_torch.data.corpus import snapshot_series

    snaps = list(snapshot_series(base_bytes=1 << 20, snapshots=3,
                                 edit_rate=2e-5, seed=4))
    corpus = np.concatenate(snaps + [snaps[0][:70_000]])
    cfg = PipelineConfig(avg_chunk=8192, segment_bytes=1 << 18,
                         batch_segments=8, seq_len=2047, batch_size=2)
    for k in (kmasks.KERNEL, kselect.KERNEL, kfp.KERNEL):
        k.launches = 0
    got = DedupIngest(cfg, device=dev)
    want = DedupIngest(cfg, device="cpu")
    g = list(got.unique_bytes(corpus))
    assert all(k.launches > 0 for k in (kmasks.KERNEL, kselect.KERNEL,
                                        kfp.KERNEL))
    w = list(want.unique_bytes(corpus))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)
    assert got.savings == want.savings > 0.2  # 0.3021 on the card
    tb = list(DedupIngest(cfg, device=dev).token_batches(corpus))
    tw = list(DedupIngest(cfg, device="cpu").token_batches(corpus))
    assert len(tb) == len(tw) > 0
    for a, b in zip(tb, tw):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    """A tree of card tensors (float32, bfloat16, int32, a NamedTuple)
    saved with the chunker's kernels restores onto the card bit-equal, and
    the manifest is the one a CPU manager (plain versions) writes."""
    from repro_torch._tree import leaves
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train.optim import OptState

    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((512, 300), generator=g, device=dev)
    tree = {"params": {"w": w, "e": w.to(torch.bfloat16)[:, :77],
                       "i": torch.arange(1000, dtype=torch.int32, device=dev)},
            "opt": OptState({"w": w * 0.5}, {"w": w * w},
                            torch.tensor(3, dtype=torch.int32, device=dev))}
    kmasks.KERNEL.launches = kselect.KERNEL.launches = 0
    mgr = CheckpointManager(str(tmp_path / "card"), avg_chunk=8192,
                            device=dev)
    mgr.save(2, tree, {"next_step": 3})
    assert kmasks.KERNEL.launches > 0 and kselect.KERNEL.launches > 0
    step, out, extra = mgr.restore_on_device(tree, dev)
    assert (step, extra) == (2, {"next_step": 3})
    for a, b in zip(leaves(tree), leaves(out)):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    CheckpointManager(str(tmp_path / "cpu"), avg_chunk=8192,
                      device="cpu").save(2, tree, {"next_step": 3})
    name = "manifest-00000002.json"
    assert (tmp_path / "card" / name).read_bytes() == (
        tmp_path / "cpu" / name).read_bytes()


# -- the recurrent families' scans and flash attention at head width 256 ------


def _t32(rng, shape, lo=None, hi=None, std=1.0, dev="cuda"):
    x = (rng.uniform(lo, hi, shape) if lo is not None
         else rng.standard_normal(shape) * std)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _close_to(got, want, tol, msg=""):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol,
                               err_msg=msg)


_TILE = 128  # kernels/linear_scan.py TILE_STEPS


@pytest.mark.parametrize("B,T,N", [(1, 1, 1), (2, 37, 100), (3, 1000, 33),
                                   (1, 4096, 2560), (2, 17, 2561),
                                   (1, _TILE - 1, 64), (1, _TILE, 64),
                                   (2, _TILE + 1, 64), (3, 300 * _TILE + 5, 40),
                                   (3, 300, 2561)])
def test_linear_scan_kernel_matches_plain(dev, B, T, N):
    """Ragged T, N not a multiple of 32, B > 1, T at a tile's edges and
    over hundreds of tiles (the look-back), and the state carried across
    two calls launched back to back (the second call's h0 is the first's
    last h)."""
    from repro_torch.kernels import linear_scan as kscan

    rng = np.random.default_rng(T + N)
    a = _t32(rng, (B, 2 * T, N), 0.0, 0.95)
    b = _t32(rng, (B, 2 * T, N), std=0.5)
    h0 = _t32(rng, (B, N))
    kscan.KERNEL.launches = 0
    h1, last1 = kscan.linear_scan(a[:, :T], b[:, :T], h0)
    h2, last2 = kscan.linear_scan(a[:, T:], b[:, T:], last1)
    assert kscan.KERNEL.launches == 2
    want, want_last = kscan.linear_scan_plain(a, b, h0)
    _close_to(torch.cat([h1, h2], 1), want, kscan.TOLERANCE)
    _close_to(last2, want_last, kscan.TOLERANCE)
    _close_to(last1, want[:, T - 1], kscan.TOLERANCE)


def test_linear_scan_kernel_after_launches_of_other_sizes(dev):
    """A launch leaves the ticket at 0 and its status words tagged with its
    generation, which the next launch on the stream reads as unpublished: a
    large launch, a small one, the large one again and a larger one (a new
    scratch), back to back on one stream, each equal to its plain version;
    then the same again across the generations' wrap."""
    from repro_torch.kernels import linear_scan as kscan

    rng = np.random.default_rng(7)
    shapes = [(2, 40 * _TILE + 3, 300), (1, 5, 7), (2, 40 * _TILE + 3, 300),
              (3, 20 * _TILE, 2561)]
    ins = [(_t32(rng, s, 0.0, 0.95), _t32(rng, s, std=0.5),
            _t32(rng, (s[0], s[2]))) for s in shapes]
    stream = torch.cuda.current_stream()
    key = (stream.device.index, stream.cuda_stream)
    kscan._scratch.bufs.pop(key, None)
    for wrap in (False, True):
        if wrap:
            buf, _ = kscan._scratch.bufs[key]
            kscan._scratch.bufs[key] = (buf, kscan.GENERATIONS - 2)
        kscan.KERNEL.launches = 0
        got = [kscan.linear_scan(*x) for x in ins]
        assert kscan.KERNEL.launches == len(shapes)
        for (h, last), x in zip(got, ins):
            want, want_last = kscan.linear_scan_plain(*x)
            _close_to(h, want, kscan.TOLERANCE)
            _close_to(last, want_last, kscan.TOLERANCE)
    assert kscan._scratch.bufs[key][1] == 3  # wrapped at the second launch


@pytest.mark.parametrize("B,T,N", [(1, 32768, 2560), (3, 300 * _TILE, 2561)])
def test_linear_scan_kernel_is_bit_reproducible(dev, B, T, N):
    """The look-back folds forward from the nearest prefix in the order a
    chain of prefixes would, so however far each tile walks, five launches
    give the same bits (phase 10's longest prompt and hundreds of tiles at
    B 3)."""
    from repro_torch.kernels import linear_scan as kscan

    rng = np.random.default_rng(B + T)
    a = _t32(rng, (B, T, N), 0.0, 0.999)
    b = _t32(rng, (B, T, N), std=0.5)
    h0 = _t32(rng, (B, N))
    first, first_last = kscan.linear_scan(a, b, h0)
    for _ in range(4):
        h, last = kscan.linear_scan(a, b, h0)
        assert torch.equal(h, first) and torch.equal(last, first_last)
    want, _ = kscan.linear_scan_plain(a[:, :4096], b[:, :4096], h0)
    _close_to(first[:, :4096], want, kscan.TOLERANCE)


@pytest.mark.parametrize("B,nc,H,hd", [(1, 1, 1, 1), (2, 5, 3, 33),
                                       (1, 16, 4, 384), (3, 9, 2, 64)])
def test_mlstm_scan_kernel_matches_plain(dev, B, nc, H, hd):
    """Every output (the state at each chunk start and after the last),
    the state carried across two calls, B > 1."""
    from repro_torch.kernels import mlstm_scan as kmlstm

    rng = np.random.default_rng(nc + hd)
    btot = -_t32(rng, (B, 2 * nc, H), 0.0, 5.0)
    mc = _t32(rng, (B, 2 * nc, H))
    kv = _t32(rng, (B, 2 * nc, H, hd, hd))
    ks = _t32(rng, (B, 2 * nc, H, hd))
    st0 = (_t32(rng, (B, H, hd, hd)), _t32(rng, (B, H, hd)),
           torch.full((B, H), -1e30, device=dev))
    kmlstm.KERNEL.launches = 0
    st, got = st0, []
    for hv in (slice(0, nc), slice(nc, 2 * nc)):
        out = kmlstm.mlstm_scan(btot[:, hv], mc[:, hv], kv[:, hv], ks[:, hv],
                                *st)
        got.append(out)
        st = out[3:]
    assert kmlstm.KERNEL.launches == 2
    want = kmlstm.mlstm_scan_plain(btot, mc, kv, ks, *st0)
    for i in range(3):  # the state at every chunk start, both calls
        _close_to(torch.cat([got[0][i], got[1][i]], 1), want[i],
                  kmlstm.TOLERANCE, f"output {i}")
    for i in range(3, 6):
        _close_to(got[1][i], want[i], kmlstm.TOLERANCE, f"output {i}")


#: (B, S, H, hd): head widths on each cluster size the kernel picks (1 at
#: hd <= 32, 2 at 64, 4 at 128, 8 above), several clusters (B 3, H > 1)
_SLSTM_SHAPES = [(1, 1, 1, 8), (2, 33, 2, 32), (3, 17, 3, 24),
                 (1, 300, 4, 128), (1, 40, 2, 64), (3, 25, 2, 128)]


@pytest.mark.parametrize("dtype,B,S,H,hd", [
    (dt, *shape) for dt in (torch.float32, torch.bfloat16)
    for shape in _SLSTM_SHAPES] + [
        (torch.bfloat16, 2, 50, 4, 192), (torch.bfloat16, 1, 1, 4, 192),
        (torch.bfloat16, 3, 20, 2, 256), (torch.bfloat16, 3, 12, 3, 200),
        (torch.bfloat16, 1, 2048, 4, 192), (torch.float32, 2, 50, 4, 192),
        (torch.float32, 3, 20, 2, 256), (torch.float32, 3, 12, 3, 200)])
def test_slstm_scan_kernel_matches_plain(dev, dtype, B, S, H, hd):
    """Gate inputs and recurrent weights in float32 and in bfloat16 (the
    reference's promotion: the state times r in float32), the weights at
    the model's scale (std 0.02), the state carried across two calls, head
    widths up to the kernel's 256 (in float32 too: xLSTM's 192 is trained
    there by phase 14's gradient check; 200: 25 channels a CTA, padded to
    28 in the h buffer), S = 1, and xLSTM's
    width over 4,096 steps (two calls of 2,048); held to the plain version
    in float64 as accurately as the plain version in float32 is
    (``ACCURACY``)."""
    from repro_torch.kernels import slstm_scan as kslstm

    rng = np.random.default_rng(S + hd)
    D = H * hd
    xg = _t32(rng, (B, 2 * S, 4, D), std=0.5).to(dtype)
    r = _t32(rng, (4, H, hd, hd), std=0.02).to(dtype)
    st = kslstm.SLSTMState(_t32(rng, (B, D), std=0.3), _t32(rng, (B, D)),
                           _t32(rng, (B, D), 0.5, 2.0), _t32(rng, (B, D)))
    kslstm.KERNEL.launches = 0
    h1, st1 = kslstm.slstm_scan(xg[:, :S], r, st)
    h2, st2 = kslstm.slstm_scan(xg[:, S:], r, st1)
    assert kslstm.KERNEL.launches == 2
    want = kslstm.slstm_scan_plain(xg, r, st)
    want64 = kslstm.slstm_scan_plain(
        xg.double(), r.double(), kslstm.SLSTMState(*(t.double() for t in st)))
    got = (torch.cat([h1, h2], 1), st2)
    ratio = kslstm.accuracy_ratio(got, want, want64)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV", [1, 2])
@pytest.mark.parametrize("S", [1, 100, 1500])
def test_flash_kernel_at_head_width_256(dev, no_tf32, dtype, KV, S):
    """RecurrentGemma's head width: 4 query heads over 1 or 2 KV heads,
    causal with and without a window, B = 2."""
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(S + KV, 2, S, 4, KV, 256, dtype, dev)
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        got = kflash.flash_attention(q, k, v, causal=causal, window=window)
        want = kflash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_block=512,
                                            kv_block=512)
        _close_to(got, want, kflash.TOLERANCE[dtype],
                  f"causal={causal} window={window}")


# -- the scans' backward kernels ---------------------------------------------


def _grads(outs, ins, seed):
    """Autograd's gradients of ``ins`` under random upstream gradients on
    every output (the same numbers for every call with the same seed)."""
    rng = np.random.default_rng(seed)
    gs = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)).to(o.device) for o in outs]
    got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)),
                              ins)
    return got, gs


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,T,N", [(1, 1, 1), (2, 37, 100), (3, 1000, 33),
                                   (1, 4096, 2560), (2, _TILE + 1, 64),
                                   (3, 300 * _TILE + 5, 40)])
def test_linear_scan_bwd_kernel_matches_plain(dev, B, T, N, with_h0):
    """Ragged T and N, one and hundreds of tiles (the look-back run from
    the end), with and without h0: the kernel's gradients against the
    plain backward on the same saved h, and two launches bit-equal."""
    from repro_torch.kernels import linear_scan as kscan

    rng = np.random.default_rng(T + N + with_h0)
    a = _t32(rng, (B, T, N), 0.0, 0.95).requires_grad_(True)
    b = _t32(rng, (B, T, N), std=0.5).requires_grad_(True)
    h0 = _t32(rng, (B, N)).requires_grad_(True) if with_h0 else None
    ins = (a, b) + ((h0,) if with_h0 else ())
    kscan.KERNEL.launches = kscan.BWD_KERNEL.launches = 0
    h, last = kscan.linear_scan(a, b, h0)
    got, (g, g_last) = _grads((h, last), ins, 1)
    assert (kscan.KERNEL.launches, kscan.BWD_KERNEL.launches) == (1, 1)
    want = kscan.linear_scan_bwd_plain(
        a.detach(), h.detach(), None if h0 is None else h0.detach(), g,
        g_last)
    for x, w in zip(got, want):
        _close_to(x, w, kscan.TOLERANCE)
    again, _ = _grads(kscan.linear_scan(a, b, h0), ins, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("B,nc,H,hd", [(1, 1, 1, 1), (2, 5, 3, 33),
                                       (8, 8, 4, 384), (3, 9, 2, 64),
                                       (1, 20, 1, 8)])
def test_mlstm_scan_bwd_kernel_matches_plain(dev, B, nc, H, hd, carried):
    """Every input's gradient against the plain backward's
    (``BWD_TOLERANCE``), from a carried state and from the model's initial
    one (m at -1e30), nc above the kernel's group of 8 chunks; xLSTM's
    width at phase 14's batch of 8 rows; two launches bit-equal."""
    from repro_torch.kernels import mlstm_scan as kmlstm

    rng = np.random.default_rng(nc + hd + carried)
    ins = [-_t32(rng, (B, nc, H), 0.0, 5.0), _t32(rng, (B, nc, H)),
           _t32(rng, (B, nc, H, hd, hd)), _t32(rng, (B, nc, H, hd))]
    if carried:
        ins += [_t32(rng, (B, H, hd, hd)), _t32(rng, (B, H, hd)),
                _t32(rng, (B, H))]
    else:
        ins += [torch.zeros((B, H, hd, hd), device=dev),
                torch.zeros((B, H, hd), device=dev),
                torch.full((B, H), -1e30, device=dev)]
    ins = [t.requires_grad_(True) for t in ins]
    kmlstm.KERNEL.launches = kmlstm.BWD_KERNEL.launches = 0
    outs = kmlstm.mlstm_scan(*ins)
    got, gs = _grads(outs, ins, 2)
    assert (kmlstm.KERNEL.launches, kmlstm.BWD_KERNEL.launches) == (1, 1)
    want = kmlstm.mlstm_scan_bwd_plain(*(t.detach() for t in ins[:4]),
                                       *(t.detach() for t in outs[:3]), *gs)
    torch.cuda.synchronize()
    used = kmlstm.bwd_tolerance_used(got, want)
    assert used <= 1.0, used
    again, _ = _grads(kmlstm.mlstm_scan(*ins), ins, 2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _slstm_bwd_case(dev, dtype, B, S, H, hd, seed):
    from repro_torch.kernels import slstm_scan as kslstm

    rng = np.random.default_rng(seed)
    D = H * hd
    xg = _t32(rng, (B, S, 4, D), std=0.5).to(dtype)
    r = _t32(rng, (4, H, hd, hd), std=0.02).to(dtype)
    st = [_t32(rng, (B, D), std=0.3), _t32(rng, (B, D)),
          _t32(rng, (B, D), 0.5, 2.0), _t32(rng, (B, D))]
    return xg, r, st


def slstm_bwd_accuracy(xg, r, st, seed):
    """The kernels' gradients (forward and backward kernel under autograd)
    held to float64 autograd of the plain loop by ``accuracy_ratio``, the
    float32 plain backward's own error the yardstick: (ratio, kernel
    gradients)."""
    from repro_torch.kernels import slstm_scan as kslstm

    def run(fn, xg, r, st):
        ins = [t.detach().requires_grad_(True) for t in (xg, r, *st)]
        hs, fin = fn(ins[0], ins[1], kslstm.SLSTMState(*ins[2:]))
        got, _ = _grads([hs, *fin], ins, seed)
        return got[0], got[1], got[2:]

    got = run(kslstm.slstm_scan, xg, r, st)
    plain32 = run(kslstm.slstm_scan_plain, xg, r, st)
    plain64 = run(kslstm.slstm_scan_plain, xg.double(), r.double(),
                  [t.double() for t in st])
    return kslstm.accuracy_ratio(got, plain32, plain64), got


@pytest.mark.parametrize("dtype,B,S,H,hd", [
    (dt, *shape) for dt in (torch.float32, torch.bfloat16)
    for shape in [(1, 1, 1, 8), (2, 33, 2, 32), (3, 17, 3, 24),
                  (1, 300, 4, 128), (1, 40, 2, 64)]] + [
        (torch.bfloat16, 2, 50, 4, 192), (torch.bfloat16, 3, 20, 2, 256),
        (torch.bfloat16, 3, 12, 3, 200), (torch.bfloat16, 2, 2048, 4, 192),
        (torch.float32, 2, 50, 4, 192), (torch.float32, 3, 20, 2, 256),
        (torch.float32, 1, 2304, 4, 192),
        (torch.bfloat16, 3, 300, 4, 192), (torch.bfloat16, 5, 300, 4, 192),
        (torch.float32, 5, 100, 4, 192), (torch.bfloat16, 1, 500, 4, 192),
        (torch.bfloat16, 64, 24, 4, 192), (torch.float32, 64, 16, 2, 64),
        (torch.bfloat16, 8, 2048, 4, 192), (torch.float32, 8449, 3, 1, 4)])
def test_slstm_scan_bwd_kernel_matches_float64_autograd(dev, dtype, B, S, H,
                                                        hd):
    """Every cluster size (1 at hd <= 32, 2 at 64, 4 at 128, 8 above),
    several clusters, padded rows (hd 200: 25 channels a CTA), S = 1, and
    xLSTM's width over 2,048 steps; the batch rows a cluster serves (R,
    ``bwd_plan``): 1 (B 1 and 3), 2 with a row past B (B 5 at 4 heads), 3
    with one (xLSTM's 8 rows of 4 heads), B 64, more clusters than one
    wave, and 3 at hd 4, where the third cell warp sums no channel (8,449
    rows of 1 head: more than two rows a cluster of 1 CTA on any card of
    at most 132 SMs, each holding at most 32 CTAs): the gradients of xg, r and the initial state, forward and
    backward kernels under autograd, as accurate as the plain version's in
    float32 (``accuracy_ratio`` against float64 autograd of the plain
    loop); each kernel launched once; the backward bit-equal over two
    launches."""
    from repro_torch.kernels import slstm_scan as kslstm

    xg, r, st = _slstm_bwd_case(dev, dtype, B, S, H, hd, S + hd)
    kslstm.KERNEL.launches = kslstm.BWD_KERNEL.launches = 0
    ratio, got = slstm_bwd_accuracy(xg, r, st, 3)
    assert (kslstm.KERNEL.launches, kslstm.BWD_KERNEL.launches) == (1, 1)
    assert ratio <= 1.0, ratio
    assert got[0].dtype == dtype and got[1].dtype == dtype
    _, again = slstm_bwd_accuracy(xg, r, st, 3)
    assert all(torch.equal(x, y) for x, y in zip(
        [got[0], got[1], *got[2]], [again[0], again[1], *again[2]]))


def test_slstm_scan_bwd_plan_one_wave_where_it_fits(dev):
    """The backward's launch plan: the least R of 1-3 whose ceil(B / R) H
    clusters the card holds at once, else 3; xLSTM's 8 rows of 4 heads of
    192 in one wave; one row a cluster where it fits; cluster sizes as the
    forward's; a warp for two channels, at least R of them, and the io
    warp (at hd 4 and R 3, four warps: the third cell warp sums
    nothing); the same plan when asked again."""
    from repro_torch.kernels import slstm_scan as kslstm

    launches = kslstm.BWD_KERNEL.launches
    for B, H, hd in [(1, 4, 192), (3, 4, 192), (5, 4, 192), (8, 4, 192),
                     (64, 4, 192), (2, 2, 64), (1, 1, 8), (4, 2, 256),
                     (8449, 1, 4)]:
        plan = kslstm.bwd_plan(B, H, hd)
        C = plan["C"]
        assert C == max(1, 2 ** int(np.ceil(np.log2(hd / 32)))), plan
        fits = [R for R in (1, 2, 3)
                if -(-B // R) * H <= plan["max_active_clusters"]]
        want = min(fits) if fits else 3
        assert plan["R"] == (1 if B == 1 else want), (B, H, hd, plan)
        assert plan["clusters"] == -(-B // plan["R"]) * H, plan
        assert plan["threads"] == 32 * (
            max(-(-(hd // C) // 2), plan["R"]) + 1), plan
        assert kslstm.bwd_plan(B, H, hd) == plan
    plan = kslstm.bwd_plan(8449, 1, 4)
    assert (plan["R"], plan["threads"]) == (3, 128), plan
    plan = kslstm.bwd_plan(8, 4, 192)
    assert plan["clusters"] <= plan["max_active_clusters"], plan
    assert kslstm.BWD_KERNEL.launches == launches


def test_new_wrappers_launch_their_backward_kernels_on_a_cuda_input_that_needs_a_gradient(dev):  # noqa: E501
    """A CUDA input that needs a gradient goes through the scan's Function:
    the forward kernel, then, at ``backward``, the backward kernel (once
    each), with gradients equal to the plain backward's; under
    ``torch.no_grad()`` the forward kernel alone.  The sLSTM wrapper
    refuses a head width its kernels do not take, with or without a
    gradient."""
    from repro_torch.kernels import linear_scan as kscan
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import slstm_scan as kslstm

    rng = np.random.default_rng(0)
    a, b = _t32(rng, (1, 4, 8), 0.0, 0.9), _t32(rng, (1, 4, 8))
    mins = (_t32(rng, (1, 2, 1)), _t32(rng, (1, 2, 1)),
            _t32(rng, (1, 2, 1, 4, 4)), _t32(rng, (1, 2, 1, 4)),
            _t32(rng, (1, 1, 4, 4)), _t32(rng, (1, 1, 4)), _t32(rng, (1, 1)))
    xg, r = _t32(rng, (1, 3, 4, 8)), _t32(rng, (4, 2, 4, 4), std=0.02)
    st = kslstm.SLSTMState(*(_t32(rng, (1, 8)) for _ in range(4)))
    for g in (lambda t: t, lambda t: t.clone().requires_grad_(True)):
        with pytest.raises(ValueError, match="head width"):  # 20 % 8 != 0
            kslstm.slstm_scan(g(_t32(rng, (1, 2, 4, 40))),
                              _t32(rng, (4, 2, 20, 20)).bfloat16(),
                              kslstm.SLSTMState(*(_t32(rng, (1, 40))
                                                  for _ in range(4))))
    cases = [
        (kscan, lambda g: kscan.linear_scan(g(a), b),
         lambda outs, gs: kscan.linear_scan_bwd_plain(a, outs[0], None,
                                                      *gs)[:1]),
        (kmlstm, lambda g: kmlstm.mlstm_scan(*mins[:2], g(mins[2]),
                                             *mins[3:]),
         lambda outs, gs: kmlstm.mlstm_scan_bwd_plain(
             *mins[:4], *outs[:3], *gs)[2:3]),
        (kslstm, lambda g: (lambda o: [o[0], *o[1]])(
            kslstm.slstm_scan(g(xg), r, st)), None),
    ]
    for mod, call, plain in cases:
        x = None

        def grad_input(t):
            nonlocal x
            x = t.clone().requires_grad_(True)
            return x

        mod.KERNEL.launches = mod.BWD_KERNEL.launches = 0
        outs = call(grad_input)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        assert (mod.KERNEL.launches, mod.BWD_KERNEL.launches) == (1, 0)
        (got,), gs = _grads(outs, [x], 4)
        assert (mod.KERNEL.launches, mod.BWD_KERNEL.launches) == (1, 1)
        assert bool(torch.isfinite(got).all())
        if plain is not None:
            (want,) = plain([o.detach() for o in outs], gs)
            _close_to(got, want, kscan.TOLERANCE)
        with torch.no_grad():  # no gradient wanted: the forward kernel only
            call(lambda t: t.clone().requires_grad_(True))
        assert (mod.KERNEL.launches, mod.BWD_KERNEL.launches) == (2, 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_recurrent_models_train_on_the_card_like_the_cpu(dev, no_tf32,
                                                         arch):
    """Reduced recurrentgemma-2b (flash blocks of 16) and xlstm-125m in
    float32, 2 x 48 tokens: ``grads_and_metrics`` on the card (the scans'
    forward and backward kernels, flash under autograd) against the CPU's
    (the plain versions), leaf by leaf within 1e-3 of each element plus
    1e-5 of the whole gradient's largest value; every scan kernel of the
    arch launched once a layer of its kind, forward and backward."""
    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm
    from repro_torch.models.transformer import segments
    from repro_torch.train import grads_and_metrics

    cfg = get_reduced(arch)
    if arch == "recurrentgemma-2b":
        cfg = cfg.replace(attn_q_block=16, attn_kv_block=16)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 48)))
    batch = {"tokens": toks, "labels": toks}
    want, wm = grads_and_metrics(cfg, params, batch)
    for k in KERNELS:
        k.launches = 0
    got, gm = grads_and_metrics(cfg, tree_map(lambda t: t.to(dev), params),
                                {k: t.to(dev) for k, t in batch.items()})
    torch.cuda.synchronize()
    layers = {}
    for kind, n in segments(cfg):
        layers[kind] = layers.get(kind, 0) + n
    # a call a layer; the mLSTM's 48 tokens are a chunk of 32 and a ragged
    # tail of 16, a call each
    calls = {"rglru": ("linear_scan", 1), "mlstm": ("mlstm_scan", 2),
             "slstm": ("slstm_scan", 1)}
    expect = {}
    for kind, (name, per_layer) in calls.items():
        if kind in layers:
            expect[name] = expect[f"{name}_bwd"] = layers[kind] * per_layer
    if "attn" in layers:
        expect["flash_attn"] = layers["attn"]
    assert {k.name: k.launches for k in KERNELS if k.launches} == expect
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)
    g_max = max(float(w.abs().max()) for w in leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        _close_to(g, w, dict(rtol=1e-3, atol=1e-5 * g_max))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_recurrent_models_and_engine_on_the_card_match_the_cpu(dev, no_tf32,
                                                              arch):
    """Reduced recurrentgemma-2b (flash blocks of 16) and xlstm-125m in
    float32: forward logits on the card (the scan kernels, and flash for
    the hybrid's attention) equal the CPU's (their plain versions), and the
    engine's greedy tokens are the CPU engine's."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_reduced(arch)
    if arch == "recurrentgemma-2b":
        cfg = cfg.replace(attn_q_block=16, attn_kv_block=16)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    on_dev = tree_map(lambda t: t.to(dev), params)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 48)))
    for k in KERNELS:
        k.launches = 0
    got = lm.forward(cfg, on_dev, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    launched = {k.name for k in KERNELS if k.launches}
    assert launched == ({"linear_scan", "flash_attn"}
                        if arch == "recurrentgemma-2b"
                        else {"mlstm_scan", "slstm_scan"}), launched
    want = lm.forward(cfg, params, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=3e-4,
                               atol=3e-4)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, n) for n in (48, 9, 32, 16, 64)]
    out = {}
    for device, p in (("cpu", params), (dev, on_dev)):
        eng = Engine(cfg, p, ServeConfig(max_slots=2, cache_len=96,
                                         max_new_tokens=6), device=device)
        for pr in prompts:
            eng.submit(pr)
        out[str(device)] = eng.run()
    assert out["cpu"] == out[str(dev)]


# -- the dense family, the embedding input modes and MoE ----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV", [(128, 56, 8), (128, 40, 10),
                                     (128, 64, 8), (128, 32, 4),
                                     (64, 32, 32)])
@pytest.mark.parametrize("S", [1024, 4096])
def test_flash_kernel_at_the_dense_family_s_serving_shapes(dev, no_tf32,
                                                           dtype, hd, H, KV,
                                                           S):
    """llava-next-34b's heads (56 over 8 KV heads: groups of 7),
    phi3-medium-14b's (40 over 10), qwen2-72b's (64 over 8: groups of 8)
    and qwen3-moe-30b-a3b's (32 over 4: groups of 8) at width 128, and
    musicgen-large's full MHA (32 over 32) at width 64: one causal prompt
    of S tokens."""
    from repro_torch.kernels import flash_attn as kflash

    q, k, v = _flash_inputs(S + H + hd, 1, S, H, KV, hd, dtype, dev)
    kflash.KERNEL.launches = 0
    got = kflash.flash_attention(q, k, v)
    assert kflash.KERNEL.launches == 1
    want = kflash.flash_attention_plain(q, k, v, q_block=1024,
                                        kv_block=1024)
    _close_to(got, want, kflash.TOLERANCE[dtype])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llava-next-34b",
                                  "deepseek-v3-671b"])
def test_moe_and_mixed_models_on_the_card_match_the_cpu(dev, no_tf32, arch):
    """Reduced qwen3-moe-30b-a3b, llava-next-34b and deepseek-v3-671b
    (float32, flash blocks of 16): a 48-position prefill (llava: 16 patch
    embeddings and 32 text tokens) and 4 greedy decode steps on the card
    (deepseek's absorbed MLA decode), logits and the greedy tokens equal to
    the CPU's; the prefill launches the flash kernel once an attention
    layer (never for an MLA layer)."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attn as kflash
    from repro_torch.models import lm
    from repro_torch.models.transformer import ATTENTION_KINDS, layer_kinds

    cfg = get_reduced(arch).replace(attn_q_block=16, attn_kv_block=16)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(12)
    S = 48
    n_tok = S - (cfg.img_tokens if cfg.input_mode == "mixed" else 0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, n_tok)))}
    if cfg.input_mode == "mixed":
        batch["embeds"] = torch.from_numpy((rng.standard_normal(
            (2, cfg.img_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    runs = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        b = {k: t.to(device) for k, t in batch.items()}
        kflash.KERNEL.launches = 0
        lg, caches = lm.prefill_step(cfg, p, b, S + 8)
        if str(device) != "cpu":
            assert kflash.KERNEL.launches == sum(
                k in ATTENTION_KINDS for k in layer_kinds(cfg))
        logits = [lg]
        for i in range(4):
            tok = logits[-1].argmax(-1)[:, None]
            lg, caches = lm.decode_step(cfg, p, caches, tok, S + i)
            logits.append(lg)
        runs[str(device)] = [t.cpu() for t in logits]
    for i, (g, w) in enumerate(zip(runs[str(dev)], runs["cpu"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
        assert torch.equal(g.argmax(-1), w.argmax(-1)), i
