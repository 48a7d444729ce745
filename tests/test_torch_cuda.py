"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA card: they
are marked ``cuda`` and skip with a reason elsewhere.  On the card, run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports neither jax nor the JAX package: the plain torch
versions, which the CPU tests hold against the reference, are the oracle
here, every output compared bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _packing_cases
from repro_torch.core import available, make_chunker
from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.automaton import select_boundaries as select_plain
from repro_torch.core.baselines.selectors import SelectorParams
from repro_torch.core.calibrate import calibrated_kwargs
from repro_torch.core.oracle import boundaries_numpy
from repro_torch.core.params import SeqCDCParams, paper_params
from repro_torch.core.seqcdc import boundaries_sequential
from repro_torch.dedup.fingerprint import fingerprints_numpy
from repro_torch.kernels import extremum as kext
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import fused_pipeline as kfused
from repro_torch.kernels import gear_hash as kgear
from repro_torch.kernels import native_scan as kscan
from repro_torch.kernels import packed_pipeline as kpacked
from repro_torch.kernels import select_boundaries as kselect
from repro_torch.kernels import seqcdc_masks as kmasks
from repro_torch.service import DedupService, ShardedDedupService

pytestmark = pytest.mark.cuda

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
