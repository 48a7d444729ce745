#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It drives only
``src/repro_torch`` (never jax, never the JAX package ``repro``):

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every CUDA kernel of the port's paths is compiled from
   ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc`` per source, all in
   parallel) into ``build/kernels/``;
3. each kernel against its plain torch version, on the card, at the
   shapes its path gives it: the service's kernels at paper 8 KiB
   parameters (masks, fused, fingerprint and select at a 1 MiB x 8 and a
   48 KiB x 8 bucket, the packed kernel at 8 packed rows of 16 KiB under
   three segment mixes: all-tiny 100-1000 B, 512-2048 B, and the
   heavy-tail sizes below 16 KiB); the registry's kernels at calibrated
   8 KiB knobs (gear and block max over a 64 MiB stream, select over one
   1 MiB gear selector row, the native scan over 64 KiB for each of its
   seven algorithms); every output bit-equal, rows spot-checked against
   the numpy oracle, kernel, plain and (block max) library times, and the
   least time the card could take (its bound); the plain gather and event
   automaton steps, once each on a 4 MiB SeqCDC stream, bit-equal to the
   select kernel; then the block-max op once, its only path;
4. the single-store service: ``DedupService.open`` on a temporary
   directory with the mask, fingerprint and pipeline cross-checks on (their
   replays run the split path: the masks, select and fingerprint kernels),
   a seeded versioned corpus (6 versions of 48 objects, log-uniform
   16 KiB-2 MiB, about 1% of bytes edited per version), every object
   submitted, flushed, restored SHA-verified, and a sample of recipes held
   against the numpy oracle;
5. the sharded service with segment packing: ``ShardedDedupService.open``
   with 4 local shards, the fused pipeline and the packing cross-check, a
   seeded file tree (3 versions of 4,096 files, heavy-tail sizes; per
   version 2% of files edited, 1% new, 1% deleted), every version ingested,
   the last restored SHA-verified, a sample of recipes held against the
   oracle;
6. the chunker registry: ``benchmarks/bench_chunking.py``'s native and
   vectorized lists through ``make_chunker`` on the card at avg 8 KiB with
   the calibrated knobs, at that benchmark's "full" sizes (64 MiB for the
   vectorized chunkers, 16 MiB for rabin/crc/gear/fastcdc/tttd and every
   ``_seq`` form), crc/rabin also with ``backend="torch"``: one warm-up
   and two timed calls each, GB/s and mean chunk size, and every
   (vectorized, native) pair of ``tests/test_baselines.py`` bit-equal on
   one stream;
7. the ``kernels`` JSON line, then the result line.

The launch counts are set to 0 before the block-max op in phase 3 and
before phases 4, 5 and 6, and read after each; every kernel must launch in
one of them, and each phase must launch the kernels of its own path.  The
``kernels`` line sums them.

It exits non-zero, with no result line, without a CUDA card, outside a
checkout of the repo, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM: HBM3 rate and the non-tensor (FP32 CUDA-core) peak rate
#: (NVIDIA data sheet); operations bounds use the latter
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

#: the single-store phase's corpus: versions x objects, about 128 MiB
#: logical
VERSIONS = 6
OBJECTS = 48

#: the sharded phase's file tree: versions x files, about 116 MiB a version
TREE_VERSIONS = 3
TREE_FILES = 4096
SHARDS = 4

#: phase 3's stream for the gear and block-max kernels (64 MiB, the
#: vectorized chunkers' "full" size) and the native scans' (64 KiB: their
#: plain versions are Python loops)
BIG_STREAM = 64 << 20
SCAN_BYTES = 64 << 10


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str) -> float | None:
    """Mean device milliseconds per call of the CUDA kernel whose name
    contains ``kernel``, from a ``torch.profiler`` trace of ``reps`` calls;
    None if the trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += getattr(ev, "self_device_time_total", 0.0) or getattr(
                ev, "self_cuda_time_total", 0.0)
    return us / reps / 1e3 if us > 0 else None


def kernel_times(run, reps: int, kernel: str) -> dict:
    """A kernel wrapper's per-call time (CUDA events, host launch overhead
    included) and its kernel's device time (profiler)."""
    return dict(call_ms=cuda_ms(run, reps, 3),
                device_ms=device_ms(run, reps, kernel))


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer outputs."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise AssertionError(
                f"shape/dtype mismatch: {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(r: dict) -> dict:
    """Set ``ms``: the kernel's own time on the card where the profiler's
    trace has it, else the per-call time (host launch overhead included)."""
    r["ms"] = r["device_ms"] if r["device_ms"] is not None else r["call_ms"]
    r["ms_source"] = ("profiler device time" if r["device_ms"] is not None
                      else "CUDA events per call")
    return r


# -- phase 3: each kernel against its plain version ---------------------------

def kernel_phase(p, B: int, S: int, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.automaton import max_chunks_for, select_boundaries
    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import fused_pipeline as kfused
    from repro_torch.kernels import select_boundaries as kselect
    from repro_torch.kernels import seqcdc_masks as kmasks

    rng = np.random.default_rng(seed)
    host = rng.integers(0, 256, (B, S), dtype=np.uint8)
    x = torch.from_numpy(host).cuda()
    mc = max_chunks_for(S, p)
    L, mode = p.seq_length, p.mode
    plain_reps = 2 if S > (256 << 10) else 5
    out = {}

    # masks
    got = kmasks.seqcdc_masks(x, L, mode)
    want = kmasks.seqcdc_masks_plain(x, L, mode)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"seqcdc_masks differs from its plain version "
                             f"at {B}x{S}")
    bms, by = bound_ms(3 * B * S, L * B * S)
    out["seqcdc_masks"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kmasks.seqcdc_masks(x, L, mode), 20,
                       "seqcdc_masks_kernel"),
        plain_ms=cuda_ms(lambda: kmasks.seqcdc_masks_plain(x, L, mode),
                         plain_reps),
    )

    # fused pipeline (its plain version is the split path, which also
    # provides the bounds the fingerprint kernel is fed below)
    got = kfused.fused_pipeline_batch(x, p, max_chunks=mc)
    want = kfused.fused_pipeline_plain(x, p, max_chunks=mc)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"fused_pipeline differs from its plain version "
                             f"at {B}x{S}")
    bounds, counts, fps, lens = (t.cpu().numpy() for t in got)
    for r in (0, B - 1):  # rows against the numpy oracle
        ob = boundaries_numpy(host[r], p)
        if bounds[r, : counts[r]].tolist() != ob.tolist():
            raise AssertionError(f"fused bounds row {r} != numpy oracle")
        if not np.array_equal(fps[r, : counts[r]],
                              fingerprints_numpy(host[r], ob)):
            raise AssertionError(f"fused fps row {r} != numpy oracle")
    bms, by = bound_ms(B * S + 16 * B * mc + 4 * B, (L + 4) * B * S)
    out["fused_pipeline"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kfused.fused_pipeline_batch(x, p,
                                                           max_chunks=mc),
                       10, "fused_pipeline_kernel"),
        plain_ms=cuda_ms(
            lambda: kfused.fused_pipeline_plain(x, p, max_chunks=mc),
            plain_reps),
    )

    # fingerprints over the plain path's bounds
    b_t, c_t = want[0], want[1]
    got = kfp.chunk_fingerprints(x, b_t, c_t, max_chunks=mc)
    want_fp = kfp.chunk_fingerprints_plain(x, b_t, c_t, max_chunks=mc)
    torch.cuda.synchronize()
    err = max_abs_err(got, want_fp)
    if err:
        raise AssertionError(f"fingerprint differs from its plain version "
                             f"at {B}x{S}")
    bms, by = bound_ms(B * S + 16 * B * mc + 4 * B, 4 * B * S)
    out["fingerprint"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kfp.chunk_fingerprints(x, b_t, c_t,
                                                      max_chunks=mc),
                       20, "fingerprint_kernel"),
        plain_ms=cuda_ms(lambda: kfp.chunk_fingerprints_plain(
            x, b_t, c_t, max_chunks=mc), plain_reps),
    )
    for r in out.values():
        timed(r)

    # the split path's boundary stage alone: the select kernel against the
    # plain W-block automaton, a Python loop of torch ops on the card
    cand, opp = kmasks.seqcdc_masks(x, L, mode)
    got = kselect.select_boundaries(cand, opp, S, p, max_chunks=mc)
    want = select_boundaries(cand, opp, S, p, max_chunks=mc)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"select_boundaries differs from its plain "
                             f"version at {B}x{S}")
    bms, by = bound_ms(2 * B * S + 4 * B * mc + 4 * B, 4 * B * S)
    out["select_boundaries"] = timed(dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kselect.select_boundaries(
            cand, opp, S, p, max_chunks=mc), 10, "select_boundaries_kernel"),
        plain_ms=cuda_ms(
            lambda: select_boundaries(cand, opp, S, p, max_chunks=mc),
            plain_reps),
    ))
    blocks = (S + p.skip_size + 2 * p.block_width - 1) // p.block_width
    return out, dict(ms=out["select_boundaries"]["plain_ms"], blocks=blocks)


def heavy_tail(rng) -> int:
    """The repo's heavy-tail object size (the occupancy benchmark's draw):
    lognormal(9.0, 1.6) bytes clipped to 256 B-2 MiB."""
    import numpy as np

    return int(np.clip(rng.lognormal(mean=9.0, sigma=1.6), 256, 2 << 20))


PACKED_MIXES = {
    "all-tiny": lambda rng: int(rng.integers(100, 1000)),
    "512-2048": lambda rng: int(rng.integers(512, 2048)),
    "heavy-tail<16KiB": None,  # heavy_tail draws, those below the row
}


def packed_rows(rng, mix: str, B: int, S: int):
    """``B`` rows of ``S`` bytes packed back to back, next-fit, from one
    segment-size mix: ``(data (B, S) uint8, ends (B, G) int32, streams)``
    in the scheduler's layout (G a power of two >= 4, pad entries carrying
    the payload end)."""
    import numpy as np

    draw = PACKED_MIXES[mix]
    rows = []
    for _ in range(B):
        row, fill = [], 0
        while True:
            if draw is None:
                n = heavy_tail(rng)
                while n >= S:
                    n = heavy_tail(rng)
            else:
                n = draw(rng)
            if fill + n > S:
                break
            row.append(rng.integers(0, 256, n, dtype=np.uint8))
            fill += n
        rows.append(row)
    G = 4
    while G < max(len(r) for r in rows):
        G <<= 1
    data = np.zeros((B, S), np.uint8)
    ends = np.zeros((B, G), np.int32)
    for bi, row in enumerate(rows):
        off = 0
        for gi, seg in enumerate(row):
            data[bi, off:off + seg.size] = seg
            off += seg.size
            ends[bi, gi] = off
        ends[bi, len(row):] = off
    return data, ends, rows


def packed_phase(p, B: int, S: int, seed: int) -> dict:
    """The packed kernel against its plain version on each segment mix."""
    import numpy as np
    import torch

    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.kernels import packed_pipeline as kpacked

    out = {}
    rng = np.random.default_rng(seed)
    for mix in PACKED_MIXES:
        data, ends, rows = packed_rows(rng, mix, B, S)
        x = torch.from_numpy(data).cuda()
        e = torch.from_numpy(ends).cuda()
        G = ends.shape[1]
        mc = S // p.min_size + 2 * G + 2
        got = kpacked.packed_pipeline_batch(x, e, p, max_chunks=mc)
        want = kpacked.packed_pipeline_plain(x, e, p, max_chunks=mc)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"packed_pipeline differs from its plain "
                                 f"version on the {mix} mix")
        bounds, counts, fps = (t.cpu().numpy() for t in got[:3])
        for bi in (0, B - 1):  # each stream of a row against the oracle
            off, j = 0, 0
            for seg in rows[bi]:
                ob = boundaries_numpy(seg, p)
                k = len(ob)
                if bounds[bi, j:j + k].tolist() != (ob + off).tolist():
                    raise AssertionError(f"packed bounds row {bi} ({mix}) "
                                         f"!= numpy oracle")
                if not np.array_equal(fps[bi, j:j + k],
                                      fingerprints_numpy(seg, ob)):
                    raise AssertionError(f"packed fps row {bi} ({mix}) != "
                                         f"numpy oracle")
                off += seg.size
                j += k
            if counts[bi] != j:
                raise AssertionError(f"packed count row {bi} ({mix})")
        bms, by = bound_ms(B * S + 4 * B * G + 16 * B * mc + 4 * B,
                           (p.seq_length + 4) * B * S)
        out[mix] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, G=G, mc=mc,
            streams=sum(len(row) for row in rows),
            payload_bytes=int(ends[:, -1].sum()),
            **kernel_times(lambda: kpacked.packed_pipeline_batch(
                x, e, p, max_chunks=mc), 20, "packed_pipeline_kernel"),
            plain_ms=cuda_ms(lambda: kpacked.packed_pipeline_plain(
                x, e, p, max_chunks=mc), 3),
        ))
    return out


# -- phase 3, the chunker registry's kernels -----------------------------

#: the native scans' algorithms, each as the port's ``<algo>_seq`` chunker
#: runs it (calibrated 8 KiB knobs)
SCAN_ALGOS = ("gear", "crc", "rabin", "fastcdc", "ae", "ram", "seqcdc")


def chunk_kernel_phase(seed: int, n_big: int, n_select: int,
                       n_scan: int) -> dict:
    """The gear, block-max, select (gear selector row) and native-scan
    kernels against their plain versions at the registry's shapes, and the
    plain ``gather``/``event`` steps against the select kernel."""
    import numpy as np
    import torch

    from repro_torch.core import automaton, make_chunker
    from repro_torch.core.baselines.selectors import SelectorParams
    from repro_torch.core.calibrate import calibrated_kwargs
    from repro_torch.kernels import extremum as kext
    from repro_torch.kernels import gear_hash as kgear
    from repro_torch.kernels import native_scan as kscan
    from repro_torch.kernels import seqcdc_masks as kmasks
    from repro_torch.kernels import select_boundaries as kselect

    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.integers(0, 256, n_big, dtype=np.uint8)).cuda()
    out = {}

    # gear hash over the whole stream
    got = kgear.gear_hash(x)
    want = kgear.gear_hash_parallel(x)
    torch.cuda.synchronize()
    err = max_abs_err([got.view(torch.int32)], [want.view(torch.int32)])
    if err:
        raise AssertionError("gear_hash differs from its plain version")
    bms, by = bound_ms(5 * n_big, 3 * n_big)
    out["gear_hash"] = timed(dict(
        max_abs_err=err, bound_ms=bms, bound_by=by, shape=f"{n_big} B",
        **kernel_times(lambda: kgear.gear_hash(x), 20, "gear_hash_kernel"),
        plain_ms=cuda_ms(lambda: kgear.gear_hash_parallel(x), 3),
    ))

    # per-block maxima, and the one PyTorch call that computes them
    block = kext.DEFAULT_BLOCK
    got = kext.block_max(x, block)
    want = kext.block_max_plain(x, block)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err:
        raise AssertionError("block_max differs from its plain version")
    nb = -(-n_big // block)
    bms, by = bound_ms(n_big + nb, n_big)
    out["block_max"] = timed(dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape=f"{n_big} B, block {block}",
        **kernel_times(lambda: kext.block_max(x, block), 20,
                       "block_max_kernel"),
        plain_ms=cuda_ms(lambda: kext.block_max_plain(x, block), 5),
        library_ms=cuda_ms(lambda: torch.amax(x.view(-1, block), dim=1), 20),
    ))

    # the select kernel on one gear selector row (calibrated 8 KiB gear)
    gear = make_chunker("gear", 8192, device="cuda",
                        **calibrated_kwargs("gear", 8192))
    h = kgear.gear_hash(x[:n_select]).to(torch.int64)
    bits = ((h & int(gear.mask)) == 0)[None]
    opp = torch.zeros_like(bits)
    sp = SelectorParams(min_size=gear.min_size, max_size=gear.max_size)
    mc = automaton.max_chunks_for(n_select, sp)
    got = kselect.select_boundaries(bits, opp, n_select, sp)
    want = automaton.select_boundaries(bits, opp, n_select, sp)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError("select_boundaries differs from its plain "
                             "version on a gear selector row")
    bms, by = bound_ms(2 * n_select + 4 * mc + 4, n_select)
    out["select_boundaries gear row"] = timed(dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape=f"1x{n_select} gear selector", chunks=int(got[1][0]),
        **kernel_times(lambda: kselect.select_boundaries(
            bits, opp, n_select, sp), 10, "select_boundaries_kernel"),
        plain_ms=cuda_ms(lambda: automaton.select_boundaries(
            bits, opp, n_select, sp), 1),
    ))

    # the plain gather and event steps on a SeqCDC stream, once each
    seqcdc = make_chunker("seqcdc", 8192, device="cuda",
                          **calibrated_kwargs("seqcdc", 8192))
    p = seqcdc.params
    cand, opp = kmasks.seqcdc_masks(x[None, :n_big // 16], p.seq_length,
                                    p.mode)
    n4 = cand.shape[1]
    want = kselect.select_boundaries(cand, opp, n4, p)
    steps = {}
    for step in ("gather", "event"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = automaton.select_boundaries(cand, opp, n4, p, step_impl=step)
        torch.cuda.synchronize()
        steps[step] = (time.perf_counter() - t0) * 1e3
        if max_abs_err(got, want):
            raise AssertionError(f"the plain {step} step differs from the "
                                 f"select kernel")
    out["steps"] = dict(n=n4, select_kernel_ms=cuda_ms(
        lambda: kselect.select_boundaries(cand, opp, n4, p), 5),
        **{f"{k}_ms": v for k, v in steps.items()})

    # each native scan on one stream, as its _seq chunker calls it
    scans = {}
    xs = x[None, :n_scan]
    for algo in SCAN_ALGOS:
        c = make_chunker(f"{algo}_seq", 8192, device="cuda",
                         **calibrated_kwargs(algo, 8192))
        kw = (dict(params=c.params) if algo == "seqcdc" else
              dict(min_size=c.min_size, max_size=c.max_size,
                   **c.scan_args()))
        got = kscan.native_scan(xs, algo, **kw)
        want = kscan.native_scan_plain(xs, algo, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"native_scan ({algo}) differs from its "
                                 f"plain version")
        mc = got[0].shape[1]
        bms, by = bound_ms(n_scan + 4 * mc, n_scan)
        scans[algo] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            shape=f"1x{n_scan} {algo}", chunks=int(got[1][0]),
            **kernel_times(lambda: kscan.native_scan(xs, algo, **kw), 5,
                           "native_scan_kernel"),
            plain_ms=cuda_ms(lambda: kscan.native_scan_plain(xs, algo, **kw),
                             1, 0),
        ))
    out["native_scan"] = scans
    return out


def block_max_path(seed: int, n: int, kernels) -> dict:
    """The block-max kernel's one path: the public op over a stream, with
    the launch counts set to 0 just before and read just after."""
    import numpy as np
    import torch

    from repro_torch.kernels import extremum as kext

    x = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, 256, n, dtype=np.uint8)).cuda()
    for k in kernels:
        k.launches = 0
    kext.block_max(x)
    torch.cuda.synchronize()
    return {k.name: k.launches for k in kernels}


# -- phase 4: the service ------------------------------------------------------

def make_corpus(seed: int, versions: int, objects: int,
                lo: int = 16 << 10, hi: int = 2 << 20,
                edit_frac: float = 0.01):
    """Seeded versioned corpus: ``versions`` lists of ``objects`` uint8
    arrays; each version edits about ``edit_frac`` of every object's bytes
    with inserts, deletes and overwrites of 1-4096 byte spans."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(math.log(lo), math.log(hi), objects))
    cur = [rng.integers(0, 256, int(s), dtype=np.uint8) for s in sizes]
    out = [cur]
    for _ in range(1, versions):
        nxt = []
        for obj in cur:
            budget = max(1, int(obj.size * edit_frac))
            while budget > 0:
                span = int(rng.integers(1, 4097))
                pos = int(rng.integers(0, obj.size))
                op = int(rng.integers(0, 3))
                new = rng.integers(0, 256, span, dtype=np.uint8)
                if op == 0:  # insert
                    obj = np.concatenate([obj[:pos], new, obj[pos:]])
                elif op == 1:  # delete
                    obj = np.concatenate([obj[:pos], obj[pos + span:]])
                else:  # overwrite
                    obj = obj.copy()
                    obj[pos:pos + span] = new[: obj.size - pos]
                budget -= span
            nxt.append(obj)
        cur = nxt
        out.append(cur)
    return out


def service_phase(p, versions: int, objects: int, seed: int,
                  kernels) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.dedup.store import sha256_key
    from repro_torch.service import DedupService
    from repro_torch.service.api import pack_fps

    t0 = time.perf_counter()
    corpus = make_corpus(seed, versions, objects)
    logical = sum(o.size for v in corpus for o in v)
    log(f"service: corpus {versions} versions x {objects} objects, "
        f"{logical} bytes ({logical / 2**20:.1f} MiB), made in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as root:
        svc = DedupService.open(
            root, params=p, device="cuda", slots=8,
            cross_check_masks=True, cross_check_fps=True,
            cross_check_pipeline=True,
        )
        for k in kernels:
            k.launches = 0  # the main path's count starts here
        t0 = time.perf_counter()
        submit_s = 0.0  # submit dispatches every bucket that fills
        for v, objs in enumerate(corpus):
            t1 = time.perf_counter()
            for i, obj in enumerate(objs):
                svc.submit(f"v{v:02d}/obj{i:03d}", obj)
            submit_s += time.perf_counter() - t1
            svc.flush()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}

        t0 = time.perf_counter()
        for v, objs in enumerate(corpus):
            for i, obj in enumerate(objs):
                data = svc.get(f"v{v:02d}/obj{i:03d}")  # SHA-verified
                if data != obj.tobytes():
                    raise AssertionError(f"restore of v{v}/obj{i} differs")
        restore_s = time.perf_counter() - t0

        rng = np.random.default_rng(seed + 1)
        for _ in range(8):  # a sample of recipes against the numpy oracle
            v = int(rng.integers(0, versions))
            i = int(rng.integers(0, objects))
            obj = corpus[v][i]
            r = svc.recipes.get(f"v{v:02d}/obj{i:03d}")
            ob = boundaries_numpy(obj, p)
            if r.chunk_lens != np.diff(np.concatenate([[0], ob])).tolist():
                raise AssertionError(f"recipe v{v}/obj{i}: chunking differs")
            if r.fps != pack_fps(fingerprints_numpy(obj, ob)):
                raise AssertionError(f"recipe v{v}/obj{i}: fps differ")
            starts = np.concatenate([[0], ob[:-1]])
            keys = [sha256_key(obj[s:e].tobytes()) for s, e in zip(starts, ob)]
            if r.keys != keys:
                raise AssertionError(f"recipe v{v}/obj{i}: keys differ")
        st = svc.stats()
        sched = svc.scheduler.stats
        hists = svc.metrics()["service"]["histograms"]
        phases = {
            name[len("req.latency_s{"):-1]: h["sum"]
            for name, h in hists.items()
            if name.startswith("req.latency_s{")
        }
        dispatch_s = sum(h["sum"] for name, h in hists.items()
                         if name.startswith("sched.dispatch_s"))
        return dict(
            submit_s=submit_s,
            phase_s=phases,
            dispatch_s=dispatch_s,
            logical_bytes=logical,
            ingest_s=ingest_s,
            restore_s=restore_s,
            ingest_mb_s=logical / ingest_s / 1e6,
            ingest_mb_s_without_cross_checks=(
                logical / (ingest_s - sched.cross_check_s) / 1e6),
            restore_mb_s=logical / restore_s / 1e6,
            dedup_ratio=st.dedup_ratio,
            stored_bytes=st.stored_bytes,
            chunks=st.total_chunks,
            unique_chunks=st.unique_chunks,
            dispatches=sched.dispatches,
            occupancy=sched.occupancy,
            tail_bytes=sched.tail_bytes,
            tail_s=sched.tail_s,
            cross_check_s=sched.cross_check_s,
            launches=launches,
        )


# -- phase 5: the sharded service with segment packing --------------------------

def make_tree(seed: int, versions: int, files: int,
              edit_frac: float = 0.02, new_frac: float = 0.01,
              del_frac: float = 0.01):
    """Seeded file-tree versions: ``versions`` dicts path -> uint8 array.
    Sizes are heavy-tail draws; each version edits ``edit_frac`` of the
    files once (a 1-4096 byte insert, delete or overwrite, capped at the
    file's size), adds ``new_frac`` new files and deletes ``del_frac``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cur = {f"d{i % 64:02d}/f{i:05d}": rng.integers(
        0, 256, heavy_tail(rng), dtype=np.uint8) for i in range(files)}
    out = [cur]
    nxt_id = files
    for _ in range(1, versions):
        nxt = dict(cur)
        names = sorted(nxt)
        order = rng.permutation(len(names))
        n_edit = int(len(names) * edit_frac)
        n_del = int(len(names) * del_frac)
        for i in order[:n_edit]:
            obj = nxt[names[i]]
            span = min(int(rng.integers(1, 4097)), obj.size)
            pos = int(rng.integers(0, obj.size))
            new = rng.integers(0, 256, span, dtype=np.uint8)
            op = int(rng.integers(0, 3))
            if op == 0:  # insert
                obj = np.concatenate([obj[:pos], new, obj[pos:]])
            elif op == 1:  # delete
                obj = np.concatenate([obj[:pos], obj[pos + span:]])
            else:  # overwrite
                obj = obj.copy()
                obj[pos:pos + span] = new[: obj.size - pos]
            nxt[names[i]] = obj
        for i in order[n_edit:n_edit + n_del]:
            del nxt[names[i]]
        for _ in range(int(files * new_frac)):
            nxt[f"d{nxt_id % 64:02d}/f{nxt_id:05d}"] = rng.integers(
                0, 256, heavy_tail(rng), dtype=np.uint8)
            nxt_id += 1
        cur = nxt
        out.append(cur)
    return out


def sharded_phase(p, seed: int, kernels) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.dedup.store import sha256_key
    from repro_torch.service import ShardedDedupService
    from repro_torch.service.api import pack_fps

    t0 = time.perf_counter()
    tree = make_tree(seed, TREE_VERSIONS, TREE_FILES)
    logical = sum(o.size for v in tree for o in v.values())
    small = [sum(1 for o in v.values() if o.size < (16 << 10)) for v in tree]
    log(f"sharded: tree {TREE_VERSIONS} versions of about {TREE_FILES} "
        f"files ({[len(v) for v in tree]} files, {small} below 16 KiB), "
        f"{logical} bytes ({logical / 2**20:.1f} MiB), made in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as root:
        svc = ShardedDedupService.open(
            root, num_shards=SHARDS, transport="local", params=p,
            device="cuda", slots=8, packing_impl="segments",
            pipeline_impl="fused", cross_check_packing=True,
        )
        try:
            for k in kernels:
                k.launches = 0  # the main path's count starts here
            t0 = time.perf_counter()
            for v, files in enumerate(tree):
                for path, obj in files.items():
                    svc.submit(f"v{v}/{path}", obj)
                svc.flush()
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            last = len(tree) - 1
            last_bytes = sum(o.size for o in tree[last].values())
            t0 = time.perf_counter()
            for path, obj in tree[last].items():
                if svc.get(f"v{last}/{path}") != obj.tobytes():  # SHA-verified
                    raise AssertionError(f"restore of v{last}/{path} differs")
            restore_s = time.perf_counter() - t0
            rng = np.random.default_rng(seed + 1)
            for v, files in enumerate(tree):  # recipes against the oracle
                names = sorted(files)
                picks = [names[int(i)] for i in rng.integers(0, len(names), 6)]
                picks += [n for n in names if files[n].size < 1024][:2]
                for path in picks:
                    obj = files[path]
                    r = svc.recipes.get(f"v{v}/{path}")
                    ob = boundaries_numpy(obj, p)
                    if r.chunk_lens != np.diff(
                            np.concatenate([[0], ob])).tolist():
                        raise AssertionError(f"recipe v{v}/{path}: chunking")
                    if r.fps != pack_fps(fingerprints_numpy(obj, ob)):
                        raise AssertionError(f"recipe v{v}/{path}: fps")
                    starts = np.concatenate([[0], ob[:-1]])
                    if r.keys != [sha256_key(obj[s:e].tobytes())
                                  for s, e in zip(starts, ob)]:
                        raise AssertionError(f"recipe v{v}/{path}: keys")
            st = svc.stats()
            sched = svc.scheduler.stats
            m = svc.metrics()["service"]
            hists, gauges = m["histograms"], m["gauges"]
            phases = {
                name[len("req.latency_s{"):-1]: h["sum"]
                for name, h in hists.items()
                if name.startswith("req.latency_s{")
            }
            dispatch_s = sum(h["sum"] for name, h in hists.items()
                             if name.startswith("sched.dispatch_s"))
            occupancy = {k[len("sched.occupancy"):]: v
                         for k, v in gauges.items()
                         if k.startswith("sched.occupancy")}
            if not svc.scheduler._packing_checked:
                raise AssertionError("the packing cross-check never ran")
            return dict(
                logical_bytes=logical,
                ingest_s=ingest_s,
                ingest_mb_s=logical / ingest_s / 1e6,
                ingest_mb_s_without_cross_checks=(
                    logical / (ingest_s - sched.cross_check_s) / 1e6),
                restore_bytes=last_bytes,
                restore_s=restore_s,
                restore_mb_s=last_bytes / restore_s / 1e6,
                dedup_ratio=st.dedup_ratio,
                stored_bytes=st.stored_bytes,
                chunks=st.total_chunks,
                unique_chunks=st.unique_chunks,
                shard_stored_bytes=[s["stored_bytes"]
                                    for s in svc.shard_stats()],
                dispatches=sched.dispatches,
                packed_streams=sched.packed_streams,
                occupancy=sched.occupancy,
                occupancy_gauges=occupancy,
                tail_bytes=sched.tail_bytes,
                cross_check_s=sched.cross_check_s,
                dispatch_s=dispatch_s,
                phase_s=phases,
                launches=launches,
            )
        finally:
            svc.close()


# -- phase 6: the chunker registry --------------------------------------

#: benchmarks/bench_chunking.py's two lists (copied: the benchmarks import
#: the JAX package), the paper's Figs. 1/7 (native) and 8/9 (vectorized)
NATIVE = ["rabin_seq", "crc_seq", "gear_seq", "fastcdc_seq", "ae_seq",
          "ram_seq", "seqcdc_seq"]
VECTOR = ["rabin", "crc", "gear", "fastcdc", "tttd", "ae", "ram", "seqcdc",
          "seqcdc_numpy"]
#: tests/test_baselines.py's (vectorized, native) pairs
PAIRS = [("seqcdc", "seqcdc_seq"), ("seqcdc", "seqcdc_numpy"),
         ("gear", "gear_seq"), ("crc", "crc_seq"), ("rabin", "rabin_seq"),
         ("fastcdc", "fastcdc_seq"), ("ae", "ae_seq"), ("ram", "ram_seq")]
_SLOW = {"rabin", "crc", "gear", "fastcdc", "tttd"}


def mib_for(name: str) -> int:
    """bench_chunking.py's "full" budget (``_mb_for(name, "full")``)."""
    if name in _SLOW or name.endswith("_seq"):
        return 16
    return 64


def registry_phase(seed: int, avg: int, kernels) -> dict:
    """Every chunker of the two lists through ``make_chunker`` on the card
    at ``avg`` with the calibrated knobs (and crc/rabin once more with
    ``backend="torch"``): one warm-up and two timed calls each on a prefix
    of one seeded random stream, then every pair bit-equal on one stream."""
    import numpy as np

    from repro_torch.core import make_chunker
    from repro_torch.core.calibrate import calibrated_kwargs

    data = np.random.default_rng(seed + 5).integers(0, 256, 64 << 20,
                                                    dtype=np.uint8)
    runs = [(name, {}) for name in NATIVE + VECTOR]
    runs += [(name, {"backend": "torch"}) for name in ("crc", "rabin")]
    for k in kernels:
        k.launches = 0  # the main path's count starts here
    out, bounds = {}, {}
    for name, extra in runs:
        d = data[: mib_for(name) << 20]
        c = make_chunker(name, avg, device="cuda",
                         **calibrated_kwargs(name, avg), **extra)
        b = c.chunk(d)  # warm-up
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            b2 = c.chunk(d)  # host bounds: the call has waited for the card
            times.append(time.perf_counter() - t0)
            if not np.array_equal(b, b2):
                raise AssertionError(f"{name}: two runs differ")
        if b[-1] != d.size or (np.diff(b) <= 0).any():
            raise AssertionError(f"{name}: bounds are not a chunking")
        label = name + ("[torch]" if extra else "")
        bounds[label] = b
        s = sum(times) / len(times)
        out[label] = dict(bytes=d.size, s=times, gb_s=d.size / s / 1e9,
                          chunks=int(b.size), mean_chunk=d.size / b.size)
    launches = {k.name: k.launches for k in kernels}
    for name in ("crc", "rabin"):
        if not np.array_equal(bounds[name], bounds[f"{name}[torch]"]):
            raise AssertionError(f"{name}: backend='torch' != 'numpy'")
    pairs = {}
    for vec, seq in PAIRS:
        n = min(bounds[vec][-1], bounds[seq][-1])
        b_vec = bounds[vec]
        if b_vec[-1] != n:  # the vectorized form on the native's stream
            b_vec = make_chunker(vec, avg, device="cuda",
                                 **calibrated_kwargs(vec, avg)).chunk(
                data[:n])
        if not np.array_equal(b_vec, bounds[seq]):
            raise AssertionError(f"{vec} != {seq} on {n} bytes")
        pairs[f"{vec}=={seq}"] = int(n)
    return dict(chunkers=out, pairs=pairs, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. the build
    from repro_torch.core.params import paper_params
    from repro_torch.kernels import KERNELS, _build

    t0 = time.perf_counter()
    built = _build.build(KERNELS)
    build_s = time.perf_counter() - t0
    log(f"build: {len(built)} of {len(KERNELS)} kernels compiled in "
        f"{build_s:.2f} s")
    for k in built:
        for line in k.build_log.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    # 3. each kernel against its plain version
    p = paper_params(8192)
    shapes = {"1MiBx8": (8, 1 << 20), "48KiBx8": (8, 48 << 10)}
    measured = {}
    for label, (B, S) in shapes.items():
        res, automaton = kernel_phase(p, B, S, args.seed)
        measured[label] = res
        log(f"split-path automaton {label}: plain {automaton['ms']:.1f} ms "
            f"for {automaton['blocks']} W-blocks "
            f"({automaton['ms'] / automaton['blocks']:.3f} ms per block: a "
            f"Python loop of torch ops)")
        for name, r in res.items():
            log(f"kernel {name} {label}: bit-equal to plain "
                f"(max_abs_err {r['max_abs_err']}), {r['ms']:.4f} ms "
                f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")

    packed = packed_phase(p, 8, 16 << 10, args.seed)
    measured["16KiBx8 packed"] = packed
    for mix, r in packed.items():
        log(f"kernel packed_pipeline 16KiBx8 {mix} ({r['streams']} streams, "
            f"G {r['G']}, mc {r['mc']}): bit-equal to plain "
            f"(max_abs_err {r['max_abs_err']}), {r['ms']:.4f} ms "
            f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")

    reg = chunk_kernel_phase(args.seed, BIG_STREAM, 1 << 20, SCAN_BYTES)
    measured["registry"] = reg
    rows3 = [(k, r) for k, r in reg.items() if k not in ("steps",
                                                          "native_scan")]
    rows3 += [(f"native_scan {a}", r) for a, r in reg["native_scan"].items()]
    for name, r in rows3:
        lib = (f", library {r['library_ms']:.4f} ms"
               if "library_ms" in r else "")
        log(f"kernel {name} ({r['shape']}): bit-equal to plain "
            f"(max_abs_err {r['max_abs_err']}), {r['ms']:.4f} ms "
            f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
            f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    st = reg["steps"]
    log(f"automaton steps on one {st['n']} B SeqCDC stream, bit-equal to "
        f"the select kernel ({st['select_kernel_ms']:.4f} ms): plain gather "
        f"{st['gather_ms']:.1f} ms, plain event {st['event_ms']:.1f} ms")
    from repro_torch.kernels import (
        extremum,
        fingerprint,
        fused_pipeline,
        gear_hash,
        native_scan,
        packed_pipeline,
        select_boundaries,
        seqcdc_masks,
    )

    # block_max is on no chunker's path (nor the reference's): its path is
    # the public op
    path3 = block_max_path(args.seed, BIG_STREAM, KERNELS)
    if path3[extremum.KERNEL.name] == 0:
        raise AssertionError("the block_max op never launched its kernel")

    # 4. the single-store service
    svc = service_phase(p, VERSIONS, OBJECTS, args.seed, KERNELS)
    log(f"service: ingest {svc['ingest_mb_s']:.2f} MB/s "
        f"({svc['ingest_s']:.2f} s, of which cross-check replays "
        f"{svc['cross_check_s']:.2f} s; "
        f"{svc['ingest_mb_s_without_cross_checks']:.2f} MB/s without them), "
        f"restore {svc['restore_mb_s']:.2f} MB/s ({svc['restore_s']:.2f} s), "
        f"dedup ratio {svc['dedup_ratio']:.4f}, chunks {svc['chunks']} "
        f"({svc['unique_chunks']} unique), dispatches {svc['dispatches']}, "
        f"occupancy {svc['occupancy']:.4f}, host tail redo "
        f"{svc['tail_bytes']} bytes in {svc['tail_s']:.2f} s")
    log(f"service: seconds in submit (full buckets dispatch there) "
        f"{svc['submit_s']:.3f}; by flush/get request phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(svc["phase_s"].items())))
    log(f"service: device dispatches (copy in, kernel, copy out) "
        f"{svc['dispatch_s']:.3f} s; launches {svc['launches']}")
    # the cross-check replays run the split path: masks, select, fingerprints
    path4 = (seqcdc_masks.KERNEL, fingerprint.KERNEL, fused_pipeline.KERNEL,
             select_boundaries.KERNEL)
    missing = [k.name for k in path4 if svc["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the single-store "
                             f"service: {missing}")

    # 5. the sharded service with segment packing
    sh = sharded_phase(p, args.seed, KERNELS)
    log(f"sharded: ingest {sh['ingest_mb_s']:.2f} MB/s ({sh['ingest_s']:.2f} "
        f"s for {sh['logical_bytes']} bytes, of which cross-check replays "
        f"{sh['cross_check_s']:.2f} s), restore of the last version "
        f"{sh['restore_mb_s']:.2f} MB/s ({sh['restore_bytes']} bytes in "
        f"{sh['restore_s']:.2f} s), dedup ratio {sh['dedup_ratio']:.4f}, "
        f"chunks {sh['chunks']} ({sh['unique_chunks']} unique), stored by "
        f"shard {sh['shard_stored_bytes']}")
    log(f"sharded: dispatches {sh['dispatches']}, packed streams "
        f"{sh['packed_streams']}, occupancy {sh['occupancy']:.4f}, host tail "
        f"redo {sh['tail_bytes']} bytes, device dispatches "
        f"{sh['dispatch_s']:.3f} s; occupancy gauges (last dispatch per "
        f"series): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 sorted(sh["occupancy_gauges"].items())))
    log("sharded: seconds by flush/get request phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(sh["phase_s"].items())))
    path5 = (fused_pipeline.KERNEL, packed_pipeline.KERNEL)
    missing = [k.name for k in path5 if sh["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the sharded "
                             f"service: {missing}")

    # 6. the chunker registry
    rg = registry_phase(args.seed, 8192, KERNELS)
    for name, r in rg["chunkers"].items():
        runs = ", ".join(f"{t:.4f}" for t in r["s"])
        log(f"chunker {name} ({r['bytes'] >> 20} MiB, avg 8192 calibrated): "
            f"{r['gb_s']:.4f} GB/s (runs {runs} s), {r['chunks']} chunks, "
            f"mean {r['mean_chunk']:.1f} B")
    log("registry pairs bit-equal: " + ", ".join(
        f"{k} ({v} B)" for k, v in rg["pairs"].items()))
    log(f"registry: launches {rg['launches']}")
    path6 = (gear_hash.KERNEL, select_boundaries.KERNEL, native_scan.KERNEL,
             seqcdc_masks.KERNEL)
    missing = [k.name for k in path6 if rg["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the chunker "
                             f"registry: {missing}")
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "repro."))
              or m == "repro"]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # 7. the kernels line and the result
    row_of = {
        packed_pipeline.KERNEL: ("16KiBx8 packed all-tiny",
                                 packed["all-tiny"]),
        gear_hash.KERNEL: (reg["gear_hash"]["shape"], reg["gear_hash"]),
        extremum.KERNEL: (reg["block_max"]["shape"], reg["block_max"]),
        native_scan.KERNEL: (reg["native_scan"]["seqcdc"]["shape"],
                             reg["native_scan"]["seqcdc"]),
    }
    errs = {
        packed_pipeline.KERNEL: [m["max_abs_err"] for m in packed.values()],
        select_boundaries.KERNEL: [
            reg["select_boundaries gear row"]["max_abs_err"]],
        native_scan.KERNEL: [m["max_abs_err"]
                             for m in reg["native_scan"].values()],
    }
    rows = []
    for k in KERNELS:
        shape, r = row_of.get(k, ("1MiBx8", measured["1MiBx8"].get(k.name)))
        err = max(errs.get(k, []) + [r["max_abs_err"]] + [
            measured[s][k.name]["max_abs_err"] for s in shapes
            if k.name in measured[s]])
        launches = (path3[k.name] + svc["launches"][k.name]
                    + sh["launches"][k.name] + rg["launches"][k.name])
        if launches == 0:
            raise AssertionError(f"kernel {k.name} never launched")
        rows.append(dict(
            name=k.name, route="cuda",
            source=os.path.relpath(k.source, ROOT),
            replaces=k.replaces, launches=launches, max_abs_err=err,
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=shape, ms_source=r["ms_source"], call_ms=r["call_ms"],
        ))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=measured,
                           service=svc, sharded=sh, registry=rg), f,
                      indent=1, default=float)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
