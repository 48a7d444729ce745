#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It drives only
``src/repro_torch`` (never jax, never the JAX package ``repro``):

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every CUDA kernel of the service's path is compiled from
   ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc`` per source, all in
   parallel) into ``build/kernels/``;
3. each kernel against its plain torch version, on the card, at the
   service's shapes (a 1 MiB x 8 bucket and a 48 KiB x 8 bucket, paper
   8 KiB parameters): every output bit-equal, rows spot-checked against the
   numpy oracle, kernel and plain times from CUDA events, and the least
   time the card could take (its bound);
4. a service run: ``DedupService.open`` on a temporary directory with all
   three cross-checks on, a seeded versioned corpus (12 versions of 48
   objects, log-uniform 16 KiB-2 MiB, about 1% of bytes edited per
   version), every object submitted, flushed, restored SHA-verified, and a
   sample of recipes held against the numpy oracle; the kernels' launch
   counts are read from this phase alone;
5. the ``kernels`` JSON line, then the result line.

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

#: the service phase's corpus: versions x objects, about 256 MiB logical
VERSIONS = 12
OBJECTS = 48


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


# -- phase 3: each kernel against its plain version ---------------------------

def kernel_phase(p, B: int, S: int, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.automaton import max_chunks_for, select_boundaries
    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import fused_pipeline as kfused
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
        # the kernel's own time on the card where the trace has it, else
        # the per-call time (which includes the host's launch overhead)
        r["ms"] = r["device_ms"] if r["device_ms"] is not None else r[
            "call_ms"]
        r["ms_source"] = ("profiler device time" if r["device_ms"] is not None
                          else "CUDA events per call")

    # the split path's boundary stage alone: the W-block automaton, a
    # Python loop of torch ops on the card (cross-check replays only)
    cand, opp = kmasks.seqcdc_masks(x, L, mode)
    automaton_ms = cuda_ms(
        lambda: select_boundaries(cand, opp, S, p, max_chunks=mc),
        plain_reps)
    blocks = (S + p.skip_size + 2 * p.block_width - 1) // p.block_width
    return out, dict(ms=automaton_ms, blocks=blocks)


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
            k.launches = 0
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
        measured[f"{label} split automaton"] = automaton
        log(f"split-path automaton {label}: {automaton['ms']:.1f} ms for "
            f"{automaton['blocks']} W-blocks "
            f"({automaton['ms'] / automaton['blocks']:.3f} ms per block: a "
            f"Python loop of torch ops)")
        for name, r in res.items():
            log(f"kernel {name} {label}: bit-equal to plain "
                f"(max_abs_err {r['max_abs_err']}), {r['ms']:.4f} ms "
                f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")

    # 4. the service
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
        f"{svc['dispatch_s']:.3f} s")
    missing = [n for n, c in svc["launches"].items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the service: "
                             f"{missing}")
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "repro."))
              or m == "repro"]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # 5. the kernels line and the result
    main_shape = "1MiBx8"
    rows = []
    for k in KERNELS:
        r = measured[main_shape][k.name]
        rows.append(dict(
            name=k.name, route="cuda",
            source=os.path.relpath(k.source, ROOT),
            replaces=k.replaces,
            launches=svc["launches"][k.name],
            max_abs_err=max(measured[s][k.name]["max_abs_err"]
                            for s in shapes),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, shape=main_shape,
            ms_source=r["ms_source"], call_ms=r["call_ms"],
        ))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=measured,
                           service=svc), f, indent=1)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
