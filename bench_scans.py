#!/usr/bin/env python3
"""Time the native-scan, select, fused, packed, gear, masks, fingerprint and
recurrent-family kernels at the sizes the paths launch them, on one
NVIDIA card.

Run from the root of a checkout: ``python3 bench_scans.py [--src DIR]
[--label NAME] [--only GROUPS] [--json FILE]``.  ``--src`` names the
``src`` directory whose ``repro_torch`` is timed (default: this
checkout's), so two trees can be compared on one card in one go: run it
for each in turns (parent, change, change, parent).  Every timed call
goes through the public wrapper and is timed with CUDA events (a call's
time, the wrapper's allocations included), after one warm-up call:

* the native scan (``kernels.native_scan``) on one 16 MiB random stream
  for each algorithm at calibrated 8 KiB knobs, as phase 6's ``_seq``
  chunkers launch it, three timed calls each, with the card's SM clock
  sampled during the calls and cycles a byte (seqcdc: a byte of stream);
  and on 64 KiB (``chip_smoke.py`` phase 3's shape);
* the select kernel (``kernels.select_boundaries``) on SeqCDC bitmaps at
  paper 8 KiB parameters (1 MiB x 8, 48 KiB x 8 and one 64 MiB row), at
  calibrated 8 KiB knobs (one 4 MiB random row and one all-zero 4 MiB
  row) and on gear selector rows (calibrated 8 KiB gear: one 16 MiB and
  one 1 MiB row), five timed calls each (two on the 64 MiB row), and the
  ``gather`` and ``event`` select kernels on the same bitmaps, with the
  device time a call of each of their launches (their node launch, jump
  and chase apart; a tree from before the node table has two launches a
  call);
* the fused pipeline at 1 MiB x 8, paper 8 KiB parameters;
* the packed pipeline (``kernels.packed_pipeline``) on ``chip_smoke.py``
  phase 3's three segment mixes, 8 packed rows of 16 KiB at paper 8 KiB
  parameters (the sharded service's launched shape), twenty timed calls
  each, and the packed select kernel (``kernels.select_boundaries_packed``)
  on the masks kernel's bitmaps of the same rows, twenty timed calls each;
* the Gear hash (``kernels.gear_hash``) over one 64 MiB stream, ten
  timed calls, and the registry's gear chunker (``make_chunker("gear")``
  at calibrated 8 KiB knobs, phase 6's call) on its first 16 MiB, twenty
  calls timed by the host clock (host bytes in, host bounds out);
* the SeqCDC masks (``kernels.seqcdc_masks``) at paper 8 KiB parameters
  on 1 MiB x 8 random rows (``chip_smoke.py`` phase 3's shape) and on one
  64 MiB row (phase 6's seqcdc chunker), twenty and ten timed calls;
* the fingerprints (``kernels.fingerprint``) over the fused kernel's
  SeqCDC bounds (paper 8 KiB parameters) on 1 MiB x 8 random rows and on
  2 MiB x 4, phase 4's widest bucket (objects up to 2 MiB; ``slots=8``
  capped at 4 rows by the scheduler's 8 MiB batch), twenty timed calls;
  also its device time with every count 0, the cost of its grid alone
  (a CTA a slot that reads one count and writes zeros);
* the recurrent families' kernels at ``chip_smoke.py`` phase 3's cases,
  the shapes phase 10 launches them: the RG-LRU's linear scan (1 x 4,096
  and 1 x 32,768 x 2,560), the mLSTM's chunk carry (16 and 128 chunks of
  4 heads of 384), the sLSTM's recurrence (4,096 and 32,768 steps at D
  768, bfloat16) and flash at recurrentgemma-2b's head width 256 (4,096
  tokens, 10 heads over 1 KV head, window 2048), with their device time
  a call; the sLSTM also at 1, 2 and 64 steps (a step's time from the
  slope); and the sLSTM's training kernels at ``chip_smoke.py`` phase 3's
  backward case, phase 14's shape (8 x 2,048 at D 768, bfloat16): the
  forward's training instantiation (``keep=True``, which also writes the
  state of every step) and the backward (``_launch_bwd``: the call with
  the wrapper's rebuild of the pre-activations and its ``dr`` product, the
  device time the kernel's alone), the backward also at 1, 2 and 64 steps
  at B 1 and at B 8 (a step's time from the slope, apart from the waves of
  clusters).

The select, packed (the packed select kernel too), gear, masks and
fingerprint rows also give the kernels' device time a call, from a
``torch.profiler`` trace (``chip_smoke.device_ms``; the packed one also
for its scan and hash launches apart): at these sizes a call's host
overhead can exceed its kernels' time.

``--only`` takes a comma-separated subset of the groups ``select`` (with
the fused pipeline), ``native``, ``packed``, ``gear``, ``masks``,
``fingerprint`` and ``recurrent``.

Each output's SHA-256 digest is printed, so two trees' outputs can be
held equal.  ``--sass FILE`` also writes ``cuobjdump -sass`` of the built
native-scan library there, for reading its per-byte chain.  It imports
neither jax nor the JAX package, and exits 2 without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

from chip_smoke import (
    FLASH_CASES,
    LINEAR_SCAN_CASES,
    MLSTM_SCAN_CASES,
    PACKED_MIXES,
    SCAN_ALGOS,
    SLSTM_BWD_CASES,
    SLSTM_SCAN_CASES,
    device_ms,
    device_ms_by_kernel,
    packed_rows,
    scan_kwargs,
    sm_clock_during,
)

ROOT = os.path.dirname(os.path.abspath(__file__))


def call_ms(fn, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` after a warm-up,
    by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def native_rows(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import native_scan as kscan

    stream = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, 16 << 20, dtype=np.uint8)).cuda()
    out = {}
    for algo in SCAN_ALGOS:
        kw = scan_kwargs(algo)
        for label, n, reps in (("16MiB", 16 << 20, 3), ("64KiB", 64 << 10,
                                                        5)):
            x = stream[None, :n]
            run = lambda: kscan.native_scan(x, algo, **kw)  # noqa: E731
            ms, mhz = sm_clock_during(lambda: call_ms(run, reps))
            got = run()
            mean = sum(ms) / len(ms)
            out[f"native_scan {algo} {label}"] = dict(
                ms=ms, mean_ms=mean, sm_mhz=mhz, bytes=n,
                cycles_per_byte=(mean * 1e-3 * mhz * 1e6 / n
                                 if mhz else None),
                chunks=int(got[1][0]), digest=digest(got))
    return out


def select_rows(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import make_chunker
    from repro_torch.core.automaton import max_chunks_for
    from repro_torch.core.baselines.selectors import SelectorParams
    from repro_torch.core.calibrate import calibrated_kwargs
    from repro_torch.core.params import paper_params
    from repro_torch.kernels import fused_pipeline as kfused
    from repro_torch.kernels import gear_hash as kgear
    from repro_torch.kernels import select_boundaries as kselect
    from repro_torch.kernels import select_boundaries_event as kevent
    from repro_torch.kernels import select_boundaries_gather as kgather
    from repro_torch.kernels import seqcdc_masks as kmasks

    def steps(label, cand, opp, n, p, mc, reps):
        """The gather and event select kernels on the same bitmaps."""
        for step, mod in (("gather", kgather), ("event", kevent)):
            fn = getattr(mod, f"select_boundaries_{step}")
            run = lambda: fn(cand, opp, n, p, max_chunks=mc)  # noqa: E731
            ms = call_ms(run, reps)
            got = run()
            # a tree from before the node table launches two kernels a call
            dev, _ = device_ms(run, reps, f"select_boundaries_{step}_",
                               names=getattr(mod, "LAUNCH_NAMES", 2))
            out[f"{step} {label}"] = dict(
                ms=ms, mean_ms=sum(ms) / len(ms), chunks=int(got[1].sum()),
                digest=digest(got), device_ms=dev,
                stages=device_ms_by_kernel(run, reps,
                                           f"select_boundaries_{step}_"))

    rng = np.random.default_rng(seed + 1)
    p = paper_params(8192)
    pc = make_chunker("seqcdc", 8192, device="cuda",
                      **calibrated_kwargs("seqcdc", 8192)).params
    out = {}
    for label, (B, n, reps, pr, zero) in {
            "seqcdc 1MiBx8": (8, 1 << 20, 5, p, False),
            "seqcdc 48KiBx8": (8, 48 << 10, 5, p, False),
            "seqcdc 64MiBx1": (1, 64 << 20, 2, p, False),
            "seqcdc calibrated 4MiB": (1, 4 << 20, 5, pc, False),
            "zero calibrated 4MiB": (1, 4 << 20, 5, pc, True)}.items():
        x = (torch.zeros((B, n), dtype=torch.uint8, device="cuda") if zero
             else torch.from_numpy(rng.integers(0, 256, (B, n),
                                                dtype=np.uint8)).cuda())
        cand, opp = kmasks.seqcdc_masks(x, pr.seq_length, pr.mode)
        mc = max_chunks_for(n, pr)
        run = lambda: kselect.select_boundaries(  # noqa: E731
            cand, opp, n, pr, max_chunks=mc)
        ms = call_ms(run, reps)
        got = run()
        dev, _ = device_ms(run, reps, "select_boundaries_", names=2)
        out[f"select {label}"] = dict(ms=ms, mean_ms=sum(ms) / len(ms),
                                      chunks=int(got[1].sum()),
                                      digest=digest(got), device_ms=dev)
        steps(label, cand, opp, n, pr, mc, reps)
        if label == "seqcdc 1MiBx8":
            frun = lambda: kfused.fused_pipeline_batch(  # noqa: E731
                x, p, max_chunks=mc)
            ms = call_ms(frun, reps)
            out["fused 1MiBx8"] = dict(ms=ms, mean_ms=sum(ms) / len(ms),
                                       digest=digest(frun()))
        del x, cand, opp
    gear = make_chunker("gear", 8192, device="cuda",
                        **calibrated_kwargs("gear", 8192))
    sp = SelectorParams(min_size=gear.min_size, max_size=gear.max_size)
    stream = torch.from_numpy(rng.integers(0, 256, 16 << 20,
                                           dtype=np.uint8)).cuda()
    for label, n in (("gear 16MiB", 16 << 20), ("gear 1MiB", 1 << 20)):
        h = kgear.gear_hash(stream[:n]).to(torch.int64)
        bits = ((h & int(gear.mask)) == 0)[None]
        zeros = torch.zeros_like(bits)
        run = lambda: kselect.select_boundaries(  # noqa: E731
            bits, zeros, n, sp)
        ms = call_ms(run, 5)
        got = run()
        dev, _ = device_ms(run, 5, "select_boundaries_", names=2)
        out[f"select {label}"] = dict(ms=ms, mean_ms=sum(ms) / len(ms),
                                      chunks=int(got[1][0]),
                                      digest=digest(got), device_ms=dev)
        steps(label, bits, zeros, n, sp, got[0].shape[1], 5)
    return out


def packed_rows_timed(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.params import paper_params
    from repro_torch.core.seqcdc import packed_masks, segment_end_positions
    from repro_torch.kernels import packed_pipeline as kpacked
    from repro_torch.kernels import select_boundaries_packed as kselp

    p = paper_params(8192)
    B, S = 8, 16 << 10
    rng = np.random.default_rng(seed)  # chip_smoke.py packed_phase's rows
    out = {}
    for mix in PACKED_MIXES:
        data, ends, rows = packed_rows(rng, mix, B, S)
        x = torch.from_numpy(data).cuda()
        e = torch.from_numpy(ends).cuda()
        mc = S // p.min_size + 2 * ends.shape[1] + 2
        run = lambda: kpacked.packed_pipeline_batch(  # noqa: E731
            x, e, p, max_chunks=mc)
        ms = call_ms(run, 20)
        out[f"packed 16KiBx8 {mix}"] = dict(
            ms=ms, mean_ms=sum(ms) / len(ms),
            device_ms=device_ms(run, 20, "packed_pipeline_")[0],
            # the scan and hash launches apart (None for a tree whose
            # kernel is one launch of another name)
            scan_device_ms=device_ms(run, 20, "packed_pipeline_scan")[0],
            hash_device_ms=device_ms(run, 20, "packed_pipeline_hash")[0],
            streams=sum(len(r) for r in rows), digest=digest(run()))
        # the packed select kernel on the same rows' masks-kernel bitmaps
        # (chip_smoke.py select_packed_phase's inputs)
        cand, opp = packed_masks(x, segment_end_positions(e, S), p,
                                 mask_impl="cuda")
        run = lambda: kselp.select_boundaries_packed(  # noqa: E731
            cand, opp, e, p, max_chunks=mc)
        ms = call_ms(run, 20)
        out[f"select packed 16KiBx8 {mix}"] = dict(
            ms=ms, mean_ms=sum(ms) / len(ms),
            device_ms=device_ms(run, 20, "select_boundaries_packed")[0],
            digest=digest(run()))
    return out


def gear_rows(seed: int) -> dict:
    import time

    import numpy as np
    import torch

    from repro_torch.core import make_chunker
    from repro_torch.core.calibrate import calibrated_kwargs
    from repro_torch.kernels import gear_hash as kgear

    host = np.random.default_rng(seed + 3).integers(0, 256, 64 << 20,
                                                    dtype=np.uint8)
    x = torch.from_numpy(host).cuda()
    run = lambda: kgear.gear_hash(x)  # noqa: E731
    ms = call_ms(run, 10)
    out = {"gear 64MiB": dict(ms=ms, mean_ms=sum(ms) / len(ms),
                              device_ms=device_ms(run, 10, "gear_hash_")[0],
                              digest=digest([run()]))}
    # the registry's gear chunker as phase 6 calls it (host bytes in, host
    # bounds out, so the host clock is the call's time)
    chunker = make_chunker("gear", 8192, device="cuda",
                           **calibrated_kwargs("gear", 8192))
    stream = host[: 16 << 20]
    chunker.chunk(stream)
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        bounds = chunker.chunk(stream)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["gear chunker 16MiB"] = dict(
        ms=ms, mean_ms=sum(ms) / len(ms),
        digest=digest([torch.from_numpy(bounds)]))
    return out


def masks_rows(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.params import paper_params
    from repro_torch.kernels import seqcdc_masks as kmasks

    p = paper_params(8192)
    rng = np.random.default_rng(seed + 4)
    out = {}
    for label, (B, n, reps) in {"1MiBx8": (8, 1 << 20, 20),
                                "64MiBx1": (1, 64 << 20, 10)}.items():
        x = torch.from_numpy(rng.integers(0, 256, (B, n),
                                          dtype=np.uint8)).cuda()
        run = lambda: kmasks.seqcdc_masks(  # noqa: E731
            x, p.seq_length, p.mode)
        ms = call_ms(run, reps)
        out[f"masks {label}"] = dict(
            ms=ms, mean_ms=sum(ms) / len(ms),
            device_ms=device_ms(run, reps, "seqcdc_masks_kernel")[0],
            digest=digest(run()))
    return out


def fingerprint_rows(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.automaton import max_chunks_for
    from repro_torch.core.params import paper_params
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import fused_pipeline as kfused

    p = paper_params(8192)
    rng = np.random.default_rng(seed + 5)
    out = {}
    for label, (B, n) in {"1MiBx8": (8, 1 << 20),
                          "2MiBx4": (4, 2 << 20)}.items():
        x = torch.from_numpy(rng.integers(0, 256, (B, n),
                                          dtype=np.uint8)).cuda()
        mc = max_chunks_for(n, p)
        b, c = kfused.fused_pipeline_batch(x, p, max_chunks=mc)[:2]
        run = lambda: kfp.chunk_fingerprints(  # noqa: E731
            x, b, c, max_chunks=mc)
        ms = call_ms(run, 20)
        zero = torch.zeros_like(c)  # every slot past its row's count
        out[f"fingerprint {label}"] = dict(
            ms=ms, mean_ms=sum(ms) / len(ms),
            device_ms=device_ms(run, 20, "fingerprint_kernel")[0],
            empty_device_ms=device_ms(lambda: kfp.chunk_fingerprints(
                x, b, zero, max_chunks=mc), 20, "fingerprint_kernel")[0],
            chunks=int(c.sum()), digest=digest(run()))
    return out


def recurrent_rows(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attn as kflash
    from repro_torch.kernels import linear_scan as kscan
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import slstm_scan as kslstm

    rng = np.random.default_rng(seed + 6)

    def f32(shape, lo=None, hi=None, std=1.0):
        x = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.standard_normal(shape) * std)
        return torch.from_numpy(x.astype(np.float32)).cuda()

    def row(run, reps, kernel):
        ms = call_ms(run, reps)
        got = run()
        if torch.is_tensor(got):
            flat = [got]
        elif isinstance(got[1], tuple):  # (hs, state)
            flat = [got[0], *got[1]]
        else:
            flat = list(got)
        return dict(ms=ms, mean_ms=sum(ms) / len(ms),
                    device_ms=device_ms(run, reps, kernel)[0],
                    digest=digest(flat))

    out = {}
    for label, B, T, N in LINEAR_SCAN_CASES:
        a, b, h0 = (f32((B, T, N), 0.0, 0.95), f32((B, T, N), std=0.5),
                    f32((B, N)))
        out[f"linear_scan {label}"] = row(
            lambda: kscan.linear_scan(a, b, h0), 5, "linear_scan_kernel")
    for label, B, nc, H, hd in MLSTM_SCAN_CASES:
        ins = (-f32((B, nc, H), 0.0, 80.0), f32((B, nc, H)),
               f32((B, nc, H, hd, hd)), f32((B, nc, H, hd)),
               torch.zeros((B, H, hd, hd), device="cuda"),
               torch.zeros((B, H, hd), device="cuda"),
               torch.full((B, H), -1e30, device="cuda"))
        out[f"mlstm_scan {label}"] = row(
            lambda: kmlstm.mlstm_scan(*ins), 10, "mlstm_scan_kernel")
    for label, B, S, H, hd in SLSTM_SCAN_CASES:
        D = H * hd
        xg = f32((B, S, 4, D), std=0.5).to(torch.bfloat16)
        r = f32((4, H, hd, hd), std=0.02).to(torch.bfloat16)
        st = kslstm.SLSTMState(*(torch.zeros((B, D), device="cuda")
                                 for _ in range(3)),
                               torch.full((B, D), -1e30, device="cuda"))
        out[f"slstm_scan {label}"] = row(
            lambda: kslstm.slstm_scan(xg, r, st), 3, "slstm_scan_kernel")
        if S != SLSTM_SCAN_CASES[0][2]:
            continue
        # a step's time: the launched shape at S = 1, 2 and 64 (the slope
        # is a step, the intercept the launch and the loads of r)
        for steps in SLSTM_STEPS:
            out[f"slstm_scan {B}x{steps}"] = row(
                lambda: kslstm.slstm_scan(xg[:, :steps], r, st), 20,
                "slstm_scan_kernel")
    for label, B, S, H, hd in SLSTM_BWD_CASES[:1]:
        D = H * hd
        xg = f32((B, S, 4, D), std=0.5).to(torch.bfloat16)
        r = f32((4, H, hd, hd), std=0.02).to(torch.bfloat16)
        st = kslstm.SLSTMState(*(torch.zeros((B, D), device="cuda")
                                 for _ in range(3)),
                               torch.full((B, D), -1e30, device="cuda"))
        ups = [f32((B, S, D))] + [f32((B, D)) for _ in range(4)]
        out[f"slstm_scan keep {B}x{S}"] = row(
            lambda: kslstm._launch(xg, r, st, keep=True), 3,
            "slstm_scan_kernel")
        for b, steps in [(B, S)] + [(b, n) for b in (1, B)
                                    for n in SLSTM_STEPS]:
            xs = xg[:b, :steps].contiguous()
            sts = kslstm.SLSTMState(*(t[:b] for t in st))
            hs, _, cnm = kslstm._launch(xs, r, sts, keep=True)
            ins = (xs, r, sts, hs, cnm, ups[0][:b, :steps].contiguous(),
                   kslstm.SLSTMState(*(u[:b] for u in ups[1:])))
            run = lambda: (lambda g: [g[0], g[1], *g[2]])(  # noqa: E731
                kslstm._launch_bwd(*ins))
            out[f"slstm_scan_bwd {b}x{steps}"] = dict(
                row(run, 3 if steps == S else 20, "slstm_scan_bwd_kernel"),
                plan=kslstm.bwd_plan(b, H, hd)
                if hasattr(kslstm, "bwd_plan") else None)  # an older tree
    for label, B, S, H, KV, hd, dt, causal, window in FLASH_CASES:
        if hd != 256:
            continue
        q, k, v = (f32(shape, std=0.5).to(getattr(torch, dt))
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        out[f"flash_attn {label}"] = row(
            lambda: kflash.flash_attention(q, k, v, causal=causal,
                                           window=window), 20, "flash_attn_")
    return out


#: the sLSTM's step counts for its per-step fit
SLSTM_STEPS = (1, 2, 64)

GROUPS = {"select": select_rows, "native": native_rows,
          "packed": packed_rows_timed, "gear": gear_rows,
          "masks": masks_rows, "fingerprint": fingerprint_rows,
          "recurrent": recurrent_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups: " + ", ".join(GROUPS))
    ap.add_argument("--json", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("bench_scans: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import repro_torch

    print(f"{args.label}: {card}; repro_torch from "
          f"{os.path.dirname(repro_torch.__file__)}", flush=True)
    rows = {}
    for group in args.only.split(","):
        rows.update(GROUPS[group](args.seed))
    for name, r in rows.items():
        extra = (f", SM {r['sm_mhz']:.0f} MHz, {r['cycles_per_byte']:.2f} "
                 f"cycles a byte" if r.get("cycles_per_byte") else "")
        if r.get("device_ms") is not None:
            extra += f", device {r['device_ms']:.5f} ms a call (profiler"
            if r.get("scan_device_ms") is not None:
                extra += (f": scan {r['scan_device_ms']:.5f}, hash "
                          f"{r['hash_device_ms']:.5f}")
            extra += ")"
        if r.get("plan"):
            p = r["plan"]
            extra += (f", {p['clusters']} clusters of {p['C']} ({p['R']} "
                      f"rows a cluster; the card holds "
                      f"{p['max_active_clusters']} at once)")
        if r.get("stages"):
            extra += " (" + ", ".join(f"{k} {v:.5f}" for k, v in
                                      r["stages"].items()) + ")"
        if r.get("empty_device_ms") is not None:
            extra += (f", counts 0: device {r['empty_device_ms']:.5f} ms a "
                      f"call")
        print(f"{args.label}: {name}: mean {r['mean_ms']:.4f} ms (calls "
              + ", ".join(f"{t:.4f}" for t in r["ms"])
              + f"){extra}; digest {r['digest']}", flush=True)
    if args.sass:
        import shutil

        from repro_torch.kernels import native_scan as kscan

        tool = shutil.which("cuobjdump") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
            "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", str(kscan.KERNEL.library)],
                           stdout=f, check=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(label=args.label, card=card, rows=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
