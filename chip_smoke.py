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
   parameters (masks, fused, fingerprint and the wide, gather and event
   select kernels at a 1 MiB x 8 and a 48 KiB x 8 bucket: the gather and
   event ones bit-equal to their plain versions at 48 KiB x 8, also at
   ``max_chunks=5``, and to the wide select kernel at 1 MiB x 8), the
   packed kernel at 8 packed rows of 16 KiB under three segment mixes:
   all-tiny 100-1000 B, 512-2048 B, and the heavy-tail sizes below
   16 KiB); the registry's kernels at calibrated 8 KiB knobs (gear and
   block max over a 64 MiB stream, the wide, gather and event select
   kernels over one 1 MiB gear selector row, the native scan over 64 KiB
   for each of its seven algorithms); at the sizes phase 6 launches them,
   the native scan on one 16 MiB stream for each algorithm (bit-equal to
   the vectorized chunker of its pair, three timed calls, the SM clock
   sampled during them and cycles a byte), the masks kernel on one 64 MiB row (bit-equal
   to its plain version) and the select kernel on its bitmaps (bit-equal to
   the fused kernel's bounds) and on one 16 MiB gear selector row
   (bit-equal to ``select_numpy``); every output bit-equal, rows
   spot-checked against the numpy oracle, kernel, plain and (block max)
   library times, and the least time the card could take (its bound); the
   gather and event select kernels on one 4 MiB SeqCDC stream and one
   all-zero 4 MiB row (calibrated 8 KiB knobs), one all-candidate 1 MiB
   selector row and the 16 MiB gear selector row, bit-equal to the wide
   select kernel (also on the 1 MiB gear row), with its time beside
   theirs; for each call of theirs, a line with its node table and chase
   (nodes, the chase's serial hops and expanded edges, the device ms of
   the node launch and of the jump and chase launches); then the block-max
   op once, its only path; the flash
   attention kernel at llama3.2-1b's serving shapes (1 x 2048 and 4096
   tokens, 32 query and 8 KV heads of width 64, causal, bfloat16 and
   float32), at phase 9's training shape (a microbatch of 2 x 2048,
   bfloat16), at recurrentgemma-2b's local MQA (4,096 tokens, 10 query
   heads and 1 KV head of width 256, window 2048, bfloat16), at phase
   11's (4,096 tokens, bfloat16: 32 over 8 heads and 56 over 8 of width
   128, 32 over 32 of width 64) and one small
   ragged case each for the full mask and a local window, with its error
   beside the stated tolerance, kernel, plain and SDPA times (the window
   as a boolean mask) and its bound; the recurrent families' three scans
   at the shapes phase 10 launches them, each within its stated
   tolerance of its plain version, with kernel, plain and bound times: the
   RG-LRU's linear scan at 1 x 4,096 and 1 x 32,768 x 2,560 from a
   non-zero h0, the mLSTM's chunk carry over 16 and 128 chunks of 4 heads
   of 384, the sLSTM's recurrence over 4,096 and 32,768 steps at D 768
   (bfloat16); their backward kernels at the shapes phase 14 launches
   them, with kernel, plain and bound times: the linear scan's at 1 x
   4,096 x 2,560 (a recurrentgemma-2b microbatch) and the mLSTM's over 8
   rows of 8 chunks of 4 heads of 384, each within its stated tolerance of
   its plain backward, and the sLSTM's over 8 rows of 2,048 steps at D 768
   (bfloat16), its gradients held to float64 autograd of the plain loop by
   ``ACCURACY``; and the count of tensor-core instructions
   (``HMMA``/``HGMMA``) in the built flash library's bfloat16 and float32
   kernels, from ``cuobjdump -sass``; the fused kernel also on two
   adversarial 1 MiB x 8 batches (constant bytes, where only max-size cuts
   fire, and a pattern of period ``max_size``), bit-equal with times, and
   the split path's three kernels (masks, select, fingerprint) summed
   against the fused kernel at each service shape;
4. the single-store service: ``DedupService.open`` on a temporary
   directory with the mask, fingerprint and pipeline cross-checks on (their
   replays run the split path: the masks, select and fingerprint kernels),
   a seeded versioned corpus (6 versions of 48 objects, log-uniform
   16 KiB-2 MiB, about 1% of bytes edited per version), every object
   submitted, flushed, restored SHA-verified, and a sample of recipes held
   against the numpy oracle; then version 0 again through
   ``DedupService(device="cuda", pipeline_impl="split")`` with an
   in-memory store once for each automaton step (``step_impl`` "wide",
   "gather", "event": the masks kernel, that step's select kernel and the
   fingerprint kernel) with the pipeline cross-check on, recipes equal to
   the main run's version 0, MB/s each;
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
   ``_seq`` form), crc/rabin also with ``backend="torch"`` and seqcdc
   also with ``step_impl="gather"`` and ``"event"`` (their select kernels;
   bounds equal to the ``wide`` step's, GB/s beside it): one warm-up
   and two timed calls each, GB/s and mean chunk size, and every
   (vectorized, native) pair of ``tests/test_baselines.py`` bit-equal on
   one stream;
7. LM serving at full ``llama3.2-1b`` width: random bfloat16 weights from
   a seeded generator on the card, ``Engine`` with 4 slots and a 4,160-
   token cache, 8 requests of 4096, 2048, 4096, 2048, 1024, 512, 100 and
   37 prompt tokens taking 32 new tokens each (greedy); every request
   must finish with 32 in-range tokens and finite logits and the flash
   kernel must launch once a layer for each prompt above 1024 tokens
   (4 x 16); prefill ms per prompt, decode tokens/s, and the device's
   busy share over the run's first decode-only steps (their device time
   traced in a replay of the same requests); then one 2048-token
   prompt's last-token logits on the flash route against the materialised
   route (plain torch), in bfloat16 and in float32 with TF32 off, within
   the stated tolerance and with the same argmax;
8. the scenarios: the four catalog scenarios at the quick budget through
   ``DedupService(device="cuda")`` at ``bench_scenarios.py``'s settings
   (``bench_params``, zlib, fingerprints on, 8 slots, packing off), every
   object restored SHA-verified, dedup and compressed ratios equal to
   ``BENCH_quick.json``'s to the last digit; again at the full budget for
   ingest and restore MB/s (recorded, not gated: the median of repeated
   runs, each a new service, until each window holds 1.5 s); the
   all-tiny occupancy draw through the scheduler, packing off and on,
   equal to its pins;
9. the dedup data pipeline and training: ``DedupIngest`` (avg 8192, 1 MiB
   segments x 8) over ``load_dataset("DEB", 64)``, MB/s and savings, the
   first 8 MiB's unique bytes (SHA-256) equal to the port's CPU run, the
   MB/s the median of passes repeated until they fill 2 s; then
   ``Trainer`` at the published llama3.2-1b configuration (16 layers, bf16,
   remat full, microbatch 4), random weights from the seed, AdamW, 4
   steps of 8 x 2048 tokens of the ingest's unique bytes: step ms,
   tokens/s, peak GB, loss and grad norm a step (finite), and the flash
   kernel's launches (each layer's forward and its remat recompute, the
   backward recomputing the plain loop), and one more step traced for
   its device time by kernel group; then the restart check at the
   same widths with the depth cut to 2 layers, under deterministic
   algorithms, in a child process of this script that alone has
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: 4 steps with a checkpoint every 2
   through the CDC store (SeqCDC at avg 1 MiB on the card), once unbroken
   and once resumed from step 2's checkpoint, final parameters and
   optimizer state bit-equal, save and restore MB/s and the store's dedup
   savings;
10. the recurrent and hybrid families served at their published size,
   ``recurrentgemma-2b`` (3.55 B parameters: RG-LRU blocks and local MQA)
   and ``xlstm-125m`` (mLSTM and sLSTM), random bfloat16 weights from the
   seed: ``Engine`` with 4 slots and a 32,832-token cache, 7 requests of
   32768, 8192, 4096, 2048, 1024, 512 and 37 prompt tokens, 32 new each;
   prefill ms per prompt, decode tokens/s, peak memory, the device's busy
   share over the decode-only steps, the launches of flash and of the
   three scans (exactly those the prefills make), and the decode state's
   bytes a slot (equal at the cache length and at twice it); then the
   decode-equals-forward gate at one pattern period of layers (3 and 6)
   at full width: an 8,192-token prefill and 8 greedy decode steps
   against one ``forward`` over the same tokens, logits within the
   tolerance between routes and the greedy tokens the forward's argmax
   (or near-ties within twice the routes' difference);
11. the rest of the dense family, the embedding input modes and MoE at
   their published width, random bfloat16 weights from the seed, each
   model freed before the next: ``granite-8b`` (18 of 36 layers),
   ``phi3-medium-14b`` (20 of 40), ``qwen2-72b`` (10 of 80: 38 fit beside
   the cache, 145 GB whole) and ``qwen3-moe-30b-a3b`` (128 experts, top
   8; 12 of 48), their depth cut for the script's time
   (``FAMILY_DEPTH_CAP``)
   through ``Engine`` with 4 slots and a 4,160-token cache, 4 requests of
   4096, 2048, 1024 and 37 prompt tokens, 16 new each, with the device's
   busy share over the decode-only steps and, for the MoE, the pairs each
   prefill drops past the experts' capacity; ``musicgen-large``
   (``embeddings``: 2 rows of 4,096 frame embeddings) and
   ``llava-next-34b`` (``mixed``: 2 rows of 2,880 patch embeddings and
   1,216 text tokens) through ``lm.prefill_step`` and 15 greedy
   ``lm.decode_step``s; prefill ms, decode tokens/s, peak memory, flash
   launches equal to those the prefills make; then each model's gate at 2
   layers, full width (the MoE's capacity lifted): a 2,048-position
   prefill (llava: 4,096) and 8 greedy steps against one ``forward``, as
   phase 10's;
12. MLA: ``deepseek-v3-671b`` at its published width (d_model 7168, 128
   heads, q_lora 1536, kv_lora 512, all 256 routed experts of 2048, top
   8, and the shared one; vocabulary 129,280), random bfloat16 weights
   from the seed, its depth cut to the deepest that fits, each layer
   reckoned by its kind (its 3 ``mla_dense`` layers and 2 ``mla_moe`` on
   an 80 GB card), served as phase 11 serves its token models (the
   absorbed decode: a cache of 512 + 64 values a token a layer, asserted
   so), with no hand-written kernel launched, the bound of a decode step
   that reads every expert beside the decode rate, and the gate at 3
   ``mla_dense`` + 1 ``mla_moe`` layers (the materialised prefill and
   forward against the absorbed decode);
13. distribution on one card: (a) the fingerprint index's ``all_to_all``
   (``routed_fp_tables``, ``distributed_dedup``) over an 8-shard mesh of
   ``cuda:0`` on 8 x 2^20 seeded records with duplicates, the tables
   bit-equal to an 8-shard CPU mesh's and the stats equal to
   ``dedup_stats``, and a skewed batch whose overflow equals the CPU's,
   with the ms of each; (b) phase 5's tree ingested again through
   ``ShardedDedupService(mesh=make_host_mesh(shards=4))``, its recipes'
   digest, stored bytes and ``fp_estimated_savings`` equal to phase 5's
   host route's, ``overflow_rerouted`` and MB/s beside phase 5's; (c) the
   op counter (``roofline/cost.py``) on llama3.2-1b's 4,096-token prefill
   at full width: FLOPs, bytes and the H100 bound beside phase 7's
   prefill ms; (d) one published-size dry-run cell (llama3.2-1b x
   decode_32k on the (16, 16) mesh, fake backend): status ``ok``;
14. the recurrent families trained at their published width:
   ``Trainer``, random bf16 weights from the seed, AdamW, 4 steps of
   ``xlstm-125m`` at 8 x 2,048 tokens (remat ``dots``) and
   ``recurrentgemma-2b`` at 8 x 4,096 (remat ``full``, 8 microbatches,
   the 2,048 window sliding), each model freed before the next (depth cut
   only where training does not fit the card): step ms, tokens/s, peak
   GB, loss and grad norm a step (finite), every scan kernel's forward and
   backward launches equal to what the model makes (layers of the kind x
   microbatches, the forward again under remat), one more step traced by
   kernel group (matmul, flash, scan forward, scan backward, other); then
   the gradient gate: one pattern period (3 and 6 layers) at full width in
   float32 on one row of 2,304 tokens, the card's gradient (the kernels)
   against the CPU's (the plain versions) leaf by leaf, the worst leaf
   printed;
15. the ``kernels`` JSON line, then the result line.

Phases 7, 10, 11 and 12 count, in the traced replay of their decode
steps, the kernel launches the host issued against the kernels the trace
recorded, and print both beside the busy share where they differ (the
share is then a lower bound).  The launch counts are set to 0 before the
block-max op in phase 3, before phases 4, 5, 6, 7 and 8, before phase 9's
ingest and its training run, before each serving run of phases 10, 11
and 12, before phase 13's ``mesh=`` ingest and before each training run
of phase 14, and read after each; every kernel must launch in one of
them, and each phase must launch the kernels of its own path (phase 12's
path has none; phase 13's ``mesh=`` ingest launches the fused pipeline
kernel; phase 14's its arch's scans forward and backward, and flash for
the hybrid).  The ``kernels`` line sums them.

It exits non-zero, with no result line, without a CUDA card, outside a
checkout of the repo, or when any phase fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM: HBM3 rate and the non-tensor (FP32 CUDA-core) peak rate
#: (NVIDIA data sheet); operations bounds use the latter, except for
#: bfloat16 attention, which the card's tensor cores take at 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

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


def device_ms(fn, reps: int, kernel: str,
              names: int = 1) -> tuple[float | None, int]:
    """Mean device milliseconds per call of the CUDA kernels whose names
    contain ``kernel``, each launched once a call, from a
    ``torch.profiler`` trace of ``reps`` calls: per kernel name its device
    time over the launches the trace recorded, summed over the names (a
    trace late in a long process can miss launches, so a sum over ``reps``
    would undercount).  Also the fewest launches recorded for a name; None
    and 0 if the trace holds no device time for them, or for fewer than
    the ``names`` kernels a call launches (the sum would leave one out)."""
    ms, records = 0.0, []
    for key, us, count in traced_kernels(fn, reps):
        if kernel in key:
            ms += us / count / 1e3
            records.append(count)
    return (ms, min(records)) if len(records) >= names else (None, 0)


def traced_kernels(fn, reps: int) -> list:
    """(name, device µs, launches) of each CUDA kernel with device time in
    a ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after one
    untraced call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or getattr(
            ev, "self_cuda_time_total", 0.0)
        if us > 0 and ev.count:
            out.append((ev.key, us, ev.count))
    return out


def kernel_times(run, reps: int, kernel: str, names: int = 1) -> dict:
    """A kernel wrapper's per-call time (CUDA events, host launch overhead
    included) and its kernel's device time (profiler; ``names`` kernels a
    call) with the launches the trace recorded of the ``reps``."""
    call = cuda_ms(run, reps, 3)
    dev, records = device_ms(run, reps, kernel, names)
    return dict(call_ms=call, device_ms=dev, device_records=records,
                device_reps=reps)


def device_ms_by_kernel(fn, reps: int, kernel: str) -> dict:
    """Mean device milliseconds a call of each CUDA kernel whose name holds
    ``kernel``, keyed by the part of its name between ``kernel`` and
    ``_kernel`` (a profiler trace of ``reps`` calls, each launch once a
    call)."""
    out = {}
    for key, us, count in traced_kernels(fn, reps):
        m = re.search(re.escape(kernel) + r"(\w+?)_kernel", key)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / count / 1e3
    return out


def chain_info(fn, cand, opp, n: int, p, mc: int, step: str) -> dict:
    """The gather or event select kernel's node table and chase on one
    call: its nodes (each row's start and candidates), the chase's serial
    hops (the most of a row) and expanded edges (all rows), the jump
    length K, and the device ms of its node launch and of its jump and
    chase launches together (profiler, five calls)."""
    import torch

    from repro_torch.kernels.boundary_chain import chain_k

    B = cand.shape[0]
    stats = torch.zeros((B, 2), dtype=torch.int32, device=cand.device)
    fn(cand, opp, n, p, max_chunks=mc, stats=stats)
    by = device_ms_by_kernel(lambda: fn(cand, opp, n, p, max_chunks=mc), 5,
                             f"select_boundaries_{step}_")
    return dict(nodes=int(cand.sum()) + B, hops=int(stats[:, 0].max()),
                edges=int(stats[:, 1].sum()), K=chain_k(n, p),
                node_ms=by.get("nodes"),
                chase_ms=(by["jump"] + by["chase"]
                          if "jump" in by and "chase" in by else None))


def chain_text(c: dict) -> str:
    """One line's account of chain_info."""
    ms = lambda v: "not traced" if v is None else f"{v:.4f} ms"  # noqa: E731
    return (f"{c['nodes']} nodes, chase {c['hops']} serial hops (K "
            f"{c['K']}) and {c['edges']} edges expanded; node launch "
            f"{ms(c['node_ms'])}, jump and chase {ms(c['chase_ms'])}")


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


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(r: dict) -> dict:
    """Set ``ms``: the kernel's own time on the card where the profiler's
    trace has it, else the per-call time (host launch overhead included)."""
    r["ms"] = r["device_ms"] if r["device_ms"] is not None else r["call_ms"]
    r["ms_source"] = (
        f"profiler device time, {r['device_records']} of "
        f"{r['device_reps']} launches traced" if r["device_ms"] is not None
        else "CUDA events per call")
    return r


def sm_clock_during(fn):
    """``fn()``'s result and the highest SM clock (MHz) that ``nvidia-smi``
    reads while it runs (sampled every 200 ms; None if no sample)."""
    q = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        q.terminate()
        text, _ = q.communicate()
    mhz = [float(v) for v in text.split() if v.strip().isdigit()]
    return out, (max(mhz) if mhz else None)


# -- phase 3: each kernel against its plain version ---------------------------

#: the widest rows phase 3 holds the gather and event select kernels to
#: their plain versions at (the plain gather loop walks every W-block)
STEP_PLAIN_MAX = 64 << 10


def kernel_phase(p, B: int, S: int, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.automaton import max_chunks_for, select_boundaries
    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.kernels import fused_pipeline as kfused
    from repro_torch.kernels import select_boundaries as kselect
    from repro_torch.kernels import select_boundaries_event as kevent
    from repro_torch.kernels import select_boundaries_gather as kgather
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
                       10, "fused_pipeline_"),
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
            cand, opp, S, p, max_chunks=mc), 10, "select_boundaries_"),
        plain_ms=cuda_ms(
            lambda: select_boundaries(cand, opp, S, p, max_chunks=mc),
            plain_reps),
    ))
    # the gather and event select kernels on the same bitmaps: against
    # their plain versions at 48 KiB x 8, also at an undersized table (the
    # event walk stops there), and at 1 MiB x 8 against the wide select
    # kernel's bounds above, where the plain gather loop would walk 4,000-odd
    # W-blocks a call for seconds
    wide = got
    for step, mod in (("gather", kgather), ("event", kevent)):
        fn = getattr(mod, f"select_boundaries_{step}")
        got = fn(cand, opp, S, p, max_chunks=mc)
        torch.cuda.synchronize()
        if S <= STEP_PLAIN_MAX:
            want = select_boundaries(cand, opp, S, p, step_impl=step,
                                     max_chunks=mc)
            err = max_abs_err(got, want)
            err5 = max_abs_err(
                fn(cand, opp, S, p, max_chunks=5),
                select_boundaries(cand, opp, S, p, step_impl=step,
                                  max_chunks=5))
            held = "its plain version (also at max_chunks 5)"
            plain_ms = cuda_ms(lambda: select_boundaries(
                cand, opp, S, p, step_impl=step, max_chunks=mc), plain_reps)
        else:
            err, err5 = max_abs_err(got, wide), 0
            held = "the wide select kernel's bounds"
            plain_ms = None
        if err or err5:
            raise AssertionError(f"select_boundaries_{step} differs from "
                                 f"{held} at {B}x{S}")
        out[f"select_boundaries_{step}"] = timed(dict(
            max_abs_err=err, bound_ms=out["select_boundaries"]["bound_ms"],
            bound_by=out["select_boundaries"]["bound_by"], held=held,
            **kernel_times(lambda: fn(cand, opp, S, p, max_chunks=mc), 10,
                           f"select_boundaries_{step}_",
                           names=mod.LAUNCH_NAMES),
            plain_ms=plain_ms,
            chain=chain_info(fn, cand, opp, S, p, mc, step),
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
                x, e, p, max_chunks=mc), 20, "packed_pipeline_"),
            plain_ms=cuda_ms(lambda: kpacked.packed_pipeline_plain(
                x, e, p, max_chunks=mc), 3),
        ))
    return out


def select_packed_phase(p, B: int, S: int, seed: int,
                        mixes=tuple(PACKED_MIXES), rows=None) -> dict:
    """The packed select kernel against its plain version (the packed
    automaton's loop over W-blocks, torch ops on the card) and against the
    packed kernel's bounds and counts, on the masks kernel's bitmaps of
    ``packed_phase``'s rows (the same seed) clipped per segment, or of
    ``rows`` ({label: (data, ends)}); each mix also at a table one short
    of its fullest row (emits dropped)."""
    import numpy as np
    import torch

    from repro_torch.core.automaton import select_boundaries_packed
    from repro_torch.core.seqcdc import packed_masks, segment_end_positions
    from repro_torch.kernels import packed_pipeline as kpacked
    from repro_torch.kernels import select_boundaries_packed as kselp

    out = {}
    rng = np.random.default_rng(seed)
    if rows is None:
        rows = {mix: packed_rows(rng, mix, B, S)[:2] for mix in mixes}
    for mix, (data, ends) in rows.items():
        B, S = data.shape
        x = torch.from_numpy(data).cuda()
        e = torch.from_numpy(ends).cuda()
        G = ends.shape[1]
        mc = S // p.min_size + 2 * G + 2
        cand, opp = packed_masks(x, segment_end_positions(e, S), p,
                                 mask_impl="cuda")
        run = lambda m: kselp.select_boundaries_packed(  # noqa: E731
            cand, opp, e, p, max_chunks=m)
        plain = lambda m: select_boundaries_packed(  # noqa: E731
            cand, opp, e, p, max_chunks=m)
        counts = run(mc)[1]
        short = max(1, int(counts.max()) - 1)
        err = 0
        for m in (mc, short):
            got = run(m)
            want = plain(m)
            fused = kpacked.packed_pipeline_batch(x, e, p, max_chunks=m)[:2]
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
            if err or max_abs_err(got, fused):
                raise AssertionError(
                    f"select_boundaries_packed differs from its plain "
                    f"version or the packed kernel on the {mix} mix at "
                    f"max_chunks {m}")
        bms, by = bound_ms(2 * B * S + 4 * B * G + 4 * B * mc + 4 * B,
                           4 * B * S)
        out[mix] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, G=G, mc=mc,
            short_mc=short, chunks=int(counts.sum()),
            shape=f"{B}x{S} packed {mix}",
            **kernel_times(lambda: run(mc), 20, "select_boundaries_packed"),
            plain_ms=cuda_ms(lambda: plain(mc), 3),
        ))
    return out


def fused_adversarial_phase(p, B: int, S: int, seed: int) -> dict:
    """The fused kernel against its plain version on batches where the
    scan resolves many blocks a chunk: constant bytes (a different value a
    row; no candidates, no opposing pairs, only max-size cuts) and a
    pattern of period ``max_size`` (each row its own random period)."""
    import numpy as np
    import torch

    from repro_torch.core.automaton import max_chunks_for
    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.kernels import fused_pipeline as kfused

    rng = np.random.default_rng(seed)
    batches = {
        "constant": np.repeat((np.arange(B, dtype=np.uint8) * 31)[:, None],
                              S, axis=1),
        "period max_size": np.stack([np.resize(rng.integers(
            0, 256, p.max_size, dtype=np.uint8), S) for _ in range(B)]),
    }
    mc = max_chunks_for(S, p)
    out = {}
    for label, host in batches.items():
        x = torch.from_numpy(host).cuda()
        got = kfused.fused_pipeline_batch(x, p, max_chunks=mc)
        want = kfused.fused_pipeline_plain(x, p, max_chunks=mc)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"fused_pipeline differs from its plain "
                                 f"version on the {label} batch")
        bounds, counts = (t.cpu().numpy() for t in got[:2])
        for r in (0, B - 1):
            if (bounds[r, : counts[r]].tolist()
                    != boundaries_numpy(host[r], p).tolist()):
                raise AssertionError(f"fused bounds row {r} ({label}) != "
                                     f"numpy oracle")
        bms, by = bound_ms(B * S + 16 * B * mc + 4 * B,
                           (p.seq_length + 4) * B * S)
        out[label] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            chunks=int(counts.sum()),
            **kernel_times(lambda: kfused.fused_pipeline_batch(
                x, p, max_chunks=mc), 10, "fused_pipeline_"),
            plain_ms=cuda_ms(lambda: kfused.fused_pipeline_plain(
                x, p, max_chunks=mc), 2),
        ))
    return out


def tensor_core_sass(kernel) -> dict:
    """Tensor-core instructions (``HMMA``/``HGMMA`` lines) per function of
    a built kernel library, from ``cuobjdump -sass``."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernel.library)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


# -- phase 3, the chunker registry's kernels -----------------------------

#: the native scans' algorithms, each as the port's ``<algo>_seq`` chunker
#: runs it (calibrated 8 KiB knobs)
SCAN_ALGOS = ("gear", "crc", "rabin", "fastcdc", "ae", "ram", "seqcdc")


def scan_kwargs(algo: str) -> dict:
    """The native scan's keyword arguments for ``algo`` as its ``_seq``
    chunker passes them, at calibrated 8 KiB knobs."""
    from repro_torch.core import make_chunker
    from repro_torch.core.calibrate import calibrated_kwargs

    c = make_chunker(f"{algo}_seq", 8192, device="cuda",
                     **calibrated_kwargs(algo, 8192))
    if algo == "seqcdc":
        return dict(params=c.params)
    return dict(min_size=c.min_size, max_size=c.max_size, **c.scan_args())


def chunk_kernel_phase(seed: int, n_big: int, n_select: int,
                       n_scan: int) -> dict:
    """The gear, block-max, select, gather and event select (gear
    selector row) and native-scan kernels against their plain versions at
    the registry's shapes, and the gather and event select kernels on a
    4 MiB SeqCDC stream against the wide select kernel."""
    import numpy as np
    import torch

    from repro_torch.core import automaton, make_chunker
    from repro_torch.core.baselines.selectors import SelectorParams
    from repro_torch.core.calibrate import calibrated_kwargs
    from repro_torch.kernels import extremum as kext
    from repro_torch.kernels import gear_hash as kgear
    from repro_torch.kernels import native_scan as kscan
    from repro_torch.kernels import select_boundaries as kselect
    from repro_torch.kernels import select_boundaries_event as kevent
    from repro_torch.kernels import select_boundaries_gather as kgather
    from repro_torch.kernels import seqcdc_masks as kmasks

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
            bits, opp, n_select, sp), 10, "select_boundaries_"),
        plain_ms=cuda_ms(lambda: automaton.select_boundaries(
            bits, opp, n_select, sp), 1),
    ))

    # the gather and event select kernels on the same gear selector row,
    # against their plain versions and the wide select kernel
    wide = got
    for step, mod in (("gather", kgather), ("event", kevent)):
        fn = getattr(mod, f"select_boundaries_{step}")
        got = fn(bits, opp, n_select, sp)
        want = automaton.select_boundaries(bits, opp, n_select, sp,
                                           step_impl=step)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, want), max_abs_err(got, wide))
        if err:
            raise AssertionError(f"select_boundaries_{step} differs from "
                                 f"its plain version or the wide select "
                                 f"kernel on a gear selector row")
        out[f"select_boundaries_{step} gear row"] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            shape=f"1x{n_select} gear selector", chunks=int(got[1][0]),
            **kernel_times(lambda: fn(bits, opp, n_select, sp), 10,
                           f"select_boundaries_{step}_",
                           names=mod.LAUNCH_NAMES),
            plain_ms=cuda_ms(lambda: automaton.select_boundaries(
                bits, opp, n_select, sp, step_impl=step), 1),
            chain=chain_info(fn, bits, opp, n_select, sp, mc, step),
        ))

    # and against the wide select kernel (the plain gather loop took 10 s
    # at 4 MiB): one 4 MiB SeqCDC stream and one all-zero 4 MiB row
    # (calibrated 8 KiB knobs: node 0 walks the whole row, cut after cut),
    # and one all-candidate 1 MiB selector row (a node at every position)
    seqcdc = make_chunker("seqcdc", 8192, device="cuda",
                          **calibrated_kwargs("seqcdc", 8192))
    p = seqcdc.params
    n4 = n_big // 16
    rows = {"SeqCDC": (x[None, :n4], p), "all-zero SeqCDC": (
        torch.zeros((1, n4), dtype=torch.uint8, device="cuda"), p)}
    steps = {}
    for label, (xr, pr) in rows.items():
        cand, opp = kmasks.seqcdc_masks(xr, pr.seq_length, pr.mode)
        steps[label] = chain_rows(kgather, kevent, kselect, cand, opp,
                                  n4, pr, f"1x{n4} {label}")
    ones = torch.ones((1, n_select), dtype=torch.bool, device="cuda")
    steps["all-candidate selector"] = chain_rows(
        kgather, kevent, kselect, ones, torch.zeros_like(ones), n_select, sp,
        f"1x{n_select} all-candidate selector")
    out["steps"] = steps

    # each native scan on one stream, as its _seq chunker calls it
    scans = {}
    xs = x[None, :n_scan]
    for algo in SCAN_ALGOS:
        kw = scan_kwargs(algo)
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


def chain_rows(kgather, kevent, kselect, cand, opp, n: int, p,
               shape: str) -> dict:
    """The gather and event select kernels on one batch of bitmaps held
    against the wide select kernel at a true table, each timed with its
    node table and chase (chain_info), beside the wide kernel's time."""
    from repro_torch.core.automaton import max_chunks_for

    mc = max_chunks_for(n, p)
    want = kselect.select_boundaries(cand, opp, n, p, max_chunks=mc)
    bms, by = bound_ms(2 * cand.numel() + 4 * mc * cand.shape[0]
                       + 4 * cand.shape[0], 4 * cand.numel())
    kernels = {}
    for step, mod in (("gather", kgather), ("event", kevent)):
        fn = getattr(mod, f"select_boundaries_{step}")
        got = fn(cand, opp, n, p, max_chunks=mc)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"select_boundaries_{step} differs from "
                                 f"the wide select kernel ({shape})")
        kernels[step] = timed(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, shape=shape,
            chunks=int(got[1].sum()),
            **kernel_times(lambda: fn(cand, opp, n, p, max_chunks=mc), 5,
                           f"select_boundaries_{step}_",
                           names=mod.LAUNCH_NAMES),
            chain=chain_info(fn, cand, opp, n, p, mc, step)))
    return dict(n=n, kernels=kernels, **timed(dict(**kernel_times(
        lambda: kselect.select_boundaries(cand, opp, n, p, max_chunks=mc),
        5, "select_boundaries_"))))


#: the sizes phase 6 launches the native scan and the select kernel at:
#: 16 MiB a ``_seq`` chunker and a gear selector row, 64 MiB the seqcdc row
LAUNCHED_SCAN = 16 << 20
LAUNCHED_SEQCDC = 64 << 20


def launched_phase(seed: int) -> dict:
    """The native scan, masks and select kernels at the sizes phase 6
    launches them.  Each native algorithm on one 16 MiB stream as its ``_seq``
    chunker calls it (calibrated 8 KiB knobs), held against the bounds of
    the vectorized chunker of its pair, then three timed calls with the SM
    clock sampled during them; the masks kernel on one 64 MiB row (paper 8
    KiB parameters) held against its plain version, then ten traced calls;
    the select kernel on that row's bitmaps held against the fused kernel's
    bounds, and on one 16 MiB gear selector row held against
    ``select_numpy``."""
    import numpy as np
    import torch

    from repro_torch.core import make_chunker
    from repro_torch.core.automaton import max_chunks_for
    from repro_torch.core.baselines.selectors import (
        SelectorParams,
        select_numpy,
    )
    from repro_torch.core.calibrate import calibrated_kwargs
    from repro_torch.core.params import paper_params
    from repro_torch.kernels import fused_pipeline as kfused
    from repro_torch.kernels import gear_hash as kgear
    from repro_torch.kernels import native_scan as kscan
    from repro_torch.kernels import select_boundaries as kselect
    from repro_torch.kernels import select_boundaries_event as kevent
    from repro_torch.kernels import select_boundaries_gather as kgather
    from repro_torch.kernels import seqcdc_masks as kmasks

    rng = np.random.default_rng(seed + 6)
    host = rng.integers(0, 256, LAUNCHED_SEQCDC, dtype=np.uint8)
    stream = torch.from_numpy(host).cuda()
    n = LAUNCHED_SCAN
    out = {}
    for algo in SCAN_ALGOS:
        kw = scan_kwargs(algo)
        xs = stream[None, :n]
        b, cnt = kscan.native_scan(xs, algo, **kw)
        got = b[0, : int(cnt[0])].cpu().numpy()
        extra = {"backend": "torch"} if algo in ("crc", "rabin") else {}
        want = make_chunker(algo, 8192, device="cuda",
                            **calibrated_kwargs(algo, 8192),
                            **extra).chunk(host[:n])
        if not np.array_equal(got, want):
            raise AssertionError(f"native_scan ({algo}) at {n} B differs "
                                 f"from the {algo} chunker")
        ms, mhz = sm_clock_during(lambda: [
            cuda_ms(lambda: kscan.native_scan(xs, algo, **kw), 1, 0)
            for _ in range(3)])
        mean = sum(ms) / len(ms)
        bms, by = bound_ms(n + 4 * b.shape[1], n)
        out[f"native_scan {algo}"] = dict(
            shape=f"1x{n} {algo}", chunks=int(cnt[0]), ms=mean, calls_ms=ms,
            sm_mhz=mhz, cycles_per_byte=(mean * 1e-3 * mhz * 1e6 / n
                                         if mhz else None),
            bound_ms=bms, bound_by=by, ms_source="CUDA events per call")

    p = paper_params(8192)
    x = stream[None]
    cand, opp = kmasks.seqcdc_masks(x, p.seq_length, p.mode)
    want = kmasks.seqcdc_masks_plain(x, p.seq_length, p.mode)
    torch.cuda.synchronize()
    if max_abs_err((cand, opp), want):
        raise AssertionError("seqcdc_masks on a 64 MiB row differs from its "
                             "plain version")
    bms, by = bound_ms(3 * LAUNCHED_SEQCDC, p.seq_length * LAUNCHED_SEQCDC)
    out["seqcdc_masks seqcdc row"] = timed(dict(
        shape=f"1x{LAUNCHED_SEQCDC} SeqCDC", chunks=None, max_abs_err=0,
        bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kmasks.seqcdc_masks(x, p.seq_length, p.mode),
                       10, "seqcdc_masks_kernel")))
    del want
    mc = max_chunks_for(LAUNCHED_SEQCDC, p)
    got = kselect.select_boundaries(cand, opp, LAUNCHED_SEQCDC, p,
                                    max_chunks=mc)
    want = kfused.fused_pipeline_batch(x, p, max_chunks=mc)[:2]
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError("select_boundaries on a 64 MiB SeqCDC row "
                             "differs from the fused kernel's bounds")
    bms, by = bound_ms(2 * LAUNCHED_SEQCDC + 4 * mc + 4, LAUNCHED_SEQCDC)
    out["select_boundaries seqcdc row"] = timed(dict(
        shape=f"1x{LAUNCHED_SEQCDC} SeqCDC", chunks=int(got[1][0]),
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kselect.select_boundaries(
            cand, opp, LAUNCHED_SEQCDC, p, max_chunks=mc), 3,
            "select_boundaries_")))
    del cand, opp, want

    gear = make_chunker("gear", 8192, device="cuda",
                        **calibrated_kwargs("gear", 8192))
    h = kgear.gear_hash(stream[:n]).to(torch.int64)
    bits = ((h & int(gear.mask)) == 0)[None]
    zeros = torch.zeros_like(bits)
    sp = SelectorParams(min_size=gear.min_size, max_size=gear.max_size)
    b, cnt = kselect.select_boundaries(bits, zeros, n, sp)
    want = select_numpy(np.flatnonzero(bits[0].cpu().numpy()), n,
                        sp.min_size, sp.max_size)
    if b[0, : int(cnt[0])].cpu().numpy().tolist() != want.tolist():
        raise AssertionError("select_boundaries on a 16 MiB gear selector "
                             "row differs from select_numpy")
    mc = b.shape[1]
    bms, by = bound_ms(2 * n + 4 * mc + 4, n)
    out["select_boundaries gear row"] = timed(dict(
        shape=f"1x{n} gear selector", chunks=int(cnt[0]), max_abs_err=0,
        bound_ms=bms, bound_by=by,
        **kernel_times(lambda: kselect.select_boundaries(bits, zeros, n, sp),
                       5, "select_boundaries_")))
    # the gather and event select kernels on the same row, against the
    # wide select kernel's bounds and counts
    out["steps gear row"] = chain_rows(kgather, kevent, kselect, bits, zeros,
                                       n, sp, f"1x{n} gear selector")
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


# -- phase 3, flash attention (the LM serving path's kernel) ---------------

#: (label, B, S, H, KV, hd, dtype, causal, window): the serving shapes of
#: llama3.2-1b (32 query and 8 KV heads of width 64) at the two prompt
#: lengths that take the flash route, phase 9's training shape (batch 8
#: in microbatches of 4 gives 2 rows of 2048), recurrentgemma-2b's local
#: MQA (10 query heads and 1 KV head of width 256, window 2048) at a
#: 4,096-token prompt, phase 11's at 4,096 tokens: granite-8b's 32 over 8
#: heads of width 128, llava-next-34b's 56 over 8 (groups of 7),
#: phi3-medium-14b's 40 over 10, qwen2-72b's 64 over 8 and
#: qwen3-moe-30b-a3b's 32 over 4 (both groups of 8) and musicgen-large's
#: full MHA (32 over 32 of width 64): every layout phase 11 launches the
#: kernel with, held to its tolerance here; and one small
#: ragged case each for the full (non-causal) mask and a local window
FLASH_CASES = [
    ("S2048 bf16", 1, 2048, 32, 8, 64, "bfloat16", True, 0),
    ("S2048 bf16 B2", 2, 2048, 32, 8, 64, "bfloat16", True, 0),
    ("S4096 bf16", 1, 4096, 32, 8, 64, "bfloat16", True, 0),
    ("S2048 f32", 1, 2048, 32, 8, 64, "float32", True, 0),
    ("S4096 f32", 1, 4096, 32, 8, 64, "float32", True, 0),
    ("S4096 hd256 window 2048 bf16", 1, 4096, 10, 1, 256, "bfloat16", True,
     2048),
    ("S4096 hd128 32/8 bf16", 1, 4096, 32, 8, 128, "bfloat16", True, 0),
    ("S4096 hd128 56/8 bf16", 1, 4096, 56, 8, 128, "bfloat16", True, 0),
    ("S4096 hd128 40/10 bf16", 1, 4096, 40, 10, 128, "bfloat16", True, 0),
    ("S4096 hd128 64/8 bf16", 1, 4096, 64, 8, 128, "bfloat16", True, 0),
    ("S4096 hd128 32/4 bf16", 1, 4096, 32, 4, 128, "bfloat16", True, 0),
    ("S4096 hd64 32/32 bf16", 1, 4096, 32, 32, 64, "bfloat16", True, 0),
    ("S96 hd16 full", 2, 96, 4, 2, 16, "float32", False, 0),
    ("S96 hd16 window 24", 2, 96, 4, 2, 16, "float32", True, 24),
]


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the operations this input needs."""
    import numpy as np

    i = np.arange(S)
    hi = i + 1 if causal else np.full(S, S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    return int((hi - lo).sum())


def flash_phase(seed: int) -> dict:
    """The flash kernel against its plain version at each case, with the
    kernel's, the plain version's and one SDPA call's times and the
    bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as kflash

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32
    out = {}
    for label, B, S, H, KV, hd, dt, causal, window in FLASH_CASES:
        rng = np.random.default_rng(seed + S + hd)
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(
            (rng.standard_normal(shape) * 0.5).astype(np.float32)).to(
                "cuda", dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        kw = dict(causal=causal, window=window)
        blk = dict(q_block=1024, kv_block=1024)
        got = kflash.flash_attention(q, k, v, **kw)
        want = kflash.flash_attention_plain(q, k, v, **kw, **blk)
        torch.cuda.synchronize()
        # elementwise |got - want| <= atol + rtol |want| (kflash.TOLERANCE:
        # one bfloat16 step of each output in bfloat16)
        tol = kflash.TOLERANCE[dtype]
        diff = (got.float() - want.float()).abs()
        limit = tol["atol"] + tol["rtol"] * want.float().abs()
        err = float(diff.max())
        worst = float((diff / limit).max())
        tolerance = f"{tol['atol']:g} + {tol['rtol']:g} |want|"
        if not worst <= 1.0:
            raise AssertionError(f"flash_attn {label}: max_abs_err {err}, "
                                 f"{worst:.3f} of the tolerance {tolerance}")
        esize = q.element_size()
        nbytes = B * S * (2 * H + 2 * KV) * hd * esize
        ops = 4 * B * H * hd * flash_pairs(S, causal, window)
        rate = BF16_TENSOR_OPS_PER_S if dt == "bfloat16" else OPS_PER_S
        bms, by = bound_ms(nbytes, ops, rate)
        # one PyTorch call computing the same function, heads first
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            if not causal:
                mask = i[None, :] > i[:, None] - window

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        try:
            library_ms = cuda_ms(sdpa, 20, 3)
        except TypeError:  # a torch without enable_gqa
            library_ms = None
        reps = 20 if S >= 2048 else 50
        out[label] = timed(dict(
            max_abs_err=err, tolerance=tolerance, tol_used=worst,
            max_abs_want=float(want.float().abs().max()), bound_ms=bms,
            bound_by=by, gflop=ops / 1e9, mbytes=nbytes / 1e6,
            shape=f"{B}x{S}x{H}x{hd} kv {KV} {dt} causal={causal} "
                  f"window={window}",
            **kernel_times(lambda: kflash.flash_attention(q, k, v, **kw),
                           reps, "flash_attn_"),
            plain_ms=cuda_ms(lambda: kflash.flash_attention_plain(
                q, k, v, **kw, **blk), 3),
            library_ms=library_ms,
        ))
    return out


# -- phase 3, the recurrent families' scans -------------------------------------

#: (label, B, T, N): the RG-LRU's scan (kernel A) at recurrentgemma-2b's
#: LRU width for a 4,096- and a 32,768-token prompt, from a non-zero h0
LINEAR_SCAN_CASES = [("T4096", 1, 4096, 2560), ("T32768", 1, 32768, 2560)]
#: (label, B, nc, H, hd): the mLSTM's chunk carry (kernel B) at
#: xlstm-125m's width (4 heads of 1536 / 4 = 384, chunks of 256 tokens):
#: a 4,096- and a 32,768-token prompt's chunks
MLSTM_SCAN_CASES = [("16 chunks", 1, 16, 4, 384),
                    ("128 chunks", 1, 128, 4, 384)]
#: (label, B, S, H, hd): the sLSTM's recurrence (kernel D) at xlstm-125m's
#: width (D 768, 4 heads of 192), bfloat16 gate inputs and weights
SLSTM_SCAN_CASES = [("S4096", 1, 4096, 4, 192), ("S32768", 1, 32768, 4, 192)]


def float_err(name: str, got, want, tol: dict) -> tuple[float, float]:
    """The largest ``|got - want|`` over paired float outputs and the
    largest share of the elementwise tolerance ``atol + rtol |want|`` it
    uses; raises when an output is not finite or a share is above 1."""
    import torch

    err = worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if tuple(g.shape) != tuple(w.shape) or not bool(
                torch.isfinite(g).all()):
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}, or not finite")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (tol["atol"] + tol["rtol"] * w.abs()))
                                 .max()))
    if not worst <= 1.0:
        raise AssertionError(f"{name}: max_abs_err {err}, {worst:.3f} of the "
                             f"tolerance {tol}")
    return err, worst


def scan_phase(seed: int) -> dict:
    """The recurrent families' three scans against their plain versions at
    the shapes phase 10 launches them, with kernel, plain and bound times
    (no single PyTorch call computes any of them: ``library_ms`` None)."""
    import numpy as np
    import torch

    from repro_torch.kernels import linear_scan as kscan
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import slstm_scan as kslstm

    def f32(rng, shape, lo=None, hi=None, std=1.0):
        x = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.standard_normal(shape) * std)
        return torch.from_numpy(x.astype(np.float32)).cuda()

    out = {}
    for label, B, T, N in LINEAR_SCAN_CASES:
        rng = np.random.default_rng(seed + T)
        a, b = f32(rng, (B, T, N), 0.0, 0.95), f32(rng, (B, T, N), std=0.5)
        h0 = f32(rng, (B, N))
        got = kscan.linear_scan(a, b, h0)
        err, worst = float_err(f"linear_scan {label}", got,
                               kscan.linear_scan_plain(a, b, h0),
                               kscan.TOLERANCE)
        # the look-back's joins give the same bits whatever the timing
        again = kscan.linear_scan(a, b, h0)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"linear_scan {label}: two launches on the "
                                 f"same inputs differ")
        del got, again
        bms, by = bound_ms(4 * (3 * B * T * N + 2 * B * N), 2 * B * T * N)
        out[f"linear_scan {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst, tolerance=kscan.TOLERANCE,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{B}x{T}x{N} float32, h0 non-zero",
            **kernel_times(lambda: kscan.linear_scan(a, b, h0), 5,
                           "linear_scan_kernel"),
            plain_ms=cuda_ms(lambda: kscan.linear_scan_plain(a, b, h0), 3)))
        del a, b
    for label, B, nc, H, hd in MLSTM_SCAN_CASES:
        rng = np.random.default_rng(seed + nc)
        ins = (-f32(rng, (B, nc, H), 0.0, 80.0), f32(rng, (B, nc, H)),
               f32(rng, (B, nc, H, hd, hd)), f32(rng, (B, nc, H, hd)),
               torch.zeros((B, H, hd, hd), device="cuda"),
               torch.zeros((B, H, hd), device="cuda"),
               torch.full((B, H), -1e30, device="cuda"))
        err, worst = float_err(f"mlstm_scan {label}", kmlstm.mlstm_scan(*ins),
                               kmlstm.mlstm_scan_plain(*ins),
                               kmlstm.TOLERANCE)
        entries = B * H * (hd * hd + hd)
        # read: the chunk sums, btot and mc, the state; written: the state
        # at every chunk start and after the last
        nbytes = 4 * (2 * entries * nc + 3 * B * nc * H + 2 * entries
                      + 2 * B * H)
        bms, by = bound_ms(nbytes, 5 * entries * nc)
        out[f"mlstm_scan {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst, tolerance=kmlstm.TOLERANCE,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{B}x{nc} chunks x{H} heads of {hd} float32",
            **kernel_times(lambda: kmlstm.mlstm_scan(*ins), 10,
                           "mlstm_scan_kernel"),
            plain_ms=cuda_ms(lambda: kmlstm.mlstm_scan_plain(*ins), 3)))
        del ins
    for label, B, S, H, hd in SLSTM_SCAN_CASES:
        rng = np.random.default_rng(seed + S)
        D = H * hd
        xg = f32(rng, (B, S, 4, D), std=0.5).to(torch.bfloat16)
        r = f32(rng, (4, H, hd, hd), std=0.02).to(torch.bfloat16)
        st = kslstm.SLSTMState(*(torch.zeros((B, D), device="cuda")
                                 for _ in range(3)),
                               torch.full((B, D), -1e30, device="cuda"))
        got = kslstm.slstm_scan(xg, r, st)
        t0 = time.perf_counter()
        want = kslstm.slstm_scan_plain(xg, r, st)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3  # one call, host clock
        # held to the plain version in float64, as accurately as the plain
        # version in float32 (kslstm.ACCURACY: no fixed tolerance holds
        # between two float32 forms over thousands of steps)
        want64 = kslstm.slstm_scan_plain(
            xg.double(), r.double(),
            kslstm.SLSTMState(*(t.double() for t in st)))
        worst = kslstm.accuracy_ratio(got, want, want64)
        outs = list(zip([got[0], *got[1]], [want[0], *want[1]],
                        [want64[0], *want64[1]]))
        err = max(float((g.float() - w).abs().max()) for g, w, _ in outs)
        own = {name: float((w.double() - w64).abs().max()) for name, (
            _, w, w64) in zip(("hs", "h", "c", "n", "m"), outs)}
        if not worst <= 1.0 or not all(bool(torch.isfinite(g).all())
                                       for g, _, _ in outs):
            raise AssertionError(f"slstm_scan {label}: {worst:.3f} of its "
                                 f"accuracy bound; the float32 plain "
                                 f"version's own error {own}")
        nbytes = xg.numel() * 2 + r.numel() * 2 + 4 * (8 * B * D + B * S * D)
        bms, by = bound_ms(nbytes, B * S * (8 * D * hd + 20 * D))
        out[f"slstm_scan {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst, plain_f32_err=own,
            tolerance=f"error against the plain version in float64 at most "
                      f"{kslstm.ACCURACY:g} x the float32 plain version's "
                      f"own + {kslstm.TOLERANCE['atol']:g}",
            bound_ms=bms, bound_by=by, library_ms=None, plain_ms=plain_ms,
            shape=f"{B}x{S}, D {D}, {H} heads of {hd}, bfloat16 gates and "
                  f"weights",
            **kernel_times(lambda: kslstm.slstm_scan(xg, r, st), 2,
                           "slstm_scan_kernel")))
        del xg, got, want, want64
    return out


#: (label, B, T, N): the RG-LRU's backward at phase 14's shape, a
#: microbatch of recurrentgemma-2b (8 rows in 8 microbatches: 1 row) x
#: 4,096 tokens x its LRU width
LINEAR_BWD_CASES = [("T4096", 1, 4096, 2560)]
#: (label, B, nc, H, hd): the mLSTM's backward at phase 14's shape,
#: xlstm-125m's 8 rows of 2,048 tokens: 8 chunks of 256, 4 heads of 384
MLSTM_BWD_CASES = [("8 chunks", 8, 8, 4, 384)]
#: (label, B, S, H, hd): the sLSTM's backward at phase 14's shape: 8 rows
#: of 2,048 steps at D 768 (4 heads of 192), bfloat16 gates and weights;
#: and at an odd batch (3 rows of 512 steps)
SLSTM_BWD_CASES = [("S2048", 8, 2048, 4, 192), ("B3 S512", 3, 512, 4, 192)]


def scan_bwd_phase(seed: int) -> dict:
    """The three scans' backward kernels against their plain backwards at
    the shapes phase 14 launches them, with kernel, plain and bound times
    (no single PyTorch call computes any of them: ``library_ms`` None).
    The linear and mLSTM kernels are held elementwise to their plain
    backwards on the forward kernels' saved outputs; the sLSTM's gradients
    (its forward and backward kernels under autograd) to float64 autograd
    of the plain loop by ``accuracy_ratio``, the float32 plain loop's own
    error the yardstick, its backward bit-equal over two launches, and its
    launch plan (``bwd_plan``) at phase 14's shape one wave of clusters."""
    import numpy as np
    import torch

    from repro_torch.kernels import linear_scan as kscan
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import slstm_scan as kslstm

    def f32(rng, shape, lo=None, hi=None, std=1.0):
        x = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.standard_normal(shape) * std)
        return torch.from_numpy(x.astype(np.float32)).cuda()

    out = {}
    for label, B, T, N in LINEAR_BWD_CASES:
        rng = np.random.default_rng(seed + T + 1)
        a, b = f32(rng, (B, T, N), 0.0, 0.95), f32(rng, (B, T, N), std=0.5)
        h0, g, g_last = f32(rng, (B, N)), f32(rng, (B, T, N)), f32(rng, (B, N))
        h, _ = kscan.linear_scan(a, b, h0)
        ins = (a, h, h0, g, g_last)
        got = kscan._launch_bwd(*ins)
        err, worst = float_err(f"linear_scan_bwd {label}", got,
                               kscan.linear_scan_bwd_plain(*ins),
                               kscan.TOLERANCE)
        again = kscan._launch_bwd(*ins)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"linear_scan_bwd {label}: two launches on "
                                 f"the same inputs differ")
        del got, again
        # read: a, g and h, then g_last and h0; written: da, db and dh0
        bms, by = bound_ms(4 * (5 * B * T * N + 3 * B * N), 3 * B * T * N)
        out[f"linear_scan_bwd {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst, tolerance=kscan.TOLERANCE,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{B}x{T}x{N} float32, h0 non-zero",
            **kernel_times(lambda: kscan._launch_bwd(*ins), 5,
                           "linear_scan_bwd_kernel"),
            plain_ms=cuda_ms(lambda: kscan.linear_scan_bwd_plain(*ins), 3)))
        del a, b, h, g, ins
    for label, B, nc, H, hd in MLSTM_BWD_CASES:
        rng = np.random.default_rng(seed + nc + 1)
        fwd = (-f32(rng, (B, nc, H), 0.0, 80.0), f32(rng, (B, nc, H)),
               f32(rng, (B, nc, H, hd, hd)), f32(rng, (B, nc, H, hd)),
               torch.zeros((B, H, hd, hd), device="cuda"),
               torch.zeros((B, H, hd), device="cuda"),
               torch.full((B, H), -1e30, device="cuda"))
        outs = kmlstm.mlstm_scan(*fwd)
        ins = (*fwd[:4], *outs[:3], *(f32(rng, tuple(o.shape))
                                      for o in outs))
        del outs
        got = kmlstm._launch_bwd(*ins)
        want = kmlstm.mlstm_scan_bwd_plain(*ins)
        worst = kmlstm.bwd_tolerance_used(got, want)
        if not worst <= 1.0:
            raise AssertionError(f"mlstm_scan_bwd {label}: {worst:.3f} of "
                                 f"its tolerance {kmlstm.BWD_TOLERANCE}")
        err = max(float((x - w).abs().max()) for x, w in zip(got, want))
        del got, want
        entries = B * H * (hd * hd + hd)
        # read: each chunk's state, sums and gradient at its start, the
        # final gradient and the scalars; written: the sums' gradients, the
        # initial state's and the scalars'
        nbytes = 4 * (4 * entries * nc + 2 * entries + 6 * B * nc * H
                      + 2 * B * H)
        bms, by = bound_ms(nbytes, 6 * entries * nc)
        out[f"mlstm_scan_bwd {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst,
            tolerance=f"|got - want| <= {kmlstm.BWD_TOLERANCE['rtol']:g} "
                      f"|want| + {kmlstm.BWD_TOLERANCE['atol']:g} max|want| "
                      f"per output",
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{B}x{nc} chunks x{H} heads of {hd} float32",
            **kernel_times(lambda: kmlstm._launch_bwd(*ins), 5, "mlstm_bwd_",
                           names=2),
            plain_ms=cuda_ms(lambda: kmlstm.mlstm_scan_bwd_plain(*ins), 3)))
        del fwd, ins
    for label, B, S, H, hd in SLSTM_BWD_CASES:
        rng = np.random.default_rng(seed + S + 1)
        D = H * hd
        xg = f32(rng, (B, S, 4, D), std=0.5).to(torch.bfloat16)
        r = f32(rng, (4, H, hd, hd), std=0.02).to(torch.bfloat16)
        st = [torch.zeros((B, D), device="cuda") for _ in range(3)] + [
            torch.full((B, D), -1e30, device="cuda")]
        ups = [f32(rng, (B, S, D))] + [f32(rng, (B, D)) for _ in range(4)]

        def vjp(fn, xg, r, st):
            ins = [t.detach().requires_grad_(True) for t in (xg, r, *st)]
            hs, fin = fn(ins[0], ins[1], kslstm.SLSTMState(*ins[2:]))
            gs = torch.autograd.grad(
                sum((o * u.to(o.dtype)).sum()
                    for o, u in zip((hs, *fin), ups)), ins)
            return gs[0], gs[1], gs[2:]

        got = vjp(kslstm.slstm_scan, xg, r, st)
        plain32 = vjp(kslstm.slstm_scan_plain, xg, r, st)
        plain64 = vjp(kslstm.slstm_scan_plain, xg.double(), r.double(),
                      [t.double() for t in st])
        worst = kslstm.accuracy_ratio(got, plain32, plain64)
        names = ("xg", "r", "h0", "c0", "n0", "m0")
        flat = lambda x: [x[0], x[1], *x[2]]  # noqa: E731
        own = {n: float((p.double() - w).abs().max()) for n, p, w in zip(
            names, flat(plain32), flat(plain64))}
        err = max(float((g.double() - w).abs().max())
                  for g, w in zip(flat(got), flat(plain64)))
        if not worst <= 1.0 or not all(bool(torch.isfinite(g).all())
                                       for g in flat(got)):
            raise AssertionError(f"slstm_scan_bwd {label}: {worst:.3f} of "
                                 f"its accuracy bound; the float32 plain "
                                 f"loop's own error {own}")
        del got, plain32, plain64
        hs, _, cnm = kslstm._launch(xg, r, kslstm.SLSTMState(*st), keep=True)
        bwd_ins = (xg, r, kslstm.SLSTMState(*st), hs, cnm, ups[0],
                   kslstm.SLSTMState(*ups[1:]))
        once, again = (flat(kslstm._launch_bwd(*bwd_ins)) for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(once, again)):
            raise AssertionError(f"slstm_scan_bwd {label}: two launches on "
                                 f"the same inputs differ")
        del once, again
        plan = kslstm.bwd_plan(B, H, hd)
        if (B, H) == (8, 4) and plan["clusters"] > plan[
                "max_active_clusters"]:
            raise AssertionError(f"slstm_scan_bwd {label}: {plan} is more "
                                 f"than one wave of clusters")
        t0 = time.perf_counter()
        kslstm.slstm_scan_bwd_plain(*bwd_ins)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3  # one call, host clock
        # the kernel's work: read every step's pre-activations, kept state
        # and hs gradient, r once; write dpre and the initial state's
        # gradient; a step's products of r with dpre
        nbytes = (4 * B * S * D * (4 + 3 + 1 + 4) + r.numel() * 2
                  + 4 * 12 * B * D)
        bms, by = bound_ms(nbytes, B * S * (8 * D * hd + 40 * D))
        out[f"slstm_scan_bwd {label}"] = timed(dict(
            max_abs_err=err, tol_used=worst, plain_f32_err=own,
            tolerance=f"error against float64 autograd of the plain loop at "
                      f"most {kslstm.ACCURACY:g} x the float32 plain loop's "
                      f"own + {kslstm.TOLERANCE['atol']:g}",
            bound_ms=bms, bound_by=by, library_ms=None, plain_ms=plain_ms,
            plan=plan,
            shape=f"{B}x{S}, D {D}, {H} heads of {hd}, bfloat16 gates and "
                  f"weights",
            **kernel_times(lambda: kslstm._launch_bwd(*bwd_ins), 3,
                           "slstm_scan_bwd_kernel")))
        # the call's dr product on the kernel's float32 dpre: the float32
        # sum the plain backward takes (the card route's until it missed
        # ACCURACY at 64 rows) and the card route's float64 sum
        dpre = f32(rng, (B, S, 4, D))
        out[f"slstm_scan_bwd {label}"]["dr_ms"] = {
            "float32 sum": cuda_ms(lambda: kslstm._recurrent_grad(
                st[0], hs, dpre, r), 5),
            "float64 sum": cuda_ms(lambda: kslstm._recurrent_grad_f64(
                st[0], hs, dpre, r), 5)}
        del xg, hs, cnm, bwd_ins, dpre
    return out


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
        v0_sha256 = recipes_sha256(svc.recipes, "v00/")
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
            v0_sha256=v0_sha256,
        )


def recipes_sha256(recipes, prefix: str) -> str:
    """SHA-256 over the recipes whose names start with ``prefix``, in name
    order, each as sorted JSON."""
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(recipes.names()):
        if name.startswith(prefix):
            digest.update(json.dumps(recipes.get(name).to_json(),
                                     sort_keys=True).encode())
    return digest.hexdigest()


def service_steps_phase(p, objects: int, seed: int, want: str,
                        kernels) -> dict:
    """Phase 4's version 0 again through ``DedupService(device="cuda",
    pipeline_impl="split")`` once for each automaton step (``wide``,
    ``gather``, ``event``: the masks kernel, that step's select kernel and
    the fingerprint kernel), an in-memory store, the pipeline cross-check
    on (its replays run the fused kernel); each run's recipes must equal
    the main run's version 0 (digest ``want``).  MB/s and launches a run,
    the counts set to 0 just before each and read just after."""
    import torch

    from repro_torch.service import DedupService

    corpus = make_corpus(seed, 1, objects)[0]
    logical = sum(o.size for o in corpus)
    out = {}
    for step in ("wide", "gather", "event"):
        svc = DedupService(params=p, device="cuda", slots=8,
                           pipeline_impl="split", step_impl=step,
                           cross_check_pipeline=True)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        for i, obj in enumerate(corpus):
            svc.submit(f"v00/obj{i:03d}", obj)
        svc.flush()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        sha = recipes_sha256(svc.recipes, "v00/")
        if sha != want:
            raise AssertionError(f"the split pipeline with step_impl="
                                 f"{step!r} gives other recipes than the "
                                 f"main run's version 0")
        cross = svc.scheduler.stats.cross_check_s
        out[step] = dict(
            logical_bytes=logical, ingest_s=ingest_s,
            ingest_mb_s=logical / ingest_s / 1e6, cross_check_s=cross,
            ingest_mb_s_without_cross_checks=(
                logical / (ingest_s - cross) / 1e6),
            dispatches=svc.scheduler.stats.dispatches, launches=launches)
    return out


# -- phase 5: the sharded service with segment packing --------------------------

@functools.lru_cache(maxsize=1)
def make_tree(seed: int, versions: int, files: int,
              edit_frac: float = 0.02, new_frac: float = 0.01,
              del_frac: float = 0.01):
    """Seeded file-tree versions: ``versions`` dicts path -> uint8 array
    (made once a run: phases 5 and 13 ingest the same tree).
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


def sharded_phase(p, seed: int, kernels, mesh=None, verify: bool = True,
                  pipeline_impl: str = "fused",
                  versions: int | None = None) -> dict:
    """Phase 5's run: the tree through ``ShardedDedupService`` with 4 local
    shards, host-routed; with ``mesh`` (phase 13) its fingerprint records
    take the mesh's ``all_to_all`` route instead.  ``verify`` restores
    the last version and checks sampled recipes against the oracle (phase
    13 compares its recipes' digest with phase 5's instead).
    ``pipeline_impl="split"`` runs the split pipeline (the packed rows
    through the masks, packed select and fingerprint kernels);
    ``versions`` ingests only the tree's first versions."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core.oracle import boundaries_numpy
    from repro_torch.dedup.fingerprint import fingerprints_numpy
    from repro_torch.dedup.store import sha256_key
    from repro_torch.service import ShardedDedupService
    from repro_torch.service.api import pack_fps

    t0 = time.perf_counter()
    tree = make_tree(seed, TREE_VERSIONS, TREE_FILES)[:versions]
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
            pipeline_impl=pipeline_impl, cross_check_packing=True,
            **({} if mesh is None else {"mesh": mesh}),
        )
        try:
            for k in kernels:
                k.launches = 0  # the main path's count starts here
            t0 = time.perf_counter()
            version_s = []
            for v, files in enumerate(tree):
                tv = time.perf_counter()
                for path, obj in files.items():
                    svc.submit(f"v{v}/{path}", obj)
                svc.flush()
                version_s.append(time.perf_counter() - tv)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            last = len(tree) - 1
            last_bytes = sum(o.size for o in tree[last].values())
            restore_s = math.nan
            if verify:
                t0 = time.perf_counter()
                for path, obj in tree[last].items():
                    if svc.get(f"v{last}/{path}") != obj.tobytes():
                        raise AssertionError(  # the get is SHA-verified
                            f"restore of v{last}/{path} differs")
                restore_s = time.perf_counter() - t0
                rng = np.random.default_rng(seed + 1)
                for v, files in enumerate(tree):  # recipes against the oracle
                    names = sorted(files)
                    picks = [names[int(i)]
                             for i in rng.integers(0, len(names), 6)]
                    picks += [n for n in names if files[n].size < 1024][:2]
                    for path in picks:
                        obj = files[path]
                        r = svc.recipes.get(f"v{v}/{path}")
                        ob = boundaries_numpy(obj, p)
                        if r.chunk_lens != np.diff(
                                np.concatenate([[0], ob])).tolist():
                            raise AssertionError(
                                f"recipe v{v}/{path}: chunking")
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
            digest = hashlib.sha256()
            by_version = [hashlib.sha256() for _ in tree]
            for name in sorted(svc.recipes.names()):
                blob = json.dumps(svc.recipes.get(name).to_json(),
                                  sort_keys=True).encode()
                digest.update(blob)
                by_version[int(name[1:name.index("/")])].update(blob)
            return dict(
                recipes_sha256=digest.hexdigest(),
                version_sha256=[d.hexdigest() for d in by_version],
                fp_estimated_savings=st.fp_estimated_savings,
                overflow_rerouted=svc.overflow_rerouted,
                logical_bytes=logical,
                ingest_s=ingest_s,
                ingest_mb_s=logical / ingest_s / 1e6,
                version_mb_s=[sum(o.size for o in files.values()) / t / 1e6
                              for files, t in zip(tree, version_s)],
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
    ``backend="torch"``, seqcdc once more with each of ``step_impl=
    "gather"`` and ``"event"``, their bounds equal to the ``wide`` step's):
    one warm-up and two timed calls each on a prefix of one seeded random
    stream, then every pair bit-equal on one stream."""
    import numpy as np

    from repro_torch.core import make_chunker
    from repro_torch.core.calibrate import calibrated_kwargs

    data = np.random.default_rng(seed + 5).integers(0, 256, 64 << 20,
                                                    dtype=np.uint8)
    runs = [(name, {}) for name in NATIVE + VECTOR]
    runs += [(name, {"backend": "torch"}) for name in ("crc", "rabin")]
    runs += [("seqcdc", {"step_impl": s}) for s in ("gather", "event")]
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
        label = name + "".join(f"[{v}]" for v in extra.values())
        bounds[label] = b
        s = sum(times) / len(times)
        out[label] = dict(bytes=d.size, s=times, gb_s=d.size / s / 1e9,
                          chunks=int(b.size), mean_chunk=d.size / b.size)
    launches = {k.name: k.launches for k in kernels}
    for name in ("crc", "rabin"):
        if not np.array_equal(bounds[name], bounds[f"{name}[torch]"]):
            raise AssertionError(f"{name}: backend='torch' != 'numpy'")
    for step in ("gather", "event"):
        if not np.array_equal(bounds["seqcdc"], bounds[f"seqcdc[{step}]"]):
            raise AssertionError(f"seqcdc: step_impl={step!r} != 'wide'")
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


# -- phase 7: LM serving at full llama3.2-1b width ---------------------------

#: prompt lengths of the serving phase's requests, in submission order
SERVE_PROMPTS = (4096, 2048, 4096, 2048, 1024, 512, 100, 37)
SERVE_NEW = 32
SERVE_SLOTS = 4
SERVE_CACHE = 4160
#: last-token logits of a 2048-token prompt, flash route against the
#: materialised route (plain torch): in bfloat16 the routes round scores,
#: weights and context at different places in 16 layers; in float32 with
#: TF32 off they differ in summation order only
LOGITS_TOL = {"bfloat16": 0.25, "float32": 1e-4}


#: the host-side calls that launch a kernel, as the profiler's CPU trace
#: records them (the CUDA runtime API's and the lower-level API's)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def traced_device(prof) -> dict:
    """From a trace of CPU and CUDA activity: the device's busy time (every
    kernel, copy and fill it recorded), the kernels it recorded, and the
    kernel launches the host issued (its launch calls)."""
    from torch.autograd import DeviceType

    us = kernels = launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us += ev.time_range.elapsed_us()
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif ev.name in LAUNCH_CALLS:
            launches += 1
    return dict(device_us=us, kernels=kernels, launches=launches)


def share_note(t: dict) -> str:
    """How far a traced busy share can be trusted: the launches the host
    issued against the kernels the trace recorded (the profiler misses
    launches late in a long process)."""
    if t["kernels"] == t["launches"]:
        return f"all {t['launches']} launches traced"
    if t["kernels"] < t["launches"]:
        return (f"a lower bound: the trace recorded {t['kernels']} of the "
                f"{t['launches']} kernels the host launched")
    return (f"{t['kernels']} kernels traced against {t['launches']} launch "
            f"calls recorded: the host trace missed some calls")


def serve_checked(cfg, params, scfg, prompts, kernels, warm) -> dict:
    """``Engine`` over ``prompts`` after a warm-up on the ``warm`` prompts
    (cuBLAS, the allocator, the kernels' first launches), the launch counts
    set to 0 just before the run and read just after; every request must
    finish with its new tokens in range and every logit finite.  Then the
    device's busy share over the run's decode-only steps after the first
    (until the next admission): their device time traced in a replay of
    the same requests (greedy, so the same steps) over their seconds in the
    untraced run, with the launches the host issued in the traced steps
    against the kernels the trace recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine, ServeConfig

    class CheckedEngine(Engine):
        """Keeps every sampled step's logits' finiteness on the card, and
        each step's decode seconds beside whether it admitted requests."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.finite = []
            self.steps = []

        def _sample(self, logits):
            self.finite.append(torch.isfinite(logits).all())
            return super()._sample(logits)

        def step(self):
            n, s_ = len(self.stats.prefill), self.stats.decode_s
            super().step()
            self.steps.append((len(self.stats.prefill) > n,
                               self.stats.decode_s - s_))

    w = Engine(cfg, params, ServeConfig(max_slots=scfg.max_slots,
                                        cache_len=scfg.cache_len,
                                        max_new_tokens=2))
    for p in warm:
        w.submit(p)
    w.run()
    del w
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = CheckedEngine(cfg, params, scfg)
    for p in prompts:
        eng.submit(p)
    for k in kernels:
        k.launches = 0  # the main path's count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if sorted(out) != list(range(len(prompts))):
        raise AssertionError(f"requests {sorted(out)} finished, not all "
                             f"{len(prompts)}")
    for rid, toks in out.items():
        if len(toks) != scfg.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: {len(toks)} tokens, "
                                 f"range {min(toks)}-{max(toks)}")
    if not bool(torch.stack(eng.finite).all()):
        raise AssertionError("non-finite logits while serving")
    st = eng.stats
    n_busy = next((i for i, (admitted, _) in enumerate(eng.steps[1:], 1)
                   if admitted), len(eng.steps)) - 1
    busy_s = sum(s_ for _, s_ in eng.steps[1:1 + n_busy])
    del eng
    replay = Engine(cfg, params, scfg)
    for p in prompts:
        replay.submit(p)
    replay.step()  # the first prefills and the first decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_busy):
            replay.step()
        torch.cuda.synchronize()
    if len(replay.stats.prefill) != min(scfg.max_slots, len(prompts)):
        raise AssertionError("the traced replay steps admitted requests")
    del replay
    tr = traced_device(prof)
    prefill = {}
    for n, s_ in st.prefill:
        prefill.setdefault(n, []).append(s_ * 1e3)
    return dict(
        out=out, wall_s=wall_s, launches=launches, peak_gb=peak_gb,
        tokens=sum(map(len, out.values())), prefill_ms=prefill,
        prefill_tok_s=sum(n for n, _ in st.prefill)
        / sum(s_ for _, s_ in st.prefill),
        decode_steps=st.decode_steps, decode_s=st.decode_s,
        decode_tokens=st.decode_tokens,
        decode_tok_s=st.decode_tokens / st.decode_s,
        decode_ms_per_step=st.decode_s / st.decode_steps * 1e3,
        busy_steps=n_busy, busy_s=busy_s,
        busy_share=tr["device_us"] / 1e6 / busy_s,
        busy_note=share_note(tr), busy_traced=tr,
        busy_device_ms_per_step=tr["device_us"] / 1e3 / n_busy,
        busy_step_ms=busy_s / n_busy * 1e3,
        busy_kernels_per_step=tr["kernels"] / n_busy,
        busy_launches_per_step=tr["launches"] / n_busy)


def n_params_of(cfg) -> int:
    from repro_torch.models import lm
    from repro_torch.models.layers import template_map

    leaves = []
    template_map(leaves.append, lm.lm_template(cfg))
    return sum(math.prod(t.shape) for t in leaves)


def serving_phase(seed: int, kernels) -> dict:
    """``Engine`` with random bfloat16 weights at full llama3.2-1b width:
    8 requests of SERVE_PROMPTS tokens, 32 new tokens each, greedy, on 4
    slots, and the device's busy share over the run's decode-only steps
    (``serve_checked``: 4 slots decoding at 2,050-4,127 tokens of
    context).  Then one 2048-token prompt's last-token logits on the flash
    route against the materialised route, in bfloat16 and in float32."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig

    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    scfg = ServeConfig(max_slots=SERVE_SLOTS, cache_len=SERVE_CACHE,
                       max_new_tokens=SERVE_NEW)
    # the warm-up on the shortest prompt (no flash route)
    res = serve_checked(cfg, params, scfg, prompts, kernels,
                        warm=prompts[-1:])
    del res["out"]

    # flash route against the materialised route on one 2048-token prompt
    torch.backends.cuda.matmul.allow_tf32 = False
    tok = torch.as_tensor(prompts[1], device="cuda")[None]
    logits = {}
    with torch.inference_mode():
        for dt in ("bfloat16", "float32"):
            c = cfg.replace(param_dtype=dt, compute_dtype=dt)
            # the same seed's float32 draws, which the bfloat16 weights round
            p = params if dt == "bfloat16" else lm.init_params(
                c, torch.Generator(device="cuda").manual_seed(seed))
            a, _ = lm.prefill_step(c, p, {"tokens": tok}, tok.shape[1])
            b, _ = lm.prefill_step(c.replace(attn_kv_block=0), p,
                                   {"tokens": tok}, tok.shape[1])
            a, b = a.float(), b.float()
            err = float((a - b).abs().max())
            top2 = torch.topk(a[0], 2).values
            logits[dt] = dict(
                max_abs_err=err, tolerance=LOGITS_TOL[dt],
                max_abs_logit=float(a.abs().max()),
                argmax=(int(a.argmax()), int(b.argmax())),
                top2_gap=float(top2[0] - top2[1]),
                finite=bool(torch.isfinite(a).all() & torch.isfinite(b).all()))
            if not (logits[dt]["finite"] and err <= LOGITS_TOL[dt]):
                raise AssertionError(f"{dt} logits, flash vs materialised: "
                                     f"{logits[dt]}")
            if logits[dt]["argmax"][0] != logits[dt]["argmax"][1]:
                raise AssertionError(f"{dt} argmax differs: {logits[dt]}")
            del p, a, b
    return dict(params=n_params_of(cfg), init_s=init_s, logits=logits,
                **res)


# -- phase 8: the scenarios through the service -----------------------------

#: ``BENCH_quick.json``'s scenario rows (results 25-28): dedup and
#: compressed ratios at the quick budget, ``bench_scenarios.py``'s settings
SCENARIO_RATIOS = {
    "dataset_revisions": (2.7341425166358384, 7.719705489251712),
    "backup_snapshots": (2.895766562398641, 4.386469361774329),
    "lm_text": (1.6187743840612376, 4.071229115351285),
    "container_images": (2.2393782438748313, 3.9257803259661643),
}
#: ``BENCH_quick.json`` results 11 and 15 (``tests/test_occupancy.py``):
#: the all-tiny draw's occupancy, packing off and on
OCCUPANCY = {"off": 0.03356202260073905, "segments": 0.8951437356588724}
#: the budget the throughput is taken at (12-84 MB a corpus), and the
#: seconds each of its ingest and restore windows must hold: a run is
#: repeated, each time through a new service, until both are reached (at
#: least 3 runs, at most 25), and the median run's MB/s is reported
SCENARIO_TIMED_BUDGET = "full"
SCENARIO_WINDOW_S = 1.5


def scenario_run(name: str, corpus) -> dict:
    """``corpus`` of scenario ``name`` through ``DedupService(device=
    "cuda")`` at ``bench_scenarios.py``'s settings (``bench_params``, zlib,
    fingerprints on, 8 slots, packing off; the port's fused pipeline),
    every object restored SHA-verified."""
    import torch

    from repro_torch.scenarios import bench_params
    from repro_torch.service import DedupService

    budget = corpus.budget
    total = corpus.logical_bytes
    svc = DedupService(params=bench_params(name, budget), device="cuda",
                       slots=8, packing_impl="off", codec="zlib")
    t0 = time.perf_counter()
    for obj_name, data in corpus.objects:
        svc.submit(obj_name, data)
    svc.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for obj_name, data in corpus.objects:
        if svc.get(obj_name) != data.tobytes():  # SHA-256 verified
            raise AssertionError(f"{name}/{obj_name}: restore differs")
    restore_s = time.perf_counter() - t0
    st = svc.stats()
    return dict(budget=budget, bytes=total, objects=len(corpus.objects),
                ingest_s=ingest_s, restore_s=restore_s,
                ingest_mb_s=total / ingest_s / 1e6,
                restore_mb_s=total / restore_s / 1e6,
                dedup_ratio=st.dedup_ratio,
                compressed_ratio=st.compressed_ratio,
                chunks=st.total_chunks, unique_chunks=st.unique_chunks,
                in_band=corpus.expected.check_ratio(st.dedup_ratio))


def scenario_timed(name: str, budget: str) -> dict:
    """``scenario_run`` repeated on one corpus until its ingest and its
    restore windows each hold SCENARIO_WINDOW_S: the median run's MB/s,
    the range, the runs and the windows; every run's ratios equal."""
    import statistics

    from repro_torch.scenarios import corpus_digest, generate

    corpus = generate(name, budget)
    runs = []
    while len(runs) < 25 and (len(runs) < 3 or min(
            sum(r[k] for r in runs) for k in ("ingest_s", "restore_s"))
            < SCENARIO_WINDOW_S):
        runs.append(scenario_run(name, corpus))
    ratios = {(r["dedup_ratio"], r["compressed_ratio"]) for r in runs}
    if len(ratios) != 1:
        raise AssertionError(f"{name} {budget}: ratios differ between "
                             f"runs: {sorted(ratios)}")
    out = dict(runs[0], digest=corpus_digest(corpus), runs=len(runs))
    for k in ("ingest", "restore"):
        mb_s = [r[f"{k}_mb_s"] for r in runs]
        out.update({f"{k}_mb_s": statistics.median(mb_s),
                    f"{k}_mb_s_range": (min(mb_s), max(mb_s)),
                    f"{k}_window_s": sum(r[f"{k}_s"] for r in runs)})
    return out


def all_tiny_occupancy(packing_impl: str) -> dict:
    """``bench_scheduler_occupancy.py``'s all-tiny draw at the quick
    budget (2 MiB of 100-999 B streams from seed 17) through the port's
    scheduler on the card, fingerprints on (the port's default; the
    occupancy, a property of batching, is the same either way)."""
    import numpy as np
    import torch

    from repro_torch.core.params import derived_params
    from repro_torch.service import ChunkScheduler

    rng = np.random.default_rng(17)
    lengths, acc = [], 0
    while acc < 2 << 20:
        n = int(rng.integers(100, 1000))
        lengths.append(n)
        acc += n
    sched = ChunkScheduler(derived_params(8192), device="cuda", slots=8,
                           packing_impl=packing_impl)
    payload = rng.integers(0, 256, int(sum(lengths)), dtype=np.uint8)
    t0 = time.perf_counter()
    off = 0
    for n in lengths:
        sched.submit(payload[off:off + n])
        off += n
    if len(sched.drain()) != len(lengths):
        raise AssertionError("the scheduler lost streams")
    torch.cuda.synchronize()
    st = sched.stats
    return dict(occupancy=st.occupancy, streams=len(lengths),
                dispatches=st.dispatches, packed_streams=st.packed_streams,
                s=time.perf_counter() - t0)


def scenario_phase(kernels) -> dict:
    """The four scenarios at the quick budget through the service on the
    card (their ratios must equal ``BENCH_quick.json``'s), again at
    SCENARIO_TIMED_BUDGET for throughput (``scenario_timed``), then the
    all-tiny occupancy rerun, packing off and on; the launch counts set to
    0 just before and read just after."""
    from repro_torch.scenarios import corpus_digest, generate

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    quick = {}
    for name in SCENARIO_RATIOS:
        corpus = generate(name, "quick")
        quick[name] = dict(scenario_run(name, corpus),
                           digest=corpus_digest(corpus))
    timed_runs = {name: scenario_timed(name, SCENARIO_TIMED_BUDGET)
                  for name in SCENARIO_RATIOS}
    occ = {mode: all_tiny_occupancy(mode) for mode in OCCUPANCY}
    launches = {k.name: k.launches for k in kernels}
    for name, (dedup, compressed) in SCENARIO_RATIOS.items():
        r = quick[name]
        if (r["dedup_ratio"], r["compressed_ratio"]) != (dedup, compressed):
            raise AssertionError(
                f"{name}: ratios {r['dedup_ratio']!r}, "
                f"{r['compressed_ratio']!r}, not BENCH_quick.json's "
                f"{dedup!r}, {compressed!r}")
    for name, r in {**quick, **{f"{n} {SCENARIO_TIMED_BUDGET}": r for n, r
                                in timed_runs.items()}}.items():
        if not r["in_band"]:
            raise AssertionError(f"{name}: dedup ratio {r['dedup_ratio']} "
                                 f"outside the scenario's contract band")
    for mode, want in OCCUPANCY.items():
        if occ[mode]["occupancy"] != want:
            raise AssertionError(f"all-tiny occupancy, packing {mode}: "
                                 f"{occ[mode]['occupancy']!r}, not {want!r}")
    return dict(quick=quick, timed=timed_runs, occupancy=occ,
                launches=launches, s=time.perf_counter() - t0)


# -- phase 9: the dedup data pipeline and training at full width -------------

#: DedupIngest on the DEB-like corpus: MiB, the prefix held against the
#: port's CPU run, and the seconds its timing window must hold (the pass
#: repeated, each a new DedupIngest, the median pass's MB/s reported)
INGEST_MB = 64
INGEST_CHECK_MB = 8
INGEST_WINDOW_S = 2.0
TRAIN_STEPS = 4
TRAIN_BATCH = 8
TRAIN_SEQ = 2048
#: the restart check: llama3.2-1b's widths, its depth cut to this many
#: layers (the 128,256 x 2048 embedding stays whole), 4 steps with a
#: checkpoint every 2; each layer adds 0.61 GB of state to each of 4 saves
#: and a restore (about 15 s on the card machine's filesystem), so 2 of 16
#: layers keep the whole script well inside its time limit as it grows
RESTART_LAYERS = 2
RESTART_STEPS = 4
RESTART_EVERY = 2
#: the restart check's checkpoint chunks: avg 1 MiB (the store's default
#: is 64 KiB).  The store writes a file a unique chunk; at 64 KiB a state
#: of several GB is tens of thousands of files a save, and the file count,
#: not the chunking, sets the save time
CHECKPOINT_AVG = 1 << 20
#: the restart check runs in a child process of this script (so that
#: CUBLAS_WORKSPACE_CONFIG, which cuBLAS reads once, holds for it alone);
#: the seconds it may take
RESTART_TIMEOUT_S = 600


def ingest_run(corpus, device: str):
    """Unique bytes of ``DedupIngest`` (avg 8192, 1 MiB segments x 8) on
    ``corpus``: (unique chunks, savings, seconds)."""
    import torch

    from repro_torch.data import DedupIngest, PipelineConfig

    ing = DedupIngest(PipelineConfig(avg_chunk=8192, segment_bytes=1 << 20,
                                     batch_segments=8), device=device)
    t0 = time.perf_counter()
    chunks = list(ing.unique_bytes(corpus))
    if device != "cpu":
        torch.cuda.synchronize()
    return chunks, ing.savings, time.perf_counter() - t0


def sha256_of(chunks) -> str:
    """SHA-256 of the chunks' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for u in chunks:
        h.update(u.tobytes())
    return h.hexdigest()


#: device kernels of a traced training step, by name: matrix products
#: (cuBLAS/CUTLASS), the flash kernel, the rest (elementwise, reductions,
#: the plain attention recompute's softmax, the optimizer)
STEP_KERNEL_GROUPS = (("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
                      ("flash", ("flash_attn",)))


def device_split(prof, groups) -> dict:
    """A ``torch.profiler`` trace's device time by kernel group, the first
    group whose keys a kernel's name holds (else "other"): the ms of each
    group, the kernels counted and the ten costliest by name."""
    split = {name: 0.0 for name, _ in groups}
    split["other"] = 0.0
    kernels = 0
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or getattr(
            ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        kernels += ev.count
        name = next((g for g, keys in groups
                     if any(k in ev.key for k in keys)), "other")
        split[name] += us / 1e3
        top.append((us / 1e3, ev.count, ev.key))
    return dict(device_ms=sum(split.values()), groups_ms=split,
                kernels=kernels, top=sorted(top, reverse=True)[:10])


def traced_step(trainer, params, opt_state, step: int,
                groups=STEP_KERNEL_GROUPS) -> dict:
    """One more training step traced with ``torch.profiler``: its wall
    ms, the device ms by kernel group (``groups``), and the device's busy
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.batch_at(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = trainer.train_step(params, opt_state, batch)
        float(out[2]["loss"])
        wall = time.perf_counter() - t0
    del out
    split = device_split(prof, groups)
    return dict(wall_ms=wall * 1e3,
                busy_share=split["device_ms"] / (wall * 1e3), **split)


def training_phase(seed: int, kernels) -> dict:
    """(a) ``DedupIngest`` on the card over ``load_dataset("DEB", 64)``,
    its first 8 MiB's unique bytes held against the CPU's, then timed
    over repeated passes; (b) ``Trainer`` at the published llama3.2-1b
    configuration (bf16, remat full, microbatch 4), random weights from
    ``seed``, AdamW, 4 steps of 8 x 2048 tokens on the ingest's unique
    bytes; (c) ``restart_check`` in a child process.  The launch counts
    are set to 0 just before (a)'s first pass and (b) and read just after
    each."""
    import statistics

    import numpy as np
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, TokenLoader, load_dataset
    from repro_torch.kernels import flash_attn
    from repro_torch.train import LoopConfig, OptConfig, Trainer

    out = {}
    t_phase = time.perf_counter()
    # (a) the dedup data pipeline
    corpus = load_dataset("DEB", INGEST_MB)
    for k in kernels:
        k.launches = 0
    chunks, savings, s = ingest_run(corpus, "cuda")
    out["ingest_launches"] = {k.name: k.launches for k in kernels}
    unique = np.concatenate(chunks)
    digest = sha256_of(chunks)
    passes = [s]
    while sum(passes) < INGEST_WINDOW_S and len(passes) < 200:
        passes.append(ingest_run(corpus, "cuda")[2])
    head = corpus[:INGEST_CHECK_MB << 20]
    card_head = ingest_run(head, "cuda")
    cpu_head = ingest_run(head, "cpu")
    mb_s = [corpus.size / t / 1e6 for t in passes]
    out["ingest"] = dict(
        bytes=corpus.size, passes=len(passes), window_s=sum(passes),
        mb_s=statistics.median(mb_s), mb_s_range=(min(mb_s), max(mb_s)),
        first_pass_s=s, savings=savings,
        unique_bytes=int(unique.size), sha256=digest,
        head_sha256=sha256_of(card_head[0]),
        head_cpu_sha256=sha256_of(cpu_head[0]),
        head_savings=(card_head[1], cpu_head[1]), cpu_head_s=cpu_head[2])
    if (out["ingest"]["head_sha256"] != out["ingest"]["head_cpu_sha256"]
            or card_head[1] != cpu_head[1]):
        raise AssertionError(f"DedupIngest on the card and on the CPU "
                             f"differ over the first {INGEST_CHECK_MB} MiB: "
                             f"{out['ingest']}")
    del chunks, card_head, cpu_head

    # (b) Trainer at the published configuration
    cfg = get_config("llama3.2-1b")
    loader = TokenLoader(unique, LoaderConfig(batch_size=TRAIN_BATCH,
                                              seq_len=TRAIN_SEQ))
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    trainer = Trainer(cfg, opt, LoopConfig(total_steps=TRAIN_STEPS,
                                           log_every=0), loader, None,
                      device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    params, opt_state = trainer.run(
        torch.Generator(device="cuda").manual_seed(seed), steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    out["train_launches"] = {k.name: k.launches for k in kernels}
    n_params = sum(t.numel() for t in leaves(params))
    out["train_trace"] = traced_step(trainer, params, opt_state,
                                     TRAIN_STEPS)
    del params, opt_state
    hist = trainer.history
    remat_passes = 2 if cfg.remat != "none" else 1
    want_flash = (TRAIN_STEPS * max(cfg.microbatch, 1) * cfg.n_layers
                  * remat_passes)
    out["train"] = dict(
        params=n_params, steps=hist, s=train_s,
        step_ms=[h["dt"] * 1e3 for h in hist],
        tokens_per_s=[TRAIN_BATCH * TRAIN_SEQ / h["dt"] for h in hist],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_launches=out["train_launches"][flash_attn.KERNEL.name],
        flash_launches_expected=want_flash)
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or len(hist) != TRAIN_STEPS:
        raise AssertionError(f"training steps not finite: {hist}")
    if out["train"]["flash_launches"] != want_flash:
        raise AssertionError(
            f"flash kernel launched {out['train']['flash_launches']} times "
            f"in {TRAIN_STEPS} steps, not {want_flash} ({cfg.n_layers} "
            f"layers x {cfg.microbatch} microbatches x {remat_passes})")
    del trainer
    torch.cuda.empty_cache()

    # (c) restart bit-determinism through the CDC checkpoint store
    out["restart"] = restart_in_child(seed, unique)
    out["s"] = time.perf_counter() - t_phase
    return out


def restart_in_child(seed: int, unique) -> dict:
    """``restart_check`` in a child process of this script with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (the deterministic cuBLAS workspace;
    cuBLAS reads it once, so the earlier phases keep the default).  The
    loader's tokens go through a file; the child's result comes back
    through another."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "unique.npy"), unique)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--restart-check", tmp], env=env, capture_output=True,
            text=True, timeout=RESTART_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(
                f"the restart check exited {proc.returncode}:\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(tmp, "restart.json")) as f:
            out = json.load(f)
    if out["first_step"] != RESTART_EVERY or not out["bit_equal"]:
        raise AssertionError(f"the resumed run is not the unbroken one: "
                             f"{out}")
    return out


def stopwatch(fn, seconds: list):
    """``fn``, appending each call's seconds to ``seconds``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        got = fn(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return got
    return call


def restart_check(seed: int, unique) -> dict:
    """Restart bit-determinism on the card: llama3.2-1b's widths at
    RESTART_LAYERS layers, RESTART_STEPS steps with a checkpoint every
    RESTART_EVERY through the CDC store, once unbroken and once stopped at
    step 2 and resumed from its checkpoint, under deterministic
    algorithms; the final parameters and optimizer state must be
    bit-equal.  Also each save's and the restore's seconds, and the
    store's chunker once on the largest leaf.  Runs in the child process
    that ``restart_in_child`` starts."""
    import warnings

    import torch

    from repro_torch._tree import leaves
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.chunker import make_chunker
    from repro_torch.data import LoaderConfig, TokenLoader
    from repro_torch.train import LoopConfig, OptConfig, Trainer

    torch.use_deterministic_algorithms(True, warn_only=True)
    loader = TokenLoader(unique, LoaderConfig(batch_size=TRAIN_BATCH,
                                              seq_len=TRAIN_SEQ))
    rcfg = get_config("llama3.2-1b").replace(n_layers=RESTART_LAYERS)
    ropt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=RESTART_STEPS)
    save_s, restore_s = [], []

    def trainer_at(root):
        ckpt = CheckpointManager(root, avg_chunk=CHECKPOINT_AVG,
                                 device="cuda")
        ckpt.save = stopwatch(ckpt.save, save_s)
        return Trainer(rcfg, ropt, LoopConfig(
            total_steps=RESTART_STEPS, ckpt_every=RESTART_EVERY,
            log_every=0), loader, ckpt, device="cuda")

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        # one store at a time on disk: each holds about 2 x the state
        with tempfile.TemporaryDirectory() as root:
            t_full = trainer_at(root)
            p_full, o_full = t_full.run(gen())
            full = [t.cpu() for t in leaves((p_full, o_full))]
            del p_full, o_full
        with tempfile.TemporaryDirectory() as root:
            trainer_at(root).run(gen(), steps=RESTART_EVERY)  # "crash"
            t_res = trainer_at(root)
            t_res.ckpt.restore = stopwatch(t_res.ckpt.restore, restore_s)
            p_res, o_res = t_res.run(gen())
            resumed = [t.cpu() for t in leaves((p_res, o_res))]
            del p_res, o_res
            savings = t_res.ckpt.dedup_savings
    restart_s = time.perf_counter() - t0
    equal = len(full) == len(resumed) and all(
        torch.equal(a, b) for a, b in zip(full, resumed))
    state_bytes = sum(t.numel() * t.element_size() for t in full)
    # the chunker alone, on the largest leaf's bytes (host copy included)
    big = max(full, key=lambda t: t.numel() * t.element_size())
    view = big.reshape(-1).view(torch.uint8).numpy()
    chunker = make_chunker("seqcdc", CHECKPOINT_AVG, device="cuda")
    chunker.chunk(view)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chunker.chunk(view)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t1
    return dict(
        layers=RESTART_LAYERS, first_step=t_res.history[0]["step"],
        losses_full=[h["loss"] for h in t_full.history],
        losses_resumed=[h["loss"] for h in t_res.history],
        bit_equal=equal, s=restart_s, save_s=save_s, restore_s=restore_s,
        save_mb_s=len(save_s) * state_bytes / sum(save_s) / 1e6,
        restore_mb_s=len(restore_s) * state_bytes / sum(restore_s) / 1e6,
        state_bytes=state_bytes, dedup_savings=savings,
        chunk_leaf_bytes=view.size, chunk_s=chunk_s,
        deterministic_warnings=sorted({
            str(w.message).splitlines()[0] for w in warned
            if "determinis" in str(w.message)}))


# -- phase 10: the recurrent and hybrid families served at full width --------

RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-125m")
#: prompt lengths of phase 10's requests, in submission order: those above
#: 1024 tokens are multiples of 1024 (the reference's tile assert), and
#: 32,768 is the long-context case these constant-state architectures
#: exist for
RECURRENT_PROMPTS = (32768, 8192, 4096, 2048, 1024, 512, 37)
#: the engine's cache length: holds the longest prompt and its new tokens
#: (only attention caches depend on it, and the hybrid's is the 2048-token
#: window)
RECURRENT_CACHE = 32768 + 64
#: the decode-equals-forward gate: one pattern period of layers at full
#: width, an 8,192-token prefill, then 8 greedy decode steps
GATE_LAYERS = {"recurrentgemma-2b": 3, "xlstm-125m": 6}
GATE_PROMPT = 8192
GATE_STEPS = 8


def expected_launches(cfg, prompts) -> dict:
    """The scan and flash launches that prefilling ``prompts`` makes: flash
    once an attention layer (dense, MoE or local) for a prompt above
    ``attn_kv_block`` and never for an MLA layer (its attention is
    materialised in query blocks), the RG-LRU and sLSTM scans once a
    layer, the mLSTM carry once a layer (twice for a ragged prompt: the
    whole chunks, then the tail)."""
    from repro_torch.models.transformer import ATTENTION_KINDS, layer_kinds

    kinds = layer_kinds(cfg)

    def n(kind):
        return kinds.count(kind)

    flash = sum(bool(cfg.attn_kv_block) and S > cfg.attn_kv_block
                for S in prompts)
    mlstm = sum(1 if S % min(cfg.mlstm_chunk, S) == 0 else 2
                for S in prompts)
    return {"flash_attn": flash * sum(map(n, ATTENTION_KINDS)),
            "linear_scan": len(prompts) * n("rglru"),
            "mlstm_scan": mlstm * n("mlstm"),
            "slstm_scan": len(prompts) * n("slstm")}


def state_bytes_per_slot(cfg, cache_len: int) -> int:
    """Bytes of one slot's decode state (every layer's cache) at
    ``cache_len``, from the caches' shapes and types alone."""
    from repro_torch._tree import leaves
    from repro_torch.models import lm

    caches = lm.init_caches(cfg, 1, cache_len, device="meta")
    return sum(t.numel() * t.element_size() for t in leaves(caches))


def greedy_against_forward(cfg, params, batch, steps: int) -> dict:
    """One row's prefill of ``batch`` and ``steps`` greedy decode steps,
    against one ``forward`` over the prompt and the tokens decoded (its
    attention on the materialised route in query blocks that divide its
    length, as the tile assert asks; in the ``embeddings`` mode the
    tokens embedded through the output head's transpose, as decode embeds
    them).  At each of the ``steps + 1`` positions the two routes' logits
    must agree within the phase 7 tolerance between routes
    (``LOGITS_TOL``), and the greedy token must be the forward's argmax,
    or, where it is not, a near-tie: within twice that position's
    difference between the routes of the forward's own maximum."""
    import torch

    from repro_torch.models import lm

    S0 = sum(t.shape[1] for t in batch.values())
    with torch.inference_mode():
        lg, caches = lm.prefill_step(cfg, params, batch, S0 + steps + 1)
        dec = [lg[0].float()]
        for i in range(steps):
            tok = dec[-1].argmax().reshape(1, 1)
            lg, caches = lm.decode_step(cfg, params, caches, tok, S0 + i)
            dec.append(lg[0].float())
        toks = torch.stack([d.argmax() for d in dec])[None, :-1]
        full_batch = dict(batch)
        if cfg.input_mode == "embeddings":
            w = params["embed"] if cfg.tie_embeddings else params["unembed"].T
            full_batch["embeds"] = torch.cat(
                [batch["embeds"], w[toks].to(batch["embeds"].dtype)], 1)
        else:
            full_batch["tokens"] = torch.cat([batch["tokens"], toks], 1)
        S = S0 + steps
        qb = max(d for d in range(1, 1025) if S % d == 0)
        fcfg = cfg.replace(attn_kv_block=0, attn_q_block=qb)
        full = lm.forward(fcfg, params, full_batch)[0, S0 - 1:].float()
    tol = LOGITS_TOL["bfloat16"]
    out = []
    for i, d in enumerate(dec):
        f = full[i]
        err = float((d - f).abs().max())
        t_dec, t_fwd = int(d.argmax()), int(f.argmax())
        margin = float(f[t_fwd] - f[t_dec])
        top2 = torch.topk(f, 2).values
        out.append(dict(max_abs_err=err, token=t_dec, forward=t_fwd,
                        margin=margin, top2_gap=float(top2[0] - top2[1])))
        if not (err <= tol and (t_dec == t_fwd or margin <= 2 * err)):
            raise AssertionError(f"{cfg.name} decode vs forward at position "
                                 f"{S0 - 1 + i}: {out[-1]} (tolerance {tol})")
    del caches, full
    return dict(layers=cfg.n_layers, prompt=S0, q_block=qb, steps=out,
                equal=sum(s["token"] == s["forward"] for s in out),
                max_abs_err=max(s["max_abs_err"] for s in out),
                tolerance=tol)


def decode_gate(seed: int, arch: str) -> dict:
    """One pattern period of ``arch`` at full width (random bf16 weights):
    an 8,192-token prefill and 8 greedy decode steps against one
    ``forward`` over the same tokens (``greedy_against_forward``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch).replace(n_layers=GATE_LAYERS[arch])
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed + 1))
    rng = np.random.default_rng(seed + 11)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, GATE_PROMPT),
                             device="cuda")[None]
    gate = greedy_against_forward(cfg, params, {"tokens": prompt},
                                  GATE_STEPS)
    del params
    return gate


def recurrent_serving_phase(seed: int, arch: str, kernels) -> dict:
    """``Engine`` at ``arch``'s published size (random bf16 weights): 7
    requests of RECURRENT_PROMPTS tokens, 32 new tokens each, greedy, on 4
    slots, the busy share over the decode-only steps (``serve_checked``),
    the launches of the flash and scan kernels against those the prefills
    must make, the decode state's bytes a slot at two cache lengths, then
    the decode-equals-forward gate."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 10)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in RECURRENT_PROMPTS]
    scfg = ServeConfig(max_slots=SERVE_SLOTS, cache_len=RECURRENT_CACHE,
                       max_new_tokens=SERVE_NEW)
    # the warm-up on the shortest prompt and a 2048-token one (every kernel
    # of the path, and the flash route)
    res = serve_checked(cfg, params, scfg, prompts, kernels,
                        warm=[prompts[-1], prompts[3]])
    del res["out"], params
    want = expected_launches(cfg, RECURRENT_PROMPTS)
    got = {k: res["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{arch}: launches {got}, the prefills make "
                             f"{want}")
    state = {n: state_bytes_per_slot(cfg, n)
             for n in (RECURRENT_CACHE, 2 * RECURRENT_CACHE)}
    if len(set(state.values())) != 1:
        raise AssertionError(f"{arch}: the decode state grows with the "
                             f"cache length: {state}")
    torch.cuda.empty_cache()
    gate = decode_gate(seed, arch)
    return dict(arch=arch, params=n_params_of(cfg), init_s=init_s,
                expected_launches=want,
                state_bytes_per_slot=state[RECURRENT_CACHE],
                gate=gate, **res)


# -- phase 11: the dense family, the embedding modes and MoE at full width ----

#: the token models, served through ``Engine``, then the embedding-mode
#: models, through ``lm.prefill_step`` and ``lm.decode_step``
FAMILY_TOKEN_ARCHS = ("granite-8b", "phi3-medium-14b", "qwen2-72b",
                      "qwen3-moe-30b-a3b")
FAMILY_EMBED_ARCHS = ("musicgen-large", "llava-next-34b")
#: the token models' prompts, one a slot: those above 1024 tokens take the
#: flash route and are multiples of 1024 (the tile assert)
FAMILY_PROMPTS = (4096, 2048, 1024, 37)
FAMILY_NEW = 16
FAMILY_CACHE = 4160
#: the embedding models: 2 rows of 4,096 positions (llava: its 2,880
#: patch embeddings and 1,216 text tokens), 16 greedy decode steps
FAMILY_ROWS = 2
FAMILY_POSITIONS = 4096
#: device memory kept free beside a depth-cut model's weights and the
#: engine's cache: prefill activations, one request's caches, the
#: allocator's slack
FAMILY_HEADROOM_BYTES = 10e9
#: depth caps for the script's time limit, which phase 14 shares: whole or
#: at the deepest that fits (38 of qwen2-72b's 80 layers), granite-8b,
#: phi3-medium-14b, qwen2-72b and qwen3-moe-30b-a3b took 32.6, 31.1, 30.7
#: and 102.7 s of phase 11's 205.0 s on the card, their prefills and decode
#: steps scaling with depth; the script's time varies by up to 1.31x
#: between hosts (the store's file writes), so it is kept near 850 s on a
#: fast one
FAMILY_DEPTH_CAP = {"granite-8b": 18, "phi3-medium-14b": 20,
                    "qwen2-72b": 10, "qwen3-moe-30b-a3b": 12}
#: the gate: 2 layers at full width (a model with leading dense layers:
#: those and one MoE layer), a 2,048-position prompt (llava: 2,880 +
#: 1,216), 8 greedy steps; MoE with the capacity lifted, as the
#: reference's decode test lifts it (capacity drops depend on the length)
FAMILY_GATE_LAYERS = 2
FAMILY_GATE_PROMPT = 2048
FAMILY_GATE_STEPS = 8
FAMILY_GATE_CAPACITY = 8.0


def param_bytes(cfg) -> int:
    from repro_torch.models import lm

    return n_params_of(cfg) * lm.param_dtype(cfg).itemsize


def layer_bytes(cfg, kind: str, slots: int, cache_len: int) -> int:
    """Bytes of one ``kind`` layer of ``cfg`` on the card: its block's
    parameters in the parameter dtype and its decode cache for ``slots``
    rows of ``cache_len`` in the compute dtype (a KV cache 2 x n_kv_heads
    x head_dim a token, MLA's kv_lora_rank + qk_rope_dim), from the
    template's and the cache's shapes alone."""
    from repro_torch._tree import leaves
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import template_map

    shapes = []
    template_map(shapes.append, tfm.block_template(kind, cfg))
    weights = (sum(math.prod(t.shape) for t in shapes)
               * lm.param_dtype(cfg).itemsize)
    cache = tfm.init_block_cache(kind, cfg, slots, cache_len,
                                 lm.compute_dtype(cfg), device="meta")
    return weights + sum(t.numel() * t.element_size() for t in leaves(cache))


def deepest_that_fits(cfg, slots: int, cache_len: int) -> int:
    """The most layers of ``cfg``, its first ones in order (deepseek's
    three ``mla_dense`` before its ``mla_moe``), whose bf16 weights and
    ``slots`` decode caches of ``cache_len`` fit on the card beside the
    embedding, the head and ``FAMILY_HEADROOM_BYTES`` (at most the
    published depth); each layer reckoned by its kind
    (``layer_bytes``)."""
    import torch

    from repro_torch.models.transformer import layer_kinds

    room = (torch.cuda.get_device_properties(0).total_memory
            - FAMILY_HEADROOM_BYTES - param_bytes(cfg.replace(n_layers=0)))
    need = {k: layer_bytes(cfg, k, slots, cache_len)
            for k in set(layer_kinds(cfg))}
    fit = 0
    for kind in layer_kinds(cfg):
        room -= need[kind]
        if room < 0:
            break
        fit += 1
    return fit


def family_prompt(cfg, seed: int, rows: int, positions: int) -> dict:
    """A batch of ``rows`` x ``positions`` in the model's input mode,
    from ``seed``: token ids, or frame / patch embeddings drawn normal x
    0.02 (as ``tests/test_models.py`` draws them) in the compute dtype;
    llava's ``img_tokens`` patch embeddings go in front of its text."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    rng = np.random.default_rng(seed)
    dt = lm.compute_dtype(cfg)
    n_emb = {"tokens": 0, "embeddings": positions,
             "mixed": cfg.img_tokens}[cfg.input_mode]
    batch = {}
    if n_emb:
        e = rng.standard_normal((rows, n_emb, cfg.d_model),
                                dtype=np.float32) * np.float32(0.02)
        batch["embeds"] = torch.from_numpy(e).to("cuda", dt)
    if positions > n_emb:
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, positions - n_emb))).to("cuda")
    return batch


def moe_drops(cfg, params, prompts) -> list:
    """The (token, expert) pairs each prompt's prefill drops past the
    experts' capacity, summed over the layers: each prompt prefilled
    alone, the port's ``moe.dispatch`` counted through a wrapper."""
    import torch

    from repro_torch.models import lm, moe

    real, counts = moe.dispatch, []

    def counted(p, x, c):
        d = real(p, x, c)
        counts.append((~d.ok).sum())
        return d

    moe.dispatch = counted
    out = []
    try:
        with torch.inference_mode():
            for pr in prompts:
                counts.clear()
                tok = torch.as_tensor(pr, device="cuda")[None]
                lm.prefill_step(cfg, params, {"tokens": tok}, tok.shape[1])
                out.append(int(torch.stack(counts).sum()))
    finally:
        moe.dispatch = real
    return out


#: device kernels of a traced MoE prefill, by name: matrix products (the
#: attention projections and the grouped expert einsums), the flash
#: kernel, sorts (the router's top-k sort, the pair sort and the sorts
#: inside an accumulating ``index_put_``), the accumulating
#: ``index_put_``'s own scatter, other indexing (gathers, ``searchsorted``)
MOE_KERNEL_GROUPS = (STEP_KERNEL_GROUPS[0], STEP_KERNEL_GROUPS[1],
                     ("sort", ("sort", "Sort")),
                     ("index_put", ("indexing_backward", "index_put")),
                     ("index", ("gather", "index", "scatter", "search")))


def traced_prefill(cfg, params, prompt) -> dict:
    """One prefill of ``prompt`` alone (``lm.prefill_step``) traced with
    ``torch.profiler``: its wall ms and the device ms by
    ``MOE_KERNEL_GROUPS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    tok = torch.as_tensor(prompt, device="cuda")[None]
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lg, _ = lm.prefill_step(cfg, params, {"tokens": tok},
                                    tok.shape[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    del lg
    split = device_split(prof, MOE_KERNEL_GROUPS)
    return dict(wall_ms=wall * 1e3, positions=tok.shape[1], **split)


def embedding_serving(cfg, params, seed: int, kernels) -> dict:
    """The embedding-mode models served as the reference serves them:
    ``lm.prefill_step`` on FAMILY_ROWS x FAMILY_POSITIONS, then
    FAMILY_NEW - 1 greedy ``lm.decode_step``s (FAMILY_NEW tokens a row
    with the prefill's), after a warm-up at half the length; the launch
    counts set to 0 just before the timed run and read just after."""
    import torch

    from repro_torch.models import lm

    batch = family_prompt(cfg, seed, FAMILY_ROWS, FAMILY_POSITIONS)
    cache_len = FAMILY_POSITIONS + FAMILY_NEW

    def run(b, steps):
        S = sum(t.shape[1] for t in b.values())
        lg, caches = lm.prefill_step(cfg, params, b, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = [lg.argmax(-1)]
        for i in range(steps):
            lg, caches = lm.decode_step(cfg, params, caches,
                                        toks[-1][:, None], S + i)
            toks.append(lg.argmax(-1))
        out = torch.stack(toks, 1)
        finite = bool(torch.isfinite(lg).all())
        return t1, out, finite

    with torch.inference_mode():
        half = {k: v[:, : v.shape[1] // 2] for k, v in batch.items()}
        run(half, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        t1, out, finite = run(batch, FAMILY_NEW - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = {k.name: k.launches for k in kernels}
    if not finite or out.shape != (FAMILY_ROWS, FAMILY_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: tokens {out.shape}, finite "
                             f"logits {finite}")
    decode_s = t2 - t1
    return dict(launches=launches, peak_gb=torch.cuda.max_memory_allocated()
                / 1e9, prefill_ms={FAMILY_POSITIONS: [(t1 - t0) * 1e3]},
                rows=FAMILY_ROWS, decode_steps=FAMILY_NEW - 1,
                decode_s=decode_s,
                decode_tok_s=FAMILY_ROWS * (FAMILY_NEW - 1) / decode_s,
                decode_ms_per_step=decode_s / (FAMILY_NEW - 1) * 1e3,
                tokens=int(out.numel()))


def family_gate(seed: int, arch: str) -> dict:
    """2 layers of ``arch`` at full width (deepseek: its 3 dense layers
    and 1 MoE layer) with random bf16 weights, the MoE's capacity lifted:
    a FAMILY_GATE_PROMPT-position prefill (llava: its patch embeddings
    and 1,216 text tokens) and 8 greedy decode steps against one
    ``forward`` (``greedy_against_forward``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=max(FAMILY_GATE_LAYERS,
                                   cfg.n_dense_layers + 1))
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=FAMILY_GATE_CAPACITY)
    positions = (FAMILY_POSITIONS if cfg.input_mode == "mixed"
                 else FAMILY_GATE_PROMPT)
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed + 1))
    gate = greedy_against_forward(
        cfg, params, family_prompt(cfg, seed + 12, 1, positions),
        FAMILY_GATE_STEPS)
    del params
    return gate


def family_phase(seed: int, arch: str, kernels) -> dict:
    """``arch`` at its published width (random bf16 weights from the seed;
    its depth cut to the deepest that fits beside the cache, and to
    ``FAMILY_DEPTH_CAP``): the token
    models through ``Engine`` (FAMILY_PROMPTS on 4 slots, ``serve_checked``
    with its busy share), the MoE's dropped pairs a prefill; the embedding
    models through ``embedding_serving``; the flash launches equal to
    those the prefills make; then the gate at 2 layers."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import MOE_KINDS, layer_kinds
    from repro_torch.serve import ServeConfig

    cfg = get_config(arch)
    published = cfg.n_layers
    slots, cache_len = ((SERVE_SLOTS, FAMILY_CACHE)
                        if cfg.input_mode == "tokens" else
                        (FAMILY_ROWS, FAMILY_POSITIONS + FAMILY_NEW))
    fits = deepest_that_fits(cfg, slots, cache_len)
    cfg = cfg.replace(n_layers=min(fits, FAMILY_DEPTH_CAP.get(arch, fits)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    drops = trace = None
    if cfg.input_mode == "tokens":
        rng = np.random.default_rng(seed + 13)
        prompts = [rng.integers(0, cfg.vocab_size, n)
                   for n in FAMILY_PROMPTS]
        scfg = ServeConfig(max_slots=SERVE_SLOTS, cache_len=FAMILY_CACHE,
                           max_new_tokens=FAMILY_NEW)
        res = serve_checked(cfg, params, scfg, prompts, kernels,
                            warm=[prompts[-1], prompts[1]])
        del res["out"]
        want = expected_launches(cfg, FAMILY_PROMPTS)["flash_attn"]
        if cfg.n_experts:
            drops = moe_drops(cfg, params, prompts)
            trace = traced_prefill(cfg, params, prompts[0])
    else:
        res = embedding_serving(cfg, params, seed + 14, kernels)
        want = expected_launches(cfg, [FAMILY_POSITIONS])["flash_attn"]
    if res["launches"]["flash_attn"] != want:
        raise AssertionError(f"{arch}: flash launched "
                             f"{res['launches']['flash_attn']} times, the "
                             f"prefills make {want}")
    weights_gb = param_bytes(cfg) / 1e9
    n_moe = sum(k in MOE_KINDS for k in layer_kinds(cfg))
    experts_gb = (n_moe * 3 * cfg.n_experts * cfg.d_model
                  * cfg.d_ff_expert * 2 / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gate = family_gate(seed, arch)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.n_layers, published_layers=published,
                fits_layers=fits,
                kinds=layer_kinds(cfg), params=n_params_of(cfg),
                weights_gb=weights_gb, cache_len=cache_len,
                state_bytes_per_slot=state_bytes_per_slot(cfg, cache_len),
                init_s=init_s, init_peak_gb=init_peak_gb,
                expected_flash=want, moe_drops=drops, moe_trace=trace,
                experts_gb_per_step=experts_gb,
                experts_bound_ms=experts_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
                gate=gate, **res)


def log_family(arch: str, r: dict) -> None:
    """Print one model's serving numbers from ``family_phase``."""
    cut = ("nothing cut" if r["layers"] == r["published_layers"] else
           f"depth cut to {r['layers']} of {r['published_layers']} "
           f"layers (the deepest that fits beside the cache)"
           if r["layers"] == r["fits_layers"] else
           f"depth cut to {r['layers']} of {r['published_layers']} layers "
           f"for the script's time ({r['fits_layers']} fit beside the "
           f"cache)")
    how = (f"Engine, {len(FAMILY_PROMPTS)} requests on {SERVE_SLOTS} "
           f"slots, cache {FAMILY_CACHE}"
           if "busy_share" in r else
           f"lm.prefill_step on {FAMILY_ROWS} x {FAMILY_POSITIONS} "
           f"positions, then greedy lm.decode_steps")
    log(f"family {arch}: published width, {cut}; {r['params']} "
        f"parameters ({r['weights_gb']:.2f} GB bf16, init "
        f"{r['init_s']:.2f} s, peak {r['init_peak_gb']:.2f} GB during "
        f"init); {how}: {r['tokens']} tokens, peak {r['peak_gb']:.2f} "
        f"GB")
    log(f"family {arch}: prefill ms by prompt length: " + ", ".join(
        f"{n}: " + "/".join(f"{t:.2f}" for t in ts)
        for n, ts in r["prefill_ms"].items())
        + f"; decode {r['decode_tok_s']:.2f} tokens/s "
        f"({r['decode_ms_per_step']:.3f} ms a step); flash launches "
        f"{r['launches']['flash_attn']} (as the prefills make them)")
    if "busy_share" in r:
        log(f"family {arch}: device busy share {r['busy_share']:.4f} "
            f"({r['busy_note']}) over the run's {r['busy_steps']} "
            f"decode-only steps after the first "
            f"({r['busy_step_ms']:.3f} ms a step untraced, "
            f"{r['busy_device_ms_per_step']:.3f} device ms, "
            f"{r['busy_kernels_per_step']:.1f} kernels traced and "
            f"{r['busy_launches_per_step']:.1f} launched a step in a "
            f"replay)")
    if r["moe_drops"] is not None:
        log(f"family {arch}: (token, expert) pairs dropped past the "
            f"capacity, by prefill of " + ", ".join(
                f"{n}: {d}" for n, d in zip(FAMILY_PROMPTS,
                                            r["moe_drops"]))
            + f"; a decode step reads every expert: "
            f"{r['experts_gb_per_step']:.2f} GB, "
            f"{r['experts_bound_ms']:.3f} ms at 3.35 TB/s")
        tp = r["moe_trace"]
        log(f"family {arch}: one {tp['positions']}-token prefill "
            f"traced: {tp['wall_ms']:.1f} ms, device "
            f"{tp['device_ms']:.1f} ms in {tp['kernels']} kernels: "
            + ", ".join(f"{g} {v:.1f} ms"
                        for g, v in tp["groups_ms"].items()))
        for ms, count, name in tp["top"]:
            log(f"family {arch}: traced prefill kernel {ms:.1f} ms in "
                f"{count} launches: {name[:120]}")
    g = r["gate"]
    log(f"family {arch}: decode equals forward at {g['layers']} layers, "
        f"full width: {g['prompt']}-position prefill and "
        f"{FAMILY_GATE_STEPS} greedy steps, argmax equal at "
        f"{g['equal']} of {len(g['steps'])} positions"
        + ("" if g["equal"] == len(g["steps"])
           else " (near-ties elsewhere)")
        + f", max_abs_err {g['max_abs_err']:.4g} (tolerance "
        f"{g['tolerance']}, {g['max_abs_err'] / g['tolerance']:.3f} of it "
        f"used); forward attention in query blocks of {g['q_block']}; the "
        f"forward's top-2 gaps " + ", ".join(
            f"{st['top2_gap']:.4f}" for st in g["steps"]))


# -- phase 12: MLA, deepseek-v3-671b at published width ----------------------

MLA_ARCH = "deepseek-v3-671b"


def mla_phase(seed: int, kernels) -> dict:
    """``deepseek-v3-671b`` through ``family_phase``: published width, all
    256 routed experts and the shared one, its depth cut to the deepest
    that fits (its 3 ``mla_dense`` layers first, then ``mla_moe``), served
    by ``Engine`` on FAMILY_PROMPTS with the absorbed decode, then the
    gate at 3 dense + 1 MoE layers.  Beyond phase 11's checks: at least
    one MoE layer in the cut, no hand-written kernel launched (MLA takes
    no flash route), and the decode state exactly the latent cache, layers
    x cache_len x (kv_lora_rank + qk_rope_dim) in bf16 a slot."""
    from repro_torch.configs import get_config

    cfg = get_config(MLA_ARCH)
    r = family_phase(seed, MLA_ARCH, kernels)
    kinds = r["kinds"]
    if kinds[:cfg.n_dense_layers] != ["mla_dense"] * cfg.n_dense_layers or \
            "mla_moe" not in kinds:
        raise AssertionError(f"{MLA_ARCH}: layers {kinds}, not the 3 dense "
                             f"and at least one MoE layer")
    if any(r["launches"].values()):
        raise AssertionError(f"{MLA_ARCH}: hand-written kernels launched "
                             f"{r['launches']}")
    latent = cfg.kv_lora_rank + cfg.qk_rope_dim
    want = r["layers"] * r["cache_len"] * latent * 2
    if r["state_bytes_per_slot"] != want:
        raise AssertionError(f"{MLA_ARCH}: decode state "
                             f"{r['state_bytes_per_slot']} bytes a slot, "
                             f"not {want}")
    return dict(latent_per_token=latent, **r)


# -- phase 13: distribution on one card ---------------------------------------

#: phase 13's fingerprint records: 8 shards x 2^20 rows, drawn from a pool
#: of 2^22 distinct fingerprints (more than half the rows repeat one), and
#: a skewed batch of 8 x 2^16 rows half of which one owner takes
ROUTE_SHARDS = 8
ROUTE_ROWS = 1 << 20
ROUTE_POOL = 1 << 22
SKEW_ROWS = 1 << 16


def route_records(seed: int, rows: int, pool: int, skew: bool):
    import numpy as np

    rng = np.random.default_rng(seed)
    n = ROUTE_SHARDS * rows
    fps = rng.integers(0, 1 << 32, (pool, 2), dtype=np.uint64)
    fp = fps[rng.integers(0, pool, n)].astype(np.uint32)
    if skew:  # half the rows owned by shard 0
        fp[: n // 2, 0] = fp[: n // 2, 0] // ROUTE_SHARDS * ROUTE_SHARDS
    lengths = rng.integers(1, 65536, n).astype(np.int32)
    lengths[::17] = 0  # padding rows
    return fp, lengths


def route_phase(seed: int) -> dict:
    """(a) ``routed_fp_tables`` and ``distributed_dedup`` over an 8-shard
    mesh of ``cuda:0`` against the same functions over an 8-shard CPU mesh
    (tables bit-equal, overflow equal) and against ``dedup_stats``."""
    import numpy as np
    import torch

    from repro_torch.dedup.dist_index import (
        distributed_dedup,
        routed_fp_tables,
    )
    from repro_torch.dedup.index import dedup_stats
    from repro_torch.launch.mesh import make_host_mesh

    card = make_host_mesh(shards=ROUTE_SHARDS, device="cuda:0")
    host = make_host_mesh(shards=ROUTE_SHARDS, device="cpu")
    out = {}
    for label, rows, skew in (("uniform", ROUTE_ROWS, False),
                              ("skewed", SKEW_ROWS, True)):
        fp, ln = route_records(seed + 13, rows, ROUTE_POOL, skew)
        fp_d = torch.from_numpy(fp.astype(np.int64)).cuda()
        ln_d = torch.from_numpy(ln).cuda()
        route = routed_fp_tables(card)
        tables, overflow = route(fp_d, ln_d)
        want, want_over = routed_fp_tables(host)(fp, ln)
        if overflow != want_over:
            raise AssertionError(f"{label}: overflow {overflow} on the card, "
                                 f"{want_over} on the CPU")
        if not np.array_equal(tables.cpu().numpy(), want.numpy()):
            raise AssertionError(f"{label}: routed tables differ from the "
                                 f"CPU's")
        stats = distributed_dedup(card)(fp_d, ln_d)
        r = dict(records=int(fp.shape[0]), overflow=overflow,
                 tables_shape=list(tables.shape), stats=stats)
        if label == "uniform":
            if overflow:
                raise AssertionError(f"uniform draw overflowed: {overflow}")
            ref = {k: int(v) for k, v in dedup_stats(fp_d, ln_d).items()}
            if {k: stats[k] for k in ref} != ref:
                raise AssertionError(f"distributed_dedup {stats} != "
                                     f"dedup_stats {ref}")
            r["routed_ms"] = cuda_ms(lambda: route(fp_d, ln_d), reps=5)
            dd = distributed_dedup(card)
            r["dedup_ms"] = cuda_ms(lambda: dd(fp_d, ln_d), reps=5)
            r["stats_ms"] = cuda_ms(lambda: dedup_stats(fp_d, ln_d), reps=5)
        elif overflow == 0:
            raise AssertionError("the skewed draw did not overflow")
        out[label] = r
        del tables, fp_d, ln_d
    torch.cuda.empty_cache()
    return out


def prefill_count_phase(seed: int) -> dict:
    """(c) the op counter on llama3.2-1b's 4,096-token prefill at full
    width (bf16, random weights): the FLOPs and bytes of the aten ops it
    sees, plus the flash kernel's, which runs outside aten (its FLOPs from
    the pairs its causal mask keeps, its bytes q, k, v and the output once),
    and the H100 bound of the sum."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import lm
    from repro_torch.roofline import CostCounter, constants

    cfg = get_config("llama3.2-1b")
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(seed + 5))
    flash_attn.KERNEL.launches = 0
    counter = CostCounter()
    with torch.no_grad(), counter:
        lm.prefill_step(cfg, params, {"tokens": tokens},
                        cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    flash_n = flash_attn.KERNEL.launches
    if flash_n != cfg.n_layers:
        raise AssertionError(f"flash launched {flash_n} times in the counted "
                             f"prefill, not {cfg.n_layers}")
    H, hd, KV = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    pairs = flash_pairs(4096, True, 0)
    flash_flops = cfg.n_layers * 4 * H * hd * pairs
    flash_bytes = cfg.n_layers * 2 * 4096 * hd * (2 * H + 2 * KV)
    flops = counter.flops + flash_flops
    nbytes = counter.bytes + flash_bytes
    del params
    torch.cuda.empty_cache()
    return dict(
        aten_flops=counter.flops, aten_bytes=counter.bytes,
        flash_flops=flash_flops, flash_bytes=flash_bytes,
        flops=flops, bytes=nbytes, ops=sum(counter.ops.values()),
        bound_ms=max(flops / constants.PEAK_FLOPS_BF16,
                     nbytes / constants.HBM_BW) * 1e3,
        compute_ms=flops / constants.PEAK_FLOPS_BF16 * 1e3,
        memory_ms=nbytes / constants.HBM_BW * 1e3,
        top=counter.flops_by_op.most_common(4),
    )


def dryrun_cell_phase() -> dict:
    """(d) one published-size dry-run cell: llama3.2-1b x decode_32k on
    the single-pod (16, 16) mesh, on the fake backend (no card)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_production_mesh

    rec = run_cell("llama3.2-1b", "decode_32k", make_production_mesh(),
                   "pod16x16")
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run cell: {rec['status']}: "
                             f"{rec.get('error')}")
    return rec


# -- phase 14: the recurrent families trained at published width --------------

#: (arch, rows, tokens a row): xlstm-125m at 8 x 2,048, recurrentgemma-2b at
#: 8 x 4,096 (so its 2,048-token window slides), each at its published
#: microbatch (recurrentgemma: 8 microbatches of a row; xlstm: none) and
#: remat (``dots``, ``full``)
RECURRENT_TRAIN = (("xlstm-125m", 8, 2048), ("recurrentgemma-2b", 8, 4096))
RECURRENT_TRAIN_STEPS = 4
#: bytes a parameter at the update's peak, bf16 parameters and float32
#: moments: the parameters, their gradient, the moments, and the new
#: parameters and moments (``optim.update`` builds the new tree before the
#: old one is dropped): 2 + 2 + 8 + 8 + 2; and beside them, the float32
#: temporaries of the largest leaf's update (its gradient, both moments,
#: their squares and quotients, the step, the parameter), which for
#: recurrentgemma-2b's untied head (655 M parameters) is the last leaf
#: updated: at 17 of 26 layers it ran out of memory there with 76.0 GB
#: allocated, about 21 GB of them its temporaries, asking 2.6 GB more
UPDATE_BYTES_PER_PARAM = 22
UPDATE_TEMP_BYTES_PER_ELEMENT = 28
#: the backward's peak: parameters, moments, the float32 accumulator and a
#: microbatch's gradient (2 + 8 + 4 + 2), beside a microbatch's logits
#: chain (bf16 logits, their float32 copy, exp and gradients: about 18
#: bytes a logit)
BACKWARD_BYTES_PER_PARAM = 16
BYTES_PER_LOGIT = 18
#: device memory kept free beside either: the allocator's fragmentation
#: (6.9 and 11.1 GB reserved but unallocated when recurrentgemma-2b at 17
#: and 26 layers ran out of memory on the card) and the layers' saved
#: inputs
TRAIN_HEADROOM_BYTES = 10e9
#: the gradient gate: one pattern period of layers (``GATE_LAYERS``) at
#: full width in float32 (remat and microbatching off: neither changes a
#: gradient), one row of 2,304 tokens (past recurrentgemma's 2,048 window,
#: 9 mLSTM chunks of 256), the card's gradient (the kernels) against the
#: CPU's (the plain versions) leaf by leaf: ``max|g_card - g_cpu|`` at most
#: ``GRAD_GATE_TOL`` times the whole CPU gradient's largest value.  Both
#: are float32 forms that differ in summation order (cuBLAS against the
#: CPU's products, the kernels' scans and sums against the plain loops)
#: through 2,304 recurrent steps (measured on the card: 1.6e-5 for
#: xlstm-125m, 4.3e-6 for recurrentgemma-2b); the CPU tests hold the port
#: to the reference at 1e-6 of it over 40 tokens
GRAD_GATE_TOKENS = 2304
GRAD_GATE_TOL = 1e-4
#: the gate's attention tiles: the flash route wants S a multiple of them
#: (the reference's tile assert), and 2,304 = 9 x 256 is no multiple of the
#: published 1,024; tiles change no value the kernel computes, only the
#: plain version's blocking (its CPU forward and the recomputing backward)
GRAD_GATE_BLOCK = 256
#: device kernels of a traced recurrent training step: phase 9's groups,
#: then the scans' backward kernels before their forward ones (a backward's
#: name holds its forward's but for ``bwd``)
RECURRENT_STEP_GROUPS = STEP_KERNEL_GROUPS + (
    ("scan backward", ("linear_scan_bwd_kernel", "mlstm_bwd_",
                       "slstm_scan_bwd_kernel")),
    ("scan forward", ("linear_scan_kernel", "mlstm_scan_kernel",
                      "slstm_scan_kernel")))
#: each recurrent kind's scan
SCAN_OF_KIND = {"rglru": "linear_scan", "mlstm": "mlstm_scan",
                "slstm": "slstm_scan"}


def allocator_settings(settings: str) -> None:
    """Set the CUDA caching allocator's options for allocations from now on
    (``PYTORCH_CUDA_ALLOC_CONF``'s syntax), its cached blocks released
    first."""
    import gc
    import warnings

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    with warnings.catch_warnings():  # deprecated for an accelerator API
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(settings)


def train_layers_that_fit(cfg, rows: int, seq: int) -> int:
    """The most layers of ``cfg`` (at most the published depth) whose
    training fits on the card: the update's bytes (a parameter's and the
    largest leaf's temporaries) or the backward's beside a microbatch's
    logits, whichever is more, plus ``TRAIN_HEADROOM_BYTES``."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.layers import template_map

    total = torch.cuda.get_device_properties(0).total_memory
    logits = (rows // max(cfg.microbatch, 1)) * seq * cfg.vocab_size
    for n in range(cfg.n_layers, 0, -1):
        c = cfg.replace(n_layers=n)
        shapes = []
        template_map(shapes.append, lm.lm_template(c))
        biggest = max(math.prod(t.shape) for t in shapes)
        p = n_params_of(c)
        need = max(UPDATE_BYTES_PER_PARAM * p
                   + UPDATE_TEMP_BYTES_PER_ELEMENT * biggest,
                   BACKWARD_BYTES_PER_PARAM * p + BYTES_PER_LOGIT * logits)
        if need + TRAIN_HEADROOM_BYTES <= total:
            return n
    return 0


def expected_train_launches(cfg, steps: int, seq: int) -> dict:
    """The scan and flash launches ``steps`` training steps make, a
    microbatch: each recurrent layer's forward scan (twice under remat:
    the forward and the backward's recompute) and its backward, a call each
    a run of whole chunks (the mLSTM's ragged tail is one more); an
    attention layer's flash forward (and its recompute: its backward
    recomputes the plain loop)."""
    from repro_torch.models.transformer import layer_kinds

    passes = 1 if cfg.remat == "none" else 2
    runs = steps * max(cfg.microbatch, 1)
    want = {}
    for kind in layer_kinds(cfg):
        if kind == "attn":
            want["flash_attn"] = want.get("flash_attn", 0) + runs * passes
            continue
        name = SCAN_OF_KIND[kind]
        calls = (1 + (seq % min(cfg.mlstm_chunk, seq) != 0)
                 if kind == "mlstm" else 1)
        want[name] = want.get(name, 0) + runs * passes * calls
        want[f"{name}_bwd"] = want.get(f"{name}_bwd", 0) + runs * calls
    return want


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted paths of a parameter tree's leaves, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def recurrent_grad_gate(seed: int, arch: str) -> dict:
    """One pattern period of ``arch`` at full width in float32, one row of
    ``GRAD_GATE_TOKENS``: ``grads_and_metrics`` on the card (the scans'
    kernels, flash under autograd; TF32 off) against the CPU (the plain
    versions), leaf by leaf."""
    import numpy as np
    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import grads_and_metrics

    cfg = get_config(arch).replace(
        n_layers=GATE_LAYERS[arch], param_dtype="float32",
        compute_dtype="float32", remat="none", microbatch=0,
        attn_q_block=GRAD_GATE_BLOCK, attn_kv_block=GRAD_GATE_BLOCK)
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    row = torch.from_numpy(np.random.default_rng(seed + 41).integers(
        0, cfg.vocab_size, (1, GRAD_GATE_TOKENS + 1)))
    batch = {"tokens": row[:, :-1], "labels": row[:, 1:]}
    t0 = time.perf_counter()
    want, wm = grads_and_metrics(cfg, params, batch)
    cpu_s = time.perf_counter() - t0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        got, gm = grads_and_metrics(
            cfg, tree_map(lambda t: t.cuda(), params),
            {k: t.cuda() for k, t in batch.items()})
        got = [g.cpu() for g in leaves(got)]
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    g_max = max(float(w.abs().max()) for w in leaves(want))
    names = _leaf_names(params)
    errs = []
    for name, g, w in zip(names, got, leaves(want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{arch} gradient gate: {name} not finite")
        errs.append((float((g - w).abs().max()) / g_max, name))
    worst, leaf = max(errs)
    if not worst <= GRAD_GATE_TOL:
        raise AssertionError(
            f"{arch} gradient gate: leaf {leaf} differs by {worst:.3g} of "
            f"the largest gradient {g_max:.4g} (tolerance {GRAD_GATE_TOL:g})")
    return dict(layers=cfg.n_layers, tokens=GRAD_GATE_TOKENS, g_max=g_max,
                worst=worst, worst_leaf=leaf, leaves=len(names),
                loss_card=float(gm["loss"]), loss_cpu=float(wm["loss"]),
                cpu_s=cpu_s, card_s=card_s)


def recurrent_training_phase(seed: int, arch: str, rows: int, seq: int,
                             kernels) -> dict:
    """``Trainer`` at ``arch``'s published configuration (its depth cut
    only where the training state does not fit), random weights from
    ``seed``, AdamW, ``RECURRENT_TRAIN_STEPS`` steps of ``rows`` x ``seq``
    tokens of the DEB-like corpus: step ms, tokens/s, peak GB, loss and
    grad norm a step (finite), and every scan kernel's forward and
    backward launches equal to what the model makes (the counts set to 0
    just before the run and read just after); one more step traced by
    kernel group; the model freed, then the gradient gate."""
    import gc

    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, TokenLoader, load_dataset
    from repro_torch.train import LoopConfig, OptConfig, Trainer

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.n_layers
    cfg = cfg.replace(n_layers=train_layers_that_fit(cfg, rows, seq))
    loader = TokenLoader(load_dataset("DEB", 16),
                         LoaderConfig(batch_size=rows, seq_len=seq))
    opt = OptConfig(lr=3e-4, warmup_steps=1,
                    total_steps=RECURRENT_TRAIN_STEPS)
    trainer = Trainer(cfg, opt, LoopConfig(total_steps=RECURRENT_TRAIN_STEPS,
                                           log_every=0), loader, None,
                      device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    params, opt_state = trainer.run(
        torch.Generator(device="cuda").manual_seed(seed),
        steps=RECURRENT_TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in leaves(params))
    trace = traced_step(trainer, params, opt_state, RECURRENT_TRAIN_STEPS,
                        RECURRENT_STEP_GROUPS)
    hist = trainer.history
    del params, opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if len(hist) != RECURRENT_TRAIN_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist):
        raise AssertionError(f"{arch}: training steps not finite: {hist}")
    want = expected_train_launches(cfg, RECURRENT_TRAIN_STEPS, seq)
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{arch}: kernel launches {got} in "
                             f"{RECURRENT_TRAIN_STEPS} steps, the model "
                             f"makes {want}")
    gate = recurrent_grad_gate(seed, arch)
    return dict(arch=arch, layers=cfg.n_layers, published_layers=published,
                params=n_params, rows=rows, seq=seq,
                microbatch=cfg.microbatch, remat=cfg.remat, steps=hist,
                train_s=train_s, step_ms=[h["dt"] * 1e3 for h in hist],
                tokens_per_s=[rows * seq / h["dt"] for h in hist],
                peak_gb=peak_gb, launches=launches, trace=trace, gate=gate,
                s=time.perf_counter() - t_phase)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write every measured number to this file")
    ap.add_argument("--restart-check", metavar="DIR", default=None,
                    help="run only phase 9's restart check on the tokens in "
                         "DIR/unique.npy and write DIR/restart.json (phase 9 "
                         "starts the script so, in a child process)")
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
    if args.restart_check:
        import numpy as np

        unique = np.load(os.path.join(args.restart_check, "unique.npy"))
        out = restart_check(args.seed, unique)
        with open(os.path.join(args.restart_check, "restart.json"), "w") as f:
            json.dump(out, f)
        return 0

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
    for k in built:  # ptxas -v: a function's stack, spills and registers
        fn = ""
        for line in k.build_log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "Used" in line or "spill" in line:
                log(f"  {k.name} {fn}: {line.strip()}")

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
            plain = ("not run" if r["plain_ms"] is None
                     else f"{r['plain_ms']:.4f} ms")
            log(f"kernel {name} {label}: bit-equal to "
                f"{r.get('held', 'plain')} (max_abs_err "
                f"{r['max_abs_err']}), {r['ms']:.4f} ms ({r['ms_source']}; "
                f"{r['call_ms']:.4f} ms per call), plain {plain}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        split = sum(res[k]["ms"] for k in ("seqcdc_masks",
                                           "select_boundaries",
                                           "fingerprint"))
        log(f"split path {label}: masks + select + fingerprint kernels "
            f"{split:.4f} ms against the fused kernel "
            f"{res['fused_pipeline']['ms']:.4f} ms")
    adversarial = fused_adversarial_phase(p, 8, 1 << 20, args.seed)
    measured["1MiBx8 adversarial"] = adversarial
    for label, r in adversarial.items():
        log(f"kernel fused_pipeline 1MiBx8 {label} ({r['chunks']} chunks): "
            f"bit-equal to plain (max_abs_err {r['max_abs_err']}), "
            f"{r['ms']:.4f} ms ({r['ms_source']}; {r['call_ms']:.4f} ms per "
            f"call), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    packed = packed_phase(p, 8, 16 << 10, args.seed)
    measured["16KiBx8 packed"] = packed
    sel_packed = select_packed_phase(p, 8, 16 << 10, args.seed)
    measured["16KiBx8 select packed"] = sel_packed
    # the same kernel on one 1 KiB row holding one segment shorter than
    # min_size (no walk: the kernel's own floor) and on 8 rows of 64 KiB
    # from the heavy-tail draw (segments below the row, walks up to 64 KiB)
    import numpy as np

    trivial = (np.random.default_rng(args.seed).integers(
        0, 256, (1, 1024), dtype=np.uint8),
        np.full((1, 4), 1000, np.int32))
    sel_packed_more = select_packed_phase(
        p, 8, 64 << 10, args.seed, rows={
            "floor 1x1KiB": trivial,
            "64KiBx8 heavy-tail": packed_rows(
                np.random.default_rng(args.seed), "heavy-tail<16KiB", 8,
                64 << 10)[:2]})
    measured["select packed floor and 64KiBx8"] = sel_packed_more
    sel_packed_kernel = next(k for k in KERNELS
                             if k.name == "select_boundaries_packed")
    ptxas = [line.strip() for line in sel_packed_kernel.build_log.splitlines()
             if "Used" in line or "spill" in line]  # -Xptxas -v
    for line in ptxas or ["not built in this run (its library was built)"]:
        log(f"kernel select_boundaries_packed ptxas: {line}")
    for mix, r in list(sel_packed.items()) + list(sel_packed_more.items()):
        log(f"kernel select_boundaries_packed "
            f"{'' if mix in sel_packed_more else '16KiBx8 '}{mix} (G "
            f"{r['G']}, mc {r['mc']}, {r['chunks']} chunks): bit-equal to "
            f"plain and to the packed kernel's bounds and counts (also at mc "
            f"{r['short_mc']}, emits dropped), {r['ms']:.4f} ms "
            f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
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
    launched = launched_phase(args.seed)
    measured["launched"] = launched
    steps_rows = dict(reg["steps"], **{"16 MiB gear row": launched.pop(
        "steps gear row")})
    for name, r in launched.items():
        clock = ""
        if "calls_ms" in r:
            clock = (f"; SM {r['sm_mhz']:.0f} MHz, {r['cycles_per_byte']:.2f} "
                     f"cycles a byte" if r["sm_mhz"] else
                     "; SM clock not sampled") + ", calls " + ", ".join(
                f"{t:.2f}" for t in r["calls_ms"]) + " ms"
        check = ("bit-equal to its pair's vectorized chunker"
                 if name.startswith("native") else
                 "bit-equal to its plain version"
                 if name.startswith("seqcdc_masks") else
                 "bit-equal to the fused kernel's bounds"
                 if "seqcdc" in name else "bit-equal to select_numpy")
        chunks = (f", {r['chunks']} chunks" if r["chunks"] is not None
                  else "")
        log(f"kernel {name} at its launched size ({r['shape']}"
            f"{chunks}): {check}, {r['ms']:.4f} ms "
            f"({r['ms_source']}){clock}, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    for label, st in steps_rows.items():
        for step, r in st["kernels"].items():
            log(f"kernel select_boundaries_{step} ({r['shape']}, "
                f"{r['chunks']} chunks): bit-equal to the wide select "
                f"kernel, {r['ms']:.4f} ms ({r['ms_source']}; "
                f"{r['call_ms']:.4f} ms per call), bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']}); the wide select "
                f"kernel {st['ms']:.4f} ms ({st['ms_source']}; "
                f"{st['call_ms']:.4f} ms per call)")
            log(f"  chain {step} {label}: {chain_text(r['chain'])}")
    for label in shapes:
        for step in ("gather", "event"):
            log(f"  chain {step} {label}: "
                + chain_text(measured[label][f"select_boundaries_{step}"]
                             ["chain"]))
    for step in ("gather", "event"):
        log(f"  chain {step} 1 MiB gear row: "
            + chain_text(reg[f"select_boundaries_{step} gear row"]["chain"]))
    fl = flash_phase(args.seed)
    measured["flash"] = fl
    for name, r in fl.items():
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "not measured (no enable_gqa)")
        log(f"kernel flash_attn {name} ({r['shape']}): max_abs_err "
            f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}, "
            f"{r['tol_used']:.3f} of it used; largest output "
            f"{r['max_abs_want']:.3g}), "
            f"{r['ms']:.4f} ms ({r['ms_source']}; {r['call_ms']:.4f} ms per "
            f"call), plain {r['plain_ms']:.4f} ms, SDPA {lib}, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}: {r['gflop']:.2f} "
            f"GFLOP, {r['mbytes']:.2f} MB)")
    scans = scan_phase(args.seed)
    measured["scans"] = scans
    for name, r in scans.items():
        drift = ("" if "plain_f32_err" not in r else
                 "; the float32 plain version's own error against float64 "
                 + ", ".join(f"{k} {v:.3g}"
                             for k, v in r["plain_f32_err"].items()))
        log(f"kernel {name} ({r['shape']}): max_abs_err "
            f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}, "
            f"{r['tol_used']:.3f} of it used{drift}), {r['ms']:.4f} ms "
            f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
            f"{r['plain_ms']:.4f} ms, no library call, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    scans_bwd = scan_bwd_phase(args.seed)
    measured["scans_bwd"] = scans_bwd
    for name, r in scans_bwd.items():
        drift = ("" if "plain_f32_err" not in r else
                 "; the float32 plain loop's own error against float64 "
                 "autograd " + ", ".join(
                     f"{k} {v:.3g}" for k, v in r["plain_f32_err"].items()))
        if "plan" in r:
            log(f"kernel {name}: {r['plan']['clusters']} clusters of "
                f"{r['plan']['C']} CTAs ({r['plan']['R']} batch rows a "
                f"cluster, {r['plan']['threads']} threads a CTA) launched, "
                f"cudaOccupancyMaxActiveClusters "
                f"{r['plan']['max_active_clusters']}")
        log(f"kernel {name} ({r['shape']}): max_abs_err "
            f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}, "
            f"{r['tol_used']:.3f} of it used{drift}), {r['ms']:.4f} ms "
            f"({r['ms_source']}; {r['call_ms']:.4f} ms per call), plain "
            f"{r['plain_ms']:.4f} ms, no library call, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
        if "dr_ms" in r:
            log(f"kernel {name}: the call's dr product " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in r["dr_ms"].items()))
    from repro_torch.kernels import flash_attn as kflash

    sass = tensor_core_sass(kflash.KERNEL)
    hmma = {body: sum(c for f, c in sass.items()
                      if f"flash_attn_{body}_kernel" in f)
            for body in ("bf16", "f32")}
    log(f"flash_attn SASS (cuobjdump -sass): {hmma['bf16']} tensor-core "
        f"instructions (HMMA/HGMMA) in the bfloat16 kernels, "
        f"{hmma['f32']} in the float32 ones")
    if hmma["bf16"] == 0:
        raise AssertionError("the bfloat16 flash kernels issue no "
                             "tensor-core instruction")
    from repro_torch.kernels import (
        extremum,
        fingerprint,
        flash_attn,
        fused_pipeline,
        gear_hash,
        linear_scan,
        mlstm_scan,
        native_scan,
        packed_pipeline,
        select_boundaries,
        select_boundaries_event,
        select_boundaries_gather,
        select_boundaries_packed,
        seqcdc_masks,
        slstm_scan,
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
    # version 0 again through the split pipeline, once a step
    svc_steps = service_steps_phase(p, OBJECTS, args.seed, svc["v0_sha256"],
                                    KERNELS)
    for step, r in svc_steps.items():
        log(f"service, split pipeline, step_impl={step!r}, version 0: "
            f"recipes equal to the main run's; ingest {r['ingest_mb_s']:.2f} "
            f"MB/s ({r['ingest_s']:.2f} s for {r['logical_bytes']} bytes, of "
            f"which cross-check replays {r['cross_check_s']:.2f} s; "
            f"{r['ingest_mb_s_without_cross_checks']:.2f} MB/s without "
            f"them), dispatches {r['dispatches']}, launches "
            f"{({k: v for k, v in r['launches'].items() if v})}")
    for step, k in (("wide", select_boundaries.KERNEL),
                    ("gather", select_boundaries_gather.KERNEL),
                    ("event", select_boundaries_event.KERNEL)):
        if svc_steps[step]["launches"][k.name] == 0:
            raise AssertionError(f"the split service with step_impl="
                                 f"{step!r} never launched {k.name}")

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
    # the tree's first version again through the split pipeline: its packed
    # rows through the masks, packed select and fingerprint kernels
    sh_split = sharded_phase(p, args.seed, KERNELS, verify=False,
                             pipeline_impl="split", versions=1)
    if sh_split["version_sha256"][0] != sh["version_sha256"][0]:
        raise AssertionError("the split pipeline's recipes of version 0 "
                             "differ from the fused pipeline's")
    path5 = (seqcdc_masks.KERNEL, fingerprint.KERNEL,
             select_boundaries_packed.KERNEL)
    missing = [k.name for k in path5 if sh_split["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the sharded "
                             f"service's split pipeline: {missing}")
    log(f"sharded, split pipeline, version 0 again: recipes equal to the "
        f"fused run's (sha256 {sh_split['version_sha256'][0][:16]}); ingest "
        f"{sh_split['ingest_mb_s']:.2f} MB/s ({sh_split['ingest_s']:.2f} s "
        f"for {sh_split['logical_bytes']} bytes, cross-check replays "
        f"{sh_split['cross_check_s']:.2f} s) against the fused run's "
        f"{sh['version_mb_s'][0]:.2f} MB/s for version 0 "
        f"({sh['ingest_mb_s']:.2f} over all versions); dispatches "
        f"{sh_split['dispatches']}, packed streams "
        f"{sh_split['packed_streams']}, device dispatches "
        f"{sh_split['dispatch_s']:.3f} s; launches "
        f"{({k: v for k, v in sh_split['launches'].items() if v})}")

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
    ch = rg["chunkers"]
    log(f"registry: seqcdc's automaton steps over {ch['seqcdc']['bytes']} "
        f"bytes, bounds equal to wide's: wide {ch['seqcdc']['gb_s']:.4f} "
        f"GB/s, gather {ch['seqcdc[gather]']['gb_s']:.4f} GB/s, event "
        f"{ch['seqcdc[event]']['gb_s']:.4f} GB/s")
    path6 = (gear_hash.KERNEL, select_boundaries.KERNEL, native_scan.KERNEL,
             seqcdc_masks.KERNEL, select_boundaries_gather.KERNEL,
             select_boundaries_event.KERNEL)
    missing = [k.name for k in path6 if rg["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the chunker "
                             f"registry: {missing}")
    # 7. LM serving at full llama3.2-1b width
    sv = serving_phase(args.seed, KERNELS)
    log(f"serving: llama3.2-1b full width, {sv['params']} parameters "
        f"(bf16, init {sv['init_s']:.2f} s), {len(SERVE_PROMPTS)} requests "
        f"on {SERVE_SLOTS} slots, {sv['tokens']} tokens in "
        f"{sv['wall_s']:.3f} s, peak {sv['peak_gb']:.2f} GB")
    log("serving: prefill ms by prompt length: " + ", ".join(
        f"{n}: " + "/".join(f"{t:.2f}" for t in ts)
        for n, ts in sv["prefill_ms"].items())
        + f"; prefill {sv['prefill_tok_s']:.1f} prompt tokens/s")
    log(f"serving: decode {sv['decode_tok_s']:.2f} tokens/s "
        f"({sv['decode_tokens']} tokens in {sv['decode_steps']} steps, "
        f"{sv['decode_ms_per_step']:.3f} ms a step); launches "
        f"{sv['launches']}")
    log(f"serving: device busy share {sv['busy_share']:.4f} "
        f"({sv['busy_note']}) over the run's {sv['busy_steps']} "
        f"decode-only steps after the first (4 slots, 2,050-4,127 tokens "
        f"of context; {sv['busy_step_ms']:.3f} ms a step untraced, "
        f"{sv['busy_device_ms_per_step']:.3f} device ms, "
        f"{sv['busy_kernels_per_step']:.1f} kernels traced and "
        f"{sv['busy_launches_per_step']:.1f} launched a step in a replay)")
    for dt, r in sv["logits"].items():
        log(f"serving: 2048-token last-token logits, flash vs materialised "
            f"route, {dt}: max_abs_err {r['max_abs_err']:.4g} (tolerance "
            f"{r['tolerance']}; largest logit {r['max_abs_logit']:.3f}), "
            f"argmax {r['argmax'][0]} == {r['argmax'][1]}, top-2 gap "
            f"{r['top2_gap']:.4f}")
    from repro_torch.configs import get_config

    llama = get_config("llama3.2-1b")  # 16 layers, attn_kv_block 1024
    want_flash = sum(n > llama.attn_kv_block
                     for n in SERVE_PROMPTS) * llama.n_layers
    if sv["launches"][flash_attn.KERNEL.name] != want_flash:
        raise AssertionError(
            f"flash kernel launched {sv['launches'][flash_attn.KERNEL.name]} "
            f"times while serving, not {want_flash}")
    # 8. the scenarios through the service on the card
    sc = scenario_phase(KERNELS)
    for label, runs in (("quick", sc["quick"]),
                        (SCENARIO_TIMED_BUDGET, sc["timed"])):
        for name, r in runs.items():
            rate = "" if label == "quick" else (
                f"; {r['runs']} runs, median (range) ingest "
                f"{r['ingest_mb_s']:.2f} MB/s ({r['ingest_mb_s_range'][0]:.2f}"
                f"-{r['ingest_mb_s_range'][1]:.2f}) over a "
                f"{r['ingest_window_s']:.2f} s window, restore "
                f"{r['restore_mb_s']:.2f} MB/s ({r['restore_mb_s_range'][0]:.2f}"
                f"-{r['restore_mb_s_range'][1]:.2f}) over "
                f"{r['restore_window_s']:.2f} s")
            log(f"scenario {name} ({label} budget, {r['objects']} objects, "
                f"{r['bytes']} bytes, corpus sha256 {r['digest'][:16]}): "
                f"dedup ratio {r['dedup_ratio']!r}, "
                f"compressed ratio {r['compressed_ratio']!r}, chunks "
                f"{r['chunks']} ({r['unique_chunks']} unique){rate}")
    log("scenario ratios at the quick budget equal BENCH_quick.json's")
    for mode, r in sc["occupancy"].items():
        log(f"all-tiny occupancy, packing {mode}: {r['occupancy']!r} "
            f"({r['streams']} streams, {r['dispatches']} dispatches, "
            f"{r['packed_streams']} packed, {r['s']:.2f} s); pin "
            f"{OCCUPANCY[mode]!r}")
    log(f"scenarios: {sc['s']:.1f} s; launches {sc['launches']}")
    path8 = (fused_pipeline.KERNEL, packed_pipeline.KERNEL)
    missing = [k.name for k in path8 if sc["launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the scenario "
                             f"phase: {missing}")

    # 9. the dedup data pipeline and training at full llama3.2-1b width
    tr = training_phase(args.seed, KERNELS)
    ing = tr["ingest"]
    log(f"DedupIngest (DEB-like corpus, {ing['bytes']} bytes, avg 8192, "
        f"1 MiB segments x 8): median {ing['mb_s']:.2f} MB/s (range "
        f"{ing['mb_s_range'][0]:.2f}-{ing['mb_s_range'][1]:.2f}) over "
        f"{ing['passes']} passes in a {ing['window_s']:.2f} s window, "
        f"savings {ing['savings']:.4f}, {ing['unique_bytes']} unique bytes; "
        f"the first {INGEST_CHECK_MB} MiB's unique bytes sha256 "
        f"{ing['head_sha256'][:16]} on the card and on the CPU "
        f"({ing['cpu_head_s']:.2f} s there); launches {tr['ingest_launches']}")
    path9a = (seqcdc_masks.KERNEL, select_boundaries.KERNEL,
              fingerprint.KERNEL)
    missing = [k.name for k in path9a if tr["ingest_launches"][k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by DedupIngest: "
                             f"{missing}")
    t9 = tr["train"]
    log(f"training: llama3.2-1b full width and depth, {t9['params']} "
        f"parameters, bf16, remat full, microbatch 4, AdamW, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps in "
        f"{t9['s']:.2f} s (init included), peak {t9['peak_gb']:.2f} GB")
    for h, tok_s in zip(t9["steps"], t9["tokens_per_s"]):
        log(f"training step {h['step']}: {h['dt'] * 1e3:.1f} ms, "
            f"{tok_s:.0f} tokens/s, loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, lr {h['lr']:.3g}")
    tt = tr["train_trace"]
    log(f"training: one more step traced: {tt['wall_ms']:.1f} ms, device "
        f"{tt['device_ms']:.1f} ms in {tt['kernels']} kernels (busy share "
        f"{tt['busy_share']:.4f}): " + ", ".join(
            f"{g} {v:.1f} ms" for g, v in tt["groups_ms"].items()))
    for ms, count, name in tt["top"]:
        log(f"training: traced step kernel {ms:.1f} ms in {count} launches: "
            f"{name[:120]}")
    log(f"training: flash launches {t9['flash_launches']} (expected "
        f"{t9['flash_launches_expected']}: forward and remat recompute); "
        f"launches {tr['train_launches']}")
    rs = tr["restart"]
    log(f"restart: {rs['layers']} layers at full width, {RESTART_STEPS} "
        f"steps, a checkpoint every {RESTART_EVERY} (SeqCDC chunks of avg "
        f"{CHECKPOINT_AVG} bytes on the card), deterministic "
        f"algorithms: resumed at step {rs['first_step']}, final parameters "
        f"and optimizer state bit-equal to the unbroken run "
        f"({rs['s']:.1f} s); losses {rs['losses_full']} / "
        f"{rs['losses_resumed']}")
    log(f"restart: state {rs['state_bytes']} bytes; save "
        f"{rs['save_mb_s']:.2f} MB/s over {len(rs['save_s'])} saves ("
        + ", ".join(f"{t:.2f}" for t in rs["save_s"])
        + f" s), restore {rs['restore_mb_s']:.2f} MB/s ("
        + ", ".join(f"{t:.2f}" for t in rs["restore_s"])
        + f" s); the store's chunker alone on the largest leaf "
        f"({rs['chunk_leaf_bytes']} bytes, host copy included) "
        f"{rs['chunk_leaf_bytes'] / rs['chunk_s'] / 1e6:.2f} MB/s; "
        f"checkpoint dedup savings {rs['dedup_savings']:.4f}; "
        f"determinism warnings {rs['deterministic_warnings']} (a child "
        f"process with CUBLAS_WORKSPACE_CONFIG=:4096:8)")
    log(f"phase 9: {tr['s']:.1f} s")
    if t9["flash_launches"] == 0:
        raise AssertionError("training never launched the flash kernel")

    # 10. the recurrent and hybrid families served at full width
    rec = {}
    for arch in RECURRENT_ARCHS:
        r = rec[arch] = recurrent_serving_phase(args.seed, arch, KERNELS)
        log(f"serving {arch}: published size, {r['params']} parameters "
            f"(bf16, init {r['init_s']:.2f} s), {len(RECURRENT_PROMPTS)} "
            f"requests on {SERVE_SLOTS} slots, cache {RECURRENT_CACHE}, "
            f"{r['tokens']} tokens in {r['wall_s']:.3f} s, peak "
            f"{r['peak_gb']:.2f} GB")
        log(f"serving {arch}: prefill ms by prompt length: " + ", ".join(
            f"{n}: " + "/".join(f"{t:.2f}" for t in ts)
            for n, ts in r["prefill_ms"].items())
            + f"; prefill {r['prefill_tok_s']:.1f} prompt tokens/s")
        log(f"serving {arch}: decode {r['decode_tok_s']:.2f} tokens/s "
            f"({r['decode_tokens']} tokens in {r['decode_steps']} steps, "
            f"{r['decode_ms_per_step']:.3f} ms a step); launches of flash "
            f"and the scans {r['expected_launches']} (as the prefills must "
            f"make them); decode state {r['state_bytes_per_slot']} bytes a "
            f"slot at cache {RECURRENT_CACHE} and at twice it")
        log(f"serving {arch}: device busy share {r['busy_share']:.4f} "
            f"({r['busy_note']}) over the run's {r['busy_steps']} "
            f"decode-only steps after the first ({r['busy_step_ms']:.3f} ms "
            f"a step untraced, {r['busy_device_ms_per_step']:.3f} device "
            f"ms, {r['busy_kernels_per_step']:.1f} kernels traced and "
            f"{r['busy_launches_per_step']:.1f} launched a step in a "
            f"replay)")
        g = r["gate"]
        log(f"serving {arch}: decode equals forward at {g['layers']} layers "
            f"(one pattern period), full width: {GATE_PROMPT}-token prefill "
            f"and {GATE_STEPS} greedy steps, argmax equal at {g['equal']} of "
            f"{len(g['steps'])} positions"
            + ("" if g["equal"] == len(g["steps"]) else " (near-ties elsewhere)")
            + f", max_abs_err "
            f"{g['max_abs_err']:.4g} (tolerance {g['tolerance']}); forward "
            f"attention in query blocks of {g['q_block']}; the forward's "
            f"top-2 gaps " + ", ".join(f"{st['top2_gap']:.4f}"
                                       for st in g["steps"]))

    # 11. the dense family, the embedding modes and MoE at full width
    fam = {}
    t11 = time.perf_counter()
    for arch in FAMILY_TOKEN_ARCHS + FAMILY_EMBED_ARCHS:
        t_arch = time.perf_counter()
        r = fam[arch] = family_phase(args.seed, arch, KERNELS)
        log_family(arch, r)
        log(f"family {arch}: {time.perf_counter() - t_arch:.1f} s")
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # 12. MLA: deepseek-v3-671b at published width, absorbed decode
    t12 = time.perf_counter()
    ds = mla_phase(args.seed, KERNELS)
    log_family(MLA_ARCH, ds)
    log(f"mla {MLA_ARCH}: {ds['layers']} of {ds['published_layers']} "
        f"layers ({ds['kinds'].count('mla_dense')} mla_dense, "
        f"{ds['kinds'].count('mla_moe')} mla_moe: the deepest that fits "
        f"beside the cache); decode state {ds['state_bytes_per_slot']} "
        f"bytes a slot = {ds['layers']} layers x {ds['cache_len']} x "
        f"{ds['latent_per_token']} x 2 (the latent cache only); decode "
        f"{ds['decode_ms_per_step']:.3f} ms a step against the bound of a "
        f"step that reads every expert, {ds['experts_gb_per_step']:.2f} GB "
        f"at 3.35 TB/s: {ds['experts_bound_ms']:.3f} ms; no hand-written "
        f"kernel launched (MLA takes no flash route)")
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # 13. distribution on one card
    t13 = time.perf_counter()
    from repro_torch.roofline import constants as roofline_constants

    log(f"distribution: {card}: total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} bytes (the "
        f"roofline's CHIP_HBM_BYTES {roofline_constants.CHIP_HBM_BYTES})")
    rt = route_phase(args.seed)
    u, k = rt["uniform"], rt["skewed"]
    log(f"distribution (a): routed_fp_tables over {ROUTE_SHARDS} shards of "
        f"cuda:0, {u['records']} records (tables {u['tables_shape']}): "
        f"bit-equal to the CPU mesh's, overflow 0, {u['routed_ms']:.3f} ms; "
        f"distributed_dedup {u['dedup_ms']:.3f} ms, stats {u['stats']} equal "
        f"to dedup_stats ({u['stats_ms']:.3f} ms); skewed batch of "
        f"{k['records']} records: overflow {k['overflow']} on the card and "
        f"the CPU, tables bit-equal")
    from repro_torch.launch.mesh import make_host_mesh

    mesh_sh = sharded_phase(p, args.seed, KERNELS,
                            mesh=make_host_mesh(shards=SHARDS), verify=False)
    for key in ("recipes_sha256", "stored_bytes", "fp_estimated_savings",
                "shard_stored_bytes"):
        if mesh_sh[key] != sh[key]:
            raise AssertionError(f"mesh= ingest {key} {mesh_sh[key]!r} != the "
                                 f"host route's {sh[key]!r}")
    if mesh_sh["launches"][fused_pipeline.KERNEL.name] == 0:
        raise AssertionError("the mesh= ingest never launched the fused "
                             "pipeline kernel")
    log(f"distribution (b): phase 5's tree through ShardedDedupService("
        f"mesh=make_host_mesh(shards={SHARDS})): recipes sha256 "
        f"{mesh_sh['recipes_sha256'][:16]}, stored {mesh_sh['stored_bytes']} "
        f"bytes, fp_estimated_savings {mesh_sh['fp_estimated_savings']!r}, "
        f"all equal to the host route's; overflow_rerouted "
        f"{mesh_sh['overflow_rerouted']}; ingest {mesh_sh['ingest_mb_s']:.2f} "
        f"MB/s against phase 5's {sh['ingest_mb_s']:.2f} MB/s; launches "
        f"{mesh_sh['launches']}")
    pc = prefill_count_phase(args.seed)
    pre = sv["prefill_ms"][4096]
    log(f"distribution (c): op counter on llama3.2-1b's 4,096-token prefill "
        f"at full width: {pc['flops']:.4e} FLOPs ({pc['aten_flops']:.4e} in "
        f"{pc['ops']} aten ops, {pc['flash_flops']:.4e} in the flash "
        f"kernel), {pc['bytes']:.4e} bytes (unfused: each op's operands and "
        f"outputs), H100 bound {pc['bound_ms']:.3f} ms (compute "
        f"{pc['compute_ms']:.3f}, memory {pc['memory_ms']:.3f}) against "
        f"phase 7's prefill of 4,096 tokens " + "/".join(
            f"{t:.2f}" for t in pre) + " ms; largest: " + ", ".join(
            f"{n} {f:.3e}" for n, f in pc["top"]))
    dr = dryrun_cell_phase()
    log(f"distribution (d): dry-run cell llama3.2-1b x decode_32k "
        f"pod16x16: {dr['status']} in {dr['elapsed_s']} s, "
        f"flops/dev {dr['flops_per_device']:.4e}, bytes/dev "
        f"{dr['bytes_per_device']:.4e}, collective bytes/dev "
        f"{dr['collective_bytes_per_device']:.4e}, t_compute "
        f"{dr['t_compute']:.4e} s, t_memory {dr['t_memory']:.4e} s, "
        f"t_collective {dr['t_collective']:.4e} s, bottleneck "
        f"{dr['bottleneck']}, fallbacks {dr['fallbacks']}")
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # 14. the recurrent families trained at published width, their
    # allocations in expandable segments: the earlier phases leave the
    # caching allocator's pool fragmented (recurrentgemma-2b's first step
    # ran out of memory with 30.3 GB reserved but unallocated)
    t14 = time.perf_counter()
    rtrain = {}
    allocator_settings("expandable_segments:True")
    for arch, rows, seq in RECURRENT_TRAIN:
        r = rtrain[arch] = recurrent_training_phase(args.seed, arch, rows,
                                                    seq, KERNELS)
        cut = ("nothing cut" if r["layers"] == r["published_layers"] else
               f"depth cut to {r['layers']} of {r['published_layers']} "
               f"layers (the deepest whose training fits)")
        log(f"training {arch}: published width, {cut}; {r['params']} "
            f"parameters, bf16, remat {r['remat']}, microbatch "
            f"{r['microbatch']}, AdamW, batch {rows} x {seq}, "
            f"{RECURRENT_TRAIN_STEPS} steps in {r['train_s']:.2f} s (init "
            f"included), peak {r['peak_gb']:.2f} GB; {card}")
        for h, tok_s in zip(r["steps"], r["tokens_per_s"]):
            log(f"training {arch} step {h['step']}: {h['dt'] * 1e3:.1f} ms, "
                f"{tok_s:.0f} tokens/s, loss {h['loss']:.4f}, grad norm "
                f"{h['grad_norm']:.4f}, lr {h['lr']:.3g}")
        tt = r["trace"]
        log(f"training {arch}: one more step traced: {tt['wall_ms']:.1f} ms, "
            f"device {tt['device_ms']:.1f} ms in {tt['kernels']} kernels "
            f"(busy share {tt['busy_share']:.4f}): " + ", ".join(
                f"{g} {v:.1f} ms" for g, v in tt["groups_ms"].items()))
        for ms, count, name in tt["top"][:5]:
            log(f"training {arch}: traced step kernel {ms:.1f} ms in {count} "
                f"launches: {name[:120]}")
        log(f"training {arch}: launches {({k: v for k, v in r['launches'].items() if v})} "
            f"(as the model makes them: layers of each kind x microbatches, "
            f"forward twice under remat)")
        g = r["gate"]
        log(f"training {arch}: gradient gate at {g['layers']} layers (one "
            f"pattern period), full width, float32, 1 x {g['tokens']} "
            f"tokens: card (kernels) against CPU (plain versions), worst "
            f"leaf {g['worst_leaf']} at {g['worst']:.3g} of the largest "
            f"gradient {g['g_max']:.4g} (tolerance {GRAD_GATE_TOL:g}) over "
            f"{g['leaves']} leaves; loss {g['loss_card']:.6f} / "
            f"{g['loss_cpu']:.6f}; card {g['card_s']:.2f} s, CPU "
            f"{g['cpu_s']:.2f} s")
    dr = scans_bwd["slstm_scan_bwd S2048"]
    log(f"training xlstm-125m: the sLSTM backward's dr product at its shape "
        f"({dr['shape']}, phase 3): the float32 sum (before) "
        f"{dr['dr_ms']['float32 sum']:.4f} ms, the float64 sum (now) "
        f"{dr['dr_ms']['float64 sum']:.4f} ms a call; {card}")
    allocator_settings("expandable_segments:False")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "repro."))
              or m == "repro"]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # 15. the kernels line and the result
    row_of = {
        linear_scan.BWD_KERNEL: (scans_bwd["linear_scan_bwd T4096"]["shape"],
                                 scans_bwd["linear_scan_bwd T4096"]),
        mlstm_scan.BWD_KERNEL: (scans_bwd["mlstm_scan_bwd 8 chunks"]["shape"],
                                scans_bwd["mlstm_scan_bwd 8 chunks"]),
        slstm_scan.BWD_KERNEL: (scans_bwd["slstm_scan_bwd S2048"]["shape"],
                                scans_bwd["slstm_scan_bwd S2048"]),
        packed_pipeline.KERNEL: ("16KiBx8 packed all-tiny",
                                 packed["all-tiny"]),
        select_boundaries_packed.KERNEL: ("16KiBx8 packed all-tiny",
                                          sel_packed["all-tiny"]),
        select_boundaries_gather.KERNEL: (
            "48KiBx8", measured["48KiBx8"]["select_boundaries_gather"]),
        select_boundaries_event.KERNEL: (
            "48KiBx8", measured["48KiBx8"]["select_boundaries_event"]),
        gear_hash.KERNEL: (reg["gear_hash"]["shape"], reg["gear_hash"]),
        extremum.KERNEL: (reg["block_max"]["shape"], reg["block_max"]),
        native_scan.KERNEL: (reg["native_scan"]["seqcdc"]["shape"],
                             reg["native_scan"]["seqcdc"]),
        flash_attn.KERNEL: (fl["S4096 bf16"]["shape"], fl["S4096 bf16"]),
        linear_scan.KERNEL: (scans["linear_scan T4096"]["shape"],
                             scans["linear_scan T4096"]),
        mlstm_scan.KERNEL: (scans["mlstm_scan 16 chunks"]["shape"],
                            scans["mlstm_scan 16 chunks"]),
        slstm_scan.KERNEL: (scans["slstm_scan S4096"]["shape"],
                            scans["slstm_scan S4096"]),
    }
    errs = {
        packed_pipeline.KERNEL: [m["max_abs_err"] for m in packed.values()],
        select_boundaries_packed.KERNEL: [
            m["max_abs_err"] for m in list(sel_packed.values())
            + list(sel_packed_more.values())],
        select_boundaries.KERNEL: [
            reg["select_boundaries gear row"]["max_abs_err"],
            launched["select_boundaries seqcdc row"]["max_abs_err"]],
        **{k: [reg[f"{k.name} gear row"]["max_abs_err"]]
           + [st["kernels"][step]["max_abs_err"]
              for st in steps_rows.values()]
           for step, k in (("gather", select_boundaries_gather.KERNEL),
                           ("event", select_boundaries_event.KERNEL))},
        native_scan.KERNEL: [m["max_abs_err"]
                             for m in reg["native_scan"].values()],
        flash_attn.KERNEL: [m["max_abs_err"] for m in fl.values()],
        fused_pipeline.KERNEL: [m["max_abs_err"]
                                for m in adversarial.values()],
        **{k: [m["max_abs_err"] for name, m in scans.items()
               if name.startswith(k.name)]
           for k in (linear_scan.KERNEL, mlstm_scan.KERNEL,
                     slstm_scan.KERNEL)},
    }
    # the times at the sizes phase 6 launches them (no plain time there:
    # the plain versions are Python loops); the gather and event select
    # kernels' on phase 3's 4 MiB rows, all-candidate row and 16 MiB gear
    # row (phase 6 times them through the chunker, by the host clock)
    launched_of = {
        native_scan.KERNEL: {a: launched[f"native_scan {a}"]["ms"]
                             for a in SCAN_ALGOS},
        select_boundaries.KERNEL: {
            r["shape"]: r["ms"] for name, r in launched.items()
            if name.startswith("select")},
        seqcdc_masks.KERNEL: {
            r["shape"]: r["ms"] for name, r in launched.items()
            if name.startswith("seqcdc_masks")},
        **{k: {st["kernels"][step]["shape"]: st["kernels"][step]["ms"]
               for st in steps_rows.values()}
           for step, k in (("gather", select_boundaries_gather.KERNEL),
                           ("event", select_boundaries_event.KERNEL))},
        flash_attn.KERNEL: {
            fl[c]["shape"]: fl[c]["ms"]
            for c in ("S4096 hd256 window 2048 bf16", "S4096 hd128 32/8 bf16",
                      "S4096 hd128 56/8 bf16", "S4096 hd128 40/10 bf16",
                      "S4096 hd128 64/8 bf16", "S4096 hd128 32/4 bf16",
                      "S4096 hd64 32/32 bf16")},
        **{k: {r["shape"]: r["ms"] for name, r in scans.items()
               if name.startswith(k.name)}
           for k in (linear_scan.KERNEL, mlstm_scan.KERNEL,
                     slstm_scan.KERNEL)},
    }
    rows = []
    for k in KERNELS:
        shape, r = row_of.get(k, ("1MiBx8", measured["1MiBx8"].get(k.name)))
        err = max(errs.get(k, []) + [r["max_abs_err"]] + [
            measured[s][k.name]["max_abs_err"] for s in shapes
            if k.name in measured[s]])
        launches = (path3[k.name] + svc["launches"][k.name]
                    + sum(r["launches"][k.name] for r in svc_steps.values())
                    + sh["launches"][k.name] + sh_split["launches"][k.name]
                    + rg["launches"][k.name]
                    + sv["launches"][k.name] + sc["launches"][k.name]
                    + tr["ingest_launches"][k.name]
                    + tr["train_launches"][k.name]
                    + sum(r["launches"][k.name] for r in rec.values())
                    + sum(r["launches"][k.name] for r in fam.values())
                    + ds["launches"][k.name]
                    + mesh_sh["launches"][k.name]
                    + sum(r["launches"][k.name] for r in rtrain.values()))
        if launches == 0:
            raise AssertionError(f"kernel {k.name} never launched")
        rows.append(dict(
            name=k.name, route="cuda",
            source=os.path.relpath(k.source, ROOT),
            replaces=k.replaces, launches=launches, max_abs_err=err,
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=shape, ms_source=r["ms_source"], call_ms=r["call_ms"],
            **({"launched": launched_of[k]} if k in launched_of else {}),
        ))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=measured,
                           service=svc, service_steps=svc_steps, sharded=sh,
                           sharded_split=sh_split,
                           registry=rg,
                           serving=sv, scenarios=sc, training=tr,
                           recurrent=rec, family=fam, mla=ds,
                           recurrent_training=rtrain,
                           distribution=dict(route=rt, mesh_ingest=mesh_sh,
                                             prefill_count=pc, dryrun=dr)),
                      f,
                      indent=1, default=float)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
