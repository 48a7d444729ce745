"""Batched chunking scheduler: length-bucketed continuous batching for SeqCDC.

The port of ``repro/service/scheduler.py``.  Requests queue per *length
bucket* (padded length from the half-octave grid {1, 1.5}x2^k, capping row
padding at 50%); a bucket dispatches the moment its ``slots`` rows fill,
and ``drain`` flushes partial buckets.  Each dispatch ships one ``(B, S)``
uint8 batch to the device explicitly (``torch.from_numpy(batch).to(device)``)
and brings bounds, counts, fingerprints and lengths back.

Exactness under padding: SeqCDC is memoryless at chunk starts, so the
decision for a chunk starting at ``s`` depends only on bytes
``[s, s + max_size]``.  The scheduler keeps the padded run's boundaries up
to the last chunk start with a full in-bounds window and re-chunks only the
final ``< max_size`` tail with the host oracle (``_trim_exact``), so
results are bit-identical to chunking each stream alone.

Device pipelines (``pipeline_impl``): ``"fused"`` runs masks, boundary scan
and fingerprints as one CUDA kernel launch per batch
(``kernels/fused_pipeline.py``); ``"split"`` runs the stages apart, with
``mask_impl`` (``"cuda"`` kernel or ``"torch"``) for the phase-1 bitmaps,
the reference's ``step_impl`` for the W-block automaton (``"wide"``, the
default, ``"gather"`` or ``"event"``, each as its select kernel) and
``fp_impl`` (``"cuda"`` or ``"torch"``) for the fingerprints.  Each
knob has a first-dispatch-per-bucket bit-identity cross-check that replays
the batch through the other implementation (``cross_check_masks`` /
``_fps`` / ``_pipeline``) and raises a divergence error on any bit.  On a
CPU device every kernel wrapper takes its plain version.

Segment packing (``packing_impl="segments"``; default ``"off"``, as in the
reference): every stream shorter than ``min_bucket`` goes to a pack queue
instead of padding a bucket row of its own.  Once the queue holds a device
batch's worth of payload (or at ``drain``), the streams are shelf-packed
back to back into shared ``min_bucket``-wide rows and dispatched once
through the packed pipeline: the packed CUDA kernel
(``kernels/packed_pipeline.py``) for ``pipeline_impl="fused"``, the packed
split path otherwise (the masks kernel, the packed select kernel
``kernels/select_boundaries_packed.py`` and the fingerprint kernel).  Its automaton resets at every segment end, so each
stream's chunks and fingerprints equal chunking it alone and the demuxed
results skip the host tail redo.  The first packed dispatch is replayed
stream by stream through the unpacked pipeline and compared bit for bit
(``cross_check_packing`` / ``PackingDivergenceError``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Literal

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.automaton import STEP_IMPLS, max_chunks_for
from repro_torch.core.params import SeqCDCParams, derived_params
from repro_torch.core.seqcdc import (
    MASK_IMPLS,
    boundaries_batch,
    boundaries_packed_batch,
    segment_end_positions,
    select_impl_for,
)
from repro_torch.dedup.fingerprint import (
    FP_IMPLS,
    MAX_CHUNK,
    chunk_fingerprints,
    fingerprints_numpy,
)
from repro_torch.kernels import fused_pipeline as kfused
from repro_torch.kernels import packed_pipeline as kpacked
from repro_torch.obs import MetricsRegistry, labeled, span

PipelineImpl = Literal["split", "fused"]
PIPELINE_IMPLS = ("split", "fused")
PACKING_IMPLS = ("off", "segments")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device a service runs on; a CUDA device without a card raises
    (there is no quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _run_fused(x, p, mc):
    """The fused single-launch pipeline (module-level so the divergence
    tests can interpose a corrupted kernel)."""
    return kfused.fused_pipeline_batch(x, p, max_chunks=mc)


def _device_chunk(x, *, p, mc, mask_impl, step_impl, with_fp, fp_impl,
                  pipeline_impl):
    """(B, S) uint8 tensor -> (bounds, counts[, fps, lens]).

    ``pipeline_impl="fused"`` runs the whole thing as one kernel launch
    (``mask_impl``/``step_impl``/``fp_impl`` then select only the
    cross-check replays); a fingerprint-less batch has nothing to fuse and
    takes the split path.
    """
    if pipeline_impl == "fused" and with_fp:
        return _run_fused(x, p, mc)
    if not with_fp:
        bounds, counts = boundaries_batch(
            x, p, mask_impl=mask_impl, step_impl=step_impl,
            select_impl=select_impl_for(step_impl), max_chunks=mc)
        return bounds, counts, None, None
    return kfused.fused_pipeline_plain(
        x, p, max_chunks=mc, mask_impl=mask_impl, step_impl=step_impl,
        select_impl=select_impl_for(step_impl), fp_impl=fp_impl)


def _run_packed_fused(x, ends, p, mc):
    """The packed kernel launch (module-level so the divergence tests can
    interpose a corrupted kernel, like ``_run_fused``)."""
    return kpacked.packed_pipeline_batch(x, ends, p, max_chunks=mc)


def _run_packed_split(x, ends, p, mc, mask_impl, fp_impl, with_fp):
    """The composed packed pipeline: the segment-aware boundary scan (the
    packed select kernel, ``select_impl_for("wide")``; its plain loop on a
    CPU device), then the fingerprint stage (fingerprints are translation
    invariant, so the packed bounds feed ``chunk_fingerprints`` with no
    correction)."""
    select_impl = select_impl_for("wide")
    if not with_fp:
        sep = segment_end_positions(ends, x.shape[-1])
        bounds, counts = boundaries_packed_batch(
            x, sep, ends, p, mask_impl=mask_impl, select_impl=select_impl,
            max_chunks=mc)
        return bounds, counts, None, None
    return kpacked.packed_pipeline_plain(x, ends, p, max_chunks=mc,
                                         mask_impl=mask_impl,
                                         select_impl=select_impl,
                                         fp_impl=fp_impl)


def _device_chunk_packed(x, ends, *, p, mc, mask_impl, with_fp, fp_impl,
                         pipeline_impl):
    """(R, S) packed rows -> (bounds, counts[, fps, lens]) in row
    coordinates; ``ends`` is the (R, G) segment-end table.  The packed twin
    of ``_device_chunk``: the packed rows have only the ``wide`` automaton.
    With fingerprints and ``pipeline_impl="fused"`` it is the packed kernel
    (``kernels/packed_pipeline.py``); otherwise the packed split path, whose
    automaton is the packed select kernel
    (``kernels/select_boundaries_packed.py``)."""
    if pipeline_impl == "fused" and with_fp:
        return _run_packed_fused(x, ends, p, mc)
    return _run_packed_split(x, ends, p, mc, mask_impl, fp_impl, with_fp)


def _trim_exact(data: np.ndarray, padded: np.ndarray,
                padded_fps: np.ndarray | None, p: SeqCDCParams):
    """Trim a padded-run boundary list to the exact per-stream result.

    Keeps every boundary whose chunk started with a full in-bounds
    ``max_size`` window (identical to the exact run by memorylessness) and
    re-chunks the remaining tail with the host oracle.  Returns
    ``(bounds, fps, lengths, tail_bytes)`` where ``tail_bytes`` is how many
    bytes the host redid (0 when the stream length fell on a boundary).
    """
    n = data.size
    kept = 0
    s = 0
    for b in padded:
        if s + p.max_size > n:
            break
        kept += 1
        s = int(b)
    if s == n:  # stream length hit a boundary exactly: nothing to redo
        bounds = padded[:kept].astype(np.int64)
        tail_rel = np.zeros(0, dtype=np.int64)
        tail_bytes = 0
    else:
        tail_rel = oracle.boundaries_numpy(data[s:], p)
        tail_bytes = n - s
        bounds = np.concatenate([padded[:kept].astype(np.int64),
                                 tail_rel + s])
    lengths = np.diff(np.concatenate([[0], bounds]))
    if padded_fps is None:
        fps = np.zeros((0, 2), dtype=np.uint32)
    elif tail_rel.size:
        fps = np.concatenate([
            padded_fps[:kept],
            fingerprints_numpy(data[s:], tail_rel),
        ])
    else:
        fps = padded_fps[:kept].copy()
    return bounds, fps, lengths, tail_bytes


class MaskDivergenceError(AssertionError):
    """The CUDA and plain mask paths disagreed on a dispatched batch."""


class FingerprintDivergenceError(AssertionError):
    """The CUDA and plain fingerprint paths disagreed on a batch."""


class PipelineDivergenceError(AssertionError):
    """The fused and split pipelines disagreed on a dispatched batch.

    ``stage`` names what diverged first: ``"boundaries"`` (the mask/scan
    lanes emitted different chunking) or ``"fingerprints"`` (same chunks,
    different hashes).
    """

    def __init__(self, message: str, stage: str):
        super().__init__(message)
        self.stage = stage


class PackingDivergenceError(AssertionError):
    """A packed dispatch disagreed with the per-stream unpacked replay.

    Raised by the first-packed-dispatch guard: every stream of the packed
    batch is rerun as its own unpacked device row, and the demuxed packed
    results must match bit for bit.  A divergence means the segment-reset
    bookkeeping (the ``se`` register, the mask clip, the post-emit clamp)
    regressed.
    """


@dataclasses.dataclass
class ChunkRequest:
    seq: int  # submission order (results are returned in this order)
    tag: Any
    data: np.ndarray  # (n,) uint8


@dataclasses.dataclass
class ChunkResult:
    """Exact chunking of one stream: what the store/restore path consumes."""

    tag: Any
    data: np.ndarray  # the original stream (uint8)
    bounds: np.ndarray  # (C,) int64 exclusive chunk ends, bounds[-1] == size
    fps: np.ndarray  # (C, 2) uint32 device fingerprints
    lengths: np.ndarray  # (C,) int64 chunk lengths

    @property
    def size(self) -> int:
        return int(self.data.size)


@dataclasses.dataclass
class SchedulerStats:
    dispatches: int = 0
    device_rows: int = 0  # total device rows shipped
    device_bytes: int = 0  # bytes shipped to the device (incl. padding)
    stream_bytes: int = 0  # real payload bytes
    tail_bytes: int = 0  # bytes re-chunked host-side (exactness fixup)
    tail_s: float = 0.0  # wall seconds the host tail redo cost (inside drain)
    cross_check_s: float = 0.0  # wall seconds spent in cross-check replays
    packed_streams: int = 0  # streams that rode a shared packed row

    @property
    def occupancy(self) -> float:
        """Real payload fraction of device traffic (batching efficiency)."""
        return self.stream_bytes / self.device_bytes if self.device_bytes else 0.0


def _to_numpy(t):
    return None if t is None else t.cpu().numpy()


class ChunkScheduler:
    """Length-bucketed continuous batching over the batched SeqCDC pipeline."""

    def __init__(
        self,
        params: SeqCDCParams | None = None,
        *,
        device: str | torch.device = "cuda",
        slots: int = 8,
        min_bucket: int = 1 << 14,
        max_batch_bytes: int = 8 << 20,
        mask_impl: str = "cuda",
        step_impl: str = "wide",
        fp_impl: str = "cuda",
        pipeline_impl: str = "fused",
        packing_impl: str = "off",
        with_fingerprints: bool = True,
        cross_check_masks: bool = False,
        cross_check_fps: bool = False,
        cross_check_pipeline: bool = False,
        cross_check_packing: bool = False,
        registry: MetricsRegistry | None = None,
    ):
        self.params = params or derived_params(8192)
        self.device = resolve_device(device)
        if with_fingerprints and self.params.max_size > MAX_CHUNK:
            raise ValueError(
                f"max_size {self.params.max_size} exceeds the fingerprint "
                f"limit {MAX_CHUNK}; pass with_fingerprints=False"
            )
        for name, value, allowed in (
            ("mask_impl", mask_impl, MASK_IMPLS),
            ("step_impl", step_impl, STEP_IMPLS),
            ("fp_impl", fp_impl, FP_IMPLS),
            ("pipeline_impl", pipeline_impl, PIPELINE_IMPLS),
            ("packing_impl", packing_impl, PACKING_IMPLS),
        ):
            if value not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got {value!r}")
        self.slots = slots
        self.max_batch_bytes = max_batch_bytes
        self.min_bucket = max(min_bucket, self.params.max_size)
        if packing_impl == "segments" and self.min_bucket > MAX_CHUNK:
            raise ValueError(
                f"packing_impl='segments' requires min_bucket <= "
                f"{MAX_CHUNK} (the packed row width bound), got "
                f"{self.min_bucket}"
            )
        self.mask_impl = mask_impl
        self.step_impl = step_impl
        self.fp_impl = fp_impl
        self.pipeline_impl = pipeline_impl
        self.packing_impl = packing_impl
        self.with_fingerprints = with_fingerprints
        # bit-identity guards: the first dispatch of every bucket is
        # replayed through the other implementation and compared, so a
        # kernel regression is a loud divergence error instead of silent
        # chunk-boundary drift that dedup would absorb as a worse ratio
        self.cross_check_masks = cross_check_masks
        self._checked_buckets: set[int] = set()
        self.cross_check_fps = cross_check_fps
        self._fp_checked_buckets: set[int] = set()
        self.cross_check_pipeline = cross_check_pipeline
        self._pipeline_checked_buckets: set[int] = set()
        # the packing guard: the first packed dispatch replays every stream
        # as its own unpacked row (packed must equal not packed)
        self.cross_check_packing = cross_check_packing
        self._packing_checked = False
        self._pack_queue: List[ChunkRequest] = []
        self._pack_bytes = 0
        # dispatch the pack queue once it can fill a whole device batch of
        # packed rows (drain flushes whatever is left)
        self._pack_capacity = (
            self._slots_for(self.min_bucket) * self.min_bucket
        )
        self.stats = SchedulerStats()
        self.obs = registry if registry is not None else MetricsRegistry()
        self._dispatch_hist = labeled(
            "sched.dispatch_s", pipeline=self.pipeline_impl,
            mask=self.mask_impl, fp=self.fp_impl,
        )
        self._bucket_metric_names: Dict[tuple, tuple[str, str, str]] = {}
        self._pending: Dict[int, List[ChunkRequest]] = {}
        self._ready: List[tuple[int, ChunkResult]] = []
        self._next_seq = 0

    # -- public -----------------------------------------------------------------
    def submit(self, data, tag: Any = None) -> int:
        """Queue one stream for chunking; dispatches when its bucket fills.

        ``data``: raw bytes-like (bytes/bytearray/memoryview) or anything
        ``np.ascontiguousarray`` turns into a uint8 vector.
        """
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, dtype=np.uint8)
        else:
            arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        seq = self._next_seq
        self._next_seq += 1
        self.stats.stream_bytes += arr.size
        if arr.size == 0:  # no chunks; never touches the device
            empty = np.zeros(0, dtype=np.int64)
            self._ready.append(
                (seq, ChunkResult(tag, arr, empty,
                                  np.zeros((0, 2), dtype=np.uint32), empty))
            )
            return seq
        if self.packing_impl == "segments" and arr.size < self.min_bucket:
            # sub-bucket streams share device rows instead of padding a
            # bucket row each
            self._pack_queue.append(ChunkRequest(seq, tag, arr))
            self._pack_bytes += arr.size
            if self._pack_bytes >= self._pack_capacity:
                self._dispatch_packed()
            return seq
        bucket = self._bucket_for(arr.size)
        q = self._pending.setdefault(bucket, [])
        q.append(ChunkRequest(seq, tag, arr))
        if len(q) >= self._slots_for(bucket):
            self._dispatch(bucket)
        return seq

    def drain(self) -> List[ChunkResult]:
        """Flush every partial bucket and return all results, FIFO order."""
        if self._pack_queue:
            self._dispatch_packed()
        for bucket in sorted(self._pending):
            if self._pending[bucket]:
                self._dispatch(bucket)
        self._ready.sort(key=lambda t: t[0])
        out = [r for _, r in self._ready]
        self._ready.clear()
        return out

    # -- internals ----------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        # two buckets per octave ({1, 1.5} x 2^k): caps row padding at 50%
        # while keeping the set of device shapes logarithmic
        b = self.min_bucket
        while b < n:
            if n <= b + (b >> 1):
                return b + (b >> 1)
            b <<= 1
        return b

    def _slots_for(self, bucket: int) -> int:
        """Rows per device batch: ``slots``, capped so a batch stays within
        ``max_batch_bytes``."""
        return max(1, min(self.slots, self.max_batch_bytes // bucket))

    def _bucket_names(self, bucket: int,
                      packed: bool = False) -> tuple[str, str, str]:
        """(occupancy, pad_waste, batch_rows) gauge names for one bucket,
        rendered once per bucket rather than once per dispatch.  Packed
        dispatches get their own ``packed=1`` series."""
        key = (bucket, packed)
        names = self._bucket_metric_names.get(key)
        if names is None:
            labels = {"bucket": bucket, "packed": 1} if packed else {
                "bucket": bucket}
            names = (
                labeled("sched.occupancy", **labels),
                labeled("sched.pad_waste", **labels),
                labeled("sched.batch_rows", **labels),
            )
            self._bucket_metric_names[key] = names
        return names

    def _dispatch(self, bucket: int):
        # a partial batch (drain of a part-filled bucket) dispatches only
        # the rows it has
        reqs = self._pending[bucket]
        rows = len(reqs)
        self._pending[bucket] = []
        payload = sum(r.data.size for r in reqs)
        batch = np.zeros((rows, bucket), dtype=np.uint8)
        for row, r in enumerate(reqs):
            batch[row, : r.data.size] = r.data
        mc = max_chunks_for(bucket, self.params)
        with span("sched.dispatch", bucket=bucket, rows=len(reqs),
                  payload_bytes=payload, device_bytes=batch.size):
            t0 = time.perf_counter()
            x = torch.from_numpy(batch).to(self.device)
            out = _device_chunk(
                x, p=self.params, mc=mc, mask_impl=self.mask_impl,
                step_impl=self.step_impl, with_fp=self.with_fingerprints,
                fp_impl=self.fp_impl, pipeline_impl=self.pipeline_impl,
            )
            # the copies back wait for the device, so the elapsed time is
            # the real dispatch latency, not the enqueue cost
            bounds, counts, fps, lens = (_to_numpy(t) for t in out)
            dispatch_s = time.perf_counter() - t0
        # cross-check replays are excluded from the latency histogram: they
        # are a one-time-per-bucket guard, not steady-state dispatch cost
        t_check = time.perf_counter()
        if self.cross_check_masks and bucket not in self._checked_buckets:
            self._checked_buckets.add(bucket)
            self.obs.inc(labeled("sched.cross_checks", kind="masks"))
            self._cross_check(bucket, x, bounds, counts)
        if fps is not None:
            if self.cross_check_fps and bucket not in self._fp_checked_buckets:
                self._fp_checked_buckets.add(bucket)
                self.obs.inc(labeled("sched.cross_checks", kind="fps"))
                self._cross_check_fp(bucket, x, bounds, counts, fps, lens)
            if (self.cross_check_pipeline
                    and bucket not in self._pipeline_checked_buckets):
                self._pipeline_checked_buckets.add(bucket)
                self.obs.inc(labeled("sched.cross_checks", kind="pipeline"))
                self._cross_check_pipeline(bucket, x, bounds, counts,
                                           fps, lens)
        self.stats.cross_check_s += time.perf_counter() - t_check
        self.stats.dispatches += 1
        self.stats.device_bytes += batch.size
        self.stats.device_rows += rows
        self.obs.inc("sched.dispatches")
        self.obs.inc("sched.device_bytes", batch.size)
        self.obs.inc("sched.payload_bytes", payload)
        self.obs.observe(self._dispatch_hist, dispatch_s)
        occ_name, waste_name, rows_name = self._bucket_names(bucket)
        occ = payload / batch.size if batch.size else 0.0
        self.obs.set_gauge(occ_name, occ)
        self.obs.set_gauge(waste_name, 1.0 - occ)
        self.obs.set_gauge(rows_name, len(reqs))
        for row, r in enumerate(reqs):
            self._ready.append((r.seq, self._exactify(
                r, bounds[row, : counts[row]],
                fps[row] if fps is not None else None,
            )))

    def _dispatch_packed(self):
        """Shelf-pack the sub-bucket queue into shared rows and dispatch."""
        reqs = self._pack_queue
        self._pack_queue = []
        self._pack_bytes = 0
        if not reqs:
            return
        S = self.min_bucket
        # next-fit shelf packing in arrival order: a stream that no longer
        # fits opens a new row, which keeps demux order equal to submission
        # order and the packing O(n)
        rows: List[List[ChunkRequest]] = [[]]
        fill = 0
        for r in reqs:
            if fill + r.data.size > S:
                rows.append([])
                fill = 0
            rows[-1].append(r)
            fill += r.data.size
        slots = self._slots_for(S)
        for i in range(0, len(rows), slots):
            self._dispatch_packed_rows(rows[i:i + slots], S)

    def _dispatch_packed_rows(self, rows: List[List[ChunkRequest]], S: int):
        """One packed device dispatch: R rows of back-to-back segments."""
        R = len(rows)
        G = 4  # segment-table width rounded up to a power of two, so the
        while G < max(len(rr) for rr in rows):  # shapes stay logarithmic
            G <<= 1
        batch = np.zeros((R, S), dtype=np.uint8)
        ends = np.zeros((R, G), dtype=np.int32)
        layout: List[List[tuple[ChunkRequest, int, int]]] = []
        payload = 0
        for ri, rr in enumerate(rows):
            off = 0
            row_layout = []
            for gi, r in enumerate(rr):
                m = r.data.size
                batch[ri, off:off + m] = r.data
                ends[ri, gi] = off + m
                row_layout.append((r, off, off + m))
                off += m
            # pad entries carry the payload end; the per-position segment
            # ends (the padding's own being the payload end) follow from
            # this table (core/seqcdc.segment_end_positions)
            ends[ri, len(rr):] = off
            layout.append(row_layout)
            payload += off
        # per-segment bound on chunks: the sum of per-stream max_chunks_for
        mc = S // self.params.min_size + 2 * G + 2
        with span("sched.dispatch", bucket=S, rows=R, packed=1,
                  payload_bytes=payload, device_bytes=batch.size):
            t0 = time.perf_counter()
            x = torch.from_numpy(batch).to(self.device)
            out = _device_chunk_packed(
                x, torch.from_numpy(ends).to(self.device), p=self.params,
                mc=mc, mask_impl=self.mask_impl,
                with_fp=self.with_fingerprints, fp_impl=self.fp_impl,
                pipeline_impl=self.pipeline_impl,
            )
            bounds, counts, fps, _ = (_to_numpy(t) for t in out)
            dispatch_s = time.perf_counter() - t0
        # demux: each stream's chunks are the row bounds in (off, end];
        # exact results (the automaton consulted the true segment ends), so
        # no host tail redo
        results: List[tuple[ChunkRequest, ChunkResult]] = []
        for ri, row_layout in enumerate(layout):
            bs = bounds[ri, : counts[ri]]
            for r, off, end in row_layout:
                i0 = int(np.searchsorted(bs, off, side="right"))
                i1 = int(np.searchsorted(bs, end, side="right"))
                rb = bs[i0:i1].astype(np.int64) - off
                lengths = np.diff(np.concatenate([[0], rb]))
                rf = (fps[ri, i0:i1].copy() if fps is not None
                      else np.zeros((0, 2), dtype=np.uint32))
                results.append(
                    (r, ChunkResult(r.tag, r.data, rb, rf, lengths))
                )
        t_check = time.perf_counter()
        if self.cross_check_packing and not self._packing_checked:
            self._packing_checked = True
            self.obs.inc(labeled("sched.cross_checks", kind="packing"))
            self._cross_check_packing(S, results)
        self.stats.cross_check_s += time.perf_counter() - t_check
        self.stats.dispatches += 1
        self.stats.device_bytes += batch.size
        self.stats.device_rows += R
        self.stats.packed_streams += len(results)
        self.obs.inc("sched.dispatches")
        self.obs.inc("sched.device_bytes", batch.size)
        self.obs.inc("sched.payload_bytes", payload)
        self.obs.inc("sched.packed_streams", len(results))
        self.obs.observe(self._dispatch_hist, dispatch_s)
        occ_name, waste_name, rows_name = self._bucket_names(S, packed=True)
        occ = payload / batch.size if batch.size else 0.0
        self.obs.set_gauge(occ_name, occ)
        self.obs.set_gauge(waste_name, 1.0 - occ)
        self.obs.set_gauge(rows_name, R)
        for r, res in results:
            self._ready.append((r.seq, res))

    def _cross_check_packing(self, S: int,
                             results: List[tuple[ChunkRequest, ChunkResult]]):
        """Replay every packed stream as its own unpacked device row and
        compare the demuxed packed results bit for bit.  The replay goes
        through ``_device_chunk`` and the host tail trim, the pipeline a
        ``packing_impl="off"`` scheduler runs: packed must equal not
        packed."""
        reqs = [r for r, _ in results]
        xb = np.zeros((len(reqs), S), dtype=np.uint8)
        for i, r in enumerate(reqs):
            xb[i, : r.data.size] = r.data
        out = _device_chunk(
            torch.from_numpy(xb).to(self.device), p=self.params,
            mc=max_chunks_for(S, self.params), mask_impl=self.mask_impl,
            step_impl=self.step_impl, with_fp=self.with_fingerprints,
            fp_impl=self.fp_impl, pipeline_impl=self.pipeline_impl,
        )
        b2, c2, f2, _ = (_to_numpy(t) for t in out)
        bad = []
        for i, (r, res) in enumerate(results):
            eb, ef, el, _ = _trim_exact(
                r.data, b2[i, : c2[i]],
                f2[i] if f2 is not None else None, self.params,
            )
            if not (np.array_equal(res.bounds, eb)
                    and np.array_equal(res.fps, ef)
                    and np.array_equal(res.lengths, el)):
                bad.append(i)
        if bad:
            raise PackingDivergenceError(
                f"packed dispatch diverged from the per-stream unpacked "
                f"replay on streams {bad} (row width {S}): the packed "
                f"pipeline no longer chunks each stream exactly as it "
                f"would chunk alone"
            )

    def _cross_check(self, bucket: int, x: torch.Tensor,
                     bounds: np.ndarray, counts: np.ndarray):
        """Replay one batch through the other mask path; raise on any bit."""
        other = "torch" if self.mask_impl == "cuda" else "cuda"
        b2, c2 = boundaries_batch(
            x, self.params, mask_impl=other, step_impl=self.step_impl,
            select_impl=select_impl_for(self.step_impl),
            max_chunks=max_chunks_for(bucket, self.params),
        )
        b2, c2 = _to_numpy(b2), _to_numpy(c2)
        if not (np.array_equal(counts, c2) and np.array_equal(bounds, b2)):
            rows = np.nonzero(
                (counts != c2) | (bounds != b2).any(axis=-1)
            )[0].tolist()
            raise MaskDivergenceError(
                f"mask_impl={self.mask_impl!r} and {other!r} diverged on "
                f"bucket {bucket} (rows {rows}): the CUDA phase-1 kernel "
                f"no longer matches the plain version bit-for-bit"
            )

    def _cross_check_fp(self, bucket: int, x: torch.Tensor,
                        bounds: np.ndarray, counts: np.ndarray,
                        fps: np.ndarray, lens: np.ndarray):
        """Replay one batch's fingerprints through the other fp path;
        raise on any differing bit."""
        other = "torch" if self.fp_impl == "cuda" else "cuda"
        mc = max_chunks_for(bucket, self.params)
        f2, l2 = chunk_fingerprints(
            x, torch.from_numpy(bounds).to(self.device),
            torch.from_numpy(counts).to(self.device), max_chunks=mc,
            fp_impl=other,
        )
        f2, l2 = _to_numpy(f2), _to_numpy(l2)
        if not (np.array_equal(fps, f2) and np.array_equal(lens, l2)):
            rows = np.nonzero(
                (fps != f2).any(axis=(-2, -1)) | (lens != l2).any(axis=-1)
            )[0].tolist()
            raise FingerprintDivergenceError(
                f"fp_impl={self.fp_impl!r} and {other!r} diverged on bucket "
                f"{bucket} (rows {rows}): the CUDA fingerprint kernel no "
                f"longer matches the plain version bit-for-bit"
            )

    def _cross_check_pipeline(self, bucket: int, x: torch.Tensor,
                              bounds: np.ndarray, counts: np.ndarray,
                              fps: np.ndarray, lens: np.ndarray):
        """Replay one batch through the *other* pipeline (fused <-> split)
        and compare everything bit-for-bit; the raised error names the
        first stage that diverged."""
        mc = max_chunks_for(bucket, self.params)
        if self.pipeline_impl == "fused":
            other = "split"
            out = kfused.fused_pipeline_plain(
                x, self.params, max_chunks=mc, mask_impl=self.mask_impl,
                step_impl=self.step_impl,
                select_impl=select_impl_for(self.step_impl),
                fp_impl=self.fp_impl)
        else:
            other = "fused"
            out = _run_fused(x, self.params, mc)
        b2, c2, f2, l2 = (_to_numpy(t) for t in out)
        if not (np.array_equal(counts, c2) and np.array_equal(bounds, b2)):
            rows = np.nonzero(
                (counts != c2) | (bounds != b2).any(axis=-1)
            )[0].tolist()
            raise PipelineDivergenceError(
                f"pipeline_impl={self.pipeline_impl!r} and {other!r} "
                f"diverged on bucket {bucket} (rows {rows}) in the "
                f"boundary stage: the fused kernel's mask/scan lanes no "
                f"longer match the split path bit-for-bit",
                stage="boundaries",
            )
        if not (np.array_equal(fps, f2) and np.array_equal(lens, l2)):
            rows = np.nonzero(
                (fps != f2).any(axis=(-2, -1)) | (lens != l2).any(axis=-1)
            )[0].tolist()
            raise PipelineDivergenceError(
                f"pipeline_impl={self.pipeline_impl!r} and {other!r} "
                f"diverged on bucket {bucket} (rows {rows}) in the "
                f"fingerprint stage: identical chunk boundaries but the "
                f"fused kernel's hash path no longer matches",
                stage="fingerprints",
            )

    def _exactify(self, req: ChunkRequest, padded: np.ndarray,
                  padded_fps: np.ndarray | None) -> ChunkResult:
        """Trim a padded-run boundary list to the exact per-stream result."""
        t0 = time.perf_counter()
        bounds, fps, lengths, tail_bytes = _trim_exact(
            req.data, padded, padded_fps, self.params
        )
        if tail_bytes:
            # tail_s counts only redos that did work: the oracle re-chunk
            # is the latency phase the service moves out of chunk-dispatch
            self.stats.tail_bytes += tail_bytes
            self.stats.tail_s += time.perf_counter() - t0
            self.obs.inc("sched.tail_bytes", tail_bytes)
        return ChunkResult(req.tag, req.data, bounds, fps, lengths)
