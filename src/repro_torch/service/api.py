"""DedupService: the streaming deduplication service (put/get/stat/delete).

The port of ``repro/service/api.py``'s single-store service::

    submit/put --> ChunkScheduler (length-bucketed device batches: the
                   fused CUDA pipeline, or masks + scan + fingerprints)
               --> BlockStore     (SHA-256 content-addressed, refcounted)
               --> RecipeTable    (object -> chunk keys + object digest)
    get        --> reassemble from recipe, SHA-256 verify
    delete     --> release refcounts; gc() mark-and-sweeps crash orphans

The store and recipe formats are the reference's own (copied modules), so
a depot written by either package opens and restores under the other.
The service runs on the card unless the caller passes ``device="cpu"``;
``device="cuda"`` without a card raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.params import SeqCDCParams, derived_params
from repro_torch.dedup.index import FingerprintIndex
from repro_torch.dedup.store import (
    BlockCorruptionError,
    BlockStore,
    DirBlockStore,
)
from repro_torch.obs import (
    MetricsRegistry,
    PhaseClock,
    labeled,
    merge_snapshots,
    span,
)

from .objects import ObjectRecipe, RecipeTable
from .scheduler import ChunkResult, ChunkScheduler

#: the calling thread's active request (put = submit + flush reuses the
#: outer request so its phases attribute to op=put, not op=flush)
_REQ_TLS = threading.local()


@dataclasses.dataclass
class _Request:
    """One in-flight request: its id, op label, and phase partition clock."""

    op: str
    rid: str
    clock: PhaseClock


class IntegrityError(RuntimeError):
    """Restore produced bytes whose digest does not match the recipe."""


def verify_restore(r: ObjectRecipe, data: bytes) -> bytes:
    """The restore-verification rule: length and whole-object SHA-256 must
    match the recipe or nothing is returned."""
    if len(data) != r.size or hashlib.sha256(data).hexdigest() != r.sha256:
        raise IntegrityError(
            f"object {r.name!r}: restored {len(data)}B, digest mismatch "
            f"(expected {r.size}B sha256={r.sha256[:12]}...)"
        )
    return data


def sweep_store(store: BlockStore, live: Dict[str, int]) -> "GCStats":
    """One store's mark-and-sweep pass against the recomputed live
    reference counts (:meth:`BlockStore.sweep`)."""
    return GCStats(*store.sweep(live))


def pack_fps(fps) -> List[int]:
    """Per-chunk 62-bit fingerprints packed to ``(h1 << 32) | h2`` ints for
    the recipe (``ObjectRecipe.fps``), which is what makes a depot
    reshardable without re-chunking."""
    return [(int(h1) << 32) | int(h2) for h1, h2 in np.asarray(fps).tolist()]


def recipe_totals(recipes: RecipeTable) -> tuple[int, int, Dict[int, int]]:
    """(logical_bytes, total_chunks, log2-bucket histogram) over a table."""
    hist: Counter = Counter()
    logical = 0
    total_chunks = 0
    for r in recipes:
        logical += r.size
        total_chunks += len(r.keys)
        for ln in r.chunk_lens:
            hist[max(0, int(ln).bit_length() - 1)] += 1
    return logical, total_chunks, dict(sorted(hist.items()))


@dataclasses.dataclass
class ObjectStat:
    name: str
    size: int
    chunks: int
    sha256: str
    mean_chunk: float

    @classmethod
    def of(cls, r: ObjectRecipe) -> "ObjectStat":
        return cls(name=r.name, size=r.size, chunks=len(r.keys), sha256=r.sha256,
                   mean_chunk=r.size / len(r.keys) if r.keys else 0.0)


@dataclasses.dataclass
class ServiceStats:
    objects: int
    logical_bytes: int  # sum of live object sizes
    stored_bytes: int  # unique chunk bytes on disk/in memory
    total_chunks: int
    unique_chunks: int
    chunk_size_hist: Dict[int, int]  # log2-bucket -> live chunk refs
    fp_estimated_savings: float  # 62-bit fp estimate, cumulative over ingests
    batches: int
    batch_occupancy: float
    #: payload bytes the store actually holds (== stored_bytes when the
    #: store codec is "none"; smaller under compression)
    compressed_bytes: int = 0
    codec: str = "none"  # the store's write codec

    @property
    def dedup_ratio(self) -> float:
        return self.logical_bytes / self.stored_bytes if self.stored_bytes else 1.0

    @property
    def compressed_ratio(self) -> float:
        """Logical bytes per payload byte held: dedup x compression."""
        if not self.compressed_bytes:
            return self.dedup_ratio
        return self.logical_bytes / self.compressed_bytes

    @property
    def space_savings(self) -> float:
        if not self.logical_bytes:
            return 0.0
        return (self.logical_bytes - self.stored_bytes) / self.logical_bytes


@dataclasses.dataclass
class GCStats:
    freed_blocks: int
    freed_bytes: int
    repaired_refs: int


class ServiceBase:
    """The scheduler-facing ingest/serve surface: name bookkeeping, request
    attribution and metrics.  Subclasses provide ``recipes``,
    ``scheduler``, ``_in_flight`` and ``flush``."""

    recipes: RecipeTable
    scheduler: ChunkScheduler
    _in_flight: set
    obs: MetricsRegistry

    def submit(self, name: str, data, *, overwrite: bool = False) -> int:
        """Queue one object for ingest; returns its ticket (a sequence id).

        Nothing is chunked, stored, or committed until :meth:`flush`.
        Raises ``KeyError`` if ``name`` already exists (committed or
        in-flight) and ``overwrite`` is False.
        """
        if not overwrite and (name in self.recipes or name in self._in_flight):
            raise KeyError(f"object {name!r} already exists (overwrite=False)")
        seq = self.scheduler.submit(data, tag=name)
        self._in_flight.add(name)
        return seq

    def put(self, name: str, data, *, overwrite: bool = False) -> ObjectStat:
        """Store one object now (submit + flush); returns its ObjectStat."""
        with self._request("put", object=name):
            self.submit(name, data, overwrite=overwrite)
            return self.flush()[-1]

    def flush(self) -> List[ObjectStat]:
        raise NotImplementedError

    def stat(self, name: str) -> ObjectStat:
        """Recipe-level summary of one committed object."""
        return ObjectStat.of(self.recipes.get(name))

    def names(self) -> List[str]:
        """Sorted names of all committed objects (in-flight ones excluded)."""
        return self.recipes.names()

    # -- request attribution ----------------------------------------------------
    @contextlib.contextmanager
    def _request(self, op: str, **attrs):
        """Root of one public-surface request: a ``request`` span with a
        fresh request id and a :class:`PhaseClock` whose partition lands in
        ``req.latency_s{op=,phase=}`` at close, plus ``req.total_s{op=}``
        and ``req.requests{op=}``.  Re-entrant per thread."""
        active = getattr(_REQ_TLS, "active", None)
        if active is not None:
            yield active
            return
        req = _Request(op=op, rid=os.urandom(6).hex(), clock=PhaseClock())
        _REQ_TLS.active = req
        try:
            with span("request", op=op, req=req.rid, **attrs) as sp:
                try:
                    yield req
                finally:
                    _, phases = req.clock.stop()
                    sp["phases"] = {p: round(s, 6)
                                    for p, s in phases.items()}
        finally:
            _REQ_TLS.active = None
            total, phases = req.clock.stop()
            self.obs.inc(labeled("req.requests", op=op))
            self.obs.observe(labeled("req.total_s", op=op), total)
            for ph, secs in phases.items():
                self.obs.observe(
                    labeled("req.latency_s", op=op, phase=ph), secs
                )

    def _phase(self, name: str):
        """Attribute the ``with`` body's wall time to phase ``name`` of the
        thread's active request; a no-op outside any request."""
        active = getattr(_REQ_TLS, "active", None)
        if active is None:
            return contextlib.nullcontext()
        return active.clock.phase(name)

    def _move_phase(self, src: str, dst: str, seconds: float):
        """Reattribute seconds between phases of the active request."""
        active = getattr(_REQ_TLS, "active", None)
        if active is not None:
            active.clock.move(src, dst, seconds)

    def metrics(self) -> dict:
        """Live telemetry snapshot: ``service`` is this process's registry;
        ``shards`` holds one server-side snapshot per remote shard (``None``
        for an unreachable server; empty for in-process stores) and
        ``aggregate`` their merge."""
        shards = self._shard_metric_snapshots()
        return {
            "service": self.obs.snapshot(),
            "shards": shards,
            "aggregate": merge_snapshots(shards) if shards else None,
        }

    def _shard_metric_snapshots(self) -> List[Optional[dict]]:
        """Per-shard server-side snapshots; base services have none."""
        return []


class DedupService(ServiceBase):
    """Streaming dedup: batched chunking in front of a GC-capable chunk store."""

    def __init__(
        self,
        store: Optional[BlockStore] = None,
        params: Optional[SeqCDCParams] = None,
        *,
        device: str | torch.device = "cuda",
        avg_chunk: int = 8192,
        slots: int = 8,
        min_bucket: int = 1 << 14,
        recipes: Optional[RecipeTable] = None,
        mask_impl: str = "cuda",
        fp_impl: str = "cuda",
        pipeline_impl: str = "fused",
        packing_impl: str = "off",
        with_fingerprints: bool = True,
        cross_check_masks: bool = False,
        cross_check_fps: bool = False,
        cross_check_pipeline: bool = False,
        cross_check_packing: bool = False,
        codec: Optional[str] = None,
    ):
        self.params = params or derived_params(avg_chunk)
        # codec applies to the default store only; an explicit ``store``
        # arrives already configured (None resolves $REPRO_STORE_CODEC)
        self.store = store if store is not None else BlockStore(codec=codec)
        self.recipes = recipes if recipes is not None else RecipeTable()
        self.obs = MetricsRegistry()
        if hasattr(self.store, "attach_obs"):
            self.store.attach_obs(self.obs)
        self.scheduler = ChunkScheduler(
            self.params, device=device, registry=self.obs, slots=slots,
            min_bucket=min_bucket, mask_impl=mask_impl, fp_impl=fp_impl,
            pipeline_impl=pipeline_impl, packing_impl=packing_impl,
            with_fingerprints=with_fingerprints,
            cross_check_masks=cross_check_masks,
            cross_check_fps=cross_check_fps,
            cross_check_pipeline=cross_check_pipeline,
            cross_check_packing=cross_check_packing,
        )
        self.device = self.scheduler.device
        # ingest-cumulative: tracks every chunk ever ingested (the estimator
        # semantics); deletes/overwrites do not shrink it
        self.fp_index = FingerprintIndex()
        self._in_flight: set[str] = set()  # names submitted, not yet flushed

    @classmethod
    def open(cls, root: str, *, codec: Optional[str] = None,
             hot_bytes: int = 0, **kwargs) -> "DedupService":
        """File-backed service at ``root``: blocks + recipes survive restarts
        (the same on-disk depot layout as the reference service)."""
        os.makedirs(root, exist_ok=True)
        store = DirBlockStore(root, codec=codec, hot_bytes=hot_bytes)
        recipes = RecipeTable(os.path.join(root, "recipes.json"))
        return cls(store=store, recipes=recipes, **kwargs)

    # -- ingest -----------------------------------------------------------------
    def flush(self) -> List[ObjectStat]:
        """Drain the scheduler, store chunks, commit recipes.  FIFO order.

        New blocks and recipes are synced *before* any block superseded by
        an overwrite is released, so a crash mid-flush leaves orphan blocks
        (reclaimable by :meth:`gc`), never a committed recipe pointing at
        missing blocks.
        """
        with self._request("flush"):
            t0 = time.perf_counter()
            with span("service.flush") as sp:
                tail0 = self.scheduler.stats.tail_s
                with self._phase("chunk-dispatch"):
                    try:
                        results = self.scheduler.drain()
                    finally:
                        self._in_flight.clear()
                self._move_phase("chunk-dispatch", "tail",
                                 self.scheduler.stats.tail_s - tail0)
                out = []
                stale: List[str] = []
                with self._phase("commit"):
                    for res in results:
                        stat, old_keys = self._commit(res)
                        out.append(stat)
                        stale.extend(old_keys)
                with self._phase("sync"):
                    self.sync()
                if stale:
                    for k in stale:
                        self.store.release(k)
                    with self._phase("sync"):
                        self.sync()
                sp["objects"] = len(out)
            self.obs.observe("service.flush_s", time.perf_counter() - t0)
            return out

    def _commit(self, res: ChunkResult) -> tuple[ObjectStat, List[str]]:
        """Store one result; returns (stat, keys superseded by an overwrite)."""
        name = str(res.tag)
        old = self.recipes.get(name) if name in self.recipes else None
        before = self.store.unique_chunks
        keys = self.store.put_stream(res.data, res.bounds.tolist())
        self.obs.inc("ingest.objects")
        self.obs.inc("ingest.bytes", res.size)
        self.obs.inc("ingest.chunks", len(keys))
        self.obs.inc("ingest.dedup_hit_chunks",
                     len(keys) - (self.store.unique_chunks - before))
        recipe = ObjectRecipe(
            name=name,
            size=res.size,
            sha256=hashlib.sha256(res.data).hexdigest(),
            keys=keys,
            chunk_lens=res.lengths.astype(int).tolist(),
            fps=pack_fps(res.fps) if res.fps.shape[0] == len(keys) else None,
        )
        if res.fps.size:
            with self._phase("fp"):
                self.fp_index.add_batch(res.fps, res.lengths)
        self.recipes.add(recipe)
        return ObjectStat.of(recipe), (old.keys if old is not None else [])

    # -- serve ------------------------------------------------------------------
    def get(self, name: str) -> bytes:
        """Reassemble an object from its chunks, end-to-end verified: the
        restored length and whole-object SHA-256 must match the recipe or
        :class:`IntegrityError` is raised.  ``KeyError`` for unknown names."""
        r = self.recipes.get(name)
        with self._request("get", object=name):
            t0 = time.perf_counter()
            with span("service.get", object=name, bytes=r.size):
                with self._phase("rpc"):
                    try:
                        data = self.store.get_stream(r.keys)
                    except BlockCorruptionError as e:
                        raise IntegrityError(f"object {name!r}: {e}") from e
                with self._phase("verify"):
                    data = verify_restore(r, data)
            self.obs.observe("service.get_s", time.perf_counter() - t0)
            self.obs.inc("restore.objects")
            self.obs.inc("restore.bytes", r.size)
            return data

    # -- delete / GC ------------------------------------------------------------
    def delete(self, name: str) -> int:
        """Remove an object; returns stored bytes actually reclaimed.  The
        recipe removal is durable before any block file is unlinked."""
        with self._request("delete", object=name):
            r = self.recipes.remove(name)  # KeyError for unknown objects
            with self._phase("sync"):
                self.recipes.sync()
            freed = 0
            with self._phase("commit"):
                for k, ln in zip(r.keys, r.chunk_lens):
                    if self.store.release(k):
                        freed += ln
            with self._phase("sync"):
                self.sync()
            return freed

    def gc(self) -> GCStats:
        """Mark-and-sweep: recipes are roots; everything else is garbage
        (including block files a crash orphaned); also repairs refcount
        drift against the recomputed truth."""
        live: Counter = Counter()
        for r in self.recipes:
            live.update(r.keys)
        stats = sweep_store(self.store, live)
        self.sync()
        return stats

    def sync(self):
        """Persist recipes + store manifest (no-op for in-memory backends)."""
        self.recipes.sync()
        self.store.sync()

    # -- accounting -------------------------------------------------------------
    def stats(self) -> ServiceStats:
        logical, total_chunks, hist = recipe_totals(self.recipes)
        sched = self.scheduler.stats
        return ServiceStats(
            objects=len(self.recipes),
            logical_bytes=logical,
            stored_bytes=self.store.stored_bytes,
            total_chunks=total_chunks,
            unique_chunks=self.store.unique_chunks,
            chunk_size_hist=hist,
            fp_estimated_savings=self.fp_index.savings,
            batches=sched.dispatches,
            batch_occupancy=sched.occupancy,
            compressed_bytes=self.store.compressed_bytes,
            codec=self.store.codec,
        )
