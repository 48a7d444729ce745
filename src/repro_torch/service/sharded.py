"""ShardedDedupService: fingerprint-partitioned multi-shard dedup.

The port of ``repro/service/sharded.py``: the same routing, writer
queues, flush protocol and depot layout (``shard-NN/`` stores,
``sharding.json``, recipes with per-chunk shard lists), byte for byte, so a
sharded depot written by either package opens under the other.  Its
scheduler is the port's, on the card unless ``device="cpu"``.

Scales the stage *after* chunking.  The single-store :class:`DedupService`
serializes fingerprint comparison and block IO behind one refcount table;
this service partitions the fingerprint space across ``num_shards`` owner
shards — the HYDRAstor-style design of ``dedup/dist_index.py`` — so index
lookups, refcounting, GC, and block IO all become owner-local and
embarrassingly parallel:

    submit/put ──► ChunkScheduler (shared; batched SeqCDC + fingerprints)
               ──► owner_of(fp.h1, N)  — dist_index's consistent-hash rule
               ──► ShardWriter[owner]  — async bounded queue, one per shard
               ──► BlockStore[owner]   — owner-local refcounts + accounting
    flush      ──► writer barrier ──► recipes commit ──► manifests sync
    get        ──► gather chunks across shards ──► SHA-256 verify

**Routing.**  ``owner_of`` (fp.h1 mod N) is the single partition rule; equal
chunks have equal fingerprints, land on the same owner, and dedup there —
owner-local dedup is therefore globally exact, and an N-shard service stores
byte-for-byte the same unique chunks as the 1-shard service.  When a
:class:`~repro_torch.launch.mesh.Mesh` whose ``mesh_axis`` has N positions
is supplied (``make_host_mesh(shards=N)``: N logical shards of one card),
per-flush fingerprint records travel the capacity-padded ``all_to_all``
(:func:`~repro_torch.dedup.dist_index.routed_fp_tables`) into per-owner
tables; a batch that overflows the buckets is re-routed on the host
(counted in ``overflow_rerouted``, never dropped — see docs/SHARDING.md).
Without a mesh, :func:`~repro_torch.dedup.dist_index.route_host` routes on
the host.  Both derive from the same ``owner_of``.

**Async flush.**  Store writes run on per-shard writer threads behind a
bounded queue (``max_pending`` chunks of backpressure), so SHA-256 hashing
and block-file IO overlap with device chunking instead of serializing after
it.  Crash-safe ordering is preserved: the flush barrier guarantees every
block durably landed *before* any recipe is committed or any manifest
synced, so a crash at any point leaves orphan blocks (reclaimed by
:meth:`gc`), never a manifest or recipe naming bytes that don't exist.

**Restores.**  Recipes record each chunk's owner shard (routing is by
accelerator fingerprint, which the SHA key alone cannot reproduce); ``get``
gathers chunks across shards and verifies the whole-object SHA-256, exactly
like the single-store service.

**Transports.**  ``transport="local"`` (default) keeps every shard's
``BlockStore`` in-process.  ``transport="remote"`` moves each shard behind
a process boundary: :meth:`open` spawns one ``shard_server`` process per
shard directory and wires a :class:`~repro_torch.service.transport.RemoteShardClient`
— which implements the same store surface — into the writer seam.  Nothing
else changes: the scheduler, the device pipeline, and fp routing via
``dist_index.owner_of`` are bit-identical across transports, and the
on-disk layout is too, so a depot reopens under either transport
(docs/SHARDING.md documents the wire protocol and failure semantics).
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.params import SeqCDCParams, derived_params
from repro_torch.dedup.dist_index import route_host, routed_fp_tables
from repro_torch.dedup.index import FingerprintIndex
from repro_torch.dedup.store import (
    BlockCorruptionError,
    BlockStore,
    DirBlockStore,
)
from repro_torch.obs import MetricsRegistry, span

from .api import (
    GCStats,
    IntegrityError,
    ObjectStat,
    ServiceBase,
    ServiceStats,
    pack_fps,
    recipe_totals,
    sweep_store,
    verify_restore,
)
from .depot import pin_depot_shards, read_depot_shards, shard_roots
from .objects import ObjectRecipe, RecipeTable
from .scheduler import ChunkResult, ChunkScheduler
from .transport.client import spawn_shard_servers
from .transport.protocol import ShardTransportError
from .writer import WriterPool

TRANSPORTS = ("local", "remote")


class ShardedDedupService(ServiceBase):
    """Fingerprint-partitioned dedup across N owner-local shards."""

    def __init__(
        self,
        num_shards: int = 4,
        stores: Optional[Sequence[BlockStore]] = None,
        params: Optional[SeqCDCParams] = None,
        *,
        device: str | torch.device = "cuda",
        avg_chunk: int = 8192,
        slots: int = 8,
        min_bucket: int = 1 << 14,
        recipes: Optional[RecipeTable] = None,
        mask_impl: str = "cuda",
        step_impl: str = "wide",
        fp_impl: str = "cuda",
        pipeline_impl: str = "fused",
        packing_impl: str = "off",
        cross_check_masks: bool = False,
        cross_check_fps: bool = False,
        cross_check_pipeline: bool = False,
        cross_check_packing: bool = False,
        async_flush: bool = True,
        max_pending: int = 256,
        mesh=None,
        mesh_axis: str = "data",
        capacity_factor: float = 1.5,
        transport: str = "local",
        codec: Optional[str] = None,
    ):
        if stores is not None and len(stores) != num_shards:
            raise ValueError(f"{len(stores)} stores for {num_shards} shards")
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {transport!r}")
        if transport == "remote" and stores is None:
            raise ValueError(
                "transport='remote' needs shard servers: use "
                "ShardedDedupService.open(root, N, transport='remote') to "
                "spawn them, or pass stores=[RemoteShardClient(...), ...]"
            )
        self.transport = transport
        #: ShardServerProcess handles when :meth:`open` spawned the servers
        #: (empty for user-provided clients and for the local transport)
        self._servers: list = []
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.params = params or derived_params(avg_chunk)
        # codec applies to default-constructed stores only; explicit stores
        # (including remote clients) arrive already configured
        self.stores: List[BlockStore] = (
            list(stores) if stores is not None
            else [BlockStore(codec=codec) for _ in range(self.num_shards)]
        )
        self.recipes = recipes if recipes is not None else RecipeTable()
        # one registry for the whole service: scheduler dispatches, writer
        # queues, and client-side RPCs all report here; remote servers keep
        # their own, aggregated live by :meth:`metrics`
        self.obs = MetricsRegistry()
        if self.transport == "remote":
            for st in self.stores:
                # RemoteShardClient contract: a settable .registry turns on
                # its per-op rpc.client.* accounting
                st.registry = self.obs
        else:
            for s, st in enumerate(self.stores):
                if hasattr(st, "attach_obs"):
                    # shard-labeled compression telemetry (store.compress_s,
                    # store.compressed_bytes{shard=}) into the one registry
                    st.attach_obs(self.obs, shard=s)
        # fingerprints are mandatory: they are the routing key
        self.scheduler = ChunkScheduler(
            self.params, device=device, registry=self.obs, slots=slots,
            min_bucket=min_bucket, mask_impl=mask_impl, step_impl=step_impl,
            fp_impl=fp_impl, pipeline_impl=pipeline_impl,
            packing_impl=packing_impl,
            with_fingerprints=True, cross_check_masks=cross_check_masks,
            cross_check_fps=cross_check_fps,
            cross_check_pipeline=cross_check_pipeline,
            cross_check_packing=cross_check_packing,
        )
        self.device = self.scheduler.device
        # validate the mesh before anything spawns threads: a constructor
        # that raises must not leak per-shard writer workers
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            if mesh_axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no axis {mesh_axis!r} (axes: "
                    f"{list(mesh.shape)}); pass mesh_axis=<name>"
                )
            if mesh.shape[mesh_axis] != self.num_shards:
                raise ValueError(
                    f"mesh axis {mesh_axis!r} has {mesh.shape[mesh_axis]} "
                    f"devices but the service has {self.num_shards} shards; "
                    f"the all_to_all route needs one device per owner shard"
                )
        self._routed_fn = (
            routed_fp_tables(mesh, mesh_axis, capacity_factor=capacity_factor)
            if mesh is not None else None
        )
        self.async_flush = bool(async_flush)
        self.writers = WriterPool(
            self.num_shards, max_pending if self.async_flush else 0,
            registry=self.obs,
        )
        # owner-local fingerprint indexes (the paper's estimator layer),
        # partitioned by the same rule as the stores
        self.fp_index: List[FingerprintIndex] = [
            FingerprintIndex() for _ in range(self.num_shards)
        ]
        #: fp records that overflowed the mesh all_to_all capacity and were
        #: re-routed on the host (never dropped; docs/SHARDING.md)
        self.overflow_rerouted = 0
        self._in_flight: set[str] = set()  # names submitted, not yet flushed

    @classmethod
    def open(cls, root: str, num_shards: int = 4, *,
             codec: Optional[str] = None, hot_bytes: int = 0,
             **kwargs) -> "ShardedDedupService":
        """File-backed sharded service: one block depot per shard under
        ``root/shard-NN/`` plus a shared recipe table.  The shard count is
        pinned in ``root/sharding.json`` — reopening with a different N would
        scatter the partition map, so it is a hard error (repartitioning is
        what ``scripts/reshard.py`` is for).

        ``transport="remote"`` spawns one ``shard_server`` process per shard
        directory and wires remote clients in place of the in-process
        stores; the servers are stopped by :meth:`close`.  The on-disk
        layout is transport-independent, so the same depot reopens under
        either transport.
        """
        if num_shards < 1:  # validate before the depot meta is persisted:
            # a bad first call must not poison root/sharding.json
            raise ValueError("num_shards must be >= 1")
        os.makedirs(root, exist_ok=True)
        want = read_depot_shards(root)
        if want is not None and want != num_shards:
            raise ValueError(
                f"depot {root!r} was created with num_shards={want}, "
                f"reopen requested {num_shards}"
            )
        pinned_here = want is None
        if pinned_here:
            pin_depot_shards(root, num_shards)
        servers = []
        try:
            roots = shard_roots(root, num_shards)
            if kwargs.get("transport") == "remote":
                # each server resolves codec itself (arg > shard manifest >
                # env); the client hello then negotiates the wire codec
                servers = spawn_shard_servers(roots, codec=codec,
                                              hot_bytes=hot_bytes)
                stores = [h.connect(codec=codec, shard=i)
                          for i, h in enumerate(servers)]
            else:
                stores = [DirBlockStore(r, codec=codec, hot_bytes=hot_bytes)
                          for r in roots]
            recipes = RecipeTable(os.path.join(root, "recipes.json"))
            svc = cls(num_shards, stores=stores, recipes=recipes,
                      codec=codec, **kwargs)
        except BaseException:
            for h in servers:
                h.stop()
            if pinned_here:
                # the open never produced a service: a retry must be free
                # to pick a different N, so un-poison the fresh pin
                try:
                    os.remove(os.path.join(root, "sharding.json"))
                except OSError:
                    pass
            raise
        svc._servers = servers
        return svc

    # -- ingest -----------------------------------------------------------------
    def flush(self) -> List[ObjectStat]:
        """Drain the scheduler, write blocks to owner shards, commit recipes.

        Durability protocol (the async generalization of the single-store
        flush):

        1. every chunk's ``put`` is enqueued on its owner shard's writer;
        2. the writer barrier waits until all blocks durably landed — a
           failed write raises here and *nothing* below runs;
        3. recipes (with per-chunk owners) are committed and synced;
        4. shard manifests are synced — only after their blocks landed;
        5. blocks superseded by overwrites are released, manifests re-synced.

        A crash after (1) leaves orphan blocks for :meth:`gc`; a crash
        between (3) and (4) leaves stale manifests that :meth:`gc` repairs
        against the recipe roots.  No ordering leaves a recipe or manifest
        naming bytes that were never written.
        """
        # whatever drain() does — return results, or lose requests to a
        # device-side error — the submitted names are no longer pending, so
        # they must stop blocking resubmission
        with self._request("flush"):
            t0 = time.perf_counter()
            with span("service.flush") as sp:
                out = self._flush(sp)
            self.obs.observe("service.flush_s", time.perf_counter() - t0)
            return out

    def _flush(self, sp) -> List[ObjectStat]:
        tail0 = self.scheduler.stats.tail_s
        with self._phase("chunk-dispatch"):
            try:
                results = self.scheduler.drain()
            finally:
                self._in_flight.clear()
        # the host tail redo ran inside drain(); reattribute its
        # self-reported seconds so tail latency is its own phase
        self._move_phase("chunk-dispatch", "tail",
                         self.scheduler.stats.tail_s - tail0)
        staged = []  # (result, owners, keys)
        # coalesce each shard's puts: the writer seam accepts batches
        # (``put_blocks``), so a flush submits one task per shard —
        # one RPC on the remote transport where the old path paid one
        # round trip per chunk — split only at ``put_batch_bytes`` so an
        # arbitrarily large flush cannot buffer unbounded chunk bytes
        # in a single frame
        batches: dict[int, list] = {}  # shard -> [(keys, i, chunk view)]
        with self._phase("routing"):
            for res in results:
                owners = self._owners_for(res)
                keys: List[Optional[str]] = [None] * len(owners)
                s = 0
                for i, e in enumerate(res.bounds.tolist()):
                    batches.setdefault(int(owners[i]), []).append(
                        (keys, i, res.data[s:e])
                    )
                    s = e
                staged.append((res, owners, keys))
        # writer-queue-wait = submit backpressure + the barrier: the time
        # this request spent waiting on writer queues (which is where the
        # store writes and shard RPCs happen) before its blocks were durable
        with self._phase("writer-queue-wait"):
            for shard, items in batches.items():
                for group in self._split_batches(items):
                    self.writers.submit(
                        shard, self._put_blocks_task(shard, group),
                        nbytes=sum(c.size for _, _, c in group),
                    )
            self.writers.barrier()  # blocks are durable past this point

        out = []
        stale: List[tuple[int, str]] = []
        with self._phase("commit"):
            for res, owners, keys in staged:
                name = str(res.tag)
                old = self.recipes.get(name) if name in self.recipes else None
                recipe = ObjectRecipe(
                    name=name,
                    size=res.size,
                    sha256=hashlib.sha256(res.data).hexdigest(),
                    keys=list(keys),  # type: ignore[arg-type]
                    chunk_lens=res.lengths.astype(int).tolist(),
                    shards=[int(o) for o in owners],
                    fps=pack_fps(res.fps),  # fps mandatory here: reshardable
                )
                self.recipes.add(recipe)
                out.append(ObjectStat.of(recipe))
                self.obs.inc("ingest.objects")
                self.obs.inc("ingest.bytes", res.size)
                self.obs.inc("ingest.chunks", len(keys))
                if old is not None:
                    stale.extend(zip(self._recipe_shards(old), old.keys))
        sp["objects"] = len(out)
        with self._phase("fp"):
            self._ingest_fps(results)
        with self._phase("sync"):
            self.sync()
        if stale:
            by_shard: dict[int, List[str]] = {}
            for shard, key in stale:
                by_shard.setdefault(shard, []).append(key)
            with self._phase("writer-queue-wait"):
                for shard, keys in by_shard.items():
                    self.writers.submit(shard,
                                        self._release_task(shard, keys))
                self.writers.barrier()
            with self._phase("sync"):
                self.sync()
        return out

    #: max chunk payload per coalesced ``put_blocks`` call: a typical flush
    #: is one batch per shard; a huge one splits so neither the writer task
    #: nor a remote frame materializes unbounded bytes at once
    put_batch_bytes = 16 << 20

    def _split_batches(self, items: list) -> list:
        """Split one shard's (keys, i, chunk) puts at ``put_batch_bytes``."""
        groups, cur, size = [], [], 0
        for it in items:
            cur.append(it)
            size += it[2].size
            if size >= self.put_batch_bytes:
                groups.append(cur)
                cur, size = [], 0
        if cur:
            groups.append(cur)
        return groups

    def _put_blocks_task(self, owner: int, items: list):
        """One coalesced batched put on the owner's writer thread; the
        returned keys are scattered back into each recipe's key slots."""
        store = self.stores[owner]

        def task():
            got = store.put_blocks([c.tobytes() for _, _, c in items])
            for (keys, i, _), key in zip(items, got):
                keys[i] = key

        return task

    def _release_task(self, shard: int, keys: List[str]):
        store = self.stores[shard]
        return lambda: store.release_many(keys)

    def _owners_for(self, res: ChunkResult) -> np.ndarray:
        """Owner shard per chunk of one result (dist_index's hash rule)."""
        if self.num_shards == 1 or res.fps.size == 0:
            return np.zeros(len(res.bounds), dtype=np.int32)
        return route_host(res.fps, self.num_shards)

    def _recipe_shards(self, r: ObjectRecipe) -> List[int]:
        """Per-chunk owners of a recipe; tolerate single-store tables at N=1
        (migration path: a DedupService depot opens as a 1-shard service)."""
        if r.shards is not None:
            return r.shards
        if self.num_shards == 1:
            return [0] * len(r.keys)
        raise IntegrityError(
            f"recipe {r.name!r} has no shard map but the service has "
            f"{self.num_shards} shards"
        )

    # -- fingerprint-estimator ingestion ---------------------------------------
    def _ingest_fps(self, results: List[ChunkResult]):
        """Feed owner-local fp indexes, via the mesh all_to_all when present."""
        live = [r for r in results if r.fps.size]
        if not live:
            return
        fps = np.concatenate([r.fps for r in live])
        lengths = np.concatenate([r.lengths for r in live]).astype(np.int32)
        if self._routed_fn is not None and self._mesh_ingest(fps, lengths):
            return
        owners = route_host(fps, self.num_shards)
        for s in range(self.num_shards):
            m = owners == s
            if m.any():
                new = self.fp_index[s].add_batch(fps[m], lengths[m])
                # estimator-level dup count (62-bit fp re-seen), the sharded
                # analogue of the single-store exact ingest.dedup_hit_chunks;
                # the exact per-shard truth lives in each remote server's
                # store.dedup_hit_chunks
                self.obs.inc("ingest.fp_dup_chunks",
                             int(len(new) - np.count_nonzero(new)))

    def _mesh_ingest(self, fps: np.ndarray, lengths: np.ndarray) -> bool:
        """Route fp records through the all_to_all path into owner tables.

        Returns False (the caller re-routes with :func:`route_host`) when
        the capacity-padded buckets overflowed: the overflow is counted in
        ``overflow_rerouted`` and the whole batch is re-routed on the host
        so no record is lost (the contract in docs/SHARDING.md).
        """
        ns = self.mesh.shape[self.mesh_axis]
        rows = len(lengths)
        # pad to ns * next-power-of-two rows a shard, as the reference does
        # (it bounds its compile cache so); zero-length rows go nowhere
        per_shard = max(1, -(-rows // ns))
        target = ns * (1 << (per_shard - 1).bit_length())
        pad = target - rows
        if pad:
            fps = np.concatenate([fps, np.zeros((pad, 2), dtype=fps.dtype)])
            lengths = np.concatenate([lengths,
                                      np.zeros(pad, dtype=lengths.dtype)])
        with span("service.mesh_route", rows=rows, shards=ns):
            tables, overflow = self._routed_fn(fps, lengths)
        if overflow > 0:
            self.overflow_rerouted += overflow
            self.obs.inc("ingest.mesh_overflow_rerouted", overflow)
            return False
        if not isinstance(tables, tuple):  # one tensor: one copy to host
            tables = tables.cpu()
        for s in range(self.num_shards):
            flat = tables[s].cpu().numpy().reshape(-1, 3)  # (src*cap, 3)
            valid = flat[:, 2] > 0
            if valid.any():
                new = self.fp_index[s].add_batch(
                    flat[valid, :2].astype(np.uint32),
                    flat[valid, 2].astype(np.int64),
                )
                self.obs.inc("ingest.fp_dup_chunks",
                             int(len(new) - np.count_nonzero(new)))
        return True

    # -- serve ------------------------------------------------------------------
    def get(self, name: str) -> bytes:
        """Reassemble an object, gathering chunks across owner shards;
        verifies length and whole-object SHA-256 (:class:`IntegrityError`).

        Chunk fetches are batched per owner shard (one ``get_blocks`` call
        each) — for the remote transport that is one RPC per shard instead
        of one per chunk — then spliced back into stream order.
        """
        r = self.recipes.get(name)
        with self._request("get", object=name):
            t0 = time.perf_counter()
            with span("service.get", object=name, bytes=r.size):
                with self._phase("routing"):
                    owners = self._recipe_shards(r)
                    by_shard: dict[int, List[int]] = {}
                    for i, shard in enumerate(owners):
                        by_shard.setdefault(shard, []).append(i)
                # "rpc" = the per-shard block gather (one get_blocks call
                # per owner shard; a real RPC on the remote transport, the
                # same seam served in-process on the local one)
                parts: List[Optional[bytes]] = [None] * len(r.keys)
                with self._phase("rpc"):
                    try:
                        for shard, idxs in by_shard.items():
                            blocks = self.stores[shard].get_blocks(
                                [r.keys[i] for i in idxs]
                            )
                            for i, b in zip(idxs, blocks):
                                parts[i] = b
                    except BlockCorruptionError as e:
                        # a block that fails to decode (locally or typed
                        # across the wire) is corrupt storage, the same
                        # contract breach as a digest mismatch
                        raise IntegrityError(f"object {name!r}: {e}") from e
                with self._phase("verify"):
                    data = verify_restore(
                        r, b"".join(parts)  # type: ignore[arg-type]
                    )
            self.obs.observe("service.get_s", time.perf_counter() - t0)
            self.obs.inc("restore.objects")
            self.obs.inc("restore.bytes", r.size)
            return data

    # -- delete / GC ------------------------------------------------------------
    def delete(self, name: str) -> int:
        """Remove an object; returns stored bytes actually reclaimed.

        Same ordering as the single-store service: recipe removal is made
        durable first, then block releases run on the owner shards' writers
        (keeping every store single-writer), so a crash mid-delete leaves
        reclaimable orphans, never a recipe naming missing blocks.
        """
        with self._request("delete", object=name):
            r = self.recipes.remove(name)  # KeyError for unknown objects
            with self._phase("sync"):
                self.recipes.sync()
            freed = [0] * self.num_shards
            by_shard: dict[int, List[tuple[str, int]]] = {}
            for shard, key, ln in zip(self._recipe_shards(r), r.keys,
                                      r.chunk_lens):
                by_shard.setdefault(shard, []).append((key, ln))
            with self._phase("writer-queue-wait"):
                for shard, pairs in by_shard.items():
                    self.writers.submit(shard,
                                        self._free_task(shard, pairs, freed))
                self.writers.barrier()
            with self._phase("sync"):
                self.sync()
            return sum(freed)

    def _free_task(self, shard: int, pairs: List[tuple[str, int]],
                   freed: List[int]):
        """One shard's batched release — a single RPC for a remote store."""
        store = self.stores[shard]

        def task():
            flags = store.release_many([k for k, _ in pairs])
            freed[shard] = sum(ln for (_, ln), f in zip(pairs, flags) if f)

        return task

    def gc(self) -> GCStats:
        """Owner-local mark-and-sweep on every shard, recipes as roots.

        Each shard sweeps only the keys it owns (its store's
        ``scan_keys``), on its own writer thread, in parallel; the recipe
        scan partitions the roots by recorded owner.  Semantics per shard
        are identical to the single-store :meth:`DedupService.gc`: crash
        orphans reclaimed, refcount drift repaired.
        """
        live: List[Counter] = [Counter() for _ in range(self.num_shards)]
        for r in self.recipes:
            for shard, key in zip(self._recipe_shards(r), r.keys):
                live[shard][key] += 1
        totals = [GCStats(0, 0, 0) for _ in range(self.num_shards)]
        for s in range(self.num_shards):
            self.writers.submit(s, self._gc_task(s, live[s], totals))
        self.writers.barrier()
        self.sync()
        return GCStats(
            freed_blocks=sum(t.freed_blocks for t in totals),
            freed_bytes=sum(t.freed_bytes for t in totals),
            repaired_refs=sum(t.repaired_refs for t in totals),
        )

    def _gc_task(self, s: int, live: Counter, totals: List[GCStats]):
        store = self.stores[s]

        def task():
            totals[s] = sweep_store(store, live)

        return task

    def sync(self):
        """Persist recipes, then every shard manifest (in-memory: no-op)."""
        self.recipes.sync()
        for store in self.stores:
            store.sync()

    def close(self):
        """Drain writers and stop their threads (propagates write errors);
        spawned shard servers are shut down even when the drain fails."""
        try:
            self.writers.close()
        finally:
            for h, st in zip(self._servers, self.stores):
                try:
                    h.stop(st)
                except Exception:  # noqa: BLE001 — dead server is fine here
                    pass
            self._servers = []
            if self.transport == "remote":
                for st in self.stores:
                    try:
                        st.close()
                    except Exception:  # noqa: BLE001
                        pass

    def __enter__(self) -> "ShardedDedupService":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- accounting -------------------------------------------------------------
    def stats(self) -> ServiceStats:
        """Aggregate accounting, same shape as the single-store service
        (which makes N-vs-1 equivalence directly assertable)."""
        logical, total_chunks, hist = recipe_totals(self.recipes)
        fp_orig = sum(ix.original_bytes for ix in self.fp_index)
        fp_dedup = sum(ix.dedup_bytes for ix in self.fp_index)
        sched = self.scheduler.stats
        per = [st.stat() for st in self.stores]  # one RPC per remote shard
        return ServiceStats(
            objects=len(self.recipes),
            logical_bytes=logical,
            stored_bytes=sum(p["stored_bytes"] for p in per),
            total_chunks=total_chunks,
            unique_chunks=sum(p["unique_chunks"] for p in per),
            chunk_size_hist=hist,
            fp_estimated_savings=(fp_orig - fp_dedup) / fp_orig if fp_orig else 0.0,
            batches=sched.dispatches,
            batch_occupancy=sched.occupancy,
            compressed_bytes=sum(
                int(p.get("compressed_bytes", p["stored_bytes"]))
                for p in per
            ),
            codec=getattr(self.stores[0], "codec", "none"),
        )

    def _shard_metric_snapshots(self) -> List[Optional[dict]]:
        """One live server-side snapshot per remote shard (the v2 ``metrics``
        op); ``None`` for a shard whose server is unreachable, so one dead
        server degrades the aggregate instead of failing :meth:`metrics`.
        Local-transport shards have no server process and report nothing —
        their writers/stores already count into the service registry."""
        if self.transport != "remote":
            return []
        out: List[Optional[dict]] = []
        for st in self.stores:
            try:
                out.append(st.metrics())
            except (ShardTransportError, KeyError):
                out.append(None)
        return out

    def shard_stats(self) -> List[dict]:
        """Per-shard breakdown: balance of the fingerprint partition."""
        out = []
        for s, st in enumerate(self.stores):
            acct = st.stat()  # one RPC per remote shard
            out.append({
                "shard": s,
                "stored_bytes": acct["stored_bytes"],
                "logical_bytes": acct["logical_bytes"],
                "compressed_bytes": int(
                    acct.get("compressed_bytes", acct["stored_bytes"])
                ),
                "unique_chunks": acct["unique_chunks"],
                "fp_entries": len(self.fp_index[s].seen),
            })
        return out
