"""RemoteShardClient: a shard server spoken to through the store interface.

The sharded service's writer seam is the per-shard ``BlockStore`` surface —
``put``/``get``/``release``/``sync`` plus the accounting properties and the
GC ``sweep``.  This client implements exactly that surface over the framed
protocol, so ``ShardedDedupService(transport="remote")`` swaps it in where
a ``DirBlockStore`` sat and *nothing else changes*: the scheduler, the
device pipeline, fp routing via ``dist_index.owner_of``, the writer-queue
ordering, and the flush protocol are all bit-identical to the local
transport.  A copy of the reference's ``repro/service/transport/client.py``
that spawns the port's own server module.

Thread-safety: one client is shared between a shard's writer thread
(puts/releases) and the ingest thread (gets, sync, stats), so every RPC is
one lock-held request/response round trip on a single connection.  Cross-
shard parallelism is unaffected — each shard has its own client, socket,
and server process.

Failure model: any transport fault (dead server, torn frame) marks the
client dead and raises :class:`ShardTransportError` from the current and
all subsequent ops — fail-fast, no silent retry.  Inside a flush that
surfaces as ``AsyncWriteError`` at the writer barrier, *before* any recipe
is committed; the depot is left in the orphan-blocks-only state the GC
already knows how to repair (docs/SHARDING.md has the full kill matrix).

Telemetry: when the owning service attaches its registry (``.registry``),
every RPC is counted, timed, and blob-byte-accounted client-side
(``rpc.client.*``, labeled by op) — mirroring the ``rpc.server.*`` metrics
each server keeps, with identical byte semantics (payload blob only), so
the two ends of the wire can be reconciled exactly.  :meth:`metrics`
fetches a server's live snapshot via the v2 ``metrics`` op.

``ShardServerProcess`` spawns/stops the actual server processes; the
service's ``open(root, N, transport="remote")`` uses it, and tests use its
``kill()`` for SIGKILL crash injection.
"""
from __future__ import annotations

import os
import re
import selectors
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.dedup.store import encode_block, resolve_codec, sha256_key
from repro_torch.obs import MetricsRegistry, current_context, labeled, span

from . import protocol as P
from .protocol import ShardTransportError


class RemoteShardClient:
    """Store-shaped proxy for one shard server (see module docstring).

    Protocol v4: the client sends its preferred ``codec`` in a ``hello``
    right after connect; every later :meth:`put_blocks` hashes and
    compresses the chunks *client-side under the negotiated codec* — and
    since the sharded service calls ``put_blocks`` from the per-shard
    writer thread, the encode runs off the ingest thread and the bytes
    travel compressed.  ``codec="none"`` (the default) keeps the legacy
    raw frames byte-for-byte.
    """

    def __init__(self, host: str, port: int, *, timeout: float = 120.0,
                 registry: Optional[MetricsRegistry] = None,
                 codec: Optional[str] = None, shard: int = 0):
        self.host, self.port = host, int(port)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._dead: Optional[str] = None
        #: owning service's registry; None → RPCs go uncounted.  Settable
        #: after construction (the sharded service attaches its own).
        self.registry = registry
        self.shard = int(shard)
        self._sock = socket.create_connection((host, self.port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        #: wire codec for put_blocks payloads, fixed by the v4 hello
        self.codec = "none"
        preferred = resolve_codec(codec)
        if preferred != "none":
            meta, _ = self._rpc(P.OP_HELLO, {"codec": preferred})
            self.codec = str(meta["codec"])

    # -- transport core ---------------------------------------------------------
    def _rpc(self, op: int, meta: Optional[dict] = None,
             blob: bytes = b"", *, unbounded: bool = False) -> Tuple[dict, bytes]:
        """One locked request/response round trip.

        ``unbounded`` lifts the socket timeout for ops whose server-side
        work scales with store size (a full GC sweep, a directory scan) —
        a slow-but-healthy server must not be declared dead mid-sweep.
        """
        reg, opname = self.registry, P.OP_NAMES.get(op, str(op))
        if reg is not None:
            reg.inc(labeled("rpc.client.calls", op=opname))
            reg.inc(labeled("rpc.client.send_bytes", op=opname), len(blob))
        t0 = time.perf_counter()
        with span("rpc.client", op=opname,
                  peer=f"{self.host}:{self.port}", send_bytes=len(blob)):
            # protocol v3: ship this span's context in frame meta so the
            # server's rpc.server span becomes our child (copy, never
            # mutate the caller's dict); absent entirely when tracing is
            # off, so the off path stays byte-identical on the wire
            tctx = current_context()
            if tctx is not None:
                meta = {**(meta or {}), "trace": tctx}
            with self._lock:
                if self._dead is not None:
                    raise ShardTransportError(
                        f"shard server {self.host}:{self.port} is down "
                        f"({self._dead})"
                    )
                try:
                    if unbounded:
                        self._sock.settimeout(None)
                    P.send_frame(self._sock, op, meta, blob)
                    rop, rmeta, rblob = P.recv_frame(self._sock)
                except (OSError, P.ProtocolError) as e:
                    self._mark_dead(e)
                    if reg is not None:
                        reg.inc(labeled("rpc.client.errors", op=opname))
                    raise ShardTransportError(
                        f"shard server {self.host}:{self.port} unreachable "
                        f"during {P.OP_NAMES.get(op, op)}: {e}"
                    ) from e
                finally:
                    if unbounded and self._dead is None:
                        self._sock.settimeout(self._timeout)
        if reg is not None:
            # latency includes lock wait: that's the caller-observed RPC
            # cost when the writer and ingest threads contend for the
            # single connection, which is exactly what we want visible
            reg.observe(labeled("rpc.client.latency_s", op=opname),
                        time.perf_counter() - t0)
            reg.inc(labeled("rpc.client.recv_bytes", op=opname), len(rblob))
            if rop == P.OP_ERROR:
                reg.inc(labeled("rpc.client.errors", op=opname))
        if rop == P.OP_ERROR:
            P.raise_remote(rmeta)
        return rmeta, rblob

    def _mark_dead(self, cause):
        self._dead = f"{type(cause).__name__}: {cause}"
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self):
        """Close the connection (idempotent; further ops fail fast)."""
        with self._lock:
            if self._dead is None:
                self._dead = "closed"
                try:
                    self._sock.close()
                except OSError:
                    pass

    # -- the writer-seam store surface ------------------------------------------
    def put(self, chunk: bytes) -> str:
        return self.put_blocks([bytes(chunk)])[0]

    def put_blocks(self, chunks: List[bytes]) -> List[str]:
        if self.codec != "none":
            # v4 pre-compressed frame: hash + encode here (the caller is
            # the shard's writer thread, so this is off the ingest thread),
            # ship payloads compressed, server files them as-is.  Per-item
            # ``codecs``: encode_block falls back to raw on incompressible
            # chunks, and those ship (and are stored) raw in the same frame.
            keys, raw_sizes, codecs, payloads = [], [], [], []
            t0 = time.perf_counter()
            for c in chunks:
                keys.append(sha256_key(c))
                raw_sizes.append(len(c))
                eff, payload = encode_block(self.codec, c)
                codecs.append(eff)
                payloads.append(payload)
            reg = self.registry
            if reg is not None:
                reg.observe("store.compress_s", time.perf_counter() - t0)
                reg.inc(labeled("store.compressed_bytes", shard=self.shard),
                        sum(len(p) for p, e in zip(payloads, codecs)
                            if e != "none"))
            self._rpc(P.OP_PUT_BLOCKS, {
                "codec": self.codec,
                "codecs": codecs,
                "keys": keys,
                "raw_sizes": raw_sizes,
                "sizes": [len(p) for p in payloads],
            }, b"".join(payloads))
            return keys
        meta, _ = self._rpc(P.OP_PUT_BLOCKS,
                            {"sizes": [len(c) for c in chunks]},
                            b"".join(chunks))
        return list(meta["keys"])

    def get(self, key: str) -> bytes:
        return self.get_blocks([key])[0]

    def get_blocks(self, keys: List[str]) -> List[bytes]:
        meta, blob = self._rpc(P.OP_GET_BLOCKS, {"keys": list(keys)})
        return P.split_blob(blob, meta["sizes"])

    def get_stream(self, keys) -> bytes:
        return b"".join(self.get_blocks(list(keys)))

    def release(self, key: str) -> bool:
        return self.release_many([key])[0]

    def release_many(self, keys) -> List[bool]:
        meta, _ = self._rpc(P.OP_RELEASE, {"keys": list(keys)})
        return [bool(f) for f in meta["freed"]]

    def put_recipe(self, recipe) -> None:
        d = recipe.to_json() if hasattr(recipe, "to_json") else dict(recipe)
        self._rpc(P.OP_PUT_RECIPE, {"recipe": d})

    def sync(self):
        """put_manifest: server syncs its refcount manifest + recipe table."""
        self._rpc(P.OP_PUT_MANIFEST)

    def stat(self, *, scan: bool = False) -> dict:
        meta, _ = self._rpc(P.OP_STAT, {"scan": scan} if scan else None,
                            unbounded=scan)  # scan walks the blocks dir
        return meta

    def scan_keys(self) -> List[str]:
        return list(self.stat(scan=True)["keys"])

    #: live entries per gc_mark frame: ~70 JSON bytes each keeps every
    #: frame a few MB, far under protocol.MAX_META however large the shard
    GC_MARK_BATCH = 100_000

    def sweep(self, live: Dict[str, int]) -> Tuple[int, int, int]:
        """Server-side GC: upload recomputed liveness, sweep next to the data.

        Same semantics as :meth:`BlockStore.sweep`, but the per-key loop
        runs on the server.  The live table is uploaded in
        :data:`GC_MARK_BATCH`-entry ``gc_mark`` frames (the server
        accumulates; ``reset`` on the first frame starts a fresh mark), so
        a shard with tens of millions of live chunks never produces a
        frame the protocol would reject.
        """
        items = [(k, int(v)) for k, v in live.items()]
        # max(1, ...): an empty table still sends one reset frame so a
        # stale mark from an aborted earlier pass cannot leak into this one
        for off in range(0, max(1, len(items)), self.GC_MARK_BATCH):
            self._rpc(P.OP_GC_MARK, {
                "reset": off == 0,
                "live": dict(items[off:off + self.GC_MARK_BATCH]),
            })
        meta, _ = self._rpc(P.OP_GC_SWEEP, unbounded=True)  # scales with store
        return (int(meta["freed_blocks"]), int(meta["freed_bytes"]),
                int(meta["repaired_refs"]))

    def ping(self) -> dict:
        meta, _ = self._rpc(P.OP_PING)
        return meta

    def metrics(self) -> dict:
        """Live server-side MetricsRegistry snapshot (v2 ``metrics`` op)."""
        meta, _ = self._rpc(P.OP_METRICS)
        return meta["metrics"]

    def shutdown(self):
        """Ask the server to sync and exit (the graceful stop path)."""
        self._rpc(P.OP_SHUTDOWN)
        self.close()

    # -- accounting properties (the service's stats surface) ---------------------
    @property
    def stored_bytes(self) -> int:
        return int(self.stat()["stored_bytes"])

    @property
    def logical_bytes(self) -> int:
        return int(self.stat()["logical_bytes"])

    @property
    def unique_chunks(self) -> int:
        return int(self.stat()["unique_chunks"])

    @property
    def compressed_bytes(self) -> int:
        return int(self.stat()["compressed_bytes"])

    def __repr__(self):
        state = "dead" if self._dead else "up"
        return f"RemoteShardClient({self.host}:{self.port}, {state})"


_READY_RE = re.compile(r"SHARD_SERVER_READY port=(\d+) pid=(\d+)")


class ShardServerProcess:
    """One spawned ``shard_server`` subprocess (spawn, announce, stop, kill)."""

    def __init__(self, root: str, *, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0, codec: Optional[str] = None,
                 hot_bytes: int = 0, shard: int = 0):
        self.root = root
        self.host = host
        self.port: Optional[int] = None
        self._deadline = time.monotonic() + timeout
        env = dict(os.environ)
        src = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "..", "..")
        )
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        cmd = [sys.executable, "-m", "repro_torch.service.transport.shard_server",
               "--root", root, "--host", host, "--port", str(port),
               "--shard", str(shard)]
        if codec is not None:
            cmd += ["--codec", codec]
        if hot_bytes:
            cmd += ["--hot-bytes", str(hot_bytes)]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, env=env, text=True, bufsize=1,
        )

    @classmethod
    def spawn(cls, root: str, **kwargs) -> "ShardServerProcess":
        return cls(root, **kwargs).wait_ready()

    def wait_ready(self) -> "ShardServerProcess":
        """Block until the READY line announces the bound port."""
        if self.port is not None:
            return self
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        try:
            while time.monotonic() < self._deadline:
                if sel.select(timeout=0.1):
                    line = self.proc.stdout.readline()
                    if not line:
                        raise ShardTransportError(
                            f"shard server for {self.root!r} exited before "
                            f"announcing (rc={self.proc.poll()})"
                        )
                    m = _READY_RE.search(line)
                    if m:
                        self.port = int(m.group(1))
                        return self
                elif self.proc.poll() is not None:
                    raise ShardTransportError(
                        f"shard server for {self.root!r} died on startup "
                        f"(rc={self.proc.returncode})"
                    )
            raise ShardTransportError(
                f"shard server for {self.root!r} did not announce in time"
            )
        finally:
            sel.close()

    def connect(self, **kwargs) -> RemoteShardClient:
        self.wait_ready()
        return RemoteShardClient(self.host, self.port, **kwargs)

    def stop(self, client: Optional[RemoteShardClient] = None,
             timeout: float = 10.0):
        """Graceful shutdown (via ``client`` when given), escalating to
        terminate/kill; safe on an already-dead process."""
        if client is not None:
            try:
                client.shutdown()
            except (ShardTransportError, KeyError, OSError):
                pass
        try:
            self.proc.wait(timeout=timeout if client is not None else 0.1)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()

    def kill(self):
        """SIGKILL, no warning — the crash-injection path for tests."""
        self.proc.kill()
        self.proc.wait()


def spawn_shard_servers(roots: List[str], **kwargs) -> List[ShardServerProcess]:
    """Spawn one server per root *in parallel*, waiting for every announce;
    on any failure the already-started processes are killed before raising.
    Each server gets its root's index as its ``shard`` metric label."""
    procs: List[ShardServerProcess] = []
    try:
        for i, r in enumerate(roots):
            procs.append(ShardServerProcess(r, shard=i, **kwargs))
        for p in procs:
            p.wait_ready()
        return procs
    except BaseException:
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass
        raise
