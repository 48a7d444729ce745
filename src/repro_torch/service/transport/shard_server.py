"""Standalone shard server: one owner-local block store behind the protocol.

    python -m repro_torch.service.transport.shard_server --root DEPOT/shard-00 \\
        --host 127.0.0.1 --port 0

Wraps exactly one :class:`~repro_torch.dedup.store.DirBlockStore` (the same
on-disk layout the local transport uses, so a depot moves freely between
``transport="local"`` and ``transport="remote"``) plus a shard-local
:class:`~repro_torch.service.objects.RecipeTable` for the ``put_recipe`` op, and
serves the framed op set from ``protocol.py`` over TCP.

Crash-safe ordering is the store's own discipline, unchanged by the
transport: ``put_blocks`` writes and atomically renames the block file into
place *before* the RPC is acknowledged, so by the time the writer barrier
on the client has every ack, every block has landed; ``put_manifest`` syncs
the refcount manifest strictly afterwards.  Killing the server at any point
(SIGKILL included) therefore leaves orphan blocks or a stale manifest —
both repaired by the service's mark-and-sweep GC on restart — never a
manifest naming bytes that don't exist.  Note the guarantee is
*process*-crash safety, matching ``DirBlockStore``: surviving power loss
would additionally require fsync of the block file and its directory
before the ack (a deliberate future hardening, not done here).

Concurrency: connections are handled on threads (a service's writer client
plus a restore-path client may talk at once), but every store/recipe op runs
under one server-wide lock — the single-writer discipline the local
transport gets from the per-shard writer thread, enforced here at the op
boundary.

On startup the server prints ``SHARD_SERVER_READY port=<p> pid=<p>`` to
stdout (after binding, so ``--port 0`` ephemeral ports are announced);
spawners key on that line.  ``shutdown`` syncs the store and exits cleanly.

Telemetry: every handled frame is counted, timed, and byte-accounted into
a process-wide :class:`~repro_torch.obs.MetricsRegistry` (``rpc.server.*``,
labeled by op — the server-side mirror of the client's ``rpc.client.*``
metrics), and the ``metrics`` op exports the live snapshot, which is how
``ShardedDedupService.metrics()`` aggregates per-shard-server telemetry
(docs/OBSERVABILITY.md).  Failed ops are logged to stderr with a
structured one-line ``SHARD_SERVER_ERROR`` prefix (op name, shard root,
pid, error type) followed by the traceback *before* the typed error frame
is sent — so a server-side failure is diagnosable in the server's log,
not only client-side.

The module deliberately imports no torch: with the lazy package inits a
shard server is a numpy+stdlib process, so spawning N of them costs process
startup, not N torch imports (``repro_torch.obs`` is stdlib-only).  It is a
copy of the reference's ``repro/service/transport/shard_server.py`` and
speaks the same wire protocol, so either package's client can use it.
"""
from __future__ import annotations

import argparse
import os
import socketserver
import sys
import threading
import time
import traceback

from repro_torch.dedup.store import (DirBlockStore, available_codecs,
                               negotiate_codec)
from repro_torch.obs import MetricsRegistry, labeled, scope, span
from repro_torch.service.objects import ObjectRecipe, RecipeTable

from . import protocol as P


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        shard: "ShardServer" = self.server.shard  # type: ignore[attr-defined]
        sock = self.request
        while True:
            try:
                op, meta, blob = P.recv_frame(sock)
            except (ConnectionError, OSError):
                return  # client went away: nothing to clean up, ops are atomic
            except P.ProtocolError as e:
                shard.log_error("recv", e)
                self._send_error(sock, e)
                return  # stream offset untrusted past a framing error
            opname = P.OP_NAMES.get(op, str(op))
            # v3 trace propagation: the client's span context rides in the
            # reserved "trace" meta entry; pop it *before* dispatch (op
            # handlers never see it) and adopt it as the parent of this
            # frame's rpc.server span — absent/None is a clean no-op
            tctx = meta.pop("trace", None) if isinstance(meta, dict) else None
            # the server-side mirror of the client's rpc.client.* metrics:
            # every received frame is counted and blob-byte-accounted (the
            # two ends agree exactly — payload blob bytes, headers/meta
            # excluded on both sides)
            shard.registry.inc(labeled("rpc.server.calls", op=opname))
            shard.registry.inc(labeled("rpc.server.recv_bytes", op=opname),
                               len(blob))
            if op == P.OP_SHUTDOWN:
                with shard.lock:
                    shard.store.sync()
                    shard.sync_recipes()
                try:
                    P.send_frame(sock, op, {"ok": True})
                except OSError:
                    pass
                self.server.shutdown()  # handler thread: unblocks serve_forever
                return
            try:
                t0 = time.perf_counter()
                with scope(tctx), \
                        span("rpc.server", op=opname, recv_bytes=len(blob)):
                    with shard.lock:
                        rmeta, rblob = shard.dispatch(op, meta, blob)
                shard.registry.observe(
                    labeled("rpc.server.latency_s", op=opname),
                    time.perf_counter() - t0,
                )
                shard.registry.inc(
                    labeled("rpc.server.send_bytes", op=opname), len(rblob)
                )
                P.send_frame(sock, op, rmeta, rblob)
            except OSError:
                return
            except BaseException as e:  # noqa: BLE001 — propagated to client
                shard.registry.inc(labeled("rpc.server.errors", op=opname))
                shard.log_error(opname, e)
                self._send_error(sock, e)

    @staticmethod
    def _send_error(sock, exc):
        try:
            P.send_frame(sock, P.OP_ERROR, P.error_meta(exc))
        except OSError:
            pass


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ShardServer:
    """One shard's store + recipe table behind the framed protocol."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 codec: str = None, hot_bytes: int = 0, shard: int = 0):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.store = DirBlockStore(root, codec=codec, hot_bytes=hot_bytes)
        self.recipes = RecipeTable(os.path.join(root, "recipes.json"))
        self.lock = threading.RLock()
        self.registry = MetricsRegistry()
        # server-side encodes (raw puts under a compressing codec, tier
        # demotions) land in this registry's store.* series, exported
        # through the metrics op like every rpc.server.* series
        self.store.attach_obs(self.registry, shard=shard)
        self._gc_live: dict[str, int] = {}
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.shard = self  # type: ignore[attr-defined]

    def log_error(self, opname: str, exc: BaseException):
        """Structured one-line error prefix + traceback on stderr — the
        server-side record of a failed op (the client sees only the typed
        ``OP_ERROR`` frame; before this, failures were invisible here)."""
        print(
            f"SHARD_SERVER_ERROR op={opname} root={self.root} "
            f"pid={os.getpid()} etype={type(exc).__name__}: {exc}",
            file=sys.stderr, flush=True,
        )
        traceback.print_exception(type(exc), exc, exc.__traceback__,
                                  file=sys.stderr)
        sys.stderr.flush()

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    def serve_forever(self):
        self._tcp.serve_forever()

    def shutdown(self):
        self._tcp.shutdown()

    def close(self):
        self._tcp.server_close()

    def sync_recipes(self):
        """Persist the shard-local recipe table — but never materialize an
        empty one: today's sharded service keeps its recipe table at the
        depot root and uses ``put_recipe`` not at all (the op exists for
        the full-remote commit a multi-host deployment needs), so a shard
        dir should not grow a zero-object recipes.json as a side effect."""
        if len(self.recipes) or os.path.exists(self.recipes.path):
            self.recipes.sync()

    # -- op dispatch -------------------------------------------------------------
    def dispatch(self, op: int, meta: dict, blob: bytes):
        """Execute one op (caller holds the lock) -> (meta, blob)."""
        if op == P.OP_PING:
            return {"ok": True, "root": self.root, "pid": os.getpid(),
                    "version": P.VERSION}, b""
        if op == P.OP_PUT_BLOCKS:
            before = self.store.unique_chunks
            if meta.get("codec", "none") != "none":
                # v4 pre-compressed form: the client's writer thread
                # already hashed + compressed; file the payloads as-is
                keys = self.store.put_compressed_blocks(
                    meta["keys"], meta["raw_sizes"],
                    meta.get("codecs", meta["codec"]),
                    P.split_blob(blob, meta["sizes"]),
                )
            else:
                keys = [self.store.put(c)
                        for c in P.split_blob(blob, meta["sizes"])]
            # hit = a put whose key was already stored (dedup did its job);
            # measured by the unique-count delta so no extra hashing runs
            self.registry.inc("store.put_chunks", len(keys))
            self.registry.inc("store.put_bytes", len(blob))
            self.registry.inc("store.dedup_hit_chunks",
                              len(keys) - (self.store.unique_chunks - before))
            return {"keys": keys}, b""
        if op == P.OP_GET_BLOCKS:
            blocks = self.store.get_blocks(meta["keys"])  # KeyError crosses typed
            return {"sizes": [len(b) for b in blocks]}, b"".join(blocks)
        if op == P.OP_RELEASE:
            return {"freed": [bool(self.store.release(k))
                              for k in meta["keys"]]}, b""
        if op == P.OP_PUT_RECIPE:
            self.recipes.add(ObjectRecipe.from_json(meta["recipe"]))
            return {"ok": True}, b""
        if op == P.OP_PUT_MANIFEST:
            self.store.sync()
            self.sync_recipes()
            return {"ok": True}, b""
        if op == P.OP_HELLO:
            # codec negotiation: preference honored when this process can
            # decode it, degraded lz4 -> zlib -> none otherwise.  The
            # store's *write* codec is its own (manifest/env/ctor) — hello
            # only fixes how put_blocks payloads travel on this connection.
            offered = available_codecs()
            return {"codec": negotiate_codec(meta.get("codec", "none"),
                                             offered),
                    "available": list(offered),
                    "store_codec": self.store.codec}, b""
        if op == P.OP_STAT:
            st = self.store.stat()
            out = {
                "stored_bytes": self.store.stored_bytes,
                "logical_bytes": self.store.logical_bytes,
                "compressed_bytes": self.store.compressed_bytes,
                "compressed_ratio": st["compressed_ratio"],
                "unique_chunks": self.store.unique_chunks,
                "objects": len(self.recipes),
            }
            if meta.get("scan"):
                out["keys"] = self.store.scan_keys()
            return out, b""
        if op == P.OP_GC_MARK:
            if meta.get("reset"):
                self._gc_live.clear()
            for k, v in meta.get("live", {}).items():
                self._gc_live[k] = self._gc_live.get(k, 0) + int(v)
            return {"marked": len(self._gc_live)}, b""
        if op == P.OP_METRICS:
            return {"metrics": self.registry.snapshot()}, b""
        if op == P.OP_GC_SWEEP:
            freed_blocks, freed_bytes, repaired = self.store.sweep(
                self._gc_live
            )
            self._gc_live.clear()
            self.store.sync()
            return {"freed_blocks": freed_blocks, "freed_bytes": freed_bytes,
                    "repaired_refs": repaired}, b""
        raise ValueError(f"unknown op {op}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True,
                    help="shard store directory (created if missing)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, announced on stdout)")
    ap.add_argument("--codec", default=None,
                    help="write codec for new blocks (none|zlib|lz4); "
                         "default: manifest codec, else $REPRO_STORE_CODEC")
    ap.add_argument("--hot-bytes", type=int, default=0,
                    help="cold-tiering hot budget in bytes (0 = off)")
    ap.add_argument("--shard", type=int, default=0,
                    help="shard index for metric labels")
    args = ap.parse_args(argv)
    srv = ShardServer(args.root, args.host, args.port, codec=args.codec,
                      hot_bytes=args.hot_bytes, shard=args.shard)
    print(f"SHARD_SERVER_READY port={srv.port} pid={os.getpid()}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
