"""Wire protocol for the shard transport: length-prefixed, versioned frames.

One frame = a fixed 20-byte header followed by two length-delimited bodies:

    +--------+---------+------+----------+----------+----------+
    | magic  | version | op   | reserved | meta_len | blob_len |
    | 4B     | u8      | u8   | u16      | u32      | u64      |
    +--------+---------+------+----------+----------+----------+
    | meta: ``meta_len`` bytes of UTF-8 JSON (op arguments/results) |
    | blob: ``blob_len`` bytes of raw payload (chunk data)          |

The meta/blob split keeps chunk payloads out of JSON (no base64, no copies
beyond the socket) while op arguments stay debuggable.  Requests and
responses share the framing; a response echoes the request's op code on
success or carries :data:`OP_ERROR` with ``{"etype", "message"}`` meta on
failure, which the client re-raises (:func:`raise_remote`) — ``KeyError``
crosses the boundary as ``KeyError``, everything else surfaces as
:class:`ShardTransportError` so a caller can tell "the remote op failed"
from "the transport died".

Versioning: ``VERSION`` is checked on every frame by both ends; a mismatch
raises :class:`ProtocolError` before any payload is interpreted, so mixed
deployments fail loudly at the first frame instead of corrupting a store.

The op set is the full writer seam of the sharded service (the contract in
docs/SHARDING.md): block puts/gets, release, manifest sync, recipe commit,
stat/scan, mark-and-sweep GC, ping and shutdown — plus ``metrics``, which
returns the server's live :class:`~repro_torch.obs.MetricsRegistry` snapshot so
``ShardedDedupService.metrics()`` can aggregate per-shard-server telemetry
(docs/OBSERVABILITY.md).  Adding ``metrics`` bumped ``VERSION`` to 2: a
v1 peer fails loudly at the first frame instead of choking on an op it
does not know.

``VERSION`` 3 adds distributed-trace propagation: a request frame's meta
MAY carry a ``trace`` entry — ``{"trace_id": hex, "span_id": hex}``, the
client's active span context — which the server pops before op dispatch
and adopts as the parent of its per-op ``rpc.server`` span
(``repro_torch.obs.trace.scope``), stitching client and server JSONL spans into
one causal tree.  The entry is optional (absent when tracing is off), is
never interpreted by op handlers, and changes no op semantics; the bump
exists because frame meta gained a reserved key that a v2 server would
silently pass into handler kwargs, and mixed deployments must fail at the
first frame, not on a surprise argument.

``VERSION`` 4 adds codec negotiation and pre-compressed block transfer:

* :data:`OP_HELLO` — sent by the client once per connection, right after
  connect, with ``{"codec": <preferred>}``.  The server answers with
  ``{"codec": <negotiated>, "available": [...]}`` — the client's
  preference when the server store can decode it, degraded along
  lz4 -> zlib -> none otherwise (:func:`repro_torch.dedup.store.negotiate_codec`).
  Every later ``put_blocks`` uses the negotiated codec.
* ``put_blocks`` frames MAY carry **pre-compressed payloads**: meta
  ``{"codec": c, "codecs": [...], "keys": [...], "raw_sizes": [...],
  "sizes": [...]}`` with the blob holding the concatenated payloads —
  ``codecs`` gives each item's *effective* codec ("none" for chunks the
  encode could not shrink, which ship raw in the same frame).  The
  client's writer thread compressed the chunks (and computed their
  SHA-256 keys) once, off the ingest thread; the server files the
  payloads as-is (``BlockStore.put_compressed_blocks``) — bytes compress
  once and travel compressed.  The legacy meta shape (``{"sizes": ...}``
  with a raw blob) remains valid and is what a ``codec="none"``
  negotiation produces.  ``get_blocks`` responses stay raw: restores are
  latency-sensitive and the server already decodes to serve hot reads.
* ``BlockCorruptionError`` joins ``KeyError`` as a typed error that
  crosses the boundary as itself (:func:`raise_remote`), so a client-side
  restore can map a corrupt remote block to the service's
  ``IntegrityError`` instead of a generic transport failure.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Optional, Tuple

MAGIC = b"SCDC"
VERSION = 4  # v4: OP_HELLO codec negotiation + pre-compressed put_blocks

#: header: magic, version, op, reserved, meta_len (u32), blob_len (u64)
HEADER = struct.Struct("!4sBBHIQ")

#: sanity caps — a torn/foreign stream must not turn into a huge allocation
MAX_META = 1 << 28
MAX_BLOB = 1 << 34

# -- op codes (the writer-seam op set) -----------------------------------------
OP_PING = 1
OP_PUT_BLOCKS = 2
OP_GET_BLOCKS = 3
OP_RELEASE = 4
OP_PUT_RECIPE = 5
OP_PUT_MANIFEST = 6
OP_STAT = 7
OP_GC_MARK = 8
OP_GC_SWEEP = 9
OP_SHUTDOWN = 10
#: v2: server returns {"metrics": <MetricsRegistry.snapshot()>}
OP_METRICS = 11
#: v4: codec negotiation; request {"codec"} -> reply {"codec", "available"}
OP_HELLO = 12
#: response-only: remote op raised; meta = {"etype", "message"}
OP_ERROR = 0xFF

OP_NAMES = {
    OP_PING: "ping",
    OP_PUT_BLOCKS: "put_blocks",
    OP_GET_BLOCKS: "get_blocks",
    OP_RELEASE: "release",
    OP_PUT_RECIPE: "put_recipe",
    OP_PUT_MANIFEST: "put_manifest",
    OP_STAT: "stat",
    OP_GC_MARK: "gc_mark",
    OP_GC_SWEEP: "gc_sweep",
    OP_SHUTDOWN: "shutdown",
    OP_METRICS: "metrics",
    OP_HELLO: "hello",
    OP_ERROR: "error",
}


class ProtocolError(RuntimeError):
    """Malformed or version-mismatched frame: the stream cannot be trusted."""


class ShardTransportError(RuntimeError):
    """A remote shard op failed or its server became unreachable.

    Raised client-side both for propagated remote exceptions (other than
    ``KeyError``, which crosses as itself) and for dead connections.  Inside
    a flush this surfaces through the writer queue as ``AsyncWriteError`` at
    the barrier — before any recipe is committed.
    """


def send_frame(sock: socket.socket, op: int, meta: Optional[dict] = None,
               blob: bytes = b""):
    """Serialize and send one frame (sendall: complete or raise)."""
    mb = json.dumps(meta or {}, separators=(",", ":")).encode()
    sock.sendall(HEADER.pack(MAGIC, VERSION, op, 0, len(mb), len(blob)))
    sock.sendall(mb)
    if blob:
        sock.sendall(blob)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(min(n - len(buf), 1 << 20))
        if not part:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += part
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Tuple[int, dict, bytes]:
    """Receive one frame -> (op, meta, blob).

    ``ConnectionError`` on clean or mid-frame EOF; :class:`ProtocolError`
    on bad magic, version mismatch, or an implausible length — the caller
    must drop the connection, the stream offset can no longer be trusted.
    """
    hdr = _read_exact(sock, HEADER.size)
    magic, version, op, _reserved, meta_len, blob_len = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (not a shard-transport peer)")
    if version != VERSION:
        raise ProtocolError(
            f"protocol version {version} != supported {VERSION}"
        )
    if meta_len > MAX_META or blob_len > MAX_BLOB:
        raise ProtocolError(
            f"implausible frame lengths meta={meta_len} blob={blob_len}"
        )
    meta = json.loads(_read_exact(sock, meta_len)) if meta_len else {}
    blob = _read_exact(sock, blob_len) if blob_len else b""
    return op, meta, blob


# -- error propagation ----------------------------------------------------------
def error_meta(exc: BaseException) -> dict:
    return {"etype": type(exc).__name__, "message": str(exc)}


def raise_remote(meta: dict) -> None:
    """Re-raise a remote error locally.  ``KeyError`` keeps its type (store
    lookups depend on it), as does ``BlockCorruptionError`` (restores map
    it to ``IntegrityError``); everything else becomes ShardTransportError."""
    etype = meta.get("etype", "RuntimeError")
    message = meta.get("message", "")
    if etype == "KeyError":
        raise KeyError(message)
    if etype == "BlockCorruptionError":
        from repro_torch.dedup.store import BlockCorruptionError

        raise BlockCorruptionError(message)
    raise ShardTransportError(f"remote {etype}: {message}")


def split_blob(blob: bytes, sizes: list) -> list:
    """Cut a concatenated blob back into per-item byte strings."""
    out, off = [], 0
    for n in sizes:
        out.append(blob[off:off + int(n)])
        off += int(n)
    if off != len(blob):
        raise ProtocolError(
            f"blob length {len(blob)} != declared sizes total {off}"
        )
    return out
