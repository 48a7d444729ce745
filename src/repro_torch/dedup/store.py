"""Content-addressed chunk store (paper SSII "Data Storage").

Chunks are keyed by SHA-256 (collision-resistant, as the paper prescribes for
the storage layer).  Backends: in-memory dict or a directory of block files
with a refcount manifest — enough to run the end-to-end dedup pipeline and
the CDC incremental checkpoint store on top of it.

Compression (the exemplar estimators' model: every chunk compressed, the
*compressed* dedup ratio reported):

* ``codec="none"|"zlib"|"lz4"`` selects the **write codec** — how new
  blocks are encoded.  zlib is stdlib and always available; lz4 is used
  when the optional ``lz4`` package is installed and refused loudly
  otherwise.  ``codec=None`` resolves the :data:`CODEC_ENV` environment
  default (which is how the ``codec-on`` CI job flips the whole suite).
* Storage is **per-key self-describing**: each block remembers the codec
  it was stored under, so a depot freely mixes raw and compressed blocks —
  reopening a compressed depot with ``codec="none"`` (or a codec-less v1
  depot with ``codec="zlib"``) reads every old block correctly and merely
  changes how *new* blocks are written.  A block that compression does not
  shrink is stored raw (``compressed_bytes <= stored_bytes`` always).
* Accounting is **raw-first**: ``stored_bytes`` stays the sum of unique
  *raw* bytes — the dedup ratio is unchanged by the codec — while the new
  live total ``compressed_bytes`` is the payload bytes actually held.
  ``stat()`` reports both plus ``compressed_ratio``
  (= stored/compressed, the store's compression factor).  GC byte
  accounting (``sweep``/``drop``/``repair_ref``) is in raw bytes.

Cold tiering (``DirBlockStore(hot_bytes=N)``): newly put blocks land *raw*
(hot — restores pay no decompress), and once the hot tier exceeds
``hot_bytes`` the least-recently-used blocks are demoted — recompressed in
place with the write codec, raw file removed after the compressed file is
atomically in place.  A crash anywhere in that window leaves both forms
(equal content; the raw file is authoritative and the compressed copy is
swept) or only the compressed form with a stale manifest (self-healed on
the next read); ``gc``/``sweep`` stay correct across tiers.

The wire path (``service/transport``): chunks can also arrive
*pre-compressed* via :meth:`put_compressed_blocks` — the shard writer
thread compressed them once, they travelled compressed over the RPC, and
the store files the payload as-is under the client-computed key.

Observability: :meth:`attach_obs` points the store at the owning service's
``MetricsRegistry``; encode time lands in ``store.compress_s`` and
compressed payload bytes in ``store.compressed_bytes{shard=}``
(docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

try:  # optional: the related estimators' per-chunk codec
    import lz4.frame as _lz4
except ImportError:  # pragma: no cover - depends on environment
    _lz4 = None

#: every codec name the store knows (availability of lz4 is environmental)
CODECS = ("none", "zlib", "lz4")

#: environment default for ``codec=None`` (the codec-on CI job sets it)
CODEC_ENV = "REPRO_STORE_CODEC"

#: zlib level 1: the writer hot path wants lz4-like speed; on the repo's
#: structured corpora level 1 already gets most of the ratio of level 6
ZLIB_LEVEL = 1


class BlockCorruptionError(RuntimeError):
    """A stored block's payload failed to decode to its recorded raw form.

    The store-layer analogue of the service's ``IntegrityError`` (which
    subsumes it at restore time): the bytes on disk are not the bytes the
    accounting says were stored.
    """


def available_codecs() -> Tuple[str, ...]:
    """Codecs usable in this process (lz4 only when the package exists)."""
    return tuple(c for c in CODECS if c != "lz4" or _lz4 is not None)


def resolve_codec(codec: Optional[str]) -> str:
    """Validate a codec name; ``None`` resolves the :data:`CODEC_ENV`
    default.  Unknown names and an unavailable lz4 raise ``ValueError``
    (loud, never a silent fallback — negotiation is the wire's job)."""
    if codec is None:
        codec = os.environ.get(CODEC_ENV) or "none"
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r} (one of {CODECS})")
    if codec == "lz4" and _lz4 is None:
        raise ValueError(
            "codec 'lz4' requested but the lz4 package is not installed "
            f"(available: {available_codecs()})"
        )
    return codec


def negotiate_codec(preferred: str, offered: Sequence[str]) -> str:
    """The one codec-negotiation rule (client preference vs peer support):
    the preference if the peer offers it, else the best mutually-available
    compressor (lz4 degrades to zlib, which is stdlib), else ``none``."""
    if preferred in offered:
        return preferred
    if preferred == "lz4" and "zlib" in offered:
        return "zlib"
    return "none"


def encode_block(codec: str, raw: bytes) -> Tuple[str, bytes]:
    """Compress one block -> ``(effective_codec, payload)``.

    Falls back to ``("none", raw)`` when compression does not shrink the
    block (already-compressed or high-entropy data), so stored payloads
    are never larger than the raw bytes.
    """
    if codec == "none":
        return "none", raw
    if codec == "zlib":
        payload = zlib.compress(raw, ZLIB_LEVEL)
    else:
        payload = _lz4.compress(raw)
    if len(payload) >= len(raw):
        return "none", raw
    return codec, payload


def decode_block(codec: str, payload: bytes,
                 raw_size: Optional[int] = None) -> bytes:
    """Decompress one block; :class:`BlockCorruptionError` on a payload
    that fails to decode or decodes to the wrong length."""
    if codec == "none":
        raw = payload
    else:
        try:
            if codec == "zlib":
                raw = zlib.decompress(payload)
            elif codec == "lz4" and _lz4 is not None:
                raw = _lz4.decompress(payload)
            else:
                raise ValueError(f"codec {codec!r} unavailable")
        except Exception as e:
            raise BlockCorruptionError(
                f"{codec} payload failed to decode: {e}"
            ) from e
    if raw_size is not None and len(raw) != raw_size:
        raise BlockCorruptionError(
            f"decoded {len(raw)}B, accounting says {raw_size}B raw"
        )
    return raw


def sha256_key(chunk: bytes) -> str:
    return hashlib.sha256(chunk).hexdigest()


class BlockStore:
    """In-memory content-addressed store with dedup + compression accounting."""

    def __init__(self, codec: Optional[str] = None):
        self.codec = resolve_codec(codec)
        self.blocks: dict[str, bytes] = {}  # key -> stored payload
        self.refs: dict[str, int] = {}
        self.sizes: dict[str, int] = {}  # key -> raw size
        self.csizes: dict[str, int] = {}  # key -> stored payload size
        #: per-key codec; keys stored raw are simply absent (the common
        #: case for codec="none" depots, keeping manifests compact)
        self.key_codec: dict[str, str] = {}
        # all are *live* totals: puts grow them, releases/drops shrink them
        # (freeing everything returns them to zero — see release())
        self.logical_bytes = 0  # live bytes referenced by clients
        self.stored_bytes = 0  # unique *raw* bytes currently stored
        self.compressed_bytes = 0  # unique *payload* bytes currently stored
        #: owning service's MetricsRegistry (attach_obs); None = uncounted
        self.obs = None
        self.obs_shard = 0

    def attach_obs(self, registry, shard: int = 0):
        """Report compression telemetry into ``registry`` (labeled by
        ``shard``): ``store.compress_s`` encode latency and
        ``store.compressed_bytes{shard=}`` payload bytes written."""
        self.obs = registry
        self.obs_shard = int(shard)

    # -- encode/decode (shared by both backends) --------------------------------
    def _encode(self, raw: bytes) -> Tuple[str, bytes]:
        if self.codec == "none":
            return "none", raw
        t0 = time.perf_counter()
        codec, payload = encode_block(self.codec, raw)
        if self.obs is not None:
            from repro_torch.obs import labeled

            self.obs.observe("store.compress_s", time.perf_counter() - t0)
            if codec != "none":
                self.obs.inc(
                    labeled("store.compressed_bytes", shard=self.obs_shard),
                    len(payload),
                )
        return codec, payload

    def _decode(self, key: str, payload: bytes) -> bytes:
        codec = self.key_codec.get(key, "none")
        try:
            return decode_block(codec, payload, self.sizes.get(key))
        except BlockCorruptionError as e:
            raise BlockCorruptionError(f"block {key}: {e}") from None

    def _record_meta(self, key: str, raw_size: int, codec: str, csize: int):
        self.sizes[key] = raw_size
        self.csizes[key] = csize
        if codec != "none":
            self.key_codec[key] = codec
        else:
            self.key_codec.pop(key, None)

    def _forget_meta(self, key: str):
        self.sizes.pop(key, None)
        self.csizes.pop(key, None)
        self.key_codec.pop(key, None)

    def _stored_size(self, key: str) -> int:
        """Payload bytes held for ``key`` (raw size when stored raw)."""
        if key in self.csizes:
            return self.csizes[key]
        return self.chunk_size(key)

    # -- put --------------------------------------------------------------------
    def _write_block(self, key: str, raw: bytes) -> int:
        """Store ``raw`` under ``key`` -> payload bytes actually held."""
        codec, payload = self._encode(raw)
        self.blocks[key] = payload
        self._record_meta(key, len(raw), codec, len(payload))
        return len(payload)

    def _write_block_pre(self, key: str, raw_size: int, codec: str,
                         payload: bytes) -> int:
        """Store an already-compressed payload as-is -> payload bytes held."""
        self.blocks[key] = payload
        self._record_meta(key, raw_size, codec, len(payload))
        return len(payload)

    def put(self, chunk: bytes) -> str:
        chunk = bytes(chunk)
        key = sha256_key(chunk)
        self.logical_bytes += len(chunk)
        if key not in self.refs:
            csize = self._write_block(key, chunk)
            self.stored_bytes += len(chunk)
            self.compressed_bytes += csize
            self.refs[key] = 0
        self.refs[key] += 1
        return key

    def put_blocks(self, chunks: Iterable[bytes]) -> list[str]:
        """Batched put, the writer hot-path surface: in-process stores just
        loop, while a remote store (``service/transport/client.py``)
        overrides this into one RPC per batch — which is why the sharded
        flush coalesces each shard's chunks instead of calling ``put``
        per chunk."""
        return [self.put(c) for c in chunks]

    def put_compressed_blocks(self, keys: Sequence[str],
                              raw_sizes: Sequence[int], codec,
                              payloads: Sequence[bytes]) -> list[str]:
        """Batched put of pre-compressed payloads (the protocol v4 wire
        form): ``keys`` are SHA-256 of the *raw* bytes, computed by the
        writer that also compressed them, so the bytes compress once (off
        the ingest thread) and travel compressed.  Payloads are filed
        as-is — a duplicate key costs a refcount bump, no decompress.
        Whole-object restore verification still catches any corruption
        end to end.

        ``codec`` is one name for the whole batch or a per-key sequence
        (the writer's encode falls back to raw on incompressible chunks,
        so mixed batches are the norm under a compressing codec).
        """
        codecs = ([codec] * len(keys) if isinstance(codec, str)
                  else [str(c) for c in codec])
        for c in set(codecs):
            if c != "none":
                resolve_codec(c)  # loud on a codec this process can't read
        out = []
        for key, raw_size, c, payload in zip(keys, raw_sizes, codecs,
                                             payloads):
            raw_size = int(raw_size)
            self.logical_bytes += raw_size
            if key not in self.refs:
                csize = self._write_block_pre(key, raw_size, c, payload)
                self.stored_bytes += raw_size
                self.compressed_bytes += csize
                self.refs[key] = 0
            self.refs[key] += 1
            out.append(key)
        return out

    def put_stream(self, data, bounds: Iterable[int]) -> list[str]:
        """Chunk-and-store a byte stream given exclusive boundary offsets.

        ``bounds`` must be strictly increasing and cover the whole stream
        (last bound == ``len(data)``); anything else raises ``ValueError``
        — a short or non-monotonic bounds list used to silently drop the
        trailing bytes, which a later restore could not detect.  The whole
        list is validated *before* any chunk is stored, so a rejected call
        never leaves a partial ingest behind.
        """
        data = np.asarray(data, dtype=np.uint8)
        ends = [int(e) for e in bounds]
        s = 0
        for e in ends:
            if e <= s:
                raise ValueError(
                    f"bounds must be strictly increasing: {e} after {s}"
                )
            if e > data.size:
                raise ValueError(
                    f"bound {e} beyond stream end {data.size}"
                )
            s = e
        if s != data.size:
            raise ValueError(
                f"bounds cover {s} of {data.size} bytes "
                "(last bound must equal len(data))"
            )
        keys = []
        s = 0
        for e in ends:
            keys.append(self.put(data[s:e].tobytes()))
            s = e
        return keys

    # -- get --------------------------------------------------------------------
    def get(self, key: str) -> bytes:
        return self._decode(key, self.blocks[key])

    def get_blocks(self, keys: Iterable[str]) -> list[bytes]:
        """Batched get, one block per key.  The base form is a loop; the
        remote store proxy overrides it with a single RPC, which is what
        the sharded restore path batches per shard."""
        return [self.get(k) for k in keys]

    def get_stream(self, keys: Iterable[str]) -> bytes:
        return b"".join(self.get(k) for k in keys)

    def __contains__(self, key: str) -> bool:
        return key in self.refs

    def chunk_size(self, key: str) -> int:
        """Raw (uncompressed) size of a block — the unit every byte
        accounting uses, whatever codec the payload sits under."""
        if key in self.sizes:
            return self.sizes[key]
        return len(self.get(key))

    def _remove_block(self, key: str):
        del self.blocks[key]

    def scan_keys(self) -> list[str]:
        """Every key the store physically holds (GC sweep domain).

        For file-backed stores this includes blocks present on disk but
        missing from the refcount manifest (a crash between block write and
        manifest sync), which refcount iteration alone would never see.
        """
        return list(self.refs)

    def repair_ref(self, key: str, refs: int):
        """Set a key's refcount to the recomputed truth, fixing accounting.

        Re-adopts blocks that exist but fell out of the manifest (crash
        between block write and manifest sync): their bytes re-enter
        ``stored_bytes``/``logical_bytes``/``compressed_bytes`` so the live
        totals match refs.  All byte math is in *raw* sizes except the
        payload-sized ``compressed_bytes`` — consistent with ``put``.
        """
        size = self.chunk_size(key)
        have = self.refs.get(key)
        if have is None:
            self.stored_bytes += size
            self.compressed_bytes += self._stored_size(key)
            self.logical_bytes += refs * size
        else:
            self.logical_bytes += (refs - have) * size
        self.refs[key] = refs

    def release(self, key: str) -> bool:
        """Drop one reference; free the block on the last one.

        Safe on unknown keys (returns False, no accounting change) so callers
        replaying a partially-applied delete never crash.  ``logical_bytes``
        shrinks by one reference's worth per release and
        ``stored_bytes``/``compressed_bytes`` by the block's raw/payload
        size when it is freed, so all remain *live* totals after deletes
        (freeing everything returns them to zero).
        """
        if key not in self.refs:
            return False
        size = self.chunk_size(key)
        csize = self._stored_size(key)
        self.logical_bytes -= size
        self.refs[key] -= 1
        if self.refs[key] > 0:
            return False
        del self.refs[key]
        self._remove_block(key)
        self._forget_meta(key)
        self.stored_bytes -= size
        self.compressed_bytes -= csize
        return True

    def delete(self, key: str) -> bool:
        """Alias for :meth:`release` (service-facing name)."""
        return self.release(key)

    def release_many(self, keys: Iterable[str]) -> list[bool]:
        """Batched :meth:`release`, one freed-flag per key.  The base form
        is a loop; the remote store proxy overrides it with a single RPC,
        which is what the sharded delete path batches per shard."""
        return [self.release(k) for k in keys]

    def drop(self, key: str) -> int:
        """GC sweep: remove a block unconditionally, whatever its refcount.

        Used by mark-and-sweep when recomputed liveness says the block has no
        referents (e.g. refcount drift after a crash).  Returns the *raw*
        stored bytes reclaimed (0 for unknown keys) — GC accounting is in
        raw sizes on every tier.
        """
        if key not in self.refs:
            return 0
        size = self.chunk_size(key)
        csize = self._stored_size(key)
        refs = self.refs.pop(key)
        self._remove_block(key)
        self._forget_meta(key)
        self.stored_bytes -= size
        self.compressed_bytes -= csize
        self.logical_bytes -= refs * size
        return size

    def sweep(self, live: Dict[str, int]) -> Tuple[int, int, int]:
        """One mark-and-sweep pass against recomputed liveness.

        ``live`` is the truth (key -> reference count from the recipe
        roots).  Sweeps :meth:`scan_keys` — which for file-backed stores
        includes block files the refcount manifest never recorded —
        dropping unreferenced blocks and repairing refcount drift.  Returns
        ``(freed_blocks, freed_bytes, repaired_refs)``.

        Lives on the store (not the service) because it only touches store
        state — which is what lets a remote store run the whole pass next
        to its data in one RPC (``transport/client.py`` overrides this).
        """
        freed_blocks = freed_bytes = repaired = 0
        for key in self.scan_keys():
            want = live.get(key, 0)
            if want == 0:
                freed_bytes += self.drop(key)
                freed_blocks += 1
            elif self.refs.get(key) != want:
                self.repair_ref(key, want)
                repaired += 1
        return freed_blocks, freed_bytes, repaired

    def sync(self):
        """Make accounting durable (no-op for the in-memory backend).

        Uniform entry point so multi-store owners (the sharded service's
        per-shard flush) need not type-switch on the backend.
        """

    @property
    def unique_chunks(self) -> int:
        """Number of unique blocks held (part of the stats surface shared
        with the remote store proxy, which cannot expose a refs dict)."""
        return len(self.refs)

    def stat(self) -> Dict[str, float]:
        """The accounting quad in one call — the shape consumers should
        prefer over reading the properties separately, because on the
        remote store proxy each property is a full RPC and ``stat()`` is
        exactly one.  ``compressed_ratio`` is stored/compressed — the
        store's compression factor on its unique bytes (1.0 for codec-less
        depots); the *end-to-end* ratio (dedup x compression) is the
        service's ``ServiceStats.compressed_ratio``.
        """
        return {
            "stored_bytes": self.stored_bytes,
            "logical_bytes": self.logical_bytes,
            "compressed_bytes": self.compressed_bytes,
            "compressed_ratio": (
                self.stored_bytes / self.compressed_bytes
                if self.compressed_bytes else 1.0
            ),
            "unique_chunks": self.unique_chunks,
        }

    @property
    def savings(self) -> float:
        if not self.logical_bytes:
            return 0.0
        return (self.logical_bytes - self.stored_bytes) / self.logical_bytes


#: block-file suffix per codec: compressed forms are self-describing on
#: disk, so crash recovery can identify a block's codec with no manifest
_CODEC_SUFFIX = {"none": "", "zlib": ".z", "lz4": ".lz4"}
_SUFFIX_CODEC = {".z": "zlib", ".lz4": "lz4"}

#: manifest schema version: 2 adds codec/csizes/key_codecs/compressed_bytes;
#: a version-less manifest is v1 (codec-less depot, every block raw)
MANIFEST_VERSION = 2


class DirBlockStore(BlockStore):
    """File-backed store: one file per unique block + a json manifest.

    Writes are atomic (tmp + rename) so a crashed writer never corrupts the
    store — required by the fault-tolerant checkpoint manager built on top.

    The manifest also records block *sizes*: a crash between a block unlink
    and the manifest sync leaves manifest entries whose files are gone, and
    recovery (``release`` replay, ``gc``) must be able to correct the byte
    accounting for a block it can no longer stat.  v2 manifests add the
    per-key codec and payload-size maps; a v1 manifest loads as an all-raw
    depot (back-compat both ways — see the module docstring).

    ``codec=None`` resolves, in order: the manifest's recorded write codec
    (a compressed depot keeps compressing when reopened by codec-unaware
    tooling), the :data:`CODEC_ENV` environment default, then ``"none"``.
    An explicit ``codec=`` always wins — that is how a depot is reopened
    with a *different* codec preference (old blocks keep their recorded
    codec; only new writes change).

    ``hot_bytes > 0`` enables cold tiering (requires a compressing codec):
    puts land raw (hot), and LRU blocks beyond the budget are demoted —
    recompressed in place on the putting thread.  Reads of hot blocks
    refresh recency; cold reads decompress without promoting.
    """

    def __init__(self, root: str, codec: Optional[str] = None,
                 hot_bytes: int = 0):
        manifest_codec = None
        self.root = root
        os.makedirs(os.path.join(root, "blocks"), exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        m = None
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                m = json.load(f)
            manifest_codec = m.get("codec")
        if codec is None and manifest_codec is not None:
            codec = manifest_codec
        super().__init__(codec)
        self.hot_bytes = int(hot_bytes)
        if self.hot_bytes > 0 and self.codec == "none":
            raise ValueError(
                "hot_bytes tiering needs a compressing codec "
                "(demotion recompresses in place); got codec='none'"
            )
        #: LRU of hot (raw-on-disk) keys -> raw size; tiering only
        self._hot: "OrderedDict[str, int]" = OrderedDict()
        self._hot_total = 0
        if m is not None:
            self.refs = {k: int(v) for k, v in m["refs"].items()}
            self.sizes = {k: int(v) for k, v in m.get("sizes", {}).items()}
            if int(m.get("version", 1)) >= 2:
                self.csizes = {k: int(v)
                               for k, v in m.get("csizes", {}).items()}
                self.key_codec = {k: str(v)
                                  for k, v in m.get("key_codecs", {}).items()}
                self.compressed_bytes = int(
                    m.get("compressed_bytes", m["stored_bytes"])
                )
            else:
                # v1 (codec-less) manifest: every block is raw, payload
                # bytes == raw bytes
                self.csizes = dict(self.sizes)
                self.compressed_bytes = int(m["stored_bytes"])
            self.logical_bytes = int(m["logical_bytes"])
            self.stored_bytes = int(m["stored_bytes"])
            if self.hot_bytes > 0:
                # raw blocks are the hot set; manifest order is the best
                # recency estimate a restart has (true LRU resumes as reads
                # and puts refresh it)
                for k in self.refs:
                    if self.key_codec.get(k, "none") == "none":
                        self._hot[k] = self.sizes.get(k, 0)
                        self._hot_total += self._hot[k]

    def _path(self, key: str, codec: str = "none") -> str:
        return os.path.join(self.root, "blocks", key + _CODEC_SUFFIX[codec])

    def _find_block(self, key: str) -> Tuple[Optional[str], Optional[str]]:
        """Locate ``key`` on disk -> ``(path, codec)`` or ``(None, None)``.

        Probes the recorded codec's path first, then every other form —
        a crash between a demotion's rename and the manifest sync leaves
        the disk ahead of the manifest, and reads must self-heal.
        """
        recorded = self.key_codec.get(key, "none")
        for codec in (recorded, *(c for c in CODECS if c != recorded)):
            p = self._path(key, codec)
            if os.path.exists(p):
                return p, codec
        return None, None

    def _load_block(self, key: str) -> Tuple[bytes, str, int]:
        """Read + decode ``key`` from disk -> ``(raw, codec, payload_size)``;
        ``KeyError`` when no form of the block exists (every backend's
        missing-block contract).  Heals stale per-key codec records: a
        demotion that crashed after its rename is adopted into the
        accounting here."""
        path, codec = self._find_block(key)
        if path is None:
            raise KeyError(key)
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            raise KeyError(key) from None  # raced a concurrent sweep
        try:
            raw = decode_block(codec, payload, self.sizes.get(key))
        except BlockCorruptionError as e:
            raise BlockCorruptionError(f"block {key}: {e}") from None
        if key in self.refs and codec != self.key_codec.get(key, "none"):
            # disk moved ahead of the manifest (crashed demotion): adopt
            # the on-disk form so payload accounting matches reality
            self.compressed_bytes += len(payload) - self._stored_size(key)
            self._record_meta(key, len(raw), codec, len(payload))
        return raw, codec, len(payload)

    def _atomic_write(self, path: str, payload: bytes):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    # -- put / tiering -----------------------------------------------------------
    def _write_block(self, key: str, raw: bytes) -> int:
        # write keyed on *file presence*, not on the refcount: a stale
        # manifest (crash between unlink and manifest sync) may list a key
        # whose file is gone, and a committed recipe must never name bytes
        # that are not on disk
        path, codec = self._find_block(key)
        if path is not None:
            csize = os.path.getsize(path)
            self._record_meta(key, len(raw), codec, csize)
            return csize
        if self.hot_bytes > 0:
            # tiered put: land raw (hot), demote LRU cold blocks after
            self._atomic_write(self._path(key), raw)
            self._record_meta(key, len(raw), "none", len(raw))
            self._hot[key] = len(raw)
            self._hot_total += len(raw)
            self._evict_cold()
            return len(raw)
        codec, payload = self._encode(raw)
        self._atomic_write(self._path(key, codec), payload)
        self._record_meta(key, len(raw), codec, len(payload))
        return len(payload)

    def _write_block_pre(self, key: str, raw_size: int, codec: str,
                         payload: bytes) -> int:
        path, found = self._find_block(key)
        if path is not None:
            csize = os.path.getsize(path)
            self._record_meta(key, raw_size, found, csize)
            return csize
        # pre-compressed arrivals are cold by definition (the writer
        # already paid the encode); they bypass the hot tier
        self._atomic_write(self._path(key, codec), payload)
        self._record_meta(key, raw_size, codec, len(payload))
        return len(payload)

    def _evict_cold(self):
        """Demote LRU hot blocks until the hot tier fits ``hot_bytes``."""
        while self._hot_total > self.hot_bytes and self._hot:
            key, size = self._hot.popitem(last=False)
            self._hot_total -= size
            self._demote(key)

    def _demote(self, key: str):
        """Recompress one hot block in place: compressed file atomically
        renamed first, raw file removed after — a crash in between leaves
        both (equal content; scan sweeps the derived copy)."""
        raw_path = self._path(key)
        try:
            with open(raw_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return  # raced a drop/sweep: nothing to demote
        codec, payload = self._encode(raw)
        if codec == "none":
            return  # incompressible: stays raw, just no longer LRU-tracked
        self._atomic_write(self._path(key, codec), payload)
        if key in self.refs:
            self.compressed_bytes += len(payload) - self._stored_size(key)
        self._record_meta(key, len(raw), codec, len(payload))
        try:
            os.remove(raw_path)
        except FileNotFoundError:
            pass
        if self.obs is not None:
            from repro_torch.obs import labeled

            self.obs.inc(labeled("store.tier_demotions",
                                 shard=self.obs_shard))

    def put(self, chunk: bytes) -> str:
        # the refcount fast path must still consult *file presence*: a
        # stale manifest (crash between a delete's unlink and its manifest
        # sync) may list a key whose file is gone, and a committed recipe
        # must never name bytes that are not on disk — re-puts of such a
        # key rewrite the file
        chunk = bytes(chunk)
        key = sha256_key(chunk)
        if key in self.refs and self._find_block(key)[0] is None:
            old = self.csizes.get(key, self.sizes.get(key, 0))
            csize = self._write_block(key, chunk)
            self.compressed_bytes += csize - old
        return super().put(chunk)

    def put_compressed_blocks(self, keys: Sequence[str],
                              raw_sizes: Sequence[int], codec,
                              payloads: Sequence[bytes]) -> list[str]:
        # same stale-manifest rewrite window as put(), pre-compressed form
        codecs = ([codec] * len(keys) if isinstance(codec, str)
                  else [str(c) for c in codec])
        for key, raw_size, c, payload in zip(keys, raw_sizes, codecs,
                                             payloads):
            if key in self.refs and self._find_block(key)[0] is None:
                old = self.csizes.get(key, self.sizes.get(key, 0))
                csize = self._write_block_pre(key, int(raw_size), c, payload)
                self.compressed_bytes += csize - old
        return super().put_compressed_blocks(keys, raw_sizes, codecs,
                                             payloads)

    def _touch_hot(self, key: str):
        if self._hot and key in self._hot:
            self._hot.move_to_end(key)

    def _untrack_hot(self, key: str):
        if self._hot and key in self._hot:
            self._hot_total -= self._hot.pop(key)

    # -- get / meta --------------------------------------------------------------
    def get(self, key: str) -> bytes:
        raw, _, _ = self._load_block(key)
        self._touch_hot(key)
        return raw

    def get_stream(self, keys: Iterable[str]) -> bytes:
        return b"".join(self.get(k) for k in keys)

    def chunk_size(self, key: str) -> int:
        # manifest size first: must work for manifest-listed keys whose
        # block file a crashed delete already unlinked
        if key in self.sizes:
            return self.sizes[key]
        raw, codec, csize = self._load_block(key)  # orphan: learn + cache
        self._record_meta(key, len(raw), codec, csize)
        return len(raw)

    def _stored_size(self, key: str) -> int:
        if key in self.csizes:
            return self.csizes[key]
        self.chunk_size(key)  # loads + caches csizes too
        return self.csizes.get(key, self.sizes.get(key, 0))

    def _remove_block(self, key: str):
        self._untrack_hot(key)
        self._forget_meta(key)
        for codec in CODECS:  # every on-disk form, whichever tier it was in
            try:
                os.remove(self._path(key, codec))
            except FileNotFoundError:
                pass  # replay of a partially-applied delete: already gone

    def scan_keys(self) -> list[str]:
        """Manifest keys plus any block files on disk the manifest missed.

        Stale ``.tmp`` files are torn writes by construction (commits go
        through atomic rename) and are unlinked during the scan, as is the
        compressed copy of a block whose raw form still exists (a demotion
        that crashed between its rename and the raw unlink — the raw file
        is authoritative, the compressed one is derived).
        """
        keys = set(self.refs)
        blocks_dir = os.path.join(self.root, "blocks")
        on_disk: dict[str, set] = {}
        for fn in os.listdir(blocks_dir):
            if fn.endswith(".tmp"):
                try:
                    os.remove(os.path.join(blocks_dir, fn))
                except FileNotFoundError:
                    pass
                continue
            base, ext = os.path.splitext(fn)
            if ext in _SUFFIX_CODEC:
                on_disk.setdefault(base, set()).add(_SUFFIX_CODEC[ext])
            else:
                on_disk.setdefault(fn, set()).add("none")
        for key, forms in on_disk.items():
            if "none" in forms:
                for codec in forms - {"none"}:  # crashed demotion leftover
                    try:
                        os.remove(self._path(key, codec))
                    except FileNotFoundError:
                        pass
            keys.add(key)
        return sorted(keys)

    def repair_ref(self, key: str, refs: int):
        self.chunk_size(key)  # ensure sizes/csizes known (loads orphans)
        super().repair_ref(key, refs)

    def drop(self, key: str) -> int:
        if key in self.refs:
            return super().drop(key)
        # on-disk orphan: never entered the accounting.  One try/except
        # path per form — an exists/getsize/remove sequence would race a
        # concurrent sweep unlinking the same file (TOCTOU) and crash on
        # a block that is simply already gone.
        self._forget_meta(key)
        for codec in CODECS:
            path = self._path(key, codec)
            try:
                with open(path, "rb") as f:
                    payload = f.read()
                os.remove(path)
            except FileNotFoundError:
                continue
            try:  # report *raw* bytes reclaimed, consistent across tiers
                return len(decode_block(codec, payload))
            except BlockCorruptionError:
                return len(payload)  # torn orphan: disk bytes are all we know
        return 0

    def sync(self):
        self.sync_manifest()

    def sync_manifest(self):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "version": MANIFEST_VERSION,
                    "codec": self.codec,
                    "refs": self.refs,
                    "sizes": {k: self.sizes[k] for k in self.refs
                              if k in self.sizes},
                    "csizes": {k: self.csizes[k] for k in self.refs
                               if k in self.csizes},
                    "key_codecs": {k: c for k, c in self.key_codec.items()
                                   if k in self.refs},
                    "logical_bytes": self.logical_bytes,
                    "stored_bytes": self.stored_bytes,
                    "compressed_bytes": self.compressed_bytes,
                },
                f,
            )
        os.replace(tmp, self._manifest_path)
