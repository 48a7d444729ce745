"""repro_torch.dedup — fingerprints, the fingerprint index, the block store,
the host half of the distributed index.

Exports resolve lazily (``repro_torch._lazy``): ``store`` and
``dist_index`` are numpy+stdlib while ``fingerprint``/``index`` import
torch, and a spawned shard server needs only the former.
"""
from repro_torch._lazy import install as _install

_EXPORTS = {
    "owner_of": ".dist_index",
    "route_host": ".dist_index",
    "chunk_fingerprints": ".fingerprint",
    "fingerprints_numpy": ".fingerprint",
    "FingerprintIndex": ".index",
    "dedup_stats": ".index",
    "space_savings": ".index",
    "BlockStore": ".store",
    "DirBlockStore": ".store",
    "sha256_key": ".store",
    "BlockCorruptionError": ".store",
    "available_codecs": ".store",
    "resolve_codec": ".store",
    "negotiate_codec": ".store",
}

_SUBMODULES = ("dist_index", "fingerprint", "index", "store")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)

__getattr__, __dir__ = _install(__name__, _EXPORTS, _SUBMODULES)
