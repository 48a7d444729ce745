"""repro_torch.dedup — fingerprints, the fingerprint index, the block store."""
from .index import FingerprintIndex, dedup_stats, space_savings
from .store import BlockCorruptionError, BlockStore, DirBlockStore, sha256_key

__all__ = [
    "BlockCorruptionError",
    "BlockStore",
    "DirBlockStore",
    "FingerprintIndex",
    "dedup_stats",
    "sha256_key",
    "space_savings",
]
