"""repro_torch.service — the streaming dedup service on the card.

Layers: ChunkScheduler (batched device chunking, optional segment packing
of small objects) -> BlockStore (content addressed, refcounted) ->
RecipeTable (object manifests, GC roots), fronted by DedupService
(put/get/stat/delete + mark-and-sweep gc) and its fingerprint-partitioned
multi-shard form ShardedDedupService (owner-local stores behind per-shard
async writers, in-process or behind the ``transport`` package's RPC).

Exports resolve lazily (``repro_torch._lazy``): the torch modules
(api/scheduler/sharded) import when first touched, so a spawned
``shard_server`` process, which imports ``objects``, stays numpy+stdlib.
"""
from repro_torch._lazy import install as _install

#: public name -> defining submodule (resolved on first attribute access)
_EXPORTS = {
    "DedupService": ".api",
    "GCStats": ".api",
    "IntegrityError": ".api",
    "ObjectStat": ".api",
    "ServiceStats": ".api",
    "ObjectRecipe": ".objects",
    "RecipeTable": ".objects",
    "ChunkResult": ".scheduler",
    "ChunkScheduler": ".scheduler",
    "FingerprintDivergenceError": ".scheduler",
    "MaskDivergenceError": ".scheduler",
    "PackingDivergenceError": ".scheduler",
    "PipelineDivergenceError": ".scheduler",
    "SchedulerStats": ".scheduler",
    "ShardedDedupService": ".sharded",
    "AsyncWriteError": ".writer",
    "ShardWriter": ".writer",
    "WriterPool": ".writer",
    "RemoteShardClient": ".transport",
    "ShardServerProcess": ".transport",
    "ShardTransportError": ".transport",
}

_SUBMODULES = ("api", "depot", "objects", "scheduler", "sharded", "transport",
               "writer")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)

__getattr__, __dir__ = _install(__name__, _EXPORTS, _SUBMODULES)
