"""repro_torch.service — the streaming dedup service on the card.

Layers: ChunkScheduler (batched device chunking) -> BlockStore (content
addressed, refcounted) -> RecipeTable (object manifests, GC roots), fronted
by DedupService (put/get/stat/delete + mark-and-sweep gc).
"""
from .api import (
    DedupService,
    GCStats,
    IntegrityError,
    ObjectStat,
    ServiceStats,
)
from .objects import ObjectRecipe, RecipeTable
from .scheduler import (
    ChunkResult,
    ChunkScheduler,
    FingerprintDivergenceError,
    MaskDivergenceError,
    PipelineDivergenceError,
    SchedulerStats,
)

__all__ = [
    "ChunkResult",
    "ChunkScheduler",
    "DedupService",
    "FingerprintDivergenceError",
    "GCStats",
    "IntegrityError",
    "MaskDivergenceError",
    "ObjectRecipe",
    "ObjectStat",
    "PipelineDivergenceError",
    "RecipeTable",
    "SchedulerStats",
    "ServiceStats",
]
