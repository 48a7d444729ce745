"""Depot layout rules: where a sharded depot keeps what, stdlib-only.

One module owns the on-disk naming contract — ``shard-NN`` store
directories and the ``sharding.json`` shard-count pin — so every consumer
(`ShardedDedupService.open`, the shard servers' spawner, and the offline
``scripts/reshard.py``) reads and writes the same layout.  A copy of the
reference's ``repro/service/depot.py``: both packages read and write one
layout, so a sharded depot opens under either.  Stdlib only.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional


def shard_roots(root: str, num_shards: int) -> List[str]:
    """Per-shard store directories of a depot — the one place the
    ``shard-NN`` naming rule lives."""
    return [os.path.join(root, f"shard-{s:02d}") for s in range(num_shards)]


def read_depot_shards(root: str) -> Optional[int]:
    """Pinned shard count of a depot, or None when ``root`` holds none."""
    meta_path = os.path.join(root, "sharding.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return int(json.load(f)["num_shards"])


def pin_depot_shards(root: str, num_shards: int) -> None:
    """Atomically pin a depot's shard count in ``root/sharding.json``."""
    meta_path = os.path.join(root, "sharding.json")
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"num_shards": int(num_shards)}, f)
    os.replace(tmp, meta_path)
