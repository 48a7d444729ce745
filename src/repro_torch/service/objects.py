"""Object recipes: the manifest layer between objects and chunk keys.

An object put through the service is recorded as a *recipe* — the ordered
list of content-addressed chunk keys that reassemble it, plus the whole-object
SHA-256 for end-to-end restore verification (chunk keys already verify each
chunk; the object digest additionally catches recipe corruption, i.e. right
chunks in the wrong order).  Recipes are the GC roots: a block is live iff
some recipe references it.

``RecipeTable`` persists as one JSON file with atomic replace, same crash
discipline as ``DirBlockStore``'s manifest: a torn write never corrupts the
previous committed table, and blocks orphaned by a crash between block write
and recipe commit are reclaimed by the service's mark-and-sweep GC.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass
class ObjectRecipe:
    name: str
    size: int  # logical bytes
    sha256: str  # digest of the reassembled object
    keys: List[str]  # chunk keys, in stream order
    chunk_lens: List[int]
    #: owner shard per chunk (sharded service only; None = single-store).
    #: Routing is by accelerator fingerprint, which a restore cannot recompute
    #: from the SHA key alone, so the owner must be recorded at commit time.
    shards: Optional[List[int]] = None
    #: per-chunk 62-bit accelerator fingerprint, packed ``(h1 << 32) | h2``
    #: (None = ingested before fps were recorded, or fingerprints disabled).
    #: This is what lets scripts/reshard.py re-route every chunk with the
    #: shared consistent-hash rule without re-chunking or re-hashing.
    fps: Optional[List[int]] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for opt in ("shards", "fps"):  # keep legacy tables byte-stable
            if d[opt] is None:
                d.pop(opt)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ObjectRecipe":
        shards = d.get("shards")
        fps = d.get("fps")
        return cls(name=d["name"], size=int(d["size"]), sha256=d["sha256"],
                   keys=list(d["keys"]), chunk_lens=[int(x) for x in d["chunk_lens"]],
                   shards=[int(s) for s in shards] if shards is not None else None,
                   fps=[int(f) for f in fps] if fps is not None else None)


class RecipeTable:
    """Name -> recipe mapping, optionally file-backed (atomic JSON)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._recipes: Dict[str, ObjectRecipe] = {}
        if path is not None and os.path.exists(path):
            with open(path) as f:
                for d in json.load(f)["objects"]:
                    r = ObjectRecipe.from_json(d)
                    self._recipes[r.name] = r

    def __contains__(self, name: str) -> bool:
        return name in self._recipes

    def __len__(self) -> int:
        return len(self._recipes)

    def __iter__(self) -> Iterator[ObjectRecipe]:
        return iter(self._recipes.values())

    def get(self, name: str) -> ObjectRecipe:
        return self._recipes[name]

    def add(self, recipe: ObjectRecipe):
        self._recipes[recipe.name] = recipe

    def remove(self, name: str) -> ObjectRecipe:
        return self._recipes.pop(name)

    def names(self) -> List[str]:
        return sorted(self._recipes)

    def sync(self):
        """Atomically persist the table (no-op for in-memory tables)."""
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"objects": [r.to_json() for r in self._recipes.values()]}, f)
        os.replace(tmp, self.path)
