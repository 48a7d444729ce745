"""Fault-tolerant CDC-deduplicated checkpoint store.

The port of ``repro/checkpoint/store.py`` over nested dicts, lists and
NamedTuples of tensors (``state_dict``-like trees).  Every leaf is
serialized, chunked with the registry's chunker on the manager's device
(``make_chunker(algorithm, avg_chunk, device=...)``: SeqCDC's masks and
select kernels on a CUDA device) and stored in a content-addressed block
store; between adjacent checkpoints most chunks are identical, so step
k+1 costs only the changed chunks.

Interchange: the manifest format is the reference's byte for byte.  Leaf
paths are the strings ``jax.tree_util.keystr`` gives (``['segments'][0]
['attn']['wq']``, ``.mu`` for a NamedTuple field), dict keys in sorted
order as jax flattens them; dtype strings are numpy's, and bfloat16 leaves
(which have no numpy dtype without ``ml_dtypes``) are written and read as
their raw 2-byte words under ``"bfloat16"``, as the reference writes them.
A checkpoint written by either package restores bit-equal in the other.

Durability contract (the reference's):
* every block write is atomic (tmp + rename, DirBlockStore);
* a checkpoint becomes visible only when its manifest rename commits;
* ``latest`` is a pointer file updated by atomic rename: a crash at any
  point leaves the newest committed checkpoint readable.

Manifests record logical leaf paths, shapes and dtypes, never a device,
so :meth:`CheckpointManager.restore_on_device` places a checkpoint on any
device (the reference's ``restore_sharded`` places it on a mesh).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch._tree import is_namedtuple, tree_map, unflatten
from repro_torch.core.chunker import make_chunker
from repro_torch.dedup.store import DirBlockStore


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util`` flattening order: dict keys sorted,
    ``[k!r]`` for a dict key, ``[i]`` for a list or tuple index, ``.f`` for
    a NamedTuple field; ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif is_namedtuple(tree):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, Any]:
    """Tree -> {path string: leaf} with deterministic, reversible paths."""
    return dict(_paths(tree))


def _unflatten(tree_like, flat: Dict[str, Any]):
    """Inverse of _flatten given a structural template tree."""
    return unflatten(tree_like, [flat[p] for p, _ in _paths(tree_like)])


def _host(leaf, copy: bool = False) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (``copy``: never an alias)."""
    t = torch.as_tensor(leaf).detach()
    return t.to("cpu", copy=copy).contiguous()


def _dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype (``bfloat16`` for bfloat16)."""
    if dt == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dt).numpy().dtype)


def _raw(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as numpy (bfloat16 as its raw 16-bit words)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(data, dtype=np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).copy()
    return torch.from_numpy(arr).reshape(shape)


class CheckpointManager:
    def __init__(
        self,
        root: str,
        *,
        algorithm: str = "seqcdc",
        avg_chunk: int = 64 * 1024,
        keep: int = 3,
        device: str | torch.device = "cuda",
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.store = DirBlockStore(os.path.join(root, "store"))
        self.chunker = make_chunker(algorithm, avg_chunk, device=device)
        self.keep = keep
        self._lock = threading.Lock()
        self._async_thread: threading.Thread | None = None

    # -- paths ---------------------------------------------------------------
    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.root, f"manifest-{step:08d}.json")

    @property
    def _latest_path(self) -> str:
        return os.path.join(self.root, "latest")

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith("manifest-") and fn.endswith(".json"):
                out.append(int(fn[len("manifest-"): -len(".json")]))
        return sorted(out)

    def latest_step(self) -> int | None:
        try:
            with open(self._latest_path) as f:
                step = int(f.read().strip())
        except (OSError, ValueError):
            return None
        return step if os.path.exists(self._manifest_path(step)) else None

    # -- save ----------------------------------------------------------------
    def _put_leaf(self, t: torch.Tensor) -> Dict[str, Any]:
        view = _raw(t).reshape(-1).view(np.uint8)
        bounds = self.chunker.chunk(view) if view.size else np.zeros(0, np.int64)
        keys = self.store.put_stream(view, bounds) if view.size else []
        return {"shape": list(t.shape), "dtype": _dtype_name(t.dtype),
                "keys": keys}

    def save(self, step: int, state: Dict[str, Any], extra: Dict | None = None):
        """Synchronous checkpoint.  ``state`` is a dict of trees; each leaf
        is copied to the host once."""
        with self._lock:
            manifest = {"step": step, "extra": extra or {}, "trees": {}}
            for name in sorted(state):  # the reference's order of trees
                leaves = {}
                for path, leaf in _flatten(state[name]).items():
                    leaves[path] = self._put_leaf(_host(leaf))
                manifest["trees"][name] = leaves
            self.store.sync_manifest()
            tmp = self._manifest_path(step) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, self._manifest_path(step))  # commit point
            tmp = self._latest_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(step))
            os.replace(tmp, self._latest_path)
            self._retain()

    def save_async(self, step: int, state, extra=None):
        """Copy to the host synchronously, write in a background thread."""
        self.wait()
        host = {name: tree_map(lambda x: _host(x, copy=True), tree)
                for name, tree in state.items()}
        self._async_thread = threading.Thread(
            target=self.save, args=(step, host, extra), daemon=True
        )
        self._async_thread.start()

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _retain(self):
        steps = self.steps()
        for step in steps[: -self.keep] if self.keep else []:
            path = self._manifest_path(step)
            with open(path) as f:
                manifest = json.load(f)
            for tree in manifest["trees"].values():
                for meta in tree.values():
                    for key in meta["keys"]:
                        self.store.release(key)
            os.remove(path)
        self.store.sync_manifest()

    # -- restore ---------------------------------------------------------------
    def _get_leaf(self, meta: Dict[str, Any]) -> torch.Tensor:
        data = self.store.get_stream(meta["keys"])
        return _from_bytes(data, meta["dtype"], meta["shape"])

    def restore(self, step: int | None = None, tree_like: Dict | None = None):
        """Returns (step, {name: tree-or-flat-dict}, extra), CPU tensors.

        With ``tree_like`` (a dict of structural templates, e.g. the
        current params), leaves are put back into that structure;
        otherwise flat ``{path: tensor}`` dicts are returned.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None, None
        with open(self._manifest_path(step)) as f:
            manifest = json.load(f)
        out = {}
        for name, leaves in manifest["trees"].items():
            flat = {p: self._get_leaf(m) for p, m in leaves.items()}
            if tree_like is not None and name in tree_like:
                out[name] = _unflatten(tree_like[name], flat)
            else:
                out[name] = flat
        return step, out, manifest["extra"]

    def restore_on_device(self, tree_like, device, step: int | None = None):
        """Restore onto ``device`` (which need not be the one that saved
        the checkpoint): every leaf of every tree is moved there."""
        step, out, extra = self.restore(step, tree_like)
        if step is None:
            return None, None, None
        placed = {name: tree_map(lambda t: t.to(device), tree)
                  for name, tree in out.items()}
        return step, placed, extra

    # -- accounting ------------------------------------------------------------
    @property
    def dedup_savings(self) -> float:
        return self.store.savings
