"""Corpus construction: real container files + synthetic snapshot series.

The port's copy of ``repro/data/corpus.py`` (numpy, unchanged).

The paper evaluates on 40-230 GB proprietary corpora (VM images, build-server
backups, kernel trees, Redis/MySQL snapshots).  We reproduce the *phenomena*
at container scale (DESIGN.md SS8) with:

* :func:`container_corpus` — real bytes harvested from this machine's
  filesystem (source trees, shared objects, text): the "LNX-like" corpus.
* :func:`snapshot_series` — K successive "backups" of a mutating store:
  each snapshot applies insert/delete/overwrite edits to the previous one
  (byte-shifting!) — the "DEV/RDS/TPCC-like" corpora.  Edit rates control
  the achievable dedup.
* :func:`vm_image_like` — mixed-entropy image: zero runs, text blocks,
  binary blobs, repeated filesystem metadata — the "DEB-like" corpus.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

_DEFAULT_ROOTS = ("/usr/lib/python3", "/usr/include", "/etc", "/opt")


def container_corpus(
    max_bytes: int = 64 << 20, roots=_DEFAULT_ROOTS, max_file: int = 4 << 20
) -> np.ndarray:
    """Concatenate real files from the container filesystem (deterministic walk)."""
    bufs, total = [], 0
    for root in roots:
        if total >= max_bytes or not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                try:
                    size = os.path.getsize(path)
                    if size == 0 or size > max_file or os.path.islink(path):
                        continue
                    with open(path, "rb") as f:
                        bufs.append(np.frombuffer(f.read(), dtype=np.uint8))
                    total += size
                except OSError:
                    continue
                if total >= max_bytes:
                    break
            if total >= max_bytes:
                break
    if not bufs:  # fallback: deterministic pseudo-text
        return vm_image_like(max_bytes, seed=13)
    out = np.concatenate(bufs)
    return out[:max_bytes]


def snapshot_series(
    base_bytes: int = 8 << 20,
    snapshots: int = 8,
    edit_rate: float = 2e-5,
    seed: int = 0,
    low_entropy: bool = False,
) -> Iterator[np.ndarray]:
    """Yield K snapshots; each applies ~edit_rate*len edits to the previous.

    Edits are insert (1-64 B), delete (1-64 B), or overwrite (1-256 B) at
    random offsets — the byte-shifting workload of paper SSIV.
    """
    rng = np.random.default_rng(seed)
    if low_entropy:
        cur = rng.integers(0, 16, base_bytes, dtype=np.uint8) * 16
    else:
        cur = rng.integers(0, 256, base_bytes, dtype=np.uint8)
    yield cur.copy()
    for _ in range(snapshots - 1):
        n_edits = max(1, int(len(cur) * edit_rate))
        parts = []
        prev = 0
        offs = np.sort(rng.integers(0, len(cur), n_edits))
        for off in offs:
            off = int(off)
            if off < prev:
                continue
            parts.append(cur[prev:off])
            kind = rng.integers(0, 3)
            if kind == 0:  # insert
                parts.append(rng.integers(0, 256, int(rng.integers(1, 65)), dtype=np.uint8))
                prev = off
            elif kind == 1:  # delete
                prev = min(len(cur), off + int(rng.integers(1, 65)))
            else:  # overwrite
                ln = int(rng.integers(1, 257))
                parts.append(rng.integers(0, 256, ln, dtype=np.uint8))
                prev = min(len(cur), off + ln)
        parts.append(cur[prev:])
        cur = np.concatenate(parts)
        yield cur.copy()


def vm_image_like(total: int = 32 << 20, seed: int = 0) -> np.ndarray:
    """Mixed-entropy 'VM image': zero pages, ASCII text, binary, metadata."""
    rng = np.random.default_rng(seed)
    words = np.array(
        [w.encode() for w in (
            "the quick brown fox jumps over lazy dog kernel module "
            "config system daemon service mount device driver linux "
        ).split()], dtype=object,
    )
    parts, size = [], 0
    meta = rng.integers(0, 256, 4096, dtype=np.uint8)  # repeated fs metadata
    while size < total:
        kind = rng.integers(0, 10)
        if kind < 3:  # zero run
            ln = int(rng.integers(4096, 65536))
            parts.append(np.zeros(ln, dtype=np.uint8))
        elif kind < 6:  # text
            txt = b" ".join(rng.choice(words, 2048).tolist())
            parts.append(np.frombuffer(txt, dtype=np.uint8))
        elif kind < 9:  # binary blob
            ln = int(rng.integers(8192, 131072))
            parts.append(rng.integers(0, 256, ln, dtype=np.uint8))
        else:  # repeated metadata page
            parts.append(meta.copy())
        size += len(parts[-1])
    return np.concatenate(parts)[:total]


DATASETS = {
    "LNX": lambda mb=48: container_corpus(mb << 20),
    "DEB": lambda mb=48: vm_image_like(mb << 20, seed=1),
    "DEV": lambda mb=48: np.concatenate(
        list(snapshot_series(base_bytes=max(mb // 8, 1) << 20, snapshots=8, edit_rate=1e-5, seed=2))
    ),
    "RDS": lambda mb=48: np.concatenate(
        list(snapshot_series(base_bytes=max(mb // 8, 1) << 20, snapshots=8, edit_rate=1e-4, seed=3, low_entropy=True))
    ),
    "TPCC": lambda mb=48: np.concatenate(
        list(snapshot_series(base_bytes=max(mb // 6, 1) << 20, snapshots=6, edit_rate=5e-5, seed=4))
    ),
}


def load_dataset(name: str, mb: int = 48) -> np.ndarray:
    return DATASETS[name](mb)
