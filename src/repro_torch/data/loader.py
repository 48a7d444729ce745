"""Deterministic sharded batch loader with restart cursor.

The port's copy of ``repro/data/loader.py`` (numpy, unchanged): batches
are host arrays; the trainer moves them to its device.

Feeds the train loop: infinite stream of (tokens, labels) batches derived
from a (deduplicated) corpus, sharded by host so each data-parallel host
reads only its slice, with a step cursor that makes restart-after-failure
bit-deterministic (train/loop.py restores the cursor from the checkpoint).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 8  # global batch
    seq_len: int = 256
    host_index: int = 0
    host_count: int = 1
    seed: int = 17


class TokenLoader:
    """Byte-level LM batches from a corpus array, deterministic per step."""

    def __init__(self, corpus: np.ndarray, cfg: LoaderConfig):
        assert cfg.batch_size % cfg.host_count == 0
        self.cfg = cfg
        self.corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
        self.n = len(self.corpus) - (cfg.seq_len + 1)
        assert self.n > 0, "corpus smaller than one sequence"
        self.local_batch = cfg.batch_size // cfg.host_count

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(tokens (local_B, S), labels (local_B, S)) for a global step.

        Offsets are a pure function of (seed, step, host, row): restart at
        step k reproduces exactly the batches a non-failed run would see.
        """
        cfg = self.cfg
        with np.errstate(over="ignore"):  # splitmix64: wraparound intended
            rows = np.arange(self.local_batch, dtype=np.uint64)
            gidx = (
                np.uint64(step) * np.uint64(cfg.batch_size)
                + np.uint64(cfg.host_index) * np.uint64(self.local_batch)
                + rows
            )
            x = gidx + np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            x = x ^ (x >> np.uint64(31))
            offs = (x % np.uint64(self.n)).astype(np.int64)
        idx = offs[:, None] + np.arange(self.cfg.seq_len + 1)[None, :]
        window = self.corpus[idx]
        return window[:, :-1].astype(np.int32), window[:, 1:].astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
