"""Dedup ingest pipeline: the paper's technique as a training-data stage.

The port of ``repro/data/pipeline.py``.  Per-host flow:

    corpus shard -> [SeqCDC chunk] -> [fingerprint] -> [dedup filter]
                 -> unique-chunk byte stream -> token batches

Chunking and fingerprinting run batched on the device, ``batch_segments``
segments of ``segment_bytes`` a dispatch: on a CUDA device the masks,
select and fingerprint kernels (``boundaries_batch(..., mask_impl="cuda",
select_impl="cuda")`` and ``chunk_fingerprints(..., fp_impl="cuda")``),
on the CPU their plain versions (each wrapper takes its plain version for
a CPU tensor).  The index is the host-local :class:`FingerprintIndex`, and
the tail rule (a short last segment is one chunk keyed by its byte sum and
length) is the reference's, so ``unique_bytes``, ``token_batches`` and
``savings`` equal the reference's on the same corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.automaton import max_chunks_for
from repro_torch.core.params import SeqCDCParams, derived_params
from repro_torch.core.seqcdc import boundaries_batch
from repro_torch.dedup.fingerprint import chunk_fingerprints
from repro_torch.dedup.index import FingerprintIndex
from repro_torch.service.scheduler import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    avg_chunk: int = 8192
    segment_bytes: int = 1 << 20  # device batch granularity
    batch_segments: int = 8  # segments chunked per device dispatch
    vocab_size: int = 256  # byte-level tokens by default
    seq_len: int = 1024
    batch_size: int = 8
    drop_duplicates: bool = True


class DedupIngest:
    """Streaming dedup of a host corpus shard, device-batched."""

    def __init__(self, cfg: PipelineConfig, params: SeqCDCParams | None = None,
                 *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params or derived_params(cfg.avg_chunk)
        self.device = resolve_device(device)
        self.index = FingerprintIndex()

    def _chunk_batch(self, segs: np.ndarray):
        """segs: (B, S) uint8 -> (bounds, counts, fps, lens) numpy."""
        mc = max_chunks_for(segs.shape[1], self.params)
        x = torch.from_numpy(np.ascontiguousarray(segs)).to(self.device)
        bounds, counts = boundaries_batch(x, self.params, mask_impl="cuda",
                                          select_impl="cuda", max_chunks=mc)
        fps, lens = chunk_fingerprints(x, bounds, counts, max_chunks=mc,
                                       fp_impl="cuda")
        return (bounds.cpu().numpy(), counts.cpu().numpy(),
                fps.cpu().numpy(), lens.cpu().numpy())

    def unique_bytes(self, corpus: np.ndarray) -> Iterator[np.ndarray]:
        """Yield unique-chunk byte arrays from the corpus shard, in order."""
        S = self.cfg.segment_bytes
        B = self.cfg.batch_segments
        n_seg = len(corpus) // S
        tail = corpus[n_seg * S:]
        for i in range(0, n_seg, B):
            block = corpus[i * S: min((i + B) * S, n_seg * S)]
            nb = len(block) // S
            segs = block.reshape(nb, S)
            bounds, counts, fps, lens = self._chunk_batch(segs)
            for b in range(nb):
                cnt = int(counts[b])
                new = self.index.add_batch(fps[b, :cnt], lens[b, :cnt])
                s = 0
                for j in range(cnt):
                    e = int(bounds[b, j])
                    if new[j] or not self.cfg.drop_duplicates:
                        yield segs[b, s:e]
                    s = e
        if tail.size:
            if self.index.add((int(tail.sum()), len(tail)), len(tail)):
                yield tail

    def token_batches(self, corpus: np.ndarray) -> Iterator[np.ndarray]:
        """Pack unique bytes into (batch, seq_len+1) uint8 LM batches."""
        cfg = self.cfg
        need = cfg.batch_size * (cfg.seq_len + 1)
        buf = np.zeros(0, dtype=np.uint8)
        for chunk in self.unique_bytes(corpus):
            buf = np.concatenate([buf, chunk])
            while len(buf) >= need:
                batch = buf[:need].reshape(cfg.batch_size, cfg.seq_len + 1)
                yield batch
                buf = buf[need:]

    @property
    def savings(self) -> float:
        return self.index.savings
