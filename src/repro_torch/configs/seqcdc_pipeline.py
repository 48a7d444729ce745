"""The paper's own configuration: SeqCDC dedup-pipeline settings.

The port's copy of ``repro/configs/seqcdc_pipeline.py``.  Not an LM
architecture: the configuration surface of the paper's contribution
itself (chunking + fingerprinting + dedup), consumed by the data
pipeline, the checkpoint store, and the benchmarks.  Table I parameters
live in core/params.py; this file is the framework-level config record.
The implementation fields take the port's values: ``mask_impl`` is
``"torch"`` (plain) or ``"cuda"`` (the masks kernel; a CPU tensor takes
its plain version).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.params import SeqCDCParams, paper_params


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    """Framework-level dedup settings (paper SSIII + SSVI)."""

    algorithm: str = "seqcdc"  # any name in core.chunker registry
    avg_chunk: int = 8192  # paper's headline configuration
    mode: str = "increasing"
    mask_impl: str = "cuda"  # torch | cuda (phase-1 bitmap backend)
    step_impl: str = "gather"  # wide | gather (phase-2 automaton step)
    segment_bytes: int = 1 << 20
    batch_segments: int = 8
    distributed_index: bool = True  # partition-by-hash all_to_all on a mesh

    def params(self) -> SeqCDCParams:
        return paper_params(self.avg_chunk, self.mode)


CONFIG = DedupConfig()
