"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each module pairs one kernel (``csrc/<name>.cu``, built by ``_build`` at
first use) with a wrapper that launches it for CUDA tensors and takes the
plain torch version only for tensors on the CPU:

* ``seqcdc_masks`` — phase-1 candidate/opposing bitmaps;
* ``fingerprint`` — per-chunk 62-bit fingerprints;
* ``fused_pipeline`` — masks + boundary automaton + fingerprints in one
  launch per batch.

Importing this package builds nothing and needs no card.
"""
from __future__ import annotations

from . import fingerprint, fused_pipeline, seqcdc_masks

#: every kernel of the port, in the order of the TPU kernels they replace
KERNELS = (seqcdc_masks.KERNEL, fingerprint.KERNEL, fused_pipeline.KERNEL)

__all__ = ["KERNELS", "fingerprint", "fused_pipeline", "seqcdc_masks"]
