"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each module pairs one kernel (``csrc/<name>.cu``, built by ``_build`` at
first use) with a wrapper that launches it for CUDA tensors and takes the
plain torch version only for tensors on the CPU:

* ``seqcdc_masks`` — phase-1 candidate/opposing bitmaps;
* ``fingerprint`` — per-chunk 62-bit fingerprints;
* ``fused_pipeline`` — masks + boundary automaton + fingerprints in one
  launch per batch;
* ``packed_pipeline`` — the same over rows that hold several streams back
  to back (segment packing of small objects), resetting at every segment
  end;
* ``gear_hash`` — the per-position Gear rolling hash (gear, fastcdc);
* ``extremum`` — per-block byte maxima (the public ``block_max`` op);
* ``select_boundaries`` — the ``wide`` W-block automaton over given
  bitmaps (the split path's phase 2 and the hash chunkers' selector);
* ``native_scan`` — the per-byte native CDC scans (the ``_seq`` chunkers
  and ``boundaries_sequential``), one thread per stream.

Importing this package builds nothing and needs no card.
"""
from __future__ import annotations

from . import (
    extremum,
    fingerprint,
    fused_pipeline,
    gear_hash,
    native_scan,
    packed_pipeline,
    select_boundaries,
    seqcdc_masks,
)

#: every kernel of the port, in the order of the TPU kernels they replace,
#: then the two device forms of the reference's lax.scans
KERNELS = (seqcdc_masks.KERNEL, fingerprint.KERNEL, fused_pipeline.KERNEL,
           packed_pipeline.KERNEL, gear_hash.KERNEL, extremum.KERNEL,
           select_boundaries.KERNEL, native_scan.KERNEL)

__all__ = ["KERNELS", "extremum", "fingerprint", "fused_pipeline",
           "gear_hash", "native_scan", "packed_pipeline",
           "select_boundaries", "seqcdc_masks"]
