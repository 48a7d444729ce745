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
* ``select_boundaries_packed`` — the same over packed rows' bitmaps,
  resetting at every segment end (the packed split path's phase 2);
* ``select_boundaries_gather`` — the ``gather`` step over given bitmaps:
  per-block tables built in parallel, constant work a W-block, walked from
  every candidate's emit at once and chased into a row's bounds
  (``boundary_chain``);
* ``select_boundaries_event`` — the ``event`` step over given bitmaps:
  prefix sums built in parallel, one search an event, walked and chased
  the same way;
* ``native_scan`` — the per-byte native CDC scans (the ``_seq`` chunkers
  and ``boundaries_sequential``), one thread's serial loop per stream;
* ``flash_attn`` — causal (or full) flash attention forward with grouped
  KV heads, the LM serving path's prefill attention;
* ``linear_scan`` — the diagonal linear recurrence of the RG-LRU's prefill;
* ``mlstm_scan`` — the mLSTM's carry of its matrix state from chunk to
  chunk;
* ``slstm_scan`` — the sLSTM's recurrence over a sequence.

The last three also hold a backward kernel each (``BWD_KERNEL``), which
their ``torch.autograd.Function`` launches when a call needs a gradient.

Importing this package builds nothing and needs no card.
"""
from __future__ import annotations

from . import (
    extremum,
    fingerprint,
    flash_attn,
    fused_pipeline,
    gear_hash,
    linear_scan,
    mlstm_scan,
    native_scan,
    packed_pipeline,
    select_boundaries,
    select_boundaries_event,
    select_boundaries_gather,
    select_boundaries_packed,
    seqcdc_masks,
    slstm_scan,
)

#: every kernel of the port, in the order of the TPU kernels they replace
#: (1-6), then the five device forms of the dedup path's scans, then
#: TPU kernel 7, flash attention (the LM serving path's), then the device
#: forms of the recurrent families' scans, then their backwards
KERNELS = (seqcdc_masks.KERNEL, fingerprint.KERNEL, fused_pipeline.KERNEL,
           packed_pipeline.KERNEL, gear_hash.KERNEL, extremum.KERNEL,
           select_boundaries.KERNEL, select_boundaries_packed.KERNEL,
           select_boundaries_gather.KERNEL, select_boundaries_event.KERNEL,
           native_scan.KERNEL, flash_attn.KERNEL,
           linear_scan.KERNEL, mlstm_scan.KERNEL, slstm_scan.KERNEL,
           linear_scan.BWD_KERNEL, mlstm_scan.BWD_KERNEL,
           slstm_scan.BWD_KERNEL)

__all__ = ["KERNELS", "extremum", "fingerprint", "flash_attn",
           "fused_pipeline", "gear_hash", "linear_scan", "mlstm_scan",
           "native_scan", "packed_pipeline", "select_boundaries",
           "select_boundaries_event", "select_boundaries_gather",
           "select_boundaries_packed", "seqcdc_masks", "slstm_scan"]
