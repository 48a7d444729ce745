"""repro_torch — the SeqCDC dedup service on PyTorch and hand-written CUDA.

A port of the JAX package ``repro`` to one NVIDIA Hopper card.  It imports
torch, numpy and the standard library only, never jax and nothing of
``repro``: what it needs of the reference lives here as its own copy
(``core.params``, ``core.oracle``, ``dedup.store``, ``obs``,
``service.objects``), byte-for-byte where an on-disk format depends on it.

Layout (mirrors ``repro``):

* ``core`` — parameters, the numpy oracle, phase-1 masks and the W-block
  boundary automaton in plain torch (``seqcdc.boundaries_batch``);
* ``dedup`` — chunk fingerprints, the fingerprint index, the block store;
* ``kernels`` — the CUDA kernels (``csrc/*.cu``, built with ``nvcc`` at
  first use) behind wrappers that take their plain torch version only for
  tensors on the CPU;
* ``service`` — the bucketed ``ChunkScheduler`` and ``DedupService``.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from .core.params import SeqCDCParams


def params_from_reference(p: Any) -> SeqCDCParams:
    """The port's :class:`SeqCDCParams` from a reference parameter set.

    ``p`` is a field dict (``dataclasses.asdict`` of the reference's
    ``SeqCDCParams``) or any dataclass with the same fields, so a test can
    build both packages' parameters from one source.
    """
    fields = p if isinstance(p, Mapping) else dataclasses.asdict(p)
    return SeqCDCParams(**fields)


__all__ = ["SeqCDCParams", "params_from_reference"]
