"""repro_torch — the SeqCDC dedup service on PyTorch and hand-written CUDA,
and the LM substrate's serving path beside it.

A port of the JAX package ``repro`` to one NVIDIA Hopper card.  It imports
torch, numpy and the standard library only, never jax and nothing of
``repro``: what it needs of the reference lives here as its own copy
(``core.params``, ``core.oracle``, ``dedup.store``, ``obs``,
``service.objects``, ``service.writer``, ``service.depot``,
``service.transport``, ``_lazy``, ``configs``), byte-for-byte where an
on-disk or wire format depends on it.

Layout (mirrors ``repro``):

* ``core`` — parameters, the numpy oracle, phase-1 masks and the W-block
  boundary automaton in plain torch (``seqcdc.boundaries_batch``, and
  ``boundaries_packed_batch`` for rows of streams packed back to back);
* ``dedup`` — chunk fingerprints, the fingerprint index, the block store,
  the owner rule of the distributed index;
* ``kernels`` — the CUDA kernels (``csrc/*.cu``, built with ``nvcc`` at
  first use) behind wrappers that take their plain torch version only for
  tensors on the CPU;
* ``service`` — the bucketed ``ChunkScheduler`` (with segment packing of
  small objects), ``DedupService`` and ``ShardedDedupService`` with its
  writers and shard transport;
* ``configs``, ``models``, ``serve``, ``launch`` — the LM substrate's
  serving path for the dense family (``llama3.2-1b``): configurations
  (pure Python copies), the decoder with its KV caches (long prompts run
  the flash-attention kernel), the continuous-batching ``Engine`` and the
  ``python -m repro_torch.launch.serve`` CLI.

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
