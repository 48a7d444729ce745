"""Scenario engine: seeded versioned-corpus workloads with known structure.

The port's copy of ``repro/scenarios`` (numpy, byte for byte but for
the imports and the Zipf sampler of ``generators._zipf``, which keeps
``lm_text``'s corpus independent of numpy's version): the same seeds
build the same corpora, so the port's scenario ratios are held against
the reference's pinned ones.

Public surface (docs/SCENARIOS.md):

* :data:`SCENARIOS` / :func:`generate` — the workload catalog; each entry
  deterministically builds a list of named objects plus an
  :class:`ExpectedStructure` descriptor (constructed duplicate fraction,
  expected dedup-ratio band).
* :func:`corpus_digest` — canonical fingerprint of the determinism
  contract (same seed -> same digest, cross-process).
* :func:`bench_params` — the chunking params the ratio bands contract
  against, per budget.
* :func:`lm_training_corpus` — flat LM byte stream for the training
  example (``examples/train_dedup_lm.py``).

numpy + stdlib only: importing this package never imports jax.
"""
from .base import (  # noqa: F401
    BUDGETS,
    ExpectedStructure,
    Scenario,
    ScenarioCorpus,
    corpus_digest,
)
from .generators import (  # noqa: F401
    SCENARIOS,
    bench_params,
    generate,
    lm_training_corpus,
)
from . import edits  # noqa: F401

__all__ = [
    "BUDGETS", "ExpectedStructure", "Scenario", "ScenarioCorpus",
    "SCENARIOS", "bench_params", "corpus_digest", "edits", "generate",
    "lm_training_corpus",
]
