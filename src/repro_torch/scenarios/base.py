"""Scenario engine core types: corpora with a known duplicate structure.

A *scenario* is a seeded, deterministic generator of a versioned corpus —
a list of named objects (revisions, daily snapshots, corpus shards,
container images) whose redundancy is known *by construction* — plus an
:class:`ExpectedStructure` descriptor stating that construction-level
truth and the dedup-ratio band the service is contracted to deliver on
it.  Benchmarks (``benchmarks/bench_scenarios.py``) and tests
(``tests/test_scenarios.py``) consume the same objects, so a space-savings
regression on any workload shape fails CI exactly like a speed regression
(docs/SCENARIOS.md).

Determinism contract: ``generate(name, budget)`` is a pure function of
``(name, budget, seed)`` — same inputs produce byte-identical objects in
any process on any platform (numpy PCG64 streams only; no time, no
``hash()``, no filesystem reads).  :func:`corpus_digest` is the canonical
fingerprint of that contract.

This package is numpy + stdlib only — importable from shard servers,
tests, and examples without touching jax.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Tuple

import numpy as np

#: corpus-size tiers, smallest to largest; "tiny" exists for differential
#: tests (seconds-fast matrix cells), the rest mirror benchmarks/run.py
BUDGETS = ("tiny", "quick", "small", "full")


@dataclasses.dataclass(frozen=True)
class ExpectedStructure:
    """What the generator *built*, independent of any chunker.

    ``duplicate_fraction`` is the constructed redundancy: the fraction of
    logical bytes that are byte-identical to content emitted earlier in
    the corpus (payload accounting only — chunk-boundary spill means a
    real chunker recovers *at most* this much, so it upper-bounds
    achievable space savings).  ``min_dedup_ratio``/``max_dedup_ratio``
    is the contract band for the canonical service configuration
    (:func:`repro_torch.scenarios.bench_params` at the corpus's budget): a
    measured ratio outside the band is a scenario regression.
    """

    duplicate_fraction: float
    min_dedup_ratio: float
    max_dedup_ratio: float

    def check_ratio(self, ratio: float) -> bool:
        return self.min_dedup_ratio <= ratio <= self.max_dedup_ratio


@dataclasses.dataclass
class ScenarioCorpus:
    """One generated workload: ordered named objects + expected structure."""

    scenario: str
    budget: str
    seed: int
    objects: List[Tuple[str, np.ndarray]]
    expected: ExpectedStructure

    @property
    def logical_bytes(self) -> int:
        return sum(int(d.size) for _, d in self.objects)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Registry entry: name, default seed, the budget-aware builder, and
    the scenario's canonical average chunk size (workloads dedup best at
    different grains — see :func:`repro_torch.scenarios.bench_params`)."""

    name: str
    seed: int
    summary: str
    build: Callable[[str, int], ScenarioCorpus]
    avg_chunk: int = 8192

    def generate(self, budget: str = "small", seed: int | None = None
                 ) -> ScenarioCorpus:
        if budget not in BUDGETS:
            raise KeyError(
                f"unknown budget {budget!r}; expected one of {BUDGETS}")
        return self.build(budget, self.seed if seed is None else int(seed))


def corpus_digest(corpus: ScenarioCorpus) -> str:
    """SHA-256 over every object's name, length, and bytes, in order —
    the determinism contract's canonical fingerprint (same seed -> same
    digest, in any process)."""
    h = hashlib.sha256()
    for name, data in corpus.objects:
        h.update(name.encode())
        h.update(str(int(data.size)).encode())
        h.update(np.ascontiguousarray(data, dtype=np.uint8).tobytes())
    return h.hexdigest()


def scaled(table: Dict[str, tuple], budget: str) -> tuple:
    """Per-budget generator parameters with a loud failure for gaps."""
    try:
        return table[budget]
    except KeyError:
        raise KeyError(
            f"scenario has no parameters for budget {budget!r}; "
            f"declared: {sorted(table)}") from None
