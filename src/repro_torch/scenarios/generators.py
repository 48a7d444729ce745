"""The scenario catalog: four versioned-corpus workload generators.

Each builder returns a :class:`~repro_torch.scenarios.base.ScenarioCorpus` whose
redundancy is known by construction (``fresh`` bytes are tracked as they
are emitted), and whose expected dedup-ratio band is declared per budget
for the canonical bench configuration (:func:`bench_params`).  The bands
were measured on the seed corpora and widened for chunking slack; they
are a *contract*, not a measurement — see docs/SCENARIOS.md before
touching them.

Catalog (seeds are part of the corpus identity — changing one changes
every golden pin):

* ``dataset_revisions`` — edit-program revision history over structured
  row data (the HF parquet-dedupe-estimator workload shape).
* ``backup_snapshots``  — daily backups of a mixed-entropy "disk": small
  in-place mutations + log growth over a large unchanged base.
* ``lm_text``           — LM-training text shards with controlled exact
  and near duplication (the corpus side of examples/train_dedup_lm.py).
* ``container_images``  — tar-like concatenated-file images re-assembled
  per release with a few files changed (offset-shifting layer rebuilds).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .base import ExpectedStructure, Scenario, ScenarioCorpus, scaled
from . import edits

MiB = 1 << 20
KiB = 1 << 10


def bench_params(scenario: str, budget: str = "small"):
    """The canonical chunking params the expected-ratio bands contract
    against — *per scenario*, because chunker quality is
    workload-dependent (the CDC survey's point, and this subsystem's):
    byte-shifted binary corpora use production 8 KiB average chunks, but
    LM text needs a finer grain — duplicate docs are only a few 8 KiB
    chunks long, and SeqCDC's boundary walk needs many chunks to
    resynchronize after entering a duplicate at a new phase, so coarse
    chunks dedup text to ~nothing.  The tiny (test-matrix) budget drops
    everything to 1 KiB so tens-of-KiB objects still have meaningful
    chunk counts."""
    from repro_torch.core.params import derived_params

    if budget == "tiny":
        return derived_params(1024)
    return derived_params(SCENARIOS[scenario].avg_chunk)


# -- 1. dataset revisions (edit programs over structured rows) ---------------

#: budget -> (base_bytes, revisions, ops_per_rev, band)
_REVISIONS = {
    "tiny":  (24 * KiB, 3, 6),
    "quick": (640 * KiB, 4, 8),
    "small": (2 * MiB, 5, 12),
    "full":  (6 * MiB, 8, 20),
}
_REVISION_BANDS = {
    "tiny":  (1.35, 1.95),
    "quick": (2.2, 3.3),
    "small": (2.5, 3.7),
    "full":  (4.2, 6.3),
}


def _dataset_revisions(budget: str, seed: int) -> ScenarioCorpus:
    base_bytes, revisions, ops = scaled(_REVISIONS, budget)
    rng = np.random.default_rng(seed)
    base = edits.structured_rows(rng, base_bytes)
    objects: List[Tuple[str, np.ndarray]] = []
    fresh = 0
    for i, (rev, prog) in enumerate(edits.revision_history(
            base, revisions, ops, rng, payload=edits.row_payload)):
        objects.append((f"rev-{i:03d}", rev))
        fresh += int(base.size) if i == 0 else edits.fresh_bytes(prog)
    logical = sum(int(d.size) for _, d in objects)
    lo, hi = scaled(_REVISION_BANDS, budget)
    return ScenarioCorpus(
        scenario="dataset_revisions", budget=budget, seed=seed,
        objects=objects,
        expected=ExpectedStructure(1.0 - fresh / logical, lo, hi))


# -- 2. backup-style daily snapshots -----------------------------------------

#: budget -> (base_bytes, days, ops_per_day)
_BACKUP = {
    "tiny":  (32 * KiB, 3, 4),
    "quick": (1 * MiB, 4, 6),
    "small": (3 * MiB, 6, 10),
    "full":  (8 * MiB, 10, 16),
}
_BACKUP_BANDS = {
    "tiny":  (3.0, 4.5),
    "quick": (2.3, 3.5),
    "small": (3.2, 4.8),
    "full":  (5.4, 8.2),
}


def _disk_base(rng: np.random.Generator, nbytes: int) -> np.ndarray:
    """Mixed-entropy 'disk image': zero runs, text pages, binary blobs,
    and a repeated metadata page — the backup-source byte mix."""
    meta = rng.integers(0, 256, 512, dtype=np.uint8)
    parts: List[np.ndarray] = []
    total = 0
    while total < nbytes:
        kind = int(rng.integers(0, 10))
        if kind < 3:
            part = np.zeros(int(rng.integers(4 * KiB, 32 * KiB)),
                            dtype=np.uint8)
        elif kind < 6:
            part = edits.structured_rows(
                rng, int(rng.integers(4 * KiB, 24 * KiB)),
                start_id=int(rng.integers(10**6)))
        elif kind < 9:
            part = rng.integers(0, 256, int(rng.integers(8 * KiB, 48 * KiB)),
                                dtype=np.uint8)
        else:
            part = meta.copy()
        parts.append(part)
        total += int(part.size)
    return np.concatenate(parts)[:nbytes]


def _backup_snapshots(budget: str, seed: int) -> ScenarioCorpus:
    base_bytes, days, ops = scaled(_BACKUP, budget)
    rng = np.random.default_rng(seed)
    cur = _disk_base(rng, base_bytes)
    objects = [("day-000", cur.copy())]
    fresh = int(cur.size)
    # backups skew to in-place updates plus log-style appends; a rare
    # insert keeps the byte-shifting pressure CDC is supposed to absorb
    kinds = ("update", "update", "update", "append", "insert")
    for d in range(1, days):
        prog = edits.sample_program(rng, int(cur.size), ops, kinds=kinds,
                                    max_edit=2048)
        cur = edits.apply_program(cur, prog)
        objects.append((f"day-{d:03d}", cur.copy()))
        fresh += edits.fresh_bytes(prog)
    logical = sum(int(d.size) for _, d in objects)
    lo, hi = scaled(_BACKUP_BANDS, budget)
    return ScenarioCorpus(
        scenario="backup_snapshots", budget=budget, seed=seed,
        objects=objects,
        expected=ExpectedStructure(1.0 - fresh / logical, lo, hi))


# -- 3. LM-training text with controlled near-duplication --------------------

#: budget -> (shards, shard_bytes, doc_words_lo, doc_words_hi).  Docs must
#: span many average chunks (words*~7B >> avg_chunk) or CDC has no
#: interior chunks to resynchronize on and duplicate docs dedup to ~zero.
_LM = {
    "tiny":  (3, 64 * KiB, 2000, 4000),
    "quick": (4, 320 * KiB, 10000, 20000),
    "small": (4, 1 * MiB, 10000, 20000),
    "full":  (6, 2 * MiB, 10000, 20000),
}
_LM_BANDS = {
    "tiny":  (1.0, 1.25),
    "quick": (1.35, 1.95),
    "small": (1.5, 2.25),
    "full":  (1.4, 2.1),
}
#: doc-level duplication mix: fresh / exact-duplicate / near-duplicate
_LM_P_EXACT, _LM_P_NEAR = 0.25, 0.25
_LM_NEAR_EDITS = 8  # word substitutions per near-duplicate


def _vocab(rng: np.random.Generator, size: int = 2000) -> List[bytes]:
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    out = []
    for _ in range(size):
        n = int(rng.integers(3, 10))
        out.append(letters[rng.integers(0, 26, n)].tobytes())
    return out


_INT64_MAX = float(2**63 - 1)


def _zipf(rng: np.random.Generator, a: float, n: int) -> np.ndarray:
    """``rng.zipf(a, n)`` as numpy up to 2.0 draws it: the rejection
    sampler of Devroye with ``U = 1 - next_double()``, two doubles an
    attempt, the same draws off ``rng``.  numpy 2.1 changed
    ``Generator.zipf`` (``U`` from ``(Umin, 1]``), so the same seed gave
    another ``lm_text`` corpus there; with this sampler the corpus, and
    ``BENCH_quick.json``'s ratios, do not depend on numpy's version.
    ``math.pow`` is the C library's ``pow``, which numpy's sampler calls."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    out: List[int] = []
    while len(out) < n:
        state = rng.bit_generator.state
        d = rng.random(2 * max(64, 2 * (n - len(out)))).tolist()
        used = 0
        for i in range(0, len(d), 2):
            used = i + 2
            x = math.floor(math.pow(1.0 - d[i], -1.0 / am1))
            if x > _INT64_MAX or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if d[i + 1] * x * (t - 1.0) / (b - 1.0) <= t / b:
                out.append(int(x))
                if len(out) == n:
                    break
        # rewind, then take exactly the doubles the attempts used
        rng.bit_generator.state = state
        rng.random(used)
    return np.array(out, dtype=np.int64)


def _fresh_doc(rng: np.random.Generator, vocab: List[bytes],
               lo: int, hi: int) -> bytes:
    n = int(rng.integers(lo, hi))
    # Zipf-ish draw: natural-text token frequencies, clipped to the vocab
    idx = np.minimum(_zipf(rng, 1.3, n), len(vocab)) - 1
    return b" ".join(vocab[int(i)] for i in idx) + b"\n\n"


def _lm_text(budget: str, seed: int) -> ScenarioCorpus:
    shards, shard_bytes, lo_w, hi_w = scaled(_LM, budget)
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng)
    docs: List[bytes] = []
    fresh = 0
    objects: List[Tuple[str, np.ndarray]] = []
    for s in range(shards):
        parts: List[bytes] = []
        total = 0
        while total < shard_bytes:
            draw = rng.random()
            if docs and draw < _LM_P_EXACT:
                doc = docs[int(rng.integers(0, len(docs)))]
            elif docs and draw < _LM_P_EXACT + _LM_P_NEAR:
                words = docs[int(rng.integers(0, len(docs)))].split(b" ")
                for _ in range(_LM_NEAR_EDITS):
                    j = int(rng.integers(0, len(words)))
                    w = vocab[int(rng.integers(0, len(vocab)))]
                    fresh += len(w)
                    words[j] = w
                doc = b" ".join(words)
            else:
                doc = _fresh_doc(rng, vocab, lo_w, hi_w)
                fresh += len(doc)
                docs.append(doc)
            parts.append(doc)
            total += len(doc)
        objects.append((f"shard-{s:02d}", np.frombuffer(
            b"".join(parts), dtype=np.uint8)[:shard_bytes].copy()))
    logical = sum(int(d.size) for _, d in objects)
    lo, hi = scaled(_LM_BANDS, budget)
    return ScenarioCorpus(
        scenario="lm_text", budget=budget, seed=seed, objects=objects,
        expected=ExpectedStructure(
            max(0.0, 1.0 - fresh / logical), lo, hi))


def lm_training_corpus(mb: float, seed: int = 303) -> np.ndarray:
    """One flat LM-pretraining byte stream with the catalog's controlled
    duplication mix — the corpus side of ``examples/train_dedup_lm.py``
    (dedup-before-tokenization has real duplicates to remove)."""
    nbytes = int(mb * MiB)
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng)
    docs: List[bytes] = []
    parts: List[bytes] = []
    total = 0
    while total < nbytes:
        draw = rng.random()
        if docs and draw < _LM_P_EXACT + _LM_P_NEAR:
            doc = docs[int(rng.integers(0, len(docs)))]
        else:
            doc = _fresh_doc(rng, vocab, 10000, 20000)
            docs.append(doc)
        parts.append(doc)
        total += len(doc)
    return np.frombuffer(b"".join(parts), dtype=np.uint8)[:nbytes].copy()


# -- 4. container/archive-style concatenated-file images ---------------------

#: budget -> (files, file_lo, file_hi, versions, updates, adds, deletes)
_CONTAINER = {
    "tiny":  (16, 512, 4 * KiB, 3, 2, 1, 1),
    "quick": (48, 2 * KiB, 40 * KiB, 4, 4, 2, 1),
    "small": (96, 2 * KiB, 64 * KiB, 5, 6, 3, 1),
    "full":  (128, 4 * KiB, 96 * KiB, 6, 8, 4, 2),
}
_CONTAINER_BANDS = {
    "tiny":  (1.55, 2.3),
    "quick": (1.8, 2.7),
    "small": (3.0, 4.6),
    "full":  (3.4, 5.1),
}
_BLOCK = 512  # tar-style header/content block granularity


def _file_content(rng: np.random.Generator, lo: int, hi: int) -> np.ndarray:
    n = int(rng.integers(lo, hi))
    kind = int(rng.integers(0, 3))
    if kind == 0:  # text-ish
        return edits.structured_rows(rng, n, start_id=int(rng.integers(10**6)))
    if kind == 1:  # binary
        return rng.integers(0, 256, n, dtype=np.uint8)
    return np.zeros(n, dtype=np.uint8)  # sparse


def _image(files: Dict[str, np.ndarray]) -> np.ndarray:
    """Serialize a file map as a tar-like stream: per file a 512-byte
    header (name + size, zero padded) then content padded to 512."""
    parts: List[np.ndarray] = []
    for name in sorted(files):
        data = files[name]
        hdr = np.zeros(_BLOCK, dtype=np.uint8)
        meta = f"{name}\x00{int(data.size):o}\x00ustar".encode()[:_BLOCK]
        hdr[: len(meta)] = np.frombuffer(meta, dtype=np.uint8)
        parts.append(hdr)
        pad = (-int(data.size)) % _BLOCK
        parts.append(data)
        if pad:
            parts.append(np.zeros(pad, dtype=np.uint8))
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)


def _container_images(budget: str, seed: int) -> ScenarioCorpus:
    n_files, lo, hi, versions, updates, adds, deletes = scaled(
        _CONTAINER, budget)
    rng = np.random.default_rng(seed)
    files: Dict[str, np.ndarray] = {}
    fresh = 0
    for i in range(n_files):
        files[f"usr/pkg-{i:04d}.bin"] = _file_content(rng, lo, hi)
    objects: List[Tuple[str, np.ndarray]] = []
    img = _image(files)
    objects.append(("image-v000", img))
    fresh += int(img.size)
    next_id = n_files
    for v in range(1, versions):
        names = sorted(files)
        for name in [names[int(i)] for i in
                     rng.choice(len(names), size=min(updates, len(names)),
                                replace=False)]:
            files[name] = _file_content(rng, lo, hi)
            fresh += int(files[name].size)
        for _ in range(adds):
            data = _file_content(rng, lo, hi)
            files[f"usr/pkg-{next_id:04d}.bin"] = data
            fresh += int(data.size) + _BLOCK  # new header is fresh too
            next_id += 1
        names = sorted(files)
        for name in [names[int(i)] for i in
                     rng.choice(len(names), size=min(deletes, len(names) - 1),
                                replace=False)]:
            del files[name]
        objects.append((f"image-v{v:03d}", _image(files)))
    logical = sum(int(d.size) for _, d in objects)
    blo, bhi = scaled(_CONTAINER_BANDS, budget)
    return ScenarioCorpus(
        scenario="container_images", budget=budget, seed=seed,
        objects=objects,
        expected=ExpectedStructure(
            max(0.0, 1.0 - fresh / logical), blo, bhi))


# -- registry ----------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("dataset_revisions", 101,
                 "edit-program revision history over structured rows",
                 _dataset_revisions),
        Scenario("backup_snapshots", 202,
                 "daily snapshots: small mutations over a large base",
                 _backup_snapshots),
        Scenario("lm_text", 303,
                 "LM-training text shards with controlled near-duplication",
                 _lm_text, avg_chunk=1024),
        Scenario("container_images", 404,
                 "tar-like concatenated-file images, few files change per "
                 "release", _container_images),
    )
}


def generate(name: str, budget: str = "small",
             seed: int | None = None) -> ScenarioCorpus:
    """Build one scenario corpus; same (name, budget, seed) -> identical
    bytes in any process (the determinism contract)."""
    try:
        sc = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; catalog: {sorted(SCENARIOS)}"
        ) from None
    return sc.generate(budget, seed)
