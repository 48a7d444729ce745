"""Seeded edit programs: insert/delete/update/append over structured data.

The engine behind the versioned-corpus scenarios (docs/SCENARIOS.md): a
*program* is an explicit list of :class:`EditOp`, sampled from a seeded
rng and applied sequentially, so each dataset revision is a deterministic
function of (base bytes, seed) and the edited-byte totals are known by
construction — the generator can state the corpus's duplicate fraction
instead of guessing it.  Inserts and deletes shift every byte after them,
which is exactly the workload CDC exists for (fixed-size chunking loses
all alignment; content-defined boundaries resynchronize).

Structured base data (:func:`structured_rows`) mimics record-oriented
files — pipe-delimited rows with ids, categorical words, and numeric
fields — so updates/inserts look like dataset edits, not noise splices.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

#: op kinds, in the order the sampler's kind-draw indexes them
KINDS = ("insert", "delete", "update", "append")

_WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo "
    "lima mike november oscar papa quebec romeo sierra tango uniform "
    "victor whiskey xray yankee zulu"
).split()


@dataclasses.dataclass(frozen=True)
class EditOp:
    """One edit: where, how many bytes leave, and what bytes arrive.

    ``offset`` indexes the revision *as it stands when the op runs* (ops
    apply sequentially); ``length`` is the span removed (delete/update —
    zero for insert/append); ``payload`` is the bytes added (empty for
    delete).  ``append`` ignores ``offset``/``length``.
    """

    kind: str
    offset: int
    length: int
    payload: bytes = b""


def apply_op(data: np.ndarray, op: EditOp) -> np.ndarray:
    """Apply one op; offsets/lengths are clamped, never out-of-range."""
    n = int(data.size)
    pay = np.frombuffer(op.payload, dtype=np.uint8)
    if op.kind == "append":
        return np.concatenate([data, pay])
    off = min(max(0, op.offset), n)
    if op.kind == "insert":
        return np.concatenate([data[:off], pay, data[off:]])
    end = min(n, off + max(0, op.length))
    if op.kind == "delete":
        return np.concatenate([data[:off], data[end:]])
    if op.kind == "update":
        return np.concatenate([data[:off], pay, data[end:]])
    raise ValueError(f"unknown edit kind {op.kind!r}")


def apply_program(data: np.ndarray, ops: Sequence[EditOp]) -> np.ndarray:
    out = np.ascontiguousarray(data, dtype=np.uint8)
    for op in ops:
        out = apply_op(out, op)
    return out


def fresh_bytes(ops: Sequence[EditOp]) -> int:
    """Bytes a program adds that did not exist before — the payload side
    of the construction-level duplicate accounting."""
    return sum(len(op.payload) for op in ops)


def sample_program(
    rng: np.random.Generator,
    size: int,
    n_ops: int,
    *,
    kinds: Sequence[str] = KINDS,
    max_edit: int = 256,
    payload: "callable | None" = None,
) -> List[EditOp]:
    """Draw a seeded program of ``n_ops`` edits against a ``size``-byte
    revision.  ``payload(rng, length) -> bytes`` supplies inserted bytes
    (default: uniform random), so structured scenarios can insert
    structured records.  Offsets track the running length, so every op is
    in-range when applied sequentially."""
    if payload is None:
        payload = lambda r, ln: r.integers(0, 256, ln, dtype=np.uint8).tobytes()
    ops: List[EditOp] = []
    cur = int(size)
    for _ in range(max(0, int(n_ops))):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        ln = int(rng.integers(1, max_edit + 1))
        off = int(rng.integers(0, max(1, cur)))
        if kind == "insert":
            ops.append(EditOp("insert", off, 0, payload(rng, ln)))
            cur += ln
        elif kind == "delete":
            ln = min(ln, max(0, cur - 1))  # never delete the whole object
            ops.append(EditOp("delete", off, ln))
            cur = max(1, cur - ln)
        elif kind == "update":
            ops.append(EditOp("update", off, ln, payload(rng, ln)))
            cur = max(cur, off)  # length-preserving up to the clamp
        else:  # append
            ops.append(EditOp("append", 0, 0, payload(rng, ln)))
            cur += ln
    return ops


def revision_history(
    base: np.ndarray,
    revisions: int,
    ops_per_rev: int,
    rng: np.random.Generator,
    **sample_kw,
) -> Iterator[Tuple[np.ndarray, List[EditOp]]]:
    """Yield ``revisions`` successive (bytes, program) states; the first
    is the base itself with an empty program."""
    cur = np.ascontiguousarray(base, dtype=np.uint8)
    yield cur, []
    for _ in range(max(0, int(revisions) - 1)):
        ops = sample_program(rng, int(cur.size), ops_per_rev, **sample_kw)
        cur = apply_program(cur, ops)
        yield cur, ops


# -- structured base data ----------------------------------------------------

def structured_rows(rng: np.random.Generator, nbytes: int,
                    start_id: int = 0) -> np.ndarray:
    """Record-oriented base data: pipe-delimited rows with a sequential
    id, categorical words, and a numeric field — dataset-shaped bytes, so
    edit programs read as row updates/inserts rather than noise."""
    rows: List[bytes] = []
    total, rid = 0, int(start_id)
    while total < nbytes:
        w = [_WORDS[int(i)] for i in rng.integers(0, len(_WORDS), 3)]
        row = (f"{rid:08d}|{w[0]}|{w[1]}-{w[2]}|"
               f"{rng.random():.6f}|{int(rng.integers(0, 2))}\n").encode()
        rows.append(row)
        total += len(row)
        rid += 1
    return np.frombuffer(b"".join(rows), dtype=np.uint8)[:nbytes].copy()


def row_payload(rng: np.random.Generator, length: int) -> bytes:
    """Structured insert payload: whole rows, trimmed to ``length``."""
    return structured_rows(rng, length, start_id=int(rng.integers(10**7))
                           ).tobytes()
