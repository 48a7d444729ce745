"""The port's chunker registry and CDC baselines against the JAX reference.

Every registered name, made by the port's ``make_chunker(..., device="cpu")``
(the kernel wrappers take their plain versions for CPU tensors), gives the
bounds the reference's ``make_chunker`` gives on the same seeded numpy
streams, random and low-entropy, at 64 KiB and 256 KiB, at avg 4096 and
8192, with default and calibrated knobs.  The reference's gear and fastcdc
run both with their Pallas Gear kernel (interpret mode) and without it, and
crc/rabin with both backends (the second forms at 64 KiB); the port's
crc/rabin run with both of theirs.  The reference's own chunker tests
(``tests/test_baselines.py``: boundary invariants, native == vectorized,
shift resistance) then run on the port.  Bounds are integers: tolerance 0.
"""
import numpy as np
import pytest

import jax

from repro.core import available as javailable
from repro.core import make_chunker as jmake
from repro.core.calibrate import calibrated_kwargs as jcalibrated

from repro_torch.core import available, make_chunker
from repro_torch.core.calibrate import CALIBRATED, calibrated_kwargs

#: tests/test_baselines.py's algorithms and (vectorized, native) pairs
ALGOS = ["seqcdc", "fixed", "gear", "crc", "rabin", "fastcdc", "tttd", "ae",
         "ram"]
PAIRS = [
    ("seqcdc", "seqcdc_seq"),
    ("seqcdc", "seqcdc_numpy"),
    ("gear", "gear_seq"),
    ("crc", "crc_seq"),
    ("rabin", "rabin_seq"),
    ("fastcdc", "fastcdc_seq"),
    ("ae", "ae_seq"),
    ("ram", "ram_seq"),
]


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no reference
    trace made here serves a later test in the same process."""
    yield
    jax.clear_caches()


def _streams():
    rng = np.random.default_rng(21)
    return {"random": rng.integers(0, 256, 1 << 18, dtype=np.uint8),
            "low-entropy": rng.integers(0, 3, 1 << 18, dtype=np.uint8)}


STREAMS = _streams()


def port(name, avg, **kw):
    return make_chunker(name, avg, device="cpu", **kw)


def test_registry_matches_reference():
    assert available() == javailable()
    for a in ALGOS:
        assert a in available(), a
    with pytest.raises(KeyError):
        make_chunker("zstd")


def test_calibrated_table_matches_reference():
    for avg in CALIBRATED:
        for name in available():
            got, want = calibrated_kwargs(name, avg), jcalibrated(name, avg)
            if "params" in want:
                assert got["params"].__dict__ == want["params"].__dict__
            else:
                assert got == want, (name, avg)


def _reference_variants(name):
    """The reference's forms of one name that the port must equal."""
    if name in ("gear", "fastcdc"):
        return [{"use_pallas": False}, {"use_pallas": True}]
    if name in ("crc", "rabin"):
        return [{}, {"backend": "jnp"}]
    return [{}]


@pytest.mark.parametrize("kind", sorted(STREAMS))
@pytest.mark.parametrize("name", javailable())
def test_every_name_matches_reference(name, kind):
    data = STREAMS[kind]
    for n in (1 << 16, 1 << 18):
        d = data[:n]
        for avg in (4096, 8192):
            for calibrated in (False, True):
                kw = calibrated_kwargs(name, avg) if calibrated else {}
                jkw = jcalibrated(name, avg) if calibrated else {}
                got = port(name, avg, **kw).chunk(d)
                # the reference's second forms (Pallas in interpret mode,
                # the jnp backend) compile per length: the short stream
                variants = _reference_variants(name)[: 1 if n > 1 << 16
                                                     else None]
                for extra in variants:
                    want = jmake(name, avg, **jkw, **extra).chunk(d)
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{name} {avg} {extra}")
                if name in ("crc", "rabin"):
                    np.testing.assert_array_equal(
                        port(name, avg, backend="torch", **kw).chunk(d),
                        got, err_msg=f"{name} backend=torch")


def test_chunk_accepts_bytes_and_empty_input():
    d = STREAMS["random"][:5000]
    c = port("seqcdc", 4096)
    np.testing.assert_array_equal(c.chunk(d.tobytes()), c.chunk(d))
    assert c.chunk(b"").size == 0
    assert c.chunk_lengths(d).sum() == d.size
    with pytest.raises(ValueError):
        port("crc", 4096, backend="jnp")


# -- the reference's chunker tests, on the port -----------------------------

@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(1).integers(0, 256, 1 << 20, dtype=np.uint8)


@pytest.mark.parametrize("name", ALGOS)
def test_boundary_invariants(name, data):
    c = port(name, 8192)
    bounds = c.chunk(data)
    assert bounds[-1] == data.size
    assert (np.diff(bounds) > 0).all()
    lens = np.diff(np.concatenate([[0], bounds]))
    assert (lens <= c.max_size).all(), name
    assert (lens[:-1] >= c.min_size).all(), name
    mean = lens.mean()
    assert 0.25 * 8192 <= mean <= 2.1 * 8192, (name, mean)


@pytest.mark.parametrize("vec,seq", PAIRS)
def test_native_equals_vectorized(vec, seq, data):
    sub = data[: 1 << 18]
    np.testing.assert_array_equal(port(vec, 8192).chunk(sub),
                                  port(seq, 8192).chunk(sub),
                                  err_msg=f"{vec} != {seq}")


@pytest.mark.parametrize("name", ["seqcdc", "gear", "rabin", "ae", "ram"])
def test_content_defined_shift_resistance(name):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 1 << 19, dtype=np.uint8)
    c = port(name, 4096)
    b0 = set(c.chunk(data).tolist())
    pos = 1 << 18
    edit = np.concatenate([data[:pos],
                           rng.integers(0, 256, 11, dtype=np.uint8),
                           data[pos:]])
    b1 = [b - 11 for b in c.chunk(edit).tolist() if b >= pos + 11]
    survive = sum(b in b0 for b in b1) / max(len(b1), 1)
    assert survive > 0.85, (name, survive)


def test_fixed_is_exact():
    bounds = port("fixed", 4096).chunk(np.zeros(10_000, dtype=np.uint8))
    assert bounds.tolist() == [4096, 8192, 10000]


def test_seqcdc_steps_agree():
    """SeqCDCChunker(step_impl=...) picks the automaton's step: the select
    kernel's ``wide`` (its plain version here) and the plain ``gather`` and
    ``event`` steps give one result."""
    d = STREAMS["random"]
    want = port("seqcdc", 4096).chunk(d)
    for step in ("gather", "event"):
        np.testing.assert_array_equal(
            port("seqcdc", 4096, step_impl=step).chunk(d), want)


def test_chunker_on_cuda_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_chunker("seqcdc")
