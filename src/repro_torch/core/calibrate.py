"""Monte-Carlo parameter calibration (paper SSV "Obtaining parameter values").

The paper tunes (SeqLength, SkipTrigger, SkipSize) by simulating on randomized
data until the achieved average chunk size matches the target, then validates
on one real dataset.  We reproduce that methodology for SeqCDC *and* extend it
to every baseline (mask bits / window sizes), so all algorithms are compared
at comparable achieved averages.  The frozen results live in
``CALIBRATED`` below; :func:`calibrated_kwargs` selects them.

A copy of ``repro/core/calibrate.py`` (the table and the two searches).
``calibrate_seqcdc`` runs the host oracle chunker (``device="cpu"``: it
never touches a device); ``calibrate_scalar``'s chunkers run on the
chunkers' default device, the card.
"""
from __future__ import annotations

import numpy as np

from .chunker import make_chunker
from .params import SeqCDCParams

_SIM_BYTES = 4 << 20

#: Frozen output of the Monte-Carlo search below (4 MiB uniform random,
#: seed 0), the reference's table unchanged.  The search picks
#: SeqLength=6 on random data: strict 6-byte monotone runs occur ~1/720 per
#: byte, which with min_size = avg/2 and skip amplification lands the mean on
#: target, whereas Table I's L=5 (tuned on the paper's real datasets, where
#: monotone runs are rarer than uniform) undershoots on synthetic streams.
#: ``paper_params`` remains available for fidelity runs; benchmarks report the
#: achieved mean for both.
CALIBRATED = {
    4096: {
        "seqcdc": dict(seq_length=6, skip_trigger=40, skip_size=128),
        "gear": dict(mask_bits=11), "crc": dict(mask_bits=11),
        "rabin": dict(mask_bits=11), "fastcdc": dict(mask_bits=11),
        "tttd": dict(mask_bits=11),
        "ae": dict(window=4096), "ram": dict(window=3840),
    },
    8192: {
        "seqcdc": dict(seq_length=6, skip_trigger=55, skip_size=512),
        "gear": dict(mask_bits=12), "crc": dict(mask_bits=12),
        "rabin": dict(mask_bits=12), "fastcdc": dict(mask_bits=12),
        "tttd": dict(mask_bits=12),
        "ae": dict(window=8192), "ram": dict(window=7936),
    },
    16384: {
        "seqcdc": dict(seq_length=6, skip_trigger=40, skip_size=768),
        "gear": dict(mask_bits=13), "crc": dict(mask_bits=13),
        "rabin": dict(mask_bits=13), "fastcdc": dict(mask_bits=13),
        "tttd": dict(mask_bits=13),
        "ae": dict(window=16384), "ram": dict(window=16128),
    },
    32768: {
        "seqcdc": dict(seq_length=6, skip_trigger=50, skip_size=1024),
        "gear": dict(mask_bits=14), "crc": dict(mask_bits=14),
        "rabin": dict(mask_bits=14), "fastcdc": dict(mask_bits=14),
        "tttd": dict(mask_bits=14),
        "ae": dict(window=32768), "ram": dict(window=32640),
    },
}


def calibrated_kwargs(name: str, avg_size: int) -> dict:
    """Frozen calibrated knobs for a chunker family at a standard avg size."""
    fam = name.replace("_seq", "").replace("_numpy", "")
    table = CALIBRATED.get(avg_size, {})
    kw = dict(table.get(fam, {}))
    if fam == "seqcdc" and kw:
        from .params import SeqCDCParams

        p = SeqCDCParams(
            avg_size=avg_size,
            min_size=max(1024, avg_size // 2),
            max_size=2 * avg_size,
            **kw,
        )
        return {"params": p}
    return kw


def calibrated_chunker(name: str, avg_size: int, **extra):
    """make_chunker with the frozen calibrated knobs applied."""
    kw = calibrated_kwargs(name, avg_size)
    kw.update(extra)
    return make_chunker(name, avg_size, **kw)


def _mean_size(chunker, data) -> float:
    lens = chunker.chunk_lengths(data)
    return float(lens.mean()) if lens.size else float("nan")


def _sim_data(seed: int = 0, n: int = _SIM_BYTES) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def calibrate_seqcdc(avg_size: int, data: np.ndarray | None = None):
    """Grid search near Table I values; returns the best SeqCDCParams."""
    data = _sim_data() if data is None else data
    best, best_err = None, float("inf")
    min_size = max(1024, avg_size // 2)
    for L in (4, 5, 6):
        for T in (40, 45, 50, 55, 60):
            for K in (128, 256, 384, 512, 768, 1024):
                p = SeqCDCParams(
                    avg_size=avg_size,
                    seq_length=L,
                    skip_trigger=T,
                    skip_size=K,
                    min_size=min_size,
                    max_size=2 * avg_size,
                )
                c = make_chunker("seqcdc_numpy", avg_size, params=p,
                                 device="cpu")
                err = abs(_mean_size(c, data) - avg_size)
                if err < best_err:
                    best, best_err = p, err
    return best


def calibrate_scalar(name: str, avg_size: int, key: str, grid, data=None):
    """1-D search over a single knob (mask bits / window) for a baseline."""
    data = _sim_data() if data is None else data
    best, best_err = None, float("inf")
    for v in grid:
        c = make_chunker(name, avg_size, **{key: v})
        err = abs(_mean_size(c, data) - avg_size)
        if err < best_err:
            best, best_err = v, err
    return best
