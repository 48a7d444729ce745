"""Packed-row cases shared by the port's CPU and card tests (numpy only).

Each case is a list of rows, each row a list of byte strings laid back to
back in one packed row, with the parameter set (a field dict, so each
test builds its own package's ``SeqCDCParams``) and row width it runs at.
They are the adversarial cases of tests/test_packing.py: directed edges,
skip overshoots at segment ends, ends on tile edges, the 64 KiB limb row,
segments shorter than L, random mixes in both modes, and a row of about
160 tiny streams (G = 256).
"""
import numpy as np

SMALL = dict(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
             min_size=64, max_size=512)
PARAMS = {
    "small": SMALL,
    "small-dec": dict(SMALL, mode="decreasing"),
    # paper_params(8192) / derived_params(8192)
    "paper8k": dict(avg_size=8192, seq_length=5, skip_trigger=50,
                    skip_size=256, min_size=4096, max_size=16384),
}

CASES = ("directed-edges", "skip-overshoot", "tile-edges", "limb-boundary",
         "shorter-than-L", "random-increasing", "random-decreasing",
         "all-tiny-G256")


def pack(streams, S, G=None):
    """Rows of byte strings -> ``(data, sep, ends, seg_lens)``: the layout
    the schedulers build (pad entries of ``ends`` and the padding's
    ``sep`` carry the payload end)."""
    if G is None:
        G = max(len(row) for row in streams)
    B = len(streams)
    data = np.zeros((B, S), np.uint8)
    sep = np.zeros((B, S), np.int32)
    ends = np.zeros((B, G), np.int32)
    seg_lens = []
    for bi, row in enumerate(streams):
        off = 0
        for gi, s in enumerate(row):
            m = len(s)
            if m:
                data[bi, off:off + m] = np.frombuffer(bytes(s), np.uint8)
            sep[bi, off:off + m] = off + m
            ends[bi, gi] = off + m
            off += m
        sep[bi, off:] = off
        ends[bi, len(row):] = off
        seg_lens.append([len(s) for s in row])
    return data, sep, ends, seg_lens


def _random_mix(rng, S, mode, rows):
    def seg(n):
        if mode == "zeros":
            return bytes(n)
        if mode == "lowent":
            return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        if mode == "mixed" and rng.random() < 0.5:
            return bytes(n)
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    streams = []
    for _ in range(rows):
        row, fill = [], 0
        while fill < S:
            n = int(rng.integers(0, 900))
            if fill + n > S:
                break
            row.append(seg(n))
            fill += n
        streams.append(row or [seg(1)])
    return streams


def case(name):
    """``(params name, row width, rows of streams)`` of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    r = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    low = lambda n: rng.integers(0, 3, n, dtype=np.uint8).tobytes()
    z = bytes
    mixes = ("random", "lowent", "zeros", "mixed")
    if name == "directed-edges":  # 1-byte, empty, exactly min_size
        return "small", 1024, [[r(1), b"", r(64), r(300), r(1)],
                               [b"", b"", r(700)], [r(1)] * 8, [r(64)] * 4]
    if name == "skip-overshoot":  # ends while skipping or on max-size
        return "small", 1024, [[z(70), z(100), z(130)],
                               [z(600), low(200), z(65)], [low(511), z(513)],
                               [z(64 + q) for q in range(0, 32, 5)]]
    if name == "tile-edges":  # ends on and around a 1024 tile edge
        return "small", 2048, [[r(1024), r(512), r(512)],
                               [r(1023), r(1), r(1024)],
                               [r(1), r(1023), r(1024)], [r(1025), r(1023)]]
    if name == "limb-boundary":  # a full 65536-byte row
        return "small", 65536, [[r(65535), r(1)]]
    if name == "shorter-than-L":  # L = 3: a 1-byte segment clamps k to -1
        return "small", 1024, [[r(int(n)) for n in rng.integers(1, 5, 40)],
                               [r(1)] * 30 + [r(200)],
                               [r(2), z(3), r(1), z(1)]]
    if name == "random-increasing":
        return "small", 2048, [row for mode in mixes
                               for row in _random_mix(rng, 2048, mode, 2)]
    if name == "random-decreasing":
        return "small-dec", 2048, [row for mode in mixes
                                   for row in _random_mix(rng, 2048, mode, 2)]
    if name == "all-tiny-G256":
        row, fill = [], 0
        while True:
            n = int(rng.integers(60, 140))
            if fill + n > 16384:
                break
            row.append(r(n))
            fill += n
        assert 128 < len(row) <= 256
        return "paper8k", 16384, [row]
    raise KeyError(name)
