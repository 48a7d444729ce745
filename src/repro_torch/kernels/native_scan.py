"""CUDA kernel: the native per-byte CDC scans, one thread's loop per stream.

The device form of the reference's unaccelerated baselines, per-byte
``lax.scan``/``while_loop``s on the TPU with no Pallas kernel:
``core/baselines/hash_based.py:_scan_native`` (gear, crc, rabin, fastcdc),
the AE/RAM scans of ``core/baselines/hashless.py`` and
``core/seqcdc.py:boundaries_sequential``.  The kernel
(``csrc/native_scan.cu``) runs each stream as one thread's serial loop,
one CTA a stream, its bytes streamed into shared memory ahead of the loop
by the copy engine: its bytes bound (``n + 4*mc`` a stream at 3.35 TB/s)
is far off by design, as the paper's unaccelerated baselines are.

Each plain version (:func:`native_scan_plain`) is the reference's step
function as a scalar Python loop.  Both return the bounds directly, where
the reference returns a per-byte ``ends`` mask and cuts on the host:
``flatnonzero(ends) + 1``, then ``n`` appended if it is not the last.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.automaton import _BIG

from ._build import Kernel

KERNEL = Kernel(
    "native_scan",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_uint] * 2 + [ctypes.c_int] * 7,
    replaces="src/repro/core/baselines/hash_based.py:36",
)

#: the algorithms, in the kernel's numbering
ALGOS = ("gear", "crc", "rabin", "fastcdc", "ae", "ram", "seqcdc")
#: the longest CRC/Rabin window the kernel's ring keeps behind its scan
MAX_WINDOW = 3 * 8192
_M32 = 0xFFFFFFFF


def _ends_plain(d, algo, *, min_size, max_size, mask, mask_l, avg_size,
                window, tables):
    """One stream's bounds from the reference's per-byte step (a Python
    loop over ``d``, a list of ints)."""
    n = len(d)
    mn, mx = min_size, max_size
    ends = []
    if algo in ("ae", "ram"):
        w = window
        rel, ev, ep, m = -1, -1, 0, 0
        for i, b in enumerate(d):
            rel += 1
            if algo == "ae":
                if b > ev:
                    ev, ep = b, rel
                end = (rel - ep >= w and rel + 1 >= mn) or rel + 1 >= mx
                if end:
                    rel, ev, ep = -1, -1, 0
            else:
                in_win = rel < w
                if in_win:
                    m = max(m, b)
                end = (not in_win and b >= m and rel + 1 >= mn) or \
                    rel + 1 >= mx
                if end:
                    rel, m = -1, 0
            if end:
                ends.append(i + 1)
    else:
        t0, t1, t2 = (t.tolist() for t in tables)
        h, rel = 0, 0
        for i, bi in enumerate(d):
            bo = d[i - window] if i >= window else 0
            if algo == "crc":
                h = ((h << 8) & _M32) ^ t0[(h >> 24) & 0xFF]
                h ^= t1[bi] ^ t2[bo]
            elif algo == "rabin":
                h = ((h << 8) & 0x7FFFFFFF) ^ t0[(h >> 23) & 0xFF]
                h ^= t1[bi] ^ t2[bo]
            else:  # gear, fastcdc
                h = ((h << 1) + t0[bi]) & _M32
            rel += 1
            if algo == "fastcdc":
                match = (h & (mask if rel < avg_size else mask_l)) == 0
            else:
                match = (h & mask) == 0
            if (match and rel >= mn) or rel >= mx:
                ends.append(i + 1)
                rel = 0
    if not ends or ends[-1] != n:
        ends.append(n)
    return ends


def _spec(data, algo, kw):
    if data.ndim != 2:
        raise ValueError(f"expected (B, n) data, got {tuple(data.shape)}")
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    p = kw.get("params")
    if algo == "seqcdc":
        if p is None:
            raise ValueError("algo='seqcdc' needs params=")
        if data.shape[1] < max(p.seq_length, 2):
            raise ValueError("a seqcdc scan needs n >= max(L, 2); "
                             "boundaries_sequential handles shorter streams")
        kw = dict(kw, min_size=p.min_size, max_size=p.max_size)
    t = kw.get("tables")
    tables = np.zeros((3, 256), np.uint32)
    if t is not None:
        t = np.asarray(t, np.uint32).reshape(-1, 256)
        tables[: t.shape[0]] = t
    kw = dict(kw, tables=tables)
    mc = kw.get("max_chunks") or data.shape[1] // kw["min_size"] + 2
    return kw, mc


def native_scan_plain(data: torch.Tensor, algo: str, **kw):
    """The reference's per-byte scan of ``algo`` over ``(B, n)`` uint8
    rows, a scalar Python loop per row.  Keyword arguments as for
    :func:`native_scan`.  Returns ``(bounds (B, mc) int32, counts (B,)
    int32)``."""
    from repro_torch.core.seqcdc import sequential_plain

    kw, mc = _spec(data, algo, kw)
    rows = []
    for d in data.cpu().tolist():
        if algo == "seqcdc":
            rows.append(sequential_plain(d, kw["params"]))
        else:
            rows.append(_ends_plain(
                d, algo, min_size=kw["min_size"], max_size=kw["max_size"],
                mask=kw.get("mask", 0), mask_l=kw.get("mask_l", 0),
                avg_size=kw.get("avg_size", 0), window=kw.get("window", 0),
                tables=kw["tables"]))
    bounds = torch.full((len(rows), mc), _BIG, dtype=torch.int32)
    for r, b in enumerate(rows):
        kept = b[:mc]
        bounds[r, : len(kept)] = torch.tensor(kept, dtype=torch.int32)
    counts = torch.tensor([len(b) for b in rows], dtype=torch.int32)
    return bounds.to(data.device), counts.to(data.device)


def native_scan(data: torch.Tensor, algo: str, *, min_size: int = 0,
                max_size: int = 0, mask: int = 0, mask_l: int = 0,
                avg_size: int = 0, window: int = 0, tables=None,
                params=None, max_chunks: int | None = None):
    """The native scan of ``algo`` over ``(B, n)`` uint8 rows.

    ``min_size``/``max_size`` bound the chunks; ``mask`` (and ``mask_l``
    past ``avg_size`` for fastcdc) is the hash match mask; ``window`` is
    CRC/Rabin's rolling window or AE/RAM's extremum window; ``tables`` is
    up to 3 x 256 uint32 (gear/fastcdc: the Gear table; crc: the byte
    step, first-offset and removal tables; rabin: the x^8 reduction,
    first-offset and removal tables).  ``algo="seqcdc"`` takes its sizes
    from ``params`` (a ``SeqCDCParams``) and needs ``n >= max(L, 2)``.
    ``max_chunks`` defaults to ``n // min_size + 2``.

    Returns ``(bounds (B, mc) int32, counts (B,) int32)``: bounds past
    ``mc`` are dropped and counted.  A CPU tensor takes
    :func:`native_scan_plain`; a CUDA tensor launches the kernel (or
    raises).
    """
    kw = dict(min_size=min_size, max_size=max_size, mask=mask,
              mask_l=mask_l, avg_size=avg_size, window=window,
              tables=tables, params=params, max_chunks=max_chunks)
    if data.device.type == "cpu":
        return native_scan_plain(data, algo, **kw)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.uint8:
        raise ValueError(f"expected uint8 data, got {data.dtype}")
    kw, mc = _spec(data, algo, kw)
    if algo in ("crc", "rabin") and not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"the kernel takes a {algo} window of 0 to "
                         f"{MAX_WINDOW} bytes, got {window}")
    x = data.contiguous()
    dev = x.device
    B, n = x.shape
    t = torch.from_numpy(kw["tables"].view(np.int32)).to(dev)
    bounds = torch.full((B, mc), _BIG, dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    p = params
    seq = (p.seq_length, p.skip_trigger, p.skip_size, p.sub_min_skip,
           int(p.mode == "increasing")) if algo == "seqcdc" else (0,) * 5
    with torch.cuda.device(dev):
        KERNEL.launch(
            x.data_ptr(), t.data_ptr(), bounds.data_ptr(), counts.data_ptr(),
            B, n, mc, ALGOS.index(algo), kw["min_size"], kw["max_size"],
            mask & _M32, mask_l & _M32, avg_size, window, *seq,
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    return bounds, counts
