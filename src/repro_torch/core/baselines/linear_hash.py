"""Windowed linear rolling hashes (Rabin, CRC, Gear) and their parallel form.

Rolling hashes look inherently sequential, but every one used by CDC is
*linear* in its window bytes:

  * Rabin:  h_i = sum_d  b_{i-d} * x^{8d}  mod P      (GF(2) polynomial)
  * CRC:    h_i = xor_d  T_d[b_{i-d}]                  (GF(2), affine-free
            with init=0)
  * Gear:   h_i = sum_d  G[b_{i-d}] << d   (mod 2^32)  (register truncation
            bounds the window to 32 bytes)

so the hash at *every* position is an independent window sum over per-offset
tables: the parallel decomposition used by the vectorized baselines.  This
module builds the per-offset tables host-side (python ints: exact
wraparound, no numpy overflow traps) and provides numpy/torch evaluators.

A copy of ``repro/core/baselines/linear_hash.py`` (the tables and masks
bit for bit), with ``windowed_hash_torch`` in place of the reference's
``windowed_hash_jnp``.  32-bit registers throughout, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np

RABIN_WINDOW = 48
CRC_WINDOW = 32
GEAR_WINDOW = 32

#: x^31 + x^3 + 1 — primitive trinomial over GF(2), degree 31 (fits uint32).
RABIN_POLY = (1 << 31) | (1 << 3) | 1
#: CRC-32 (IEEE 802.3) polynomial, non-reflected form, init=0 for linearity.
CRC_POLY = 0x04C11DB7


def _gf2_mod(val: int, poly: int, deg: int) -> int:
    while val.bit_length() > deg:
        val ^= poly << (val.bit_length() - 1 - deg)
    return val


@functools.lru_cache(maxsize=None)
def rabin_tables(window: int = RABIN_WINDOW) -> np.ndarray:
    """T[d][v] = (v * x^(8d)) mod P  -> (window, 256) uint32."""
    out = np.zeros((window, 256), dtype=np.uint32)
    for d in range(window):
        for v in range(256):
            out[d, v] = _gf2_mod(v << (8 * d), RABIN_POLY, 31)
    return out


@functools.lru_cache(maxsize=None)
def rabin_red8() -> np.ndarray:
    """RED[t] = (t << 31) mod P: reduction of the 8 bits (h>>23) that overflow
    degree 31 after the native x^8-multiply step."""
    return np.asarray(
        [_gf2_mod(t << 31, RABIN_POLY, 31) for t in range(256)], dtype=np.uint32
    )


@functools.lru_cache(maxsize=None)
def crc_byte_table() -> np.ndarray:
    """Non-reflected CRC-32 byte-step table (init 0, no final xor)."""
    out = np.zeros(256, dtype=np.uint32)
    for v in range(256):
        r = v << 24
        for _ in range(8):
            r = ((r << 1) ^ CRC_POLY) & 0xFFFFFFFF if r & 0x80000000 else (r << 1) & 0xFFFFFFFF
        out[v] = r
    return out


@functools.lru_cache(maxsize=None)
def crc_tables(window: int = CRC_WINDOW) -> np.ndarray:
    """T[d][v] = CRC register after byte v followed by d zero bytes."""
    base = crc_byte_table()
    out = np.zeros((window, 256), dtype=np.uint32)
    out[0] = base
    for d in range(1, window):
        prev = out[d - 1]
        out[d] = ((prev << 8) & 0xFFFFFFFF) ^ base[(prev >> 24) & 0xFF]
    return out


def windowed_hash_np(data: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """h[i] = xor_d T[d][b[i-d]] (missing terms at stream head omitted)."""
    d8 = np.asarray(data, dtype=np.uint8)
    n = d8.shape[0]
    w = tables.shape[0]
    h = np.zeros(n, dtype=np.uint32)
    for d in range(min(w, n)):
        contrib = tables[d][d8[: n - d]]
        h[d:] ^= contrib
    return h


def windowed_hash_torch(data, tables_np: np.ndarray):
    """:func:`windowed_hash_np` in torch, on ``data``'s device: the
    counterpart of the reference's ``windowed_hash_jnp``.  Computes in
    int64 (torch's CPU build has no uint32 xor) and returns uint32."""
    import torch

    d = data.to(torch.int64)
    n = d.shape[0]
    w = tables_np.shape[0]
    tables = torch.from_numpy(tables_np.astype(np.int64)).to(data.device)
    h = torch.zeros(n, dtype=torch.int64, device=data.device)
    for j in range(min(w, n)):
        h[j:] ^= tables[j][d[: n - j]]
    return h.to(torch.uint32)


def spread_mask(bits: int, seed: int, width: int = 32) -> int:
    """FastCDC-style mask with ``bits`` set positions spread over the word."""
    rng = np.random.default_rng(seed)
    pos = rng.choice(width, size=bits, replace=False)
    m = 0
    for p in pos:
        m |= 1 << int(p)
    return m
