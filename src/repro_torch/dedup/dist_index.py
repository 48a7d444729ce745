"""Distributed fingerprint index: partition by hash, capacity-padded
``all_to_all``.

The port of ``repro/dedup/dist_index.py``.  Owners partition the
fingerprint space by hash (HYDRAstor-style), so equal chunks always meet on
the same owner and owner-local dedup is globally exact:

  1. owner(fp) = fp.h1 mod num_shards     (consistent hash partitioning)
  2. each source shard sorts its records by owner (stably) and scatters
     them into per-owner buckets of ``capacity`` rows;
  3. the ``all_to_all`` turns the ``(src, owner)`` buckets into
     ``(owner, src)`` tables;
  4. owners dedup locally (sort + first-occurrence mask) and the per-owner
     counts are summed.

The reference runs this under ``shard_map`` on one controller; so does the
port, over a :class:`~repro_torch.launch.mesh.Mesh` of ``torch.device``s.
Where every shard of the axis shares one device (4 or 8 shards of one card,
or the CPU), the exchange is a transpose of one ``(S, S, capacity, 3)``
tensor; across devices it copies each ``(src, owner)`` slab to the owner's
device.  Records beyond a bucket's capacity are *counted and reported*
(``overflow``), never silently dropped: a consumer re-routes the batch with
:func:`route_host` (docs/SHARDING.md, "Overflow").

:func:`owner_of` is the one normative partition rule; the host route and
the mesh route both derive from it.  The host half is numpy only (the
shard server imports this package); the mesh half imports torch when
called.  Fingerprint arithmetic runs in int64 and is cast to uint32 only
at the output.
"""
from __future__ import annotations

import numpy as np


def owner_of(fp1, num_shards: int):
    """Shard owner of a fingerprint: ``fp.h1 mod num_shards``, on python
    ints, numpy arrays and int64 tensors.  Every routing path uses this one
    rule."""
    return fp1 % num_shards


def route_host(fps: np.ndarray, num_shards: int) -> np.ndarray:
    """Per-record owner shard ids of a ``(C, 2)`` uint32 fingerprint table
    (only ``h1`` routes): ``(C,)`` int32 in ``[0, num_shards)``.  No
    capacity limit, so it never overflows."""
    fps = np.asarray(fps)
    return owner_of(fps[:, 0].astype(np.int64), num_shards).astype(np.int32)


def suggested_capacity(rows_per_shard: int, num_shards: int,
                       capacity_factor: float = 1.5) -> int:
    """Per-destination bucket rows for a capacity-padded ``all_to_all``:
    the uniform expectation ``rows_per_shard / num_shards`` times
    ``capacity_factor`` headroom, plus an 8-row floor for tiny shards."""
    return int((rows_per_shard / num_shards) * capacity_factor) + 8


def _local_route(fp, lengths, num_shards: int, capacity: int):
    """The ``(S, num_shards, capacity, 3)`` int64 buckets of S source shards
    at once, and each source's overflow ``(S,)``.

    ``fp`` (S, C, 2) and ``lengths`` (S, C) are int64.  Within a bucket the
    records keep their source order (a stable sort by owner), as the
    reference's buckets do; padding rows (length 0) go nowhere."""
    import torch

    S, C = lengths.shape
    owner = owner_of(fp[..., 0], num_shards)
    owner = torch.where(lengths > 0, owner, num_shards)  # padding -> dropped
    order = torch.argsort(owner, dim=1, stable=True)
    owner_s = torch.gather(owner, 1, order)
    # rank within the owner group: position minus the group's start
    bins = torch.arange(num_shards + 1, device=owner.device).expand(
        S, num_shards + 1).contiguous()
    starts = torch.searchsorted(owner_s, bins)
    pos = (torch.arange(C, device=owner.device)[None, :]
           - torch.gather(starts, 1, owner_s))
    src = torch.stack([torch.gather(fp[..., 0], 1, order),
                       torch.gather(fp[..., 1], 1, order),
                       torch.gather(lengths, 1, order)], dim=-1)
    routed = owner_s < num_shards
    ok = routed & (pos < capacity)
    # a scatter with mode="drop": what is not kept lands on an extra owner
    # row that is cut off
    buf = torch.zeros((S, num_shards + 1, capacity, 3), dtype=torch.int64,
                      device=owner.device)
    rows = torch.arange(S, device=owner.device)[:, None].expand(S, C)
    buf[rows, torch.where(ok, owner_s, num_shards),
        torch.where(ok, pos, 0)] = src
    overflow = (routed & (pos >= capacity)).sum(dim=1)
    return buf[:, :num_shards], overflow


def _owner_dedup(routed):
    """Dedup the records one owner holds: ``routed`` (S, capacity, 3) int64.
    Returns (original bytes, dedup bytes, unique chunks, total chunks) as
    0-d int64 tensors.  Equal fingerprints group under one int64 key
    ``(h1 << 32) | h2``; the first of a group in the stable order counts."""
    import torch

    flat = routed.reshape(-1, 3)
    ln = flat[:, 2]
    valid = ln > 0
    key = ((flat[:, 0] << 32) | flat[:, 1])[valid]
    ln = ln[valid]
    key_s, order = torch.sort(key, stable=True)
    ls = ln[order]
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return (ls.sum(), torch.where(first, ls, 0).sum(), first.sum(),
            valid.sum())


def _as_int64(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def _routed(mesh, axis: str, capacity_factor: float, fp, lengths):
    """Route ``fp`` (S*C, 2) and ``lengths`` (S*C,), split evenly over the
    axis's S shards, through the capacity-padded exchange.  Returns
    (tables, overflow (S,) int64): ``tables[owner]`` is that owner's
    ``(S, capacity, 3)`` int64 slab on the owner's device (one
    ``(S, S, capacity, 3)`` tensor when every shard shares a device)."""
    import torch

    devices = mesh.axis_devices(axis)
    ns = len(devices)
    n = int(lengths.shape[0])
    if n % ns:
        raise ValueError(f"{n} rows do not split over {ns} shards")
    c = n // ns  # rows a source shard holds
    capacity = suggested_capacity(c, ns, capacity_factor)
    if all(d == devices[0] for d in devices):
        f = _as_int64(fp, devices[0]).reshape(ns, c, 2)
        ln = _as_int64(lengths, devices[0]).reshape(ns, c)
        buf, overflow = _local_route(f, ln, ns, capacity)
        return buf.transpose(0, 1), overflow  # (src, owner) -> (owner, src)
    bufs, overflow = [], []
    for s, dev in enumerate(devices):
        f = _as_int64(fp[s * c:(s + 1) * c], dev)[None]
        ln = _as_int64(lengths[s * c:(s + 1) * c], dev)[None]
        b, o = _local_route(f, ln, ns, capacity)
        bufs.append(b[0])
        overflow.append(o.to(devices[0]))
    tables = tuple(torch.stack([bufs[s][o].to(dev, non_blocking=True)
                                for s in range(ns)])
                   for o, dev in enumerate(devices))
    return tables, torch.cat(overflow)


def routed_fp_tables(mesh, axis: str = "data", *, capacity_factor=1.5):
    """The transport half of :func:`distributed_dedup`, exposed on its own.

    Returns ``fn(fp (S*C, 2), lengths (S*C,)) -> (tables, overflow)``: the
    rows split evenly over the ``axis``'s S shards (shard s holds rows
    ``[s*C, (s+1)*C)``), ``tables`` uint32 with ``tables[owner, src]`` the
    ``(capacity, 3)`` records shard ``src`` routed to ``owner``
    (``[..., 2] == 0`` marks padding), and ``overflow`` the records that did
    not fit, a Python int.  ``tables`` is one ``(S, S, capacity, 3)`` tensor
    when the shards share a device, else a tuple of the owners' ``(S,
    capacity, 3)`` slabs, each on its owner's device.  A consumer treats any
    overflow as "this batch did not all arrive" and re-routes it with
    :func:`route_host` (docs/SHARDING.md)."""
    import torch

    def call(fp, lengths):
        tables, overflow = _routed(mesh, axis, capacity_factor, fp, lengths)
        if isinstance(tables, tuple):
            tables = tuple(t.to(torch.uint32) for t in tables)
        else:
            tables = tables.to(torch.uint32)
        return tables, int(overflow.sum())

    return call


def distributed_dedup(mesh, axis: str = "data", *, capacity_factor=1.5):
    """Returns ``fn(fp (S*C, 2), lengths (S*C,)) -> stats``: the global
    ``original_bytes``, ``dedup_bytes``, ``unique_chunks``,
    ``total_chunks`` and ``overflow_total`` as Python ints, each owner
    deduping the records routed to it on its own device."""

    def call(fp, lengths):
        tables, overflow = _routed(mesh, axis, capacity_factor, fp, lengths)
        sums = [0, 0, 0, 0]
        for o in range(len(tables)):
            for i, v in enumerate(_owner_dedup(tables[o])):
                sums[i] += int(v)
        return {
            "original_bytes": sums[0],
            "dedup_bytes": sums[1],
            "unique_chunks": sums[2],
            "total_chunks": sums[3],
            "overflow_total": int(overflow.sum()),
        }

    return call
