"""Roofline terms of one step from a cost count, on H100 constants.

The port of ``repro/roofline/analyze.py``.  Three terms per (arch x shape
x mesh), all in *seconds a step*:

  compute    = per-device FLOPs / peak bf16 FLOP/s
  memory     = per-device bytes accessed / HBM bandwidth
  collective = per-device ring-model bytes of each collective / the link
               rate of its group (NVLink inside an 8-GPU node, the network
               across nodes: ``constants.link_bw``)

The counts come from ``roofline/cost.py``'s :class:`~.cost.CostCounter`,
which records one rank's local ops (there is no HLO in eager torch, so
:func:`from_counts` takes the counter where the reference's
``from_compiled`` parsed the compiled module).  The ring model per op on a
group of size n, from the op's output bytes:

  all-reduce      2 * size * (n-1)/n      (reduce-scatter + all-gather)
  all-gather      size_out * (n-1)/n
  reduce-scatter  size_out * (n-1)/n
  all-to-all      size * (n-1)/n
  collective-permute  size (point-to-point)

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per train step; the ratio
MODEL_FLOPS / counted FLOPs exposes remat recompute and dispatch waste.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from . import constants as C


def ring_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Per-device bytes of one collective over a group of ``n``."""
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * out_bytes * ring
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return out_bytes * ring
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0
    by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0
    #: the ring model's seconds, each op at its group's link rate
    seconds: float = 0.0

    def add(self, kind: str, out_bytes: float, n: int):
        """One collective over ``n`` ranks with ``out_bytes`` of output."""
        if n <= 1:
            return
        b = ring_bytes(kind, out_bytes, n)
        self.per_device_bytes += b
        self.by_type[kind] = self.by_type.get(kind, 0.0) + b
        self.count += 1
        self.seconds += b / C.link_bw(n)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    model_flops: float = 0.0  # 6·N_active·D per step (global)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / C.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / C.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective.seconds

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops_per_device * self.chips
        return self.model_flops / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the dominant-term-bound step time."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        useful_t = (self.model_flops / self.chips) / C.PEAK_FLOPS_BF16
        return useful_t / t

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective.per_device_bytes,
            "collective_by_type": self.collective.by_type,
            "collective_ops": self.collective.count,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N(_active)·tokens for train; 2·N a prefill token; 2·N a decode
    token of each sequence."""
    from repro_torch.configs import param_count

    total, active = param_count(cfg)
    n = active
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def from_counts(arch, shape, mesh_name, chips, counter, cfg=None,
                shape_cfg=None) -> Roofline:
    """Roofline terms from a :class:`~.cost.CostCounter` that watched one
    rank's step (its FLOPs, bytes and collectives are that rank's)."""
    mf = model_flops_for(cfg, shape_cfg) if cfg is not None else 0.0
    return Roofline(arch, shape, mesh_name, chips, counter.flops,
                    counter.bytes, counter.collectives, mf)
