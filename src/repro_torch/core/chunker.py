"""Unified chunking API and algorithm registry.

The port of ``repro/core/chunker.py``.  Every CDC algorithm (SeqCDC and the
seven baselines, each in a native and a vectorized form) is a
:class:`Chunker` with one interface, so benchmarks and callers are
algorithm-agnostic.

``Chunker.chunk(data)`` takes host bytes or an ndarray of any length and
returns a numpy int64 array of exclusive boundary offsets (last ==
``len(data)``).  A chunker takes ``device=`` (default ``"cuda"``): the
torch-backed forms run their kernels there (a CPU device runs their plain
versions), the host forms run numpy whatever the device.

Importing this module registers the baselines (``core/baselines``) as the
reference's ``core/__init__`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from . import oracle, seqcdc
from .params import SeqCDCParams, derived_params

_REGISTRY: Dict[str, Callable[..., "Chunker"]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def available() -> list[str]:
    return sorted(_REGISTRY)


def make_chunker(name: str, avg_size: int = 8192, **kw) -> "Chunker":
    """Factory: e.g. ``make_chunker("seqcdc", 8192, device="cpu")``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown chunker {name!r}; available: {available()}") from None
    return factory(avg_size=avg_size, **kw)


class Chunker:
    """Base: host-facing boundary computation on a device."""

    name = "abstract"

    def __init__(self, avg_size: int, device: str | torch.device = "cuda"):
        self.avg_size = int(avg_size)
        self.min_size = max(1024, self.avg_size // 2)
        self.max_size = 2 * self.avg_size
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")

    # -- subclass hook -----------------------------------------------------
    def _boundaries(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _on_device(self, data: np.ndarray) -> torch.Tensor:
        """``data`` as a uint8 tensor on the chunker's device."""
        arr = data if data.flags.writeable else data.copy()
        return torch.from_numpy(arr).to(self.device)

    # -- public ------------------------------------------------------------
    def chunk(self, data) -> np.ndarray:
        """Exclusive boundary offsets (int64), last == len(data)."""
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)
        ) else np.asarray(data, dtype=np.uint8).reshape(-1)
        if arr.size == 0:
            return np.zeros(0, dtype=np.int64)
        out = np.asarray(self._boundaries(arr), dtype=np.int64)
        if not (out.size and out[-1] == arr.size):
            raise AssertionError(
                f"{self.name}: bounds end {out[-5:]} for {arr.size} bytes")
        return out

    def chunk_lengths(self, data) -> np.ndarray:
        b = self.chunk(data)
        return np.diff(np.concatenate([[0], b]))


def _kept(bounds: torch.Tensor, count: torch.Tensor) -> np.ndarray:
    """The first ``count`` entries of a bounds table, on the host."""
    return bounds.cpu().numpy()[: int(count)]


class _SeqCDCBase(Chunker):
    def __init__(self, avg_size: int = 8192, mode: str = "increasing",
                 params=None, device="cuda"):
        super().__init__(avg_size, device)
        self.params: SeqCDCParams = params or derived_params(avg_size, mode)
        self.min_size = self.params.min_size
        self.max_size = self.params.max_size


@register("seqcdc")
class SeqCDCChunker(_SeqCDCBase):
    """Vectorized two-phase SeqCDC (the paper's VSEQ): the masks kernel,
    then the select kernel for the ``wide`` step or the plain torch
    automaton for ``gather``/``event``."""

    name = "seqcdc"

    def __init__(self, *a, mask_impl="cuda", step_impl="wide", **kw):
        super().__init__(*a, **kw)
        self.mask_impl = mask_impl
        self.step_impl = step_impl

    def _boundaries(self, data: np.ndarray) -> np.ndarray:
        bounds, count = seqcdc.boundaries_two_phase(
            self._on_device(data), self.params, mask_impl=self.mask_impl,
            step_impl=self.step_impl,
            select_impl=seqcdc.select_impl_for(self.step_impl),
        )
        return _kept(bounds, count)


@register("seqcdc_seq")
class SeqCDCSequentialChunker(_SeqCDCBase):
    """Scalar SeqCDC (the paper's unaccelerated SEQ): the native-scan
    kernel."""

    name = "seqcdc_seq"

    def _boundaries(self, data: np.ndarray) -> np.ndarray:
        bounds, count = seqcdc.boundaries_sequential(self._on_device(data),
                                                     self.params)
        return _kept(bounds, count)


@register("seqcdc_numpy")
class SeqCDCNumpyChunker(_SeqCDCBase):
    """Event-driven numpy oracle (host, no device)."""

    name = "seqcdc_numpy"

    def _boundaries(self, data: np.ndarray) -> np.ndarray:
        return oracle.boundaries_numpy(data, self.params)


@register("fixed")
class FixedChunker(Chunker):
    """Fixed-size chunking (XC in the paper): the space-savings floor."""

    name = "fixed"

    def _boundaries(self, data: np.ndarray) -> np.ndarray:
        n = data.size
        return np.arange(self.avg_size, n + self.avg_size, self.avg_size).clip(
            max=n
        ).astype(np.int64)


# the baselines register themselves on import (they import this module)
from .baselines import hash_based, hashless  # noqa: E402,F401
