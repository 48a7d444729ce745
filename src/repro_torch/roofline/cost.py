"""One rank's FLOPs, bytes and collectives, counted op by op.

The port's stand-in for ``repro/roofline/hlo_cost.py``.  Eager torch has
no HLO to parse and no ``while`` bodies to multiply: every op a step runs
passes through the dispatcher, so a ``TorchDispatchMode`` sees each one.
:class:`CostCounter` records, for each aten op on **one rank's local
tensors**:

* FLOPs: ``torch.utils.flop_counter``'s formulas for the matrix products
  and attention ops, plus one a result element for a pointwise op (the
  reference's HLO model counts elementwise ops so too);
* bytes: each op's tensor operands plus its outputs (views and
  allocations move none).  Eager ops are unfused, so this is an upper
  bound on the HBM traffic a fused program would need;
* collectives: every ``_c10d_functional`` op the DTensor layer issues,
  as (kind, output bytes, group size), fed to the ring model
  (``analyze.CollectiveStats``);
* live bytes: the tensors ops allocate (views excluded), tracked by weak
  references, and the peak of their sum over the step.

**Local, not global.**  On DTensors the mode returns ``NotImplemented`` for
the DTensor-level op, so DTensor dispatches it and the counter sees the
local ops it runs, at the shard shapes each rank holds, and the
collectives of every redistribution.  (``FlopCounterMode`` counts the
DTensor-level op, at global shapes.)  DTensor's sharding propagator also
runs each op schema it has not seen once on global-shape fake tensors, to
learn the output's metadata; those calls are no rank's work and are not
counted.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .analyze import CollectiveStats

#: ``_c10d_functional`` op -> the ring model's collective kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


#: pointwise-tagged ops that only move data (no FLOPs)
_COPIES = ("clone", "copy", "copy_")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str, args) -> int:
    """A collective's group size: its ``group_size`` argument where the op
    has one, else the size of the process group it names."""
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor_coalesced"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class CostCounter(TorchDispatchMode):
    """Counts the ops a block of code runs: ``flops``, ``bytes``,
    ``collectives`` (a :class:`~.analyze.CollectiveStats`), ``peak_bytes``
    (live bytes allocated inside the block, at their peak), and ``ops`` /
    ``flops_by_op`` by op name."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = CollectiveStats()
        self.ops: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._propagating = 0
        self._restore = None
        self._dtensor = None

    # -- the sharding propagator's global-shape calls are not counted --------
    def __enter__(self):
        try:
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator,
            )
        except ImportError:  # a torch without torch.distributed
            pass
        else:
            self._dtensor = DTensor
            orig = ShardingPropagator._propagate_tensor_meta_non_cached
            counter = self

            def propagate(prop, *a, **kw):
                counter._propagating += 1
                try:
                    return orig(prop, *a, **kw)
                finally:
                    counter._propagating -= 1

            ShardingPropagator._propagate_tensor_meta_non_cached = propagate
            self._restore = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._restore is not None:
            cls, orig = self._restore
            cls._propagate_tensor_meta_non_cached = orig
            self._restore = None
        return super().__exit__(*exc)

    def _free(self, nbytes: int):
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come here
        out = func(*args, **kwargs)
        if not self._propagating:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                n = _group_size(name, args)
                self.collectives.add(kind, sum(map(_nbytes, _tensors(out))), n)
                self.ops[f"{ns}.{name}"] += 1
            return
        if ns == "prim" or func.is_view:
            return
        self.ops[f"{ns}.{name}"] += 1
        packet = func._overloadpacket
        flops = 0
        if packet in self._flop_registry:
            flops = self._flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags and name not in _COPIES:
            flops = sum(t.numel() for t in _tensors(out))
        if flops:
            self.flops += flops
            self.flops_by_op[f"{ns}.{name}"] += flops
        if name.startswith(("empty", "new_empty")) or name == "detach":
            moved = 0
        else:
            moved = (sum(map(_nbytes, _tensors(args)))
                     + sum(map(_nbytes, _tensors(kwargs)))
                     + sum(map(_nbytes, _tensors(out))))
        self.bytes += moved
        # live bytes: outputs that are new tensors (not an input returned)
        ins = {id(t) for t in _tensors(args)}
        for t in _tensors(out):
            if id(t) in ins:
                continue
            nb = _nbytes(t)
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, nb)
