"""Explicit redistributions where DTensor has no sharding strategy.

The port's steps are eager torch: under ``distributed.sharding.use_rules``
their parameters and activations are DTensors, and DTensor runs each op by
its registered sharding strategy.  A few ops the steps run have none, or
one that fails on the placements the rules give; :class:`Fallbacks`
installs DTensor custom op handlers for them, each an explicit
redistribution that a cost counter sees as the collectives it issues
(``roofline/cost.py``).  The dry run (``launch/dryrun.py``) and the
multi-process sharded steps both run under it.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch._tree import leaves, tree_map

#: ops with no DTensor sharding strategy that the port's steps run: their
#: DTensor inputs are redistributed to replicated at the op (an in-place
#: op writes its own shard back), and the counter counts the all-gathers
REPLICATED_OPS = (
    "aten.sort.stable",  # MoE dispatch: the stable argsort by expert
    "aten.index_put.default",
    "aten._index_put_impl_.default",
    "aten.searchsorted.Tensor",  # MoE: each expert group's start
)

#: pointwise ops with no DTensor strategy: run on each rank's shard when
#: every DTensor operand has the same placements (no collective)
LOCAL_OPS = (
    "aten.log_sigmoid_forward.default",  # xLSTM's gates
    "aten.log_sigmoid_backward.default",
)


class Fallbacks:
    """Explicit redistributions where DTensor has no strategy of its own,
    installed as DTensor custom op handlers for the duration of a ``with``
    block.  ``used`` counts each op and the fallback it took, for the
    cell's record.

    * :data:`REPLICATED_OPS`: every DTensor argument is redistributed to
      ``Replicate()`` on every mesh dim (an all-gather the counter sees),
      the op runs on the whole local tensors and its outputs come back
      replicated; an in-place op then copies its own shard back into its
      first argument's local tensor.
    * :data:`LOCAL_OPS`: run on each rank's shard when every DTensor operand
      has the same placements, else as a replicated op.
    * ``aten.index_put_`` and ``aten.scatter_add_`` into a sharded tensor
      (decode's cache row, a gather's gradient): written on each rank's
      own shard (:meth:`_index_put_`, :meth:`_scatter_add_`); into a
      plain tensor (MoE's buffers), as a replicated op.
    * ``aten.gather``: a gather along a sharded dim leaves a
      ``MaskPartial``, whose mask DTensor applies at the reduction; it is
      reduced here, while the output still has the mask's rank (indexing it
      first, as the loss's ``[..., 0]`` does, breaks the mask).
    * ``aten.view``: DTensor keeps a permuted tensor's global strides,
      which may allow a view that the local shard's strides do not (an
      einsum's permute then reshape): the shard is copied contiguous first,
      as a local reshape would; a view that splits a sharded dim unevenly
      (decode's 32 query heads on 16 ranks into 8 KV groups of 4) runs on
      the replicated input.
    """

    def __init__(self):
        from torch.distributed.tensor import DTensor

        self._handlers = DTensor._op_dispatcher._custom_op_handlers
        self.used: Counter = Counter()
        self._installed = {_resolve_op(n): self._replicated
                           for n in REPLICATED_OPS}
        self._installed.update({_resolve_op(n): self._local
                                for n in LOCAL_OPS})
        self._installed[torch.ops.aten.gather.default] = self._gather
        self._installed[torch.ops.aten.index_put_.default] = self._index_put_
        self._installed[torch.ops.aten.scatter_add_.default] = \
            self._scatter_add_
        self._installed[torch.ops.aten.view.default] = self._view
        self._saved: dict = {}

    def __enter__(self):
        self._saved = {op: self._handlers.get(op) for op in self._installed}
        self._handlers.update(self._installed)
        return self

    def __exit__(self, *exc):
        for op, h in self._saved.items():
            if h is None:
                self._handlers.pop(op, None)
            else:
                self._handlers[op] = h

    def _default(self, op_call, args, kwargs):
        """``op_call`` through DTensor's own dispatch, past this handler."""
        h = self._handlers.pop(op_call)
        try:
            return op_call(*args, **kwargs)
        finally:
            self._handlers[op_call] = h

    def _replicated(self, op_call, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        self.used[f"{op_call} replicated"] += 1
        mesh = next(x.device_mesh for x in leaves([args, kwargs])
                    if isinstance(x, DTensor))
        repl = [Replicate()] * mesh.ndim

        def full(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, repl).to_local()
            return x

        out = op_call(*tree_map(full, list(args)),
                      **tree_map(full, dict(kwargs)))
        if op_call._schema.name.endswith("_") and isinstance(args[0], DTensor):
            dst = args[0]
            shard = DTensor.from_local(out, mesh, repl, run_check=False) \
                .redistribute(mesh, dst.placements).to_local()
            dst.to_local().copy_(shard)
            return dst
        return tree_map(lambda t: DTensor.from_local(t, mesh, repl,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)

    def _local(self, op_call, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        dts = [x for x in leaves([args, kwargs]) if isinstance(x, DTensor)]
        mesh, place = dts[0].device_mesh, tuple(dts[0].placements)
        if any(tuple(x.placements) != place or x.shape != dts[0].shape
               for x in dts) or any(p.is_partial() for p in place):
            return self._replicated(op_call, args, kwargs)
        self.used[f"{op_call} local"] += 1
        out = op_call(*tree_map(lambda x: x.to_local()
                                if isinstance(x, DTensor) else x, list(args)),
                      **kwargs)
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, place, run_check=False, shape=dts[0].shape,
            stride=dts[0].stride()) if t.numel() else
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False), out)

    def _index_put_(self, op_call, args, kwargs):
        """A write into a sharded tensor (decode's cache row) on each rank's
        own shard: the indices and values are replicated (small).  Along a
        sharded dim that an index tensor covers, the indices become the
        shard's, and a write whose index falls outside the shard rewrites
        what the shard holds at a clamped index (an accumulating write adds
        0 there); along a sharded dim after the indexed ones (an MHA
        cache's heads) the values are cut to the shard's.  Other layouts
        take the replicated route."""
        from torch.distributed.tensor import DTensor, Replicate

        dst, indices, values = args[0], list(args[1]), args[2]
        accumulate = bool(args[3]) if len(args) > 3 else \
            bool(kwargs.get("accumulate", False))
        if not isinstance(dst, DTensor) or any(i is None for i in indices):
            return self._replicated(op_call, args, kwargs)
        mesh = dst.device_mesh
        k = len(indices)
        sharded = {p.dim for p in dst.placements if p.is_shard()}
        idx_shape = torch.broadcast_shapes(*(i.shape for i in indices))
        n_idx = len(idx_shape)
        if values.dim() != n_idx + dst.dim() - k:
            return self._replicated(op_call, args, kwargs)
        self.used[f"{op_call} local write"] += 1
        repl = [Replicate()] * mesh.ndim

        def full(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, repl).to_local()
            return x

        indices = [full(i) for i in indices]
        values = full(values)
        shape, offset = _shard_extent(dst)
        valid = torch.ones((), dtype=torch.bool, device=values.device)
        for d in sorted(sharded):
            if d < k:
                i = indices[d] - offset[d]
                valid = valid & (i >= 0) & (i < shape[d])
                indices[d] = i.clamp(0, shape[d] - 1)
            else:
                values = values.narrow(n_idx + d - k, offset[d], shape[d])
        local = dst.to_local()
        valid = valid.expand(idx_shape)
        mask = valid.reshape(idx_shape + (1,) * (values.dim() - n_idx))
        values = values.expand(idx_shape + values.shape[n_idx:])
        if accumulate:
            values = values * mask.to(values.dtype)
        else:
            # a clamped write may land where a kept one writes: it then
            # writes the kept one's value (else what the shard holds), so
            # every write to a place writes the same value
            n = valid.numel()
            place = sum(i.expand(idx_shape).reshape(n) * st for i, st in
                        zip(indices, local.stride()[:k]))
            valid = valid.reshape(n)
            same = (place[:, None] == place[None, :]) & valid[None, :]
            flat = values.reshape((n,) + values.shape[n_idx:])
            kept = flat[same.to(torch.int8).argmax(dim=1)]
            fill = torch.where(
                same.any(dim=1).reshape((n,) + (1,) * (flat.dim() - 1)),
                kept, local[tuple(indices)].reshape(flat.shape))
            values = fill.reshape(values.shape)
        local.index_put_(tuple(indices), values, accumulate=accumulate)
        return dst

    def _scatter_add_(self, op_call, args, kwargs):
        """``dst.scatter_add_(dim, index, src)`` into a sharded ``dst`` (the
        gradient of a gather from vocab-sharded logits) on each rank's own
        shard: ``index`` and ``src`` are replicated (small), cut to the
        shard's rows along every other sharded dim, and along ``dim``
        their indices become the shard's, a contribution outside the shard
        adding 0 at a clamped index."""
        from torch.distributed.tensor import DTensor, Replicate

        dst, dim, index, src = args[:4]
        if not isinstance(dst, DTensor):
            return self._replicated(op_call, args, kwargs)
        dim = dim % dst.dim()
        sharded = {p.dim for p in dst.placements if p.is_shard()}
        if any(index.shape[d] != dst.shape[d] for d in sharded if d != dim):
            return self._replicated(op_call, args, kwargs)
        self.used[f"{op_call} local write"] += 1
        mesh = dst.device_mesh
        repl = [Replicate()] * mesh.ndim

        def full(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, repl).to_local()
            return x

        index, src = full(index), full(src)
        shape, offset = _shard_extent(dst)
        for d in sorted(sharded):
            if d == dim:
                i = index - offset[d]
                ok = (i >= 0) & (i < shape[d])
                index = i.clamp(0, shape[d] - 1)
                src = src * ok.to(src.dtype)
            else:
                index = index.narrow(d, offset[d], shape[d])
                src = src.narrow(d, offset[d], shape[d])
        dst.to_local().scatter_add_(dim, index, src)
        return dst

    def _gather(self, op_call, args, kwargs):
        from torch.distributed.tensor import Replicate

        out = self._default(op_call, args, kwargs)
        want = [Replicate() if p.is_partial() else p for p in out.placements]
        if want != list(out.placements):
            self.used[f"{op_call} partial reduced"] += 1
            out = out.redistribute(out.device_mesh, want)
        return out

    def _view(self, op_call, args, kwargs):
        try:
            return self._default(op_call, args, kwargs)
        except (ValueError, RuntimeError):
            pass
        x = torch.ops.aten.clone.default(
            args[0], memory_format=torch.contiguous_format)
        try:
            out = self._default(op_call, (x, *args[1:]), kwargs)
            self.used[f"{op_call} contiguous copy"] += 1
            return out
        except (ValueError, RuntimeError):
            return self._replicated(op_call, (x, *args[1:]), kwargs)


def _shard_extent(x):
    """(local shape, global offset) of this rank's shard of DTensor ``x``:
    mesh dims split a tensor dim outermost first, and every sharded dim
    divides evenly (``ShardingRules.spec_for`` checks)."""
    mesh = x.device_mesh
    shape, offset = list(x.shape), [0] * x.dim()
    coord = mesh.get_coordinate()
    for m, p in enumerate(x.placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(m)
            offset[p.dim] += coord[m] * shape[p.dim]
    return shape, offset


def _resolve_op(name: str):
    ns, rest = name.split(".", 1)
    packet, overload = rest.rsplit(".", 1)
    return getattr(getattr(getattr(torch.ops, ns), packet), overload)
