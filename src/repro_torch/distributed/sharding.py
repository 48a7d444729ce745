"""Logical-axis sharding rules -> partition specs -> DTensor placements.

The port of ``repro/distributed/sharding.py``.  Models declare *logical*
axes on every parameter (``layers.PT``) and on key activations (via
:func:`constrain`); this module maps them onto a mesh's named axes:

  batch           -> (pod, data)     heads/kv_heads/mlp/experts/vocab/lru -> model
  embed           -> fsdp axes       (ZeRO-3-style parameter sharding over
                                      data, and over pod too for >=30B archs)
  q_lora/kv_lora  -> model (low priority: yields to heads when both occur)

Greedy assignment with priorities uses a mesh axis at most once per spec,
and a dim takes the longest prefix of its mesh axes whose product divides
it (a dim it does not divide is replicated).

:meth:`ShardingRules.spec_for` gives the reference's ``PartitionSpec`` as a
plain tuple: per dim ``None``, one axis name or a tuple of names.
:func:`placements_for` turns a spec into ``torch.distributed`` DTensor
placements over a ``DeviceMesh`` whose dims carry the axis names: a mesh
axis that shards tensor dim d is ``Shard(d)``, every other one
``Replicate()``.  Under :func:`use_rules`, :func:`constrain` redistributes a
DTensor activation to its rule's placements (the reference's
``with_sharding_constraint``); outside it, or on a plain tensor, it returns
its input unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Tuple

import numpy as np

#: lower = assigned first
_PRIORITY = {
    "batch": 0,
    "vocab": 0,
    "heads": 0,
    "mlp": 0,
    "experts": 0,
    "lru": 0,
    "kv_heads": 1,
    "expert_mlp": 2,
    "mlp2": 2,
    "embed2": 2,
    "lru2": 2,
    "embed": 3,  # fsdp
    "q_lora": 4,
    "kv_lora": 4,
}


def _template_map(fn, template):
    # models import this module (constrain); keep the dependency one-way
    from repro_torch.models.layers import template_map

    return template_map(fn, template)


def default_rules(mesh, fsdp: str = "none") -> Dict[str, Tuple[str, ...]]:
    names = mesh.axis_names
    multi_pod = "pod" in names
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    fsdp_map = {
        "none": (),
        "data": ("data",),
        "pod_data": ("pod", "data") if multi_pod else ("data",),
    }
    return {
        "batch": batch_axes,
        "seq": (),
        "seq_kv": ("model",),  # decode KV caches: shard the sequence dim
        "heads_act": ("model",),  # attention activations
        "embed": fsdp_map[fsdp],
        "embed2": ("model",),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "head_dim2": (),
        "mlp": ("model",),
        "mlp2": ("model",),
        "experts": ("model",),
        "expert_mlp": (),
        "q_lora": ("model",),
        "kv_lora": ("model",),
        "lru": ("model",),
        "lru2": (),
        "conv": (),
        "stack": (),
    }


def rules_for_config(mesh, cfg) -> Dict[str, Tuple[str, ...]]:
    """Arch-aware rules: one consistent tensor-parallel strategy per config.

    * heads divide the model axis -> head TP (kv replicated when the kv
      count doesn't divide: replicating tiny KV projections beats padding);
    * heads do NOT divide (phi3's 40, llava's 56 on a 16-way axis) -> the
      attention weights replicate over model (FSDP shards their embed dim)
      and the activations shard ``heads_act`` when ``tp_head_pad`` makes
      the padded count divide, else replicate.
    """
    rules = default_rules(mesh, getattr(cfg, "fsdp", "none"))
    m = mesh.shape.get("model", 1)
    h_eff = max(getattr(cfg, "tp_head_pad", 0), cfg.n_heads)
    if cfg.n_heads % m != 0:
        rules["heads"] = ()
        rules["kv_heads"] = ()
        rules["head_dim"] = ()
        if h_eff % m != 0:
            rules["heads_act"] = ()  # no padding configured: replicate
    elif cfg.n_kv_heads % m != 0:
        rules["kv_heads"] = ()
    return rules


def _mesh_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)  # a DeviceMesh
    if names is None:
        names = mesh.axis_names  # a launch.mesh.Mesh
    return tuple(names)


def placements_for(spec: Tuple, mesh) -> tuple:
    """DTensor placements over ``mesh`` (a ``DeviceMesh`` with named dims,
    or a :class:`~repro_torch.launch.mesh.Mesh`) for a partition spec: one
    placement a mesh dim, ``Shard(d)`` where that axis shards tensor dim
    ``d``, else ``Replicate()``.  A dim sharded over several axes takes
    them in the mesh's order (as ``("pod", "data")`` is)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _mesh_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} sharded over {axes}, not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _is_placements(node) -> bool:
    """True for a leaf of :meth:`ShardingRules.sharding_tree`: a tuple of
    DTensor placements (which tree walks must not open as a node)."""
    from torch.distributed.tensor.placement_types import Placement

    return (isinstance(node, tuple) and not hasattr(node, "_fields")
            and len(node) > 0 and all(isinstance(p, Placement) for p in node))


def placement_leaves(tree) -> list:
    """The placements of a :meth:`ShardingRules.sharding_tree` in the
    order ``_tree.leaves`` lists the matching tensors (dict keys sorted)."""
    if _is_placements(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in placement_leaves(v)]
    return [tree]


def local_shape(shape: Tuple, spec: Tuple, mesh_shape: Dict[str, int]) -> tuple:
    """One rank's shard shape of a global ``shape`` under ``spec`` (every
    sharded dim divides evenly: :meth:`ShardingRules.spec_for` checks)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([mesh_shape[a] for a in axes]))
        assert out[d] % n == 0, (shape, spec)
        out[d] //= n
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    """Rules over a mesh that names its axes (``shape``: axis -> size,
    ``axis_names``), as the reference's; ``device_mesh`` is the
    ``DeviceMesh`` the placements are for (None where only specs are
    asked for)."""

    mesh: Any
    rules: Dict[str, Tuple[str, ...]]
    device_mesh: Any = None

    def spec_for(self, axes: Tuple, shape: Tuple | None = None) -> tuple:
        """Partition spec for logical axes (greedy, priority-ordered).

        Every assignment is divisibility-checked (shorter prefixes tried
        first).  Arch-level fallbacks are decided once per config in
        :func:`rules_for_config`, never per tensor.
        """
        order = sorted(
            range(len(axes)),
            key=lambda i: _PRIORITY.get(axes[i] or "", 9),
        )
        assigned: list = [None] * len(axes)
        used: set = set()
        for i in order:
            name = axes[i]
            if name is None:
                continue
            mesh_axes = tuple(
                a for a in self.rules.get(name, ()) if a not in used
            )
            if not mesh_axes:
                continue
            if shape is not None:
                # longest divisible prefix (e.g. batch on (pod, data))
                while mesh_axes:
                    prod = int(np.prod([self.mesh.shape[a] for a in mesh_axes]))
                    if shape[i] >= prod and shape[i] % prod == 0:
                        break
                    mesh_axes = mesh_axes[:-1]
                if not mesh_axes:
                    continue
            assigned[i] = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
            used.update(mesh_axes)
        return tuple(assigned)

    def placements(self, axes: Tuple, shape: Tuple) -> tuple:
        mesh = self.mesh if self.device_mesh is None else self.device_mesh
        return placements_for(self.spec_for(axes, shape), mesh)

    def pspec_tree(self, template):
        return _template_map(lambda t: self.spec_for(t.axes, t.shape), template)

    def sharding_tree(self, template):
        """DTensor placements for every leaf of a ``PT`` template."""
        return _template_map(lambda t: self.placements(t.axes, t.shape),
                             template)


_ctx = threading.local()


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.rules = prev


def active_rules() -> ShardingRules | None:
    return getattr(_ctx, "rules", None)


def constrain(x, *axes):
    """Redistribute a DTensor to the placements its logical axes give; a
    no-op outside :func:`use_rules` and on a tensor that is not a DTensor."""
    rules = active_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements_for(rules.spec_for(axes, tuple(x.shape)),
                          x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's own batch rows and query heads, where
    ``q`` (B, S, H, hd) is a DTensor under :func:`use_rules`; None
    otherwise (the caller then calls ``fn`` itself).

    Attention is independent across batch rows and heads, so a rank runs a
    single-device attention (the flash kernel on a card) on its shard:
    ``q`` keeps its batch and head sharding and is whole along the sequence
    and head width; ``k`` and ``v`` keep ``q``'s batch sharding, and each
    rank takes the KV head of each of its query heads (GQA's
    ``h * KV // H``), so the local call has as many KV heads as query
    heads.  The result carries ``q``'s placements."""
    if active_rules() is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return None
    import torch

    mesh = q.device_mesh
    qp = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    kp = [Shard(0) if p == Shard(0) else Replicate() for p in qp]
    q = q.redistribute(mesh, qp)
    k, v = (x.redistribute(mesh, kp) if isinstance(x, DTensor) else
            DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False).redistribute(mesh, kp)
            for x in (k, v))
    H, KV = q.shape[2], k.shape[2]
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    h0, coord, width = 0, mesh.get_coordinate(), H
    for m, p in enumerate(qp):  # the first local head's global index
        if p == Shard(2):
            width //= mesh.size(m)
            h0 += coord[m] * width
    kv = (h0 + torch.arange(ql.shape[2], device=ql.device)) * KV // H
    out = fn(ql, kl.index_select(2, kv), vl.index_select(2, kv))
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())


def gather_fsdp(cfg, params):
    """Under :func:`use_rules`, ``cfg``'s parameters with each DTensor's
    FSDP dims (``embed``) gathered and its tensor-parallel dims kept, as
    ZeRO-3 gathers weights before they are used (the gradients then land
    back on the FSDP shards, reduce-scattered); elsewhere ``params``
    itself.  Without it DTensor contracts an FSDP-sharded dim where the
    activations' batch is sharded over the same axis: partial sums over
    every token on every rank."""
    rules = active_rules()
    if rules is None:
        return params
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import leaves, unflatten
    from repro_torch.models.lm import lm_template

    template = lm_template(cfg)

    compute = ShardingRules(rules.mesh, {**rules.rules, "embed": ()},
                            rules.device_mesh)
    out = []
    for t, p in zip(leaves(template), leaves(params)):
        if isinstance(p, DTensor):
            want = compute.placements(t.axes, t.shape)
            if tuple(p.placements) != want:
                p = p.redistribute(p.device_mesh, want)
        out.append(p)
    return unflatten(params, out)


def batch_local(fn, batched, shared=()):
    """``fn(*batched, *shared)`` on each rank's own batch rows, where the
    first of ``batched`` is a DTensor under :func:`use_rules`; None
    otherwise (the caller then calls ``fn`` itself).

    A recurrence over the sequence (the sLSTM, mLSTM and RG-LRU scans) is
    independent across batch rows, so a rank runs the single-device scan
    (its kernel on a card) on its rows: every tensor of ``batched`` leads
    with the batch dim and keeps the first one's batch sharding, whole
    elsewhere; ``shared`` (weights) is whole on every rank.  Every tensor
    ``fn`` returns leads with the batch dim and is sharded so."""
    if active_rules() is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not batched or not isinstance(batched[0], DTensor):
        return None
    from repro_torch._tree import tree_map

    mesh = batched[0].device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in batched[0].placements]
    whole = [Replicate()] * mesh.ndim

    def local(x, place):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, whole, run_check=False)
        return x.redistribute(mesh, place).to_local()

    out = fn(*(local(x, rows) for x in batched),
             *(local(x, whole) for x in shared))
    return tree_map(lambda t: DTensor.from_local(t, mesh, rows,
                                                 run_check=False), out)
