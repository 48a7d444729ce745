"""Multi-pod dry run: every (arch x shape x mesh) cell, one rank's step on
fake tensors.

The port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for 512 placeholder devices, the port runs it: one
process joins a fake ``torch.distributed`` backend (``FakeStore``) as rank
0 of a world of 256 or 512, builds the production mesh as a
``DeviceMesh``, and under ``FakeTensorMode`` (which allocates nothing)
makes every parameter, optimizer moment, batch and cache a DTensor from a
local fake shard at the shape ``ShardingRules.spec_for`` gives.  The
port's ``train_step``, ``prefill_step`` or ``decode_step`` then runs under
``use_rules`` (its ``constrain`` hints redistribute activations) and the
op counter (``roofline/cost.py``), whose local FLOPs, bytes and ring-model
collectives give the roofline terms on H100 constants.  No card is needed.

Ops with no DTensor sharding strategy are redistributed explicitly at
that op (``distributed/dtensor_ops.py`` ``Fallbacks``; each record lists
the ones its step took under ``fallbacks``), so the counter counts what
they cost; plain tensors a step makes (positions, masks, MoE's dispatch
buffers) join DTensor ops as replicated (``implicit_replication``).

Records carry the reference's keys, with ``elapsed_s`` (the step's wall
seconds on fake tensors) in place of ``lower_s`` and ``compile_s``:
``argument_bytes`` is exact (the local shards' bytes), ``output_bytes`` the
local bytes of the step's outputs, and ``peak_bytes`` the arguments plus
the peak of the bytes that the step's ops allocated and that were still
referenced (``peak_method``).  A failing cell is recorded as ``FAILED``
with its error, and the exit code is then 1.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch._tree import leaves
from repro_torch.configs import SHAPES, ModelConfig, get_config, shape_applicable
from repro_torch.distributed.sharding import (
    ShardingRules,
    local_shape,
    placements_for,
    rules_for_config,
    use_rules,
)
from repro_torch.distributed.dtensor_ops import Fallbacks
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.layers import PT, _rope_freqs_on, template_map
from repro_torch.roofline import analyze
from repro_torch.roofline.cost import CostCounter
from repro_torch.train import optim, step as step_mod

PEAK_METHOD = ("argument bytes + peak of the live bytes the step's ops "
               "allocated (local fake outputs, views excluded, tracked by "
               "weak references)")


@contextlib.contextmanager
def fake_world(mesh: Mesh):
    """A fake process group of ``mesh.size`` ranks (this process rank 0),
    the mesh's ``DeviceMesh`` (yielded) and ``FakeTensorMode``: collectives
    return at once, tensors hold no bytes."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    # device tensors a model caches (rope's frequencies) would be made
    # fake here: none made outside comes in, none made here leaks out
    _rope_freqs_on.cache_clear()
    try:
        device_mesh = mesh.to_device_mesh()
        with _strided_offsets_outside_fake_mode(), FakeTensorMode():
            yield device_mesh
    finally:
        _rope_freqs_on.cache_clear()
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_offsets_outside_fake_mode():
    """DTensor computes a ``_StridedShard``'s offsets (the placement a
    reshape of two sharded dims gives, as an einsum's bmm makes of batch
    and heads) with small index tensors that it reads back; under
    ``FakeTensorMode`` that read-back fails, so that one function runs with
    the fake mode unset."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.local_shard_size_and_offset

    def offsets(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = offsets
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def sharded_leaf(t: PT, dtype, rules: ShardingRules):
    """A DTensor of ``t``'s global shape made from one rank's fake local
    shard (``spec_for``'s shape), never from a global tensor."""
    from torch.distributed.tensor import DTensor

    spec = rules.spec_for(t.axes, t.shape)
    local = torch.empty(local_shape(t.shape, spec, rules.mesh.shape),
                        dtype=dtype)
    return DTensor.from_local(local, rules.device_mesh,
                              placements_for(spec, rules.device_mesh),
                              run_check=False, shape=torch.Size(t.shape),
                              stride=_contiguous_stride(t.shape))


def sharded_tree(template, dtype, rules: ShardingRules):
    return template_map(lambda t: sharded_leaf(t, dtype, rules), template)


def build_cell(cfg: ModelConfig, shape, rules: ShardingRules):
    """(fn, args) for one cell: every argument a DTensor from local fake
    shards.  Call it under :func:`fake_world` with ``rules.device_mesh``
    set."""
    p_dt = getattr(torch, cfg.param_dtype)
    params = sharded_tree(S.params_template(cfg), p_dt, rules)
    if shape.kind == "train":
        opt_cfg = optim.OptConfig()
        mu_dt = getattr(torch, opt_cfg.opt_dtype)
        o_tpl = S.opt_template(cfg)
        opt = optim.OptState(sharded_tree(o_tpl.mu, mu_dt, rules),
                             sharded_tree(o_tpl.nu, mu_dt, rules),
                             sharded_leaf(o_tpl.count, torch.int32, rules))
        batch = {k: sharded_leaf(t, S.batch_dtype(cfg, k), rules)
                 for k, t in S.batch_template(cfg, shape).items()}
        step = step_mod.make_train_step(cfg, opt_cfg)
        return step, (params, opt, batch)
    if shape.kind == "prefill":
        batch = {k: sharded_leaf(t, S.batch_dtype(cfg, k), rules)
                 for k, t in S.batch_template(cfg, shape).items()}

        def prefill(params, batch):
            with torch.no_grad():
                return lm.prefill_step(cfg, params, batch,
                                       cache_len=shape.seq_len)

        return prefill, (params, batch)
    # decode: one new token against a seq_len-long cache
    c_dt = getattr(torch, cfg.compute_dtype)
    caches = [sharded_tree(t, c_dt, rules) for t in S.caches_template(cfg, shape)]
    tokens = sharded_leaf(S.decode_template(cfg, shape), torch.int32, rules)
    pos = shape.seq_len - 1

    def decode(params, caches, tokens):
        with torch.no_grad():
            return lm.decode_step(cfg, params, caches, tokens, pos)

    return decode, (params, caches, tokens)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def run_step(fn, args, rules: ShardingRules):
    """Run one cell's step under the rules and the counter: (outputs,
    counter, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = CostCounter()
    t0 = time.perf_counter()
    fallbacks = Fallbacks()
    with fallbacks, implicit_replication(), use_rules(rules), counter:
        out = fn(*args)
    counter.fallbacks = fallbacks.used
    return out, counter, time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, mesh: Mesh, mesh_name: str,
             cfg: ModelConfig | None = None, shape=None) -> Dict[str, Any]:
    """One cell's record (a fake world of ``mesh.size`` ranks for its
    duration)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped (full-attention arch; see DESIGN.md SS5)"
        return rec
    try:
        with fake_world(mesh) as device_mesh:
            rules = ShardingRules(mesh, rules_for_config(mesh, cfg),
                                  device_mesh)
            fn, args = build_cell(cfg, shape, rules)
            arg_bytes = _local_bytes(args)
            out, counter, elapsed = run_step(fn, args, rules)
            out_bytes = _local_bytes(out)
            del out
        rl = analyze.from_counts(arch, shape_name, mesh_name, mesh.size,
                                 counter, cfg=cfg, shape_cfg=shape)
        rec.update(rl.to_dict())
        rec.update(
            status="ok",
            elapsed_s=round(elapsed, 2),
            argument_bytes=arg_bytes,
            output_bytes=out_bytes,
            temp_bytes=counter.peak_bytes,
            peak_bytes=arg_bytes + counter.peak_bytes,
            peak_method=PEAK_METHOD,
            ops=sum(counter.ops.values()),
            fallbacks=dict(counter.fallbacks),
        )
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh, mesh_name)
                records.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (
                        f" elapsed={rec['elapsed_s']}s"
                        f" flops/dev={rec['flops_per_device']:.3e}"
                        f" coll/dev={rec['collective_bytes_per_device']:.3e}B"
                        f" bottleneck={rec['bottleneck']}"
                    )
                print(f"[{mesh_name}] {arch} x {shape_name}: {status}{extra}",
                      flush=True)
                if status == "FAILED":
                    print(rec["error"], flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    n_fail = sum(r["status"] == "FAILED" for r in records)
    print(f"cells: {len(records)}  failed: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
