"""The port's distribution layer against the JAX reference's.

* sharding rules: the 14 cases of ``test_sharding.py`` held across the
  packages, then ``spec_for`` / ``pspec_tree`` on every ``PT`` leaf of the
  parameter, optimizer, batch and cache templates of every arch, on the
  single- and multi-pod meshes and every ``fsdp`` setting;
* ``launch/specs.py``: every abstract input's shape and dtype;
* the fingerprint index's ``all_to_all`` (``routed_fp_tables``,
  ``distributed_dedup``) bit for bit against the reference run on 8 XLA
  host devices in a subprocess, on ``test_distributed.py``'s draw and on a
  skewed draw that overflows;
* ``ShardedDedupService(mesh=...)`` on a 4-shard CPU mesh against the host
  route and the reference's overflow count;
* DTensor over gloo: the sharded train step on a (4, 2) mesh against the
  single-device step, and an elastic restore from (4, 2) to (2, 4), in 8
  spawned CPU processes;
* the dry run's tiny-mesh cell on the fake backend.

Every subprocess has a timeout; process groups start from a file under the
test's ``tmp_path``, so parallel test workers never share a port.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as PS

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import layers as jlayers

from repro_torch import configs
from repro_torch.dedup import dist_index
from repro_torch.dedup.index import dedup_stats
from repro_torch.distributed import sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import layers

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))


class DuckMesh:
    """``ShardingRules`` reads only ``.shape`` and ``.axis_names``."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _mesh(multi=False):
    return DuckMesh({"pod": 2, "data": 16, "model": 16} if multi
                    else {"data": 16, "model": 16})


def _pair(fsdp="none", multi=False, arch=None):
    """(reference rules, port rules) over the same duck mesh."""
    mesh = _mesh(multi)
    if arch is None:
        return (jsharding.ShardingRules(mesh, jsharding.default_rules(mesh, fsdp)),
                sharding.ShardingRules(mesh, sharding.default_rules(mesh, fsdp)))
    return (jsharding.ShardingRules(
                mesh, jsharding.rules_for_config(mesh, jconfigs.get_config(arch))),
            sharding.ShardingRules(
                mesh, sharding.rules_for_config(mesh, configs.get_config(arch))))


def _spec(ps) -> tuple:
    """A reference ``PartitionSpec`` as the port's plain tuple."""
    return tuple(ps)


# -- the 14 cases of test_sharding.py, each held across the packages ----------

def _case_calls():
    """name -> (rules kwargs, [(axes, shape)], expected spec or None)."""
    return {
        "batch_sharding": (
            {}, [(("batch", "seq"), (256, 4096))], [("data", None)]),
        "batch_multi_pod": (
            {"multi": True}, [(("batch", "seq"), (256, 4096))],
            [(("pod", "data"), None)]),
        "batch_too_small_falls_back": (
            {"multi": True}, [(("batch", "seq"), (32, 128)),
                              (("batch", "seq"), (1, 128))],
            [(("pod", "data"), None), (None, None)]),
        "heads_shard_when_divisible": (
            {}, [(("embed", "heads", "head_dim"), (4096, 32, 128))],
            [(None, "model", None)]),
        "heads_fallback_phi3": (
            {"arch": "phi3-medium-14b"},
            [(("embed", "heads", "head_dim"), (5120, 40, 128)),
             (("embed", "kv_heads", "head_dim"), (5120, 8, 128)),
             (("batch", None, "heads_act", None), (256, 1024, 48, 128))],
            [("data", None, None), ("data", None, None),
             ("data", None, "model", None)]),
        "heads_fallback_llava": (
            {"arch": "llava-next-34b"},
            [(("embed", "heads", "head_dim"), (7168, 56, 128)),
             (("embed", "kv_heads", "head_dim"), (7168, 8, 128)),
             (("batch", None, "heads_act", None), (256, 1024, 64, 128))],
            [("data", None, None), ("data", None, None),
             ("data", None, "model", None)]),
        "decode_cache_seq_sharded": (
            {"arch": "llama3.2-1b"},
            [(("batch", "seq_kv", "kv_heads", "head_dim"), (128, 32768, 8, 64))],
            [("data", "model", None, None)]),
        "decode_cache_mha_kv_sharded": (
            {"arch": "musicgen-large"},
            [(("batch", "seq_kv", "kv_heads", "head_dim"),
              (128, 32768, 32, 64))],
            [("data", None, "model", None)]),
        "small_kv_heads_replicated": (
            {"arch": "llama3.2-1b"},
            [(("embed", "heads", "head_dim"), (2048, 32, 64)),
             (("embed", "kv_heads", "head_dim"), (2048, 8, 64))],
            [("data", "model", None), ("data", None, None)]),
        "fsdp_embeds": (
            {"fsdp": "data"}, [(("embed", "mlp"), (4096, 14336))],
            [("data", "model")]),
        "fsdp_none": (
            {}, [(("embed", "mlp"), (4096, 14336))], [(None, "model")]),
        "fsdp_pod_data_multi": (
            {"fsdp": "pod_data", "multi": True},
            [(("embed", "mlp"), (8192, 29568))], [(("pod", "data"), "model")]),
        "no_axis_used_twice": (
            {}, [(("vocab", "embed"), (151936, 2048))], None),
        "moe_expert_sharding": (
            {}, [(("experts", "embed", "expert_mlp"), (128, 2048, 768))],
            [("model", None, None)]),
        "one_dim_params_replicated": (
            {}, [(("embed",), (4096,))], [(None,)]),
        "stack_dim_never_sharded": (
            {}, [(("stack", "embed", "mlp"), (48, 2048, 768))], None),
    }


@pytest.mark.parametrize("case", sorted(_case_calls()))
def test_spec_for_twins_test_sharding(case):
    kw, calls, want = _case_calls()[case]
    ref, port = _pair(**kw)
    for i, (axes, shape) in enumerate(calls):
        got = port.spec_for(axes, shape)
        assert got == _spec(ref.spec_for(axes, shape)), (case, axes)
        if want is not None:
            assert got == want[i], (case, axes, got)
    if case == "no_axis_used_twice":
        flat = [a for s in got if s is not None
                for a in (s if isinstance(s, tuple) else (s,))]
        assert len(flat) == len(set(flat))
    if case == "stack_dim_never_sharded":
        assert got[0] is None


# -- every leaf of every template, every arch ---------------------------------

def _flat(tree, leaf_type, path=()):
    """{path: leaf} of a template tree (dict keys sorted, NamedTuples by
    field), for trees built by either package."""
    if isinstance(tree, leaf_type):
        return {path: tree}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf_type, path + (k,)))
    return out


def _templates(arch):
    """(name, reference template, port template) of every role."""
    jc, pc = jconfigs.get_config(arch), configs.get_config(arch)
    out = [("params", jspecs.params_template(jc), specs.params_template(pc)),
           ("opt", jspecs.opt_template(jc), specs.opt_template(pc))]
    for name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(pc, shape):
            continue
        jshape = jconfigs.SHAPES[name]
        if shape.kind == "decode":
            out.append((f"caches/{name}", jspecs.caches_template(jc, jshape),
                        specs.caches_template(pc, shape)))
        else:
            out.append((f"batch/{name}", jspecs.batch_template(jc, jshape),
                        specs.batch_template(pc, shape)))
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_pspec_tree_matches_reference_every_leaf(arch):
    rule_sets = [("arch", False), ("arch", True)] + [
        (f, m) for f in ("none", "data", "pod_data") for m in (False, True)]
    for name, jt, pt in _templates(arch):
        jl, pl = _flat(jt, jlayers.PT), _flat(pt, layers.PT)
        assert list(jl) == list(pl), (arch, name)
        for path in jl:
            assert (tuple(pl[path].shape), tuple(pl[path].axes)) == \
                (tuple(jl[path].shape), tuple(jl[path].axes)), (arch, name, path)
        for fsdp, multi in rule_sets:
            ref, port = (_pair(arch=arch, multi=multi) if fsdp == "arch"
                         else _pair(fsdp, multi))
            jspec = _flat(ref.pspec_tree(jt), PS)
            pspec = port.pspec_tree(pt)
            got = {p: port.spec_for(t.axes, t.shape) for p, t in pl.items()}
            assert list(jspec) == list(got), (arch, name)
            for path, ps in jspec.items():
                assert got[path] == _spec(ps), (arch, name, fsdp, multi, path)
            # pspec_tree keeps the template's structure, a spec a leaf
            for path, spec in got.items():
                node = pspec
                for k in path:
                    node = getattr(node, k) if isinstance(k, str) and \
                        hasattr(node, "_fields") else node[k]
                assert node == spec, (arch, name, path)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch):
    jc, pc = jconfigs.get_config(arch), configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(pc, shape):
            continue
        want = _flat(jspecs.input_specs(jc, jconfigs.SHAPES[name]),
                     jax.ShapeDtypeStruct)
        got = _flat(specs.input_specs(pc, shape), torch.Tensor)
        assert list(got) == list(want), (arch, name)
        for path, w in want.items():
            g = got[path]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, name, path)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), \
                (arch, name, path)


def test_cache_template_mirrors_init_block_cache():
    """The cache templates' tree is ``init_stack_states``' (what decode
    runs on), for every arch at a reduced size."""
    from repro_torch.models import transformer as tfm

    for arch in configs.ARCHS:
        cfg = configs.get_reduced(arch)
        tpl = tfm.stack_cache_template(cfg, 2, 16)
        real = tfm.init_stack_states(cfg, 2, 16, torch.float32,
                                     device="cpu")
        tl, rl = _flat(tpl, layers.PT), _flat(real, torch.Tensor)
        assert list(tl) == list(rl), arch
        for p in tl:
            assert tuple(tl[p].shape) == tuple(rl[p].shape), (arch, p)


# -- meshes --------------------------------------------------------------------

def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert single.devices is None
    m = make_host_mesh(shards=4, device="cpu")
    assert m.shape == {"data": 4, "model": 1}
    assert m.axis_devices("data") == [torch.device("cpu")] * 4
    m = Mesh({"data": 2, "model": 2}, ["cpu", "cpu:0", "cpu", "cpu:0"])
    assert m.axis_devices("model") == [torch.device("cpu"),
                                       torch.device("cpu:0")]
    with pytest.raises(ValueError, match="no axis 'x'"):
        m.axis_devices("x")
    with pytest.raises(ValueError, match="3 devices for a mesh of 4"):
        Mesh({"data": 4}, ["cpu"] * 3)
    import torch.distributed as dist

    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="needs a process group"):
            m.to_device_mesh()


def test_placements_for():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(multi=True)
    assert sharding.placements_for((("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements_for((("data", "pod"),), mesh)
    # outside use_rules constrain is the identity
    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", None) is x


# -- the fingerprint index's all_to_all ----------------------------------------

def _draws():
    """test_distributed.py's draw, one with lengths a function of the
    fingerprint (dedup_bytes is then independent of which duplicate a sort
    keeps first), and a skewed draw that overflows."""
    rng = np.random.default_rng(0)
    n = 8 * 512
    fp = rng.integers(0, 50, (n, 2)).astype(np.uint32)
    lengths = rng.integers(1, 1000, n).astype(np.int32)
    lengths[::17] = 0
    out = {"reference": (fp, lengths, 4.0)}
    rng = np.random.default_rng(1)
    fp2 = rng.integers(0, 1 << 32, (400, 2), dtype=np.uint64)
    fp2 = fp2[rng.integers(0, 400, n)].astype(np.uint32)
    ln2 = (fp2[:, 1] % 4000 + 1).astype(np.int32)
    ln2[5::23] = 0
    out["fp_lengths"] = (fp2, ln2, 1.5)
    rng = np.random.default_rng(2)
    fp3 = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    fp3[: n // 2, 0] = (fp3[: n // 2, 0] // 8) * 8  # half the rows own 0
    ln3 = rng.integers(1, 5000, n).astype(np.int32)
    out["skewed"] = (fp3, ln3, 1.5)
    return out


def _run(code: str, env_extra: dict, timeout: int = 240):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="module")
def reference_routes(tmp_path_factory):
    """The reference's tables, overflow and stats for every draw, on 8 XLA
    host devices (a subprocess: XLA fixes its device count at start)."""
    d = tmp_path_factory.mktemp("routes")
    np.savez(d / "draws.npz", **{f"{k}_{i}": v[i] for k, v in _draws().items()
                                 for i in range(2)})
    factors = {k: v[2] for k, v in _draws().items()}
    _run(f"""
        import json, numpy as np, jax, jax.numpy as jnp
        from repro.dedup.dist_index import distributed_dedup, routed_fp_tables
        mesh = jax.make_mesh((8,), ("data",))
        z = np.load({str(d / "draws.npz")!r})
        out, stats = {{}}, {{}}
        for name, cf in {factors!r}.items():
            fp, ln = jnp.asarray(z[name + "_0"]), jnp.asarray(z[name + "_1"])
            with mesh:
                t, o = routed_fp_tables(mesh, "data", capacity_factor=cf)(fp, ln)
                s = distributed_dedup(mesh, "data", capacity_factor=cf)(fp, ln)
            out[name] = np.asarray(t)
            stats[name] = {{k: int(v) for k, v in s.items()}}
            stats[name]["overflow"] = int(o)
        np.savez({str(d / "tables.npz")!r}, **out)
        json.dump(stats, open({str(d / "stats.json")!r}, "w"))
    """, {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
          "JAX_PLATFORMS": "cpu"})
    return np.load(d / "tables.npz"), json.load(open(d / "stats.json"))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("draw", ["reference", "fp_lengths", "skewed"])
def test_routed_fp_tables_bit_equal_reference(reference_routes, draw):
    tables_ref, stats_ref = reference_routes
    fp, ln, cf = _draws()[draw]
    mesh = make_host_mesh(shards=8, device="cpu")
    tables, overflow = dist_index.routed_fp_tables(
        mesh, capacity_factor=cf)(fp, ln)
    assert tables.dtype == torch.uint32
    np.testing.assert_array_equal(tables.numpy(), tables_ref[draw])
    assert overflow == stats_ref[draw]["overflow"]
    if draw == "skewed":
        assert overflow > 0
    else:
        assert overflow == 0
    # the same route over 8 distinct devices: one slab an owner
    spread = Mesh({"data": 8}, ["cpu", "cpu:0"] * 4)
    slabs, o2 = dist_index.routed_fp_tables(spread, capacity_factor=cf)(
        fp, ln)
    assert isinstance(slabs, tuple) and o2 == overflow
    np.testing.assert_array_equal(torch.stack(slabs).numpy(),
                                  tables_ref[draw])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("draw", ["reference", "fp_lengths", "skewed"])
def test_distributed_dedup_matches_reference_and_dedup_stats(
        reference_routes, draw):
    _, stats_ref = reference_routes
    fp, ln, cf = _draws()[draw]
    got = dist_index.distributed_dedup(
        make_host_mesh(shards=8, device="cpu"), capacity_factor=cf)(fp, ln)
    want = stats_ref[draw]
    assert all(isinstance(v, int) for v in got.values())
    assert got["overflow_total"] == want["overflow_total"] == want["overflow"]
    keys = ["original_bytes", "unique_chunks", "total_chunks"]
    if draw == "fp_lengths":  # one length a fingerprint: dedup_bytes too
        keys.append("dedup_bytes")
    for k in keys:
        assert got[k] == want[k], (draw, k)
    if got["overflow_total"] == 0:
        host = dedup_stats(torch.from_numpy(fp.astype(np.int64)),
                           torch.from_numpy(ln))
        assert got == {**{k: int(v) for k, v in host.items()},
                       "overflow_total": 0}
    spread = Mesh({"data": 8}, ["cpu", "cpu:0"] * 4)
    assert dist_index.distributed_dedup(spread, capacity_factor=cf)(
        fp, ln) == got


def test_local_route_keeps_source_order():
    """Within a bucket the records keep their source order; padding rows go
    nowhere; what does not fit is counted, never placed."""
    fp = torch.tensor([[[3, 9], [1, 8], [5, 7], [7, 6], [9, 5], [2, 4]]])
    ln = torch.tensor([[10, 11, 0, 12, 13, 14]])
    buf, over = dist_index._local_route(fp, ln, 2, 2)
    assert buf.shape == (1, 2, 2, 3)
    assert buf[0, 1].tolist() == [[3, 9, 10], [1, 8, 11]]  # 7 and 9 overflow
    assert buf[0, 0].tolist() == [[2, 4, 14], [0, 0, 0]]
    assert over.tolist() == [2]


# -- the sharded service's mesh= route -----------------------------------------

_SERVICE = """
    import json
    from repro{suffix}.core.params import SeqCDCParams
    from repro.data.corpus import snapshot_series
    from repro{suffix}.service import DedupService, ShardedDedupService
    {mesh_setup}
    P = SeqCDCParams(avg_size=256, seq_length=3, skip_trigger=6,
                     skip_size=32, min_size=64, max_size=512)
    versions = list(snapshot_series(base_bytes=1 << 16, snapshots=3,
                                    edit_rate=2e-5, seed=5))
    out = {{}}
    for cf in (4.0, 0.05):
        single = DedupService(params=P, slots=4, min_bucket=1024{dev})
        svc = ShardedDedupService(4, params=P, slots=4, min_bucket=1024,
                                  mesh=mesh, capacity_factor=cf{dev})
        host = ShardedDedupService(4, params=P, slots=4, min_bucket=1024{dev})
        for i, v in enumerate(versions):
            for s in (single, svc, host):
                s.submit(f"v{{i}}", v)
        for s in (single, svc, host):
            s.flush()
        a, b, c = svc.stats(), single.stats(), host.stats()
        assert a.fp_estimated_savings == b.fp_estimated_savings
        assert a.stored_bytes == b.stored_bytes == c.stored_bytes
        assert all(svc.get(f"v{{i}}") == v.tobytes()
                   for i, v in enumerate(versions))
        assert [x.seen for x in svc.fp_index] == \
            [x.seen for x in host.fp_index]
        out[str(cf)] = {{"overflow_rerouted": svc.overflow_rerouted,
                        "savings": a.fp_estimated_savings,
                        "stored": a.stored_bytes}}
        svc.close()
        host.close()
    print(json.dumps(out))
"""


@pytest.mark.timeout(600)
def test_mesh_routed_ingest_matches_host_and_reference():
    """Twin of test_sharded_service.py's ``test_mesh_routed_ingest_matches_
    host`` on a 4-shard CPU mesh, plus a capacity factor small enough that
    flushes overflow: the batch is re-routed on the host and counted, as
    the reference counts it, and the fingerprint indexes equal the host
    route's."""
    ref = json.loads(_run(_SERVICE.format(
        suffix="", dev="",
        mesh_setup='import jax; mesh = jax.make_mesh((4,), ("data",))'),
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
         "JAX_PLATFORMS": "cpu"}, timeout=500).strip().splitlines()[-1])
    got = json.loads(_run(_SERVICE.format(
        suffix="_torch", dev=', device="cpu"',
        mesh_setup="from repro_torch.launch.mesh import make_host_mesh; "
                   "mesh = make_host_mesh(shards=4, device='cpu')"),
        {}, timeout=300).strip().splitlines()[-1])
    assert got["4.0"]["overflow_rerouted"] == 0
    assert got["0.05"]["overflow_rerouted"] > 0
    assert got == ref


def test_mesh_checks_axis_and_size():
    from repro_torch.core.params import SeqCDCParams
    from repro_torch.service import ShardedDedupService

    p = SeqCDCParams(avg_size=256, seq_length=3, skip_trigger=6,
                     skip_size=32, min_size=64, max_size=512)
    with pytest.raises(ValueError, match="no axis 'data'"):
        ShardedDedupService(2, params=p, device="cpu",
                            mesh=Mesh({"x": 2}, ["cpu"] * 2))
    with pytest.raises(ValueError, match="4 devices but the service has 2"):
        ShardedDedupService(2, params=p, device="cpu",
                            mesh=make_host_mesh(shards=4, device="cpu"))
    svc = ShardedDedupService(2, params=p, device="cpu",
                              mesh=Mesh({"shard": 2}, ["cpu"] * 2),
                              mesh_axis="shard")
    assert svc.overflow_rerouted == 0
    svc.close()


# -- DTensor over gloo: sharded train step and elastic restore ------------------

_GLOO = """
    import os, sys, json
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch._tree import leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeConfig, get_reduced
    from repro_torch.distributed.dtensor_ops import Fallbacks
    from repro_torch.distributed.sharding import (
        ShardingRules, default_rules, placement_leaves, use_rules)
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, make_train_step, opt_init, optim

    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + root + "/pg",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    cfg = get_reduced("llama3.2-1b")
    params = lm.init_params(cfg, device="cpu")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    opt = opt_init(opt_cfg, params)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (8, 32), generator=g)}
    step = make_train_step(cfg, opt_cfg)
    p1, o1, m1 = step(tree_map(torch.clone, params),
                      tree_map(torch.clone, opt), batch)

    def place(tree, template, rules):
        pl = placement_leaves(rules.sharding_tree(template))
        vals = [distribute_tensor(t, rules.device_mesh, list(p))
                for t, p in zip(leaves(tree), pl)]
        from repro_torch._tree import unflatten
        return unflatten(tree, vals)

    mesh_a = Mesh({"data": 4, "model": 2})
    dm_a = mesh_a.to_device_mesh()
    rules = ShardingRules(mesh_a, default_rules(mesh_a, cfg.fsdp), dm_a)
    pt = S.params_template(cfg)
    p_sh = place(params, pt, rules)
    o_sh = optim.OptState(place(opt.mu, pt, rules), place(opt.nu, pt, rules),
                          distribute_tensor(opt.count, dm_a,
                                            rules.placements((), ())))
    b_tpl = S.batch_template(cfg, ShapeConfig("t", 32, 8, "train"))
    b_sh = {k: distribute_tensor(v, dm_a, rules.placements(
                b_tpl[k].axes, b_tpl[k].shape)) for k, v in batch.items()}
    from torch.distributed.tensor.experimental import implicit_replication
    with Fallbacks(), implicit_replication(), use_rules(rules):
        p2, o2, m2 = step(p_sh, o_sh, b_sh)
    res = {"loss": [float(m1["loss"]), float(m2["loss"].full_tensor())
                    if isinstance(m2["loss"], DTensor) else float(m2["loss"])],
           "sharded_leaves": sum(isinstance(x, DTensor) and any(
               p.is_shard() for p in x.placements) for x in leaves(p2))}
    err = []
    for a, b in zip(leaves(p1), leaves(p2)):
        b = b.full_tensor() if isinstance(b, DTensor) else b
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-5)
        err.append(float((a - b).abs().max()))
    res["max_param_err"] = max(err)

    # the same step with the parameters FSDP-sharded over data as well:
    # gather_fsdp gathers them for the compute, the gradients go back to
    # the shards
    rules_f = ShardingRules(mesh_a, default_rules(mesh_a, "data"), dm_a)
    pf = place(params, pt, rules_f)
    of = optim.OptState(place(opt.mu, pt, rules_f),
                        place(opt.nu, pt, rules_f),
                        distribute_tensor(opt.count, dm_a,
                                          rules_f.placements((), ())))
    with Fallbacks(), implicit_replication(), use_rules(rules_f):
        p3, _, m3 = step(pf, of, b_sh)
    res["fsdp_loss"] = float(m3["loss"].full_tensor()
                             if isinstance(m3["loss"], DTensor)
                             else m3["loss"])
    err, res["fsdp_data_sharded"] = [], 0
    for a, b, t in zip(leaves(p1), leaves(p3), leaves(pt)):
        want_pl = rules_f.placements(t.axes, t.shape)
        assert tuple(b.placements) == want_pl, (t.axes, b.placements)
        res["fsdp_data_sharded"] += want_pl[0].is_shard()
        b = b.full_tensor()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-5)
        err.append(float((a - b).abs().max()))
    res["fsdp_max_param_err"] = max(err)

    # the flash route under the rules: each rank attends over its own batch
    # rows and query heads (GQA: 4 query heads over 2 KV heads)
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import heads_local
    from repro_torch.kernels import flash_attn
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(8, 16, h, 8, generator=g) for h in (4, 2, 2))

    def attend(q, k, v):
        return flash_attn.flash_attention(q, k, v, scale=0.3, q_block=8,
                                          kv_block=8)

    dq = distribute_tensor(q, dm_a, [Shard(0), Shard(2)])
    dk, dv = (distribute_tensor(x, dm_a, [Shard(0), Replicate()])
              for x in (k, v))
    with use_rules(rules):
        got = heads_local(attend, dq, dk, dv)
    assert tuple(got.placements) == (Shard(0), Shard(2))
    res["heads_local_err"] = float(
        (got.full_tensor() - attend(q, k, v)).abs().max())
    assert heads_local(attend, q, k, v) is None  # no rules: the caller's

    # a recurrence on each rank's batch rows (batch_local: the sLSTM scan)
    from repro_torch.distributed.sharding import batch_local
    from repro_torch.kernels.slstm_scan import SLSTMState, slstm_scan
    xg = torch.randn(8, 5, 4, 16, generator=g)
    r = torch.randn(4, 2, 8, 8, generator=g) * 0.3
    h0, c0 = (torch.randn(8, 16, generator=g) for _ in range(2))
    st = SLSTMState(h0, c0, 1 + torch.rand(8, 16, generator=g),
                    torch.zeros(8, 16))
    want_out, want_st = slstm_scan(xg, r, st)
    dx = distribute_tensor(xg, dm_a, [Shard(0), Replicate()])
    with use_rules(rules):
        got_out, got_st = batch_local(
            lambda x, *s: slstm_scan(x, s[-1], SLSTMState(*s[:-1])),
            (dx, *st), (r,))
    assert tuple(got_out.placements) == (Shard(0), Replicate())
    res["batch_local_err"] = max(
        float((a.full_tensor() - b).abs().max())
        for a, b in zip((got_out, *got_st), (want_out, *want_st)))

    # a decode step's cache write into a sharded cache (Fallbacks'
    # index_put_: a GQA cache split along the sequence, an MHA one along
    # its heads) and a gather's gradient into vocab-sharded logits
    # (scatter_add_), against the same ops on whole tensors
    cache = torch.randn(8, 16, 4, 8, generator=g)
    rows, slot = torch.arange(8), torch.tensor([0, 15, 3, 8, 7, 9, 1, 14])
    new = torch.randn(8, 4, 8, generator=g)
    want = cache.clone()
    want[rows, slot] = new
    res["cache_write_err"] = 0.0
    for pl in ([Shard(0), Shard(1)], [Shard(0), Shard(2)]):
        dc = distribute_tensor(cache, dm_a, pl)
        with Fallbacks() as fb:
            dc[rows, slot] = distribute_tensor(new, dm_a, [Shard(0),
                                                           Replicate()])
        assert fb.used == {"aten.index_put_.default local write": 1}, fb.used
        res["cache_write_err"] = max(res["cache_write_err"], float(
            (dc.full_tensor() - want).abs().max()))
    logits = torch.randn(8, 6, 32, generator=g, requires_grad=True)
    lab = torch.randint(0, 32, (8, 6, 1), generator=g)
    torch.gather(logits, -1, lab).sum().backward()
    dl = distribute_tensor(logits.detach(), dm_a, [Shard(0), Shard(2)])
    dl.requires_grad_(True)
    with Fallbacks(), implicit_replication():
        torch.gather(dl, -1, distribute_tensor(
            lab, dm_a, [Shard(0), Replicate()])).sum().backward()
    res["gather_grad_err"] = float(
        (dl.grad.full_tensor() - logits.grad).abs().max())

    # elastic restore: saved from the (4, 2) placement, restored onto (2, 4)
    full = [x.full_tensor() for x in leaves(p_sh)]
    if rank == 0:
        from repro_torch._tree import unflatten
        CheckpointManager(root + "/ckpt", device="cpu").save(
            1, {"params": unflatten(params, full)})
    dist.barrier()
    mesh_b = Mesh({"data": 2, "model": 4})
    dm_b = mesh_b.to_device_mesh()
    rules_b = ShardingRules(mesh_b, default_rules(mesh_b, "none"), dm_b)
    step_no, state, _ = CheckpointManager(root + "/ckpt", device="cpu") \\
        .restore_sharded({"params": params},
                         {"params": rules_b.sharding_tree(pt)}, dm_b)
    assert step_no == 1
    n_moved = 0
    for a, b, p in zip(leaves(params), leaves(state["params"]),
                       placement_leaves(rules_b.sharding_tree(pt))):
        assert isinstance(b, DTensor) and tuple(b.placements) == tuple(p)
        assert torch.equal(b.full_tensor(), a)
        n_moved += any(q.is_shard() for q in p)
    res["restored_sharded_leaves"] = n_moved
    if rank == 0:
        json.dump(res, open(root + "/result.json", "w"))
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo")
    world = 8
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_GLOO), str(r), str(world),
         str(root)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, e[-3000:]) for p, (_, e) in zip(procs, outs)
           if p.returncode != 0]
    assert not bad, bad[0]
    return json.load(open(root / "result.json"))


@pytest.mark.timeout(300)
def test_gloo_sharded_train_step_matches_single_device(gloo_run):
    """Twin of test_distributed.py's sharded train step: the port's step on
    DTensors over a (4, 2) gloo mesh against the same step on one device,
    at the reference's tolerances (loss 1e-4, params rtol 2e-3 atol
    2e-5)."""
    single, sharded = gloo_run["loss"]
    assert abs(single - sharded) < 1e-4
    assert gloo_run["sharded_leaves"] > 0  # the step really ran sharded
    assert gloo_run["max_param_err"] < 1e-3
    # and with the parameters FSDP-sharded over data (gather_fsdp), the
    # updated parameters back on their FSDP placements
    assert abs(single - gloo_run["fsdp_loss"]) < 1e-4
    assert gloo_run["fsdp_data_sharded"] > 0
    assert gloo_run["fsdp_max_param_err"] < 1e-3


@pytest.mark.timeout(300)
def test_gloo_flash_route_on_local_heads(gloo_run):
    """``heads_local`` (the flash route under the rules) on batch x head
    shards of a (4, 2) mesh equals the attention over the whole tensors."""
    assert gloo_run["heads_local_err"] < 1e-6


@pytest.mark.timeout(300)
def test_gloo_scan_on_local_batch_rows(gloo_run):
    """``batch_local`` (the recurrent scans under the rules) on the batch
    shards of a (4, 2) mesh equals the scan over the whole batch (float32
    products over 2 rows a rank, not 8, may round apart)."""
    assert gloo_run["batch_local_err"] < 1e-5


@pytest.mark.timeout(300)
def test_gloo_fallbacks_write_each_ranks_shard(gloo_run):
    """``Fallbacks``' local writes (a cache row into a cache sharded along
    its sequence or its heads; a gather's gradient into vocab-sharded
    logits) equal the same ops on whole tensors."""
    assert gloo_run["cache_write_err"] == 0.0
    assert gloo_run["gather_grad_err"] == 0.0


@pytest.mark.timeout(300)
def test_gloo_elastic_restore_across_meshes(gloo_run):
    """Twin of test_distributed.py's elastic restore: saved from a (4, 2)
    placement, restored as DTensors onto (2, 4), every leaf equal."""
    assert gloo_run["restored_sharded_leaves"] > 0


# -- the dry run ----------------------------------------------------------------

@pytest.mark.timeout(300)
def test_dryrun_cell_tiny_mesh():
    """Twin of test_distributed.py's tiny-mesh cell: reduced
    qwen3-moe-30b-a3b, fsdp data, a (4, 2) fake mesh, train at 8 x 128."""
    from repro_torch.launch.dryrun import run_cell

    cfg = configs.get_reduced("qwen3-moe-30b-a3b").replace(fsdp="data")
    shape = configs.ShapeConfig("t", 128, 8, "train")
    rec = run_cell("qwen3-moe-30b-a3b", "t", Mesh({"data": 4, "model": 2}),
                   "m", cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_per_device"] > 0
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0
    assert rec["t_collective"] > 0  # fsdp all-gathers, grad reductions
    assert rec["argument_bytes"] > 0 and rec["peak_bytes"] > rec["argument_bytes"]
    # MoE's dispatch has no DTensor strategy: redistributed, and listed
    assert any("sort" in k for k in rec["fallbacks"])
    # a second cell in the same process (the CLI's --all), then a real
    # forward: no fake tensor a cell cached survives it
    dec = run_cell("qwen3-moe-30b-a3b", "t", Mesh({"data": 4, "model": 2}),
                   "m", cfg=cfg, shape=configs.ShapeConfig("t", 128, 8,
                                                           "decode"))
    assert dec["status"] == "ok", dec.get("traceback")
    assert "aten.index_put_.default local write" in dec["fallbacks"]
    from repro_torch.models import lm

    out = lm.forward(cfg, lm.init_params(cfg, device="cpu"),
                     {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert torch.isfinite(out).all()
