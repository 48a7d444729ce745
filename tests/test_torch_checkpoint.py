"""The port's CDC checkpoint store: twins of ``tests/test_checkpoint.py``
on trees of tensors, and checkpoint interchange with the JAX package.

Roundtrip, incremental dedup, retention with block release, crash safety,
a specific step, async and bfloat16 saves run on the CPU (the chunker's
plain versions); the reference's elastic-resharding test becomes a restore
onto a device.  Interchange: a reduced ``llama3.2-1b`` parameter and
optimizer-state tree (bfloat16 parameters included) written by either
package restores bit-equal in the other, and both write the same manifest
byte for byte.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_reduced as ref_reduced
from repro.models import lm as ref_lm
from repro.train import OptConfig as RefOptConfig
from repro.train import opt_init as ref_opt_init

from repro_torch._tree import leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.models.convert import opt_state_from_jax, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    yield
    jax.clear_caches()


def _mgr(root, **kw):
    return CheckpointManager(str(root), device="cpu", **kw)


def _tree(seed, shape=(64, 64)):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(shape, generator=g),
        "nested": {"b": torch.arange(100, dtype=torch.int32)},
    }


def _assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_roundtrip(tmp_path):
    mgr = _mgr(tmp_path)
    t = _tree(0)
    mgr.save(5, {"params": t}, {"next_step": 6})
    step, state, extra = mgr.restore(tree_like={"params": t})
    assert step == 5 and extra["next_step"] == 6
    _assert_trees_equal(t, state["params"])
    # without a template: flat {path: tensor}, the reference's path strings
    _, flat, _ = mgr.restore()
    assert sorted(flat["params"]) == ["['a']", "['nested']['b']"]


def test_incremental_dedup(tmp_path):
    """Adjacent checkpoints share most chunks -> high store savings."""
    mgr = _mgr(tmp_path, avg_chunk=4096)
    base = np.random.default_rng(0).standard_normal((512, 256)).astype(
        np.float32)
    for step in range(4):
        t = {"w": torch.from_numpy(base.copy())}
        base[step, :8] += 1.0  # tiny delta per "training step"
        mgr.save(step, {"params": t})
    assert mgr.dedup_savings > 0.6, mgr.dedup_savings


def test_retention_and_block_release(tmp_path):
    mgr = _mgr(tmp_path, keep=2)
    for step in range(5):
        mgr.save(step, {"params": _tree(step)})
    assert mgr.steps() == [3, 4]
    step, state, _ = mgr.restore(tree_like={"params": _tree(0)})
    assert step == 4
    _assert_trees_equal(state["params"], _tree(4))
    # only the two kept checkpoints' blocks are live
    live = {k for s in (3, 4) for meta in json.load(open(
        mgr._manifest_path(s)))["trees"]["params"].values()
        for k in meta["keys"]}
    assert {k for k, rc in mgr.store.refs.items() if rc > 0} == live


def test_latest_pointer_crash_safety(tmp_path):
    """A torn manifest write never corrupts the newest committed checkpoint."""
    mgr = _mgr(tmp_path)
    mgr.save(1, {"params": _tree(1)})
    with open(os.path.join(str(tmp_path), "manifest-00000002.json.tmp"),
              "w") as f:
        f.write('{"step": 2, "trees": {INVALID')
    mgr2 = _mgr(tmp_path)
    assert mgr2.latest_step() == 1
    step, state, _ = mgr2.restore(tree_like={"params": _tree(1)})
    assert step == 1
    _assert_trees_equal(state["params"], _tree(1))


def test_restore_specific_step(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    trees = {}
    for step in (1, 2, 3):
        trees[step] = _tree(step)
        mgr.save(step, {"params": trees[step]})
    step, state, _ = mgr.restore(step=2, tree_like={"params": trees[2]})
    assert step == 2
    _assert_trees_equal(state["params"], trees[2])


def test_restore_on_device(tmp_path):
    """Manifests hold no device: a checkpoint restores onto the device
    asked for (the reference's resharded restore)."""
    mgr = _mgr(tmp_path)
    t = _tree(3)
    mgr.save(1, {"params": t})
    step, placed, _ = mgr.restore_on_device({"params": t}, "cpu")
    assert step == 1
    assert all(x.device.type == "cpu" for x in leaves(placed["params"]))
    _assert_trees_equal(t, placed["params"])
    assert _mgr(tmp_path / "empty").restore_on_device(
        {"params": t}, "cpu") == (None, None, None)


def test_async_save(tmp_path):
    mgr = _mgr(tmp_path)
    t = _tree(4)
    want = {k: v for k, v in _tree(4).items()}
    mgr.save_async(7, {"params": t})
    t["a"].add_(1.0)  # the host copy was taken before save_async returned
    mgr.wait()
    step, state, _ = mgr.restore(tree_like={"params": t})
    assert step == 7
    _assert_trees_equal(state["params"], want)


def test_bf16_roundtrip(tmp_path):
    mgr = _mgr(tmp_path)
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn((32, 32), generator=g).to(torch.bfloat16)}
    mgr.save(1, {"params": t})
    step, state, _ = mgr.restore(tree_like={"params": t})
    got = state["params"]["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t["w"].view(torch.int16))
    meta = json.load(open(mgr._manifest_path(1)))["trees"]["params"]["['w']"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [32, 32]


# -- interchange with the reference ------------------------------------------

def _states():
    """One reduced llama3.2-1b state in both packages: bfloat16 parameters,
    float32 AdamW moments made non-zero, the step count."""
    cfg = get_reduced("llama3.2-1b").replace(param_dtype="bfloat16")
    rcfg = ref_reduced("llama3.2-1b").replace(param_dtype="bfloat16")
    params = ref_lm.init_params(rcfg, jax.random.PRNGKey(1))
    opt = ref_opt_init(RefOptConfig(), params)
    mu = jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, params)
    nu = jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), params)
    opt = opt._replace(mu=mu, nu=nu, count=jnp.int32(3))
    ref = {"params": params, "opt": opt}
    host = jax.tree.map(np.asarray, ref)
    port = {"params": params_from_jax(cfg, host["params"], device="cpu"),
            "opt": opt_state_from_jax(cfg, host["opt"], device="cpu")}
    return ref, port


def _assert_ref_equals_port(ref_tree, port_tree):
    ra = jax.tree.leaves(ref_tree)
    pa = leaves(port_tree)
    assert len(ra) == len(pa)
    for a, b in zip(ra, pa):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert tuple(a.shape) == tuple(b.shape)
        if b.dtype == torch.bfloat16:
            assert np.array_equal(a.view(np.int16), b.view(torch.int16).numpy())
        else:
            assert np.array_equal(a, b.numpy())


def test_interchange_reference_to_port(tmp_path):
    ref, port = _states()
    RefManager(str(tmp_path)).save(4, ref, {"next_step": 5})
    step, state, extra = _mgr(tmp_path).restore(tree_like=port)
    assert (step, extra) == (4, {"next_step": 5})
    _assert_ref_equals_port(ref["params"], state["params"])
    _assert_ref_equals_port(ref["opt"], state["opt"])


def test_interchange_port_to_reference(tmp_path):
    ref, port = _states()
    _mgr(tmp_path).save(4, port, {"next_step": 5})
    step, state, extra = RefManager(str(tmp_path)).restore(tree_like=ref)
    assert (step, extra) == (4, {"next_step": 5})
    _assert_ref_equals_port(state["params"], port["params"])
    _assert_ref_equals_port(state["opt"], port["opt"])


def test_interchange_manifests_are_byte_identical(tmp_path):
    ref, port = _states()
    RefManager(str(tmp_path / "ref")).save(2, ref, {"next_step": 3})
    _mgr(tmp_path / "port").save(2, port, {"next_step": 3})
    name = "manifest-00000002.json"
    with open(tmp_path / "ref" / name, "rb") as f:
        want = f.read()
    with open(tmp_path / "port" / name, "rb") as f:
        assert f.read() == want
    assert "['segments'][0]['attn']['wq']" in json.loads(want)["trees"][
        "params"]
    assert ".mu['embed']" in json.loads(want)["trees"]["opt"]
