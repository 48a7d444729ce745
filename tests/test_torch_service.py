"""The port's DedupService against the JAX reference service.

The same submit sequence goes to ``repro_torch.service.DedupService
(device="cpu")`` and ``repro.service.DedupService``; recipes (keys, chunk
lengths, packed fingerprints, digests), store accounting (stored, unique,
compressed bytes) and restored bytes must be equal.  Depots interchange
both ways, on disk.  A subprocess shows the port imports neither jax nor
any ``repro`` module (single-store, packed and 2-shard ingests), and
``chip_smoke.py`` refuses to run without a card or outside a checkout.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core.params import SeqCDCParams as JParams
from repro.service import DedupService as JDedupService

import repro_torch
from repro_torch.service import DedupService, IntegrityError
from repro_torch.service.api import pack_fps

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

P = JParams(avg_size=256, seq_length=3, skip_trigger=6, skip_size=32,
            min_size=64, max_size=512)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done.  The reference's
    module-level jits (its scheduler's ``_device_chunk_packed`` among them)
    would keep this file's traces, and a reference test that runs later in
    the same process and monkeypatches what such a jit calls would hit the
    cached trace and never see its patch."""
    yield
    jax.clear_caches()


def versioned_objects(seed: int, versions: int, objects: int,
                      max_size: int):
    """Seeded versioned corpus: each version edits a few spans of every
    object (overwrite, insert or delete), so later versions dedup."""
    rng = np.random.default_rng(seed)
    cur = [rng.integers(0, 256, int(rng.integers(0, max_size)),
                        dtype=np.uint8) for _ in range(objects)]
    out = [cur]
    for _ in range(1, versions):
        nxt = []
        for obj in cur:
            for _ in range(2):
                pos = int(rng.integers(0, obj.size + 1))
                new = rng.integers(0, 256, int(rng.integers(1, 40)),
                                   dtype=np.uint8)
                op = int(rng.integers(0, 3))
                if op == 0:
                    obj = np.concatenate([obj[:pos], new, obj[pos:]])
                elif op == 1:
                    obj = np.concatenate([obj[:pos], obj[pos + new.size:]])
                else:
                    obj = obj.copy()
                    obj[pos:pos + new.size] = new[: obj.size - pos]
            nxt.append(obj)
        cur = nxt
        out.append(cur)
    return out


def _ingest(svc, corpus):
    for v, objs in enumerate(corpus):
        for i, obj in enumerate(objs):
            svc.submit(f"v{v}/o{i}", obj)
        svc.flush()
    # an overwrite and a delete, so release and GC accounting move too
    svc.put("v0/o0", corpus[-1][-1], overwrite=True)
    svc.delete("v0/o1")
    return svc.gc()


def _assert_same_service(got, want, corpus):
    assert got.names() == want.names()
    for name in want.names():
        a, b = got.recipes.get(name), want.recipes.get(name)
        assert a.to_json() == b.to_json(), name
        assert got.get(name) == want.get(name)
    for v, objs in enumerate(corpus):
        for i, obj in enumerate(objs):
            if f"v{v}/o{i}" in ("v0/o0", "v0/o1"):
                continue
            assert got.get(f"v{v}/o{i}") == obj.tobytes()
    gs, ws = got.stats(), want.stats()
    for field in ("objects", "logical_bytes", "stored_bytes", "total_chunks",
                  "unique_chunks", "chunk_size_hist", "fp_estimated_savings",
                  "batches", "compressed_bytes", "codec"):
        assert getattr(gs, field) == getattr(ws, field), field
    assert gs.dedup_ratio == ws.dedup_ratio > 1.0


@pytest.mark.parametrize("impl,slots,max_size", [
    ("split", 3, 6000),  # mixed buckets, partial batches
    ("fused", 1, 1024),  # one bucket: one interpret-mode kernel compile
])
def test_service_matches_reference(impl, slots, max_size):
    corpus = versioned_objects(7, versions=3, objects=6, max_size=max_size)
    kw = dict(slots=slots, min_bucket=1024, pipeline_impl=impl)
    port = DedupService(params=repro_torch.params_from_reference(P),
                        device="cpu", cross_check_masks=True,
                        cross_check_fps=True, cross_check_pipeline=True,
                        codec="zlib", **kw)
    ref = JDedupService(params=P, packing_impl="off", codec="zlib", **kw)
    assert dataclasses.asdict(_ingest(port, corpus)) == \
        dataclasses.asdict(_ingest(ref, corpus))
    _assert_same_service(port, ref, corpus)
    for name in port.names():
        r = port.recipes.get(name)
        assert r.fps == ref.recipes.get(name).fps
        assert len(r.fps) == len(r.keys)
    res_fps = np.array([[3, 5], [1 << 30, 7]], dtype=np.uint32)
    assert pack_fps(res_fps) == [(3 << 32) | 5, ((1 << 30) << 32) | 7]


def test_service_without_fingerprints_matches_reference():
    """with_fingerprints=False: boundaries only, recipes without fps."""
    corpus = versioned_objects(11, versions=2, objects=4, max_size=4000)
    kw = dict(slots=2, min_bucket=1024, with_fingerprints=False)
    port = DedupService(params=repro_torch.params_from_reference(P),
                        device="cpu", **kw)
    ref = JDedupService(params=P, packing_impl="off", **kw)
    _ingest(port, corpus)
    _ingest(ref, corpus)
    _assert_same_service(port, ref, corpus)
    assert all(r.fps is None for r in port.recipes)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_depot_interchange_both_ways(codec, tmp_path):
    """A depot written by the reference restores SHA-verified under the
    port, and one the port then extends restores under the reference."""
    corpus = versioned_objects(3, versions=2, objects=5, max_size=5000)
    root = str(tmp_path / "depot")
    kw = dict(slots=2, min_bucket=1024, pipeline_impl="split")
    ref = JDedupService.open(root, params=P, packing_impl="off",
                             codec=codec, **kw)
    for i, obj in enumerate(corpus[0]):
        ref.submit(f"ref/{i}", obj)
    ref.flush()
    del ref
    port = DedupService.open(root, params=repro_torch.params_from_reference(P),
                             device="cpu", **kw)
    assert port.store.codec == codec  # picked up from the depot manifest
    for i, obj in enumerate(corpus[0]):
        assert port.get(f"ref/{i}") == obj.tobytes()
    for i, obj in enumerate(corpus[1]):
        port.submit(f"port/{i}", obj)
    port.flush()
    stored = port.stats().stored_bytes
    del port
    ref = JDedupService.open(root, params=P, packing_impl="off", **kw)
    assert ref.stats().stored_bytes == stored
    for v, tag in enumerate(("ref", "port")):
        for i, obj in enumerate(corpus[v]):
            assert ref.get(f"{tag}/{i}") == obj.tobytes()
    assert ref.gc().freed_blocks == 0


def test_corrupt_block_raises_integrity_error(tmp_path):
    svc = DedupService.open(str(tmp_path), device="cpu",
                            params=repro_torch.params_from_reference(P),
                            min_bucket=1024, pipeline_impl="split")
    data = np.random.default_rng(1).integers(0, 256, 3000, dtype=np.uint8)
    svc.put("x", data)
    assert svc.get("x") == data.tobytes()
    path, _ = svc.store._find_block(svc.recipes.get("x").keys[0])
    with open(path, "r+b") as f:
        head = f.read(3)
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in head))
    with pytest.raises(IntegrityError):
        svc.get("x")


def test_cuda_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="cuda"):
        DedupService()
    with pytest.raises(RuntimeError, match="cuda"):
        DedupService(device="cuda:0")


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.timeout(300)
def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.service import DedupService\n"
        "from repro_torch.kernels import KERNELS\n"
        "p = repro_torch.SeqCDCParams(avg_size=256, seq_length=3, "
        "skip_trigger=6, skip_size=32, min_size=64, max_size=512)\n"
        "svc = DedupService(params=p, device='cpu', min_bucket=1024, "
        "cross_check_pipeline=True)\n"
        "d = np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8)\n"
        "svc.put('a', d)\n"
        "assert svc.get('a') == d.tobytes()\n"
        "from repro_torch.service import ShardedDedupService\n"
        "svc = DedupService(params=p, device='cpu', min_bucket=1024, "
        "packing_impl='segments', cross_check_packing=True)\n"
        "svc.put('t', d[:300])\n"
        "assert svc.get('t') == d[:300].tobytes()\n"
        "assert svc.scheduler.stats.packed_streams == 1\n"
        "with ShardedDedupService(2, params=p, device='cpu', "
        "min_bucket=1024, packing_impl='segments') as sh:\n"
        "    sh.submit('a', d)\n"
        "    sh.submit('t', d[:300])\n"
        "    sh.flush()\n"
        "    assert sh.get('a') == d.tobytes()\n"
        "from repro_torch.core import available, make_chunker\n"
        "for name in available():\n"
        "    b = make_chunker(name, 4096, device='cpu').chunk(d)\n"
        "    assert b[-1] == d.size, name\n"
        "import torch\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.models import lm\n"
        "from repro_torch.serve import Engine, ServeConfig\n"
        "from repro_torch.launch import serve as cli\n"
        "cli.main(['--device', 'cpu', '--requests', '2', '--max-new', '3'])\n"
        "cfg = get_reduced('llama3.2-1b').replace(attn_q_block=16, "
        "attn_kv_block=16)\n"
        "eng = Engine(cfg, lm.init_params(cfg, device='cpu'), ServeConfig("
        "max_slots=2, cache_len=64, max_new_tokens=3), device='cpu')\n"
        "eng.submit(np.arange(32) % 256)\n"
        "assert len(eng.run()[0]) == 3\n"
        "from repro_torch.configs import get_config\n"
        "c = get_reduced('qwen3-moe-30b-a3b')\n"
        "lg = lm.forward(c, lm.init_params(c, device='cpu'), "
        "{'tokens': torch.arange(40)[None] % 256})\n"
        "assert lg.shape == (1, 40, c.vocab_size)\n"
        "c = get_reduced('deepseek-v3-671b')\n"
        "pm = lm.init_params(c, device='cpu')\n"
        "lg, ca = lm.prefill_step(c, pm, "
        "{'tokens': torch.arange(40)[None] % 256}, 48)\n"
        "lg, _ = lm.decode_step(c, pm, ca, lg.argmax(-1)[:, None], 40)\n"
        "assert lg.shape == (1, c.vocab_size)\n"
        "for arch in ('recurrentgemma-2b', 'xlstm-125m'):\n"
        "    assert get_config(arch).name == arch\n"
        "    c = get_reduced(arch)\n"
        "    lg, _ = lm.prefill_step(c, lm.init_params(c, device='cpu'), "
        "{'tokens': torch.arange(40)[None] % 256}, 48)\n"
        "    assert lg.shape == (1, c.vocab_size), arch\n"
        "import tempfile\n"
        "from repro_torch.scenarios import generate, corpus_digest\n"
        "assert len(corpus_digest(generate('lm_text', 'tiny'))) == 64\n"
        "from repro_torch.data import DedupIngest, PipelineConfig\n"
        "ing = DedupIngest(PipelineConfig(avg_chunk=256, segment_bytes=2048, "
        "batch_segments=2), p, device='cpu')\n"
        "n = sum(len(u) for u in ing.unique_bytes(np.tile(d[:2048], 4)))\n"
        "assert (n, ing.savings) == (2048, 0.75), (n, ing.savings)\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.train import OptConfig, opt_init\n"
        "ck = CheckpointManager(tempfile.mkdtemp(), avg_chunk=4096, "
        "device='cpu')\n"
        "w = {'w': torch.ones(64, 64)}\n"
        "ck.save(1, {'params': w, 'opt': opt_init(OptConfig(), w)})\n"
        "assert ck.restore(tree_like={'params': w})[0] == 1\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = _run([sys.executable, "-c", code], ROOT,
               {"PYTHONPATH": os.path.abspath(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


@pytest.mark.timeout(300)
def test_package_init_and_shard_server_import_no_torch():
    """``import repro_torch``, its parameters and the shard server's module
    stay numpy+stdlib: a spawned shard server must not pay torch's import,
    so the package inits resolve their torch modules lazily."""
    code = (
        "import sys\n"
        "import repro_torch\n"
        "import repro_torch.core.params\n"
        "import repro_torch.configs\n"
        "import repro_torch.service.transport.shard_server\n"
        "assert repro_torch.core.SeqCDCParams is repro_torch.SeqCDCParams\n"
        "assert 'torch' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('repro_torch'))\n"
        "print('torch-free')\n"
    )
    out = _run([sys.executable, "-c", code], ROOT,
               {"PYTHONPATH": os.path.abspath(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("torch-free")


@pytest.mark.timeout(300)
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = os.path.abspath(os.path.join(ROOT, "chip_smoke.py"))
    out = _run([sys.executable, script], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(script, lone / "chip_smoke.py")
    out = _run([sys.executable, "chip_smoke.py"], str(lone))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
