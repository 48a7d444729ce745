"""The port's ShardedDedupService against the JAX reference's.

The reference's ``test_matrix_sharded`` grid, held across the packages:
for ``pipeline_impl`` in {split, fused}, ``packing_impl`` in {off,
segments} and 1, 2 or 4 shards, the port's service (``device="cpu"``, the
kernels' plain versions) ingests the reference's adversarial corpus and
must equal the reference's sharded service bit for bit: recipes with their
shard lists, per-shard stored bytes, accounting and restored bytes.  Then
N shards against 1, the remote transport with spawned port shard servers,
and sharded depots written by one package reopened by the other, under
both transports.  Every wait on a subprocess has a timeout.
"""
import os

import numpy as np
import pytest

import jax

from repro.core.params import SeqCDCParams as JParams
from repro.dedup import dist_index as jdist
from repro.service import ShardedDedupService as JSharded

import repro_torch
from repro_torch.dedup import dist_index
from repro_torch.service import ShardedDedupService

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


TP = repro_torch.params_from_reference(P)
KW = dict(slots=2, min_bucket=1024)


def _adversarial_corpus():
    """tests/test_pipeline_matrix.py's corpus: empty and 1-byte objects,
    constant bytes (max-size cuts), shared blocks, low entropy and a dozen
    tiny objects on the bucket floor."""
    rng = np.random.default_rng(42)
    base = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    corpus = [
        ("empty", b""),
        ("one-byte", b"\x42"),
        ("tiny-pair", b"ab"),
        ("zeros", bytes(2900)),
        ("random", base),
        ("random-v2",
         base + rng.integers(0, 256, 700, dtype=np.uint8).tobytes()),
        ("low-entropy", rng.integers(0, 4, 2500, dtype=np.uint8).tobytes()),
    ]
    for i in range(12):
        n = int(rng.integers(5, 120))
        corpus.append((f"tiny-{i}",
                       rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
    return corpus


CORPUS = _adversarial_corpus()


def _ingest(svc, corpus=CORPUS):
    for name, data in corpus:
        svc.submit(name, data)
    svc.flush()
    return svc


def _state(svc, corpus=CORPUS):
    """Everything that must be bit-identical: recipes with shard lists,
    per-shard accounting, totals and restored bytes."""
    recs = {name: svc.recipes.get(name).to_json() for name, _ in corpus}
    per_shard = [{k: v for k, v in s.items() if k != "fp_entries"}
                 for s in svc.shard_stats()]
    st = svc.stats()
    totals = (st.logical_bytes, st.stored_bytes, st.total_chunks,
              st.unique_chunks, st.dedup_ratio)
    restored = {name: svc.get(name) for name, _ in corpus}
    return recs, per_shard, totals, restored


@pytest.fixture(scope="module")
def reference_states():
    """The reference's sharded state per shard count (split path, packing
    off: the reference's own matrix pins its other cells to these)."""
    out = {}
    for n in (1, 2, 4):
        with JSharded(n, params=P, pipeline_impl="split",
                      packing_impl="off", **KW) as svc:
            out[n] = _state(_ingest(svc))
    for name, data in CORPUS:
        assert out[1][3][name] == data
    return out


@pytest.mark.parametrize("packing_impl", ("off", "segments"))
@pytest.mark.parametrize("num_shards", (1, 2, 4))
@pytest.mark.parametrize("pipeline_impl", ("split", "fused"))
def test_matrix_sharded(pipeline_impl, num_shards, packing_impl,
                        reference_states):
    with ShardedDedupService(
            num_shards, params=TP, device="cpu",
            pipeline_impl=pipeline_impl, packing_impl=packing_impl,
            cross_check_pipeline=True, cross_check_packing=True,
            **KW) as svc:
        got = _state(_ingest(svc))
        label = f"shards={num_shards}/{pipeline_impl}/{packing_impl}"
        want = reference_states[num_shards]
        assert got[0] == want[0], f"{label}: recipes"
        assert got[1] == want[1], f"{label}: per-shard accounting"
        assert got[2] == want[2], f"{label}: totals"
        assert got[3] == want[3], f"{label}: restored bytes"
        # N owner-local stores hold exactly the 1-shard service's bytes
        assert got[2][1:4] == reference_states[1][2][1:4], label
        for name, _ in CORPUS:
            r = svc.recipes.get(name)
            assert len(r.shards) == len(r.keys), label
        if packing_impl == "segments":
            assert svc.scheduler._packing_checked, label


@pytest.mark.parametrize("num_shards", (1, 3, 4))
def test_dist_index_host_half_matches_reference(num_shards):
    fps = np.random.default_rng(num_shards).integers(
        0, 1 << 31, (257, 2), dtype=np.int64).astype(np.uint32)
    np.testing.assert_array_equal(dist_index.route_host(fps, num_shards),
                                  jdist.route_host(fps, num_shards))
    assert dist_index.owner_of(12345, num_shards) == \
        jdist.owner_of(12345, num_shards)
    assert dist_index.suggested_capacity(1000, num_shards) == \
        jdist.suggested_capacity(1000, num_shards)


def test_mesh_is_not_ported():
    """``mesh=`` no longer raises: it takes the ``all_to_all`` route (held
    against the reference in test_torch_distributed.py), and a mesh whose
    axis does not match the service is refused by name."""
    from repro_torch.launch.mesh import Mesh, make_host_mesh

    with pytest.raises(ValueError, match="no axis 'data'"):
        ShardedDedupService(2, params=TP, device="cpu",
                            mesh=Mesh({"x": 2}, ["cpu"] * 2))
    svc = ShardedDedupService(2, params=TP, device="cpu",
                              mesh=make_host_mesh(shards=2, device="cpu"))
    assert svc.overflow_rerouted == 0
    svc.close()


@pytest.mark.timeout(240)
def test_remote_transport_matches_local(tmp_path):
    """Two spawned port shard servers hold the same bytes and answer the
    same restores as the in-process stores."""
    corpus = CORPUS[:10]
    with ShardedDedupService(2, params=TP, device="cpu",
                             packing_impl="segments", **KW) as local:
        want = _state(_ingest(local, corpus), corpus)
    svc = ShardedDedupService.open(
        str(tmp_path / "depot"), 2, params=TP, device="cpu",
        transport="remote", packing_impl="segments", **KW)
    try:
        assert len(svc._servers) == 2
        assert all(h.proc.poll() is None for h in svc._servers)
        assert _state(_ingest(svc, corpus), corpus) == want
        assert svc.gc().freed_blocks == 0
    finally:
        svc.close()
    for h in svc._servers:
        assert h.proc.wait(timeout=30) is not None


def _open(pkg, root, transport):
    if pkg == "port":
        return ShardedDedupService.open(root, 2, params=TP, device="cpu",
                                        transport=transport, **KW)
    return JSharded.open(root, 2, params=P, transport=transport,
                         pipeline_impl="split", packing_impl="off", **KW)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("transport", ("local", "remote"))
@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_sharded_depot_interchange(tmp_path, transport, first, second):
    """A 2-shard depot written by one package reopens under the other,
    restores SHA-verified, takes new objects with the same per-shard
    accounting, and reopens under the first again."""
    root = str(tmp_path / "depot")
    half = len(CORPUS) // 2
    with _open(first, root, "local") as svc:
        _ingest(svc, CORPUS[:half])
    with _open(second, root, transport) as svc:
        for name, data in CORPUS[:half]:
            assert svc.get(name) == data
        _ingest(svc, CORPUS[half:])
        shards = svc.shard_stats()
        assert svc.gc().freed_blocks == 0
    with _open(first, root, transport) as svc:
        for name, data in CORPUS:
            assert svc.get(name) == data
        assert [s["stored_bytes"] for s in svc.shard_stats()] == \
            [s["stored_bytes"] for s in shards]


def _tree(root):
    """Every file of a depot, by relative path, with its bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_sharded_depot_layout_is_the_references(tmp_path):
    """The same corpus written by each package gives the same depot, file
    for file and byte for byte: sharding.json, recipes.json with the shard
    lists, every shard's manifest and block files."""
    roots = {pkg: str(tmp_path / pkg) for pkg in ("port", "ref")}
    for pkg, root in roots.items():
        with _open(pkg, root, "local") as svc:
            _ingest(svc)
    port, ref = _tree(roots["port"]), _tree(roots["ref"])
    assert "sharding.json" in port and "recipes.json" in port
    assert sorted(port) == sorted(ref)
    for rel in ref:
        assert port[rel] == ref[rel], rel
