"""The port's scenario engine and its hardware-independent numbers against
the JAX package, on the CPU.

Three checks of the north star's "same hardware-independent numbers":

* each scenario's corpus (``repro_torch.scenarios``, a numpy copy) is
  byte-identical to the reference's at the ``tiny`` and ``quick``
  budgets (``corpus_digest``), with the same ``bench_params``;
* the port's ``DedupService`` on the CPU at
  ``benchmarks/bench_scenarios.py``'s settings (``bench_params``, zlib,
  fingerprints on, 8 slots, packing off), on the split path the bench
  pins and on the fused path the port runs by default, gives the dedup and
  compressed ratios of ``BENCH_quick.json`` to the last digit;
* the port's ``ChunkScheduler`` gives the occupancy of
  ``benchmarks/bench_scheduler_occupancy.py``'s all-tiny draw pinned in
  ``BENCH_quick.json`` (and ``tests/test_occupancy.py``), packing off and
  on.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro.scenarios import SCENARIOS as REF_SCENARIOS
from repro.scenarios import bench_params as ref_bench_params
from repro.scenarios import corpus_digest as ref_digest
from repro.scenarios import generate as ref_generate

from repro_torch.core.params import derived_params
from repro_torch.scenarios import SCENARIOS, bench_params, corpus_digest, generate
from repro_torch.service import ChunkScheduler, DedupService

ROOT = os.path.join(os.path.dirname(__file__), "..")
MiB = 1 << 20


def _bench_quick():
    with open(os.path.join(ROOT, "BENCH_quick.json")) as f:
        return json.load(f)["results"]


def _scenario_rows():
    return {r["scenario"]: r for r in _bench_quick()
            if r.get("bench", "").startswith("scenarios:")}


def _occupancy_rows():
    return {(r["dist"], r["packing_impl"]): r for r in _bench_quick()
            if r.get("bench", "").startswith("scheduler occupancy")}


def test_catalog_equals_reference():
    assert list(SCENARIOS) == list(REF_SCENARIOS)
    for name, sc in SCENARIOS.items():
        ref = REF_SCENARIOS[name]
        assert (sc.seed, sc.summary, sc.avg_chunk) == (
            ref.seed, ref.summary, ref.avg_chunk)


@pytest.mark.parametrize("budget", ["tiny", "quick"])
@pytest.mark.parametrize("name", sorted(REF_SCENARIOS))
def test_corpus_digest_equals_reference(name, budget):
    got = generate(name, budget)
    want = ref_generate(name, budget)
    assert corpus_digest(got) == ref_digest(want)
    assert [n for n, _ in got.objects] == [n for n, _ in want.objects]
    assert dataclasses.asdict(got.expected) == dataclasses.asdict(
        want.expected)
    assert dataclasses.asdict(bench_params(name, budget)) == \
        dataclasses.asdict(ref_bench_params(name, budget))


def test_zipf_sampler_draws_what_numpy_2_0_draws():
    """The port's Zipf sampler gives ``Generator.zipf`` as numpy 2.0
    (this environment's, and ``BENCH_quick.json``'s) draws it, and leaves
    the generator where numpy's sampler leaves it; the pins below are
    numpy 2.0.2's, so the check holds under any numpy (numpy 2.1 changed
    its sampler, and with it ``lm_text``'s corpus)."""
    import hashlib

    from repro_torch.scenarios.generators import _zipf

    rng = np.random.default_rng(1)
    assert _zipf(rng, 1.3, 10).tolist() == [1, 3, 351, 14, 106, 3, 1, 2,
                                            102, 13]
    assert rng.random() == 0.16065200877512686
    h = hashlib.sha256()
    for seed in range(50):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 3000))
        h.update(_zipf(rng, 1.3, n).tobytes())
        h.update(np.float64(rng.random()).tobytes())
    assert h.hexdigest() == ("5eb0a0cd6a0daad5a3b6a9bb095c56445d7943871756691"
                             "f77f0fe8906191bd2")


@pytest.mark.parametrize("pipeline_impl", ["split", "fused"])
@pytest.mark.parametrize("name", sorted(REF_SCENARIOS))
def test_service_ratios_equal_bench_quick(name, pipeline_impl):
    want = _scenario_rows()[name]
    corpus = generate(name, "quick")
    svc = DedupService(params=bench_params(name, "quick"), device="cpu",
                       slots=8, mask_impl="torch", fp_impl="torch",
                       pipeline_impl=pipeline_impl, packing_impl="off",
                       codec="zlib")
    for obj_name, data in corpus.objects:
        svc.submit(obj_name, data)
    svc.flush()
    st = svc.stats()
    assert st.dedup_ratio == want["dedup_ratio"]
    assert st.compressed_ratio == want["compressed_ratio"]
    assert (st.total_chunks, st.unique_chunks) == (want["chunks"],
                                                   want["unique_chunks"])
    assert corpus.expected.check_ratio(st.dedup_ratio)
    name0, data0 = corpus.objects[-1]
    assert svc.get(name0) == np.ascontiguousarray(data0).tobytes()


def _all_tiny_occupancy(packing_impl: str) -> float:
    """``bench_scheduler_occupancy.py``'s all-tiny row at the quick budget
    (2 MiB of 100-999 B streams drawn from seed 17, fingerprints off)
    through the port's scheduler."""
    rng = np.random.default_rng(17)
    lengths, acc = [], 0
    while acc < 2 * MiB:
        n = int(rng.integers(100, 1000))
        lengths.append(n)
        acc += n
    sched = ChunkScheduler(derived_params(8192), device="cpu", slots=8,
                           mask_impl="torch", step_impl="wide",
                           packing_impl=packing_impl,
                           with_fingerprints=False)
    payload = rng.integers(0, 256, int(sum(lengths)), dtype=np.uint8)
    off = 0
    for n in lengths:
        sched.submit(payload[off:off + n])
        off += n
    assert len(sched.drain()) == len(lengths)
    return sched.stats.occupancy


@pytest.mark.parametrize("packing_impl,pin", [("off", 0.03356),
                                              ("segments", 0.89514)])
def test_all_tiny_occupancy_equals_bench_quick(packing_impl, pin):
    occ = _all_tiny_occupancy(packing_impl)
    assert occ == _occupancy_rows()[("all_tiny", packing_impl)]["occupancy"]
    assert round(occ, 5) == pin
