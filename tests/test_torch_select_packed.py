"""The packed select kernel's wrapper and its route through the packed
split path, against the JAX reference, on the CPU.

``kernels.select_boundaries_packed.select_boundaries_packed`` takes its
plain version (``core.automaton.select_boundaries_packed``) for CPU
tensors.  Here, on seeded bitmaps clipped per segment
(``_select_packed_cases.py``):

* the wrapper's CPU route against the reference's
  ``select_boundaries_packed`` (vmapped over rows) on ``chip_smoke.py``'s
  three segment mixes, empty streams, segments shorter than L-1, padding
  past the payload end, G = 1 (also against the unpacked
  ``select_boundaries``) and an undersized ``max_chunks``; and against the
  kernel's design emulated in torch: each segment of min_size or more
  chunked alone by the unpacked plain automaton, a shorter one a chunk of
  its own length, the bounds placed in order, emits past ``max_chunks``
  dropped and the fix-up at the payload end;
* ``boundaries_packed_batch(select_impl="cuda")`` equal to ``"torch"``;
* the scheduler's packed split and chunk-only dispatches call the wrapper.

Every output is an integer: tolerance 0.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _packing_cases
import _select_packed_cases as cases

from repro.core import automaton as jautomaton
from repro.core.params import SeqCDCParams as JParams

import repro_torch
from repro_torch.core import automaton as tautomaton
from repro_torch.core.oracle import boundaries_numpy
from repro_torch.core.seqcdc import (
    boundaries_packed_batch,
    segment_end_positions,
)
from repro_torch.kernels import select_boundaries_packed as kselp
from repro_torch.service import ChunkScheduler

ROOT = os.path.join(os.path.dirname(__file__), "..")

JPARAMS = {"small": JParams(**cases.SMALL),
           "paper8k": JParams(**cases.PAPER8K)}


def tp(name):
    return repro_torch.params_from_reference(JPARAMS[name])


@functools.lru_cache(maxsize=None)
def _jselect_packed(pname, mc):
    """The reference's packed automaton over a batch of rows, jitted once
    a parameter set and table width."""
    p = JPARAMS[pname]
    return jax.jit(jax.vmap(
        lambda c, o, e: jautomaton.select_boundaries_packed(
            c, o, e, p, max_chunks=mc)))


def _mixes():
    """Two 16 KiB rows of each of ``chip_smoke.py``'s segment mixes at
    paper 8 KiB parameters, one table wide enough for all."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    S = 16 << 10
    rng = np.random.default_rng(7)
    rows = []
    for mix in smoke.PACKED_MIXES:
        rows += [[seg.size for seg in row]
                 for row in smoke.packed_rows(rng, mix, 2, S)[2]]
    ends = cases.ends_table(rows)
    cand, opp = cases.clipped_bitmaps(rng, ends, S, cases.PAPER8K[
        "seq_length"], cases.DENSITY["paper8k"])
    return ends, cand, opp


def _case(name):
    """``(params name, ends, cand, opp, max_chunks)`` of one test case."""
    if name == "mixes":
        ends, cand, opp = _mixes()
        pname = "paper8k"
    else:
        ends, cand, opp = cases.edge_case(name.split(" ")[0])
        pname = "small"
    S, G = cand.shape[1], ends.shape[1]
    mc = cases.true_max_chunks(S, JPARAMS[pname].min_size, G)
    if name.startswith("random short"):  # the fullest row keeps fewer
        full = kselp.select_boundaries_packed(
            torch.from_numpy(cand), torch.from_numpy(opp),
            torch.from_numpy(ends), tp(pname), max_chunks=mc)[1]
        mc = max(1, int(full.max()) - int(name.split(" ")[-1]))
    return pname, ends, cand, opp, mc


def _segments_alone(cand, opp, ends, p, mc):
    """The kernel's design in torch: each segment of min_size or more
    chunked alone by the unpacked plain automaton on its own bits, a
    shorter one a chunk of its own length, the bounds placed in segment
    order, emits past ``mc`` dropped (and counted), then the fix-up at the
    payload end."""
    B = ends.shape[0]
    bounds = np.full((B, mc), 1 << 30, np.int32)
    counts = np.zeros(B, np.int32)
    for bi in range(B):
        out, st = [], 0
        for e in ends[bi].tolist():
            seg = e - st
            if seg >= p.min_size:
                b, c = tautomaton.select_boundaries(
                    torch.from_numpy(cand[bi:bi + 1, st:e].copy()),
                    torch.from_numpy(opp[bi:bi + 1, st:e].copy()), seg, p)
                out += (b[0, :int(c[0])].numpy().astype(np.int64)
                        + st).tolist()
            elif seg > 0:
                out.append(e)
            st = e
        kept = min(len(out), mc)
        bounds[bi, :kept] = out[:kept]
        c, n_row = len(out), int(ends[bi, -1])
        if (out[kept - 1] if kept else 0) < n_row and n_row > 0:
            if c < mc:
                bounds[bi, c] = n_row
            c += 1
        counts[bi] = c
    return bounds, counts


@pytest.mark.parametrize("name", ("mixes",) + cases.EDGES
                         + ("random short 1", "random short 3"))
def test_select_packed_cpu_route_matches_reference(name):
    pname, ends, cand, opp, mc = _case(name)
    got_b, got_c = kselp.select_boundaries_packed(
        torch.from_numpy(cand), torch.from_numpy(opp),
        torch.from_numpy(ends), tp(pname), max_chunks=mc)
    assert got_b.dtype == torch.int32 and got_c.dtype == torch.int32
    want_b, want_c = _jselect_packed(pname, mc)(
        jnp.asarray(cand), jnp.asarray(opp), jnp.asarray(ends))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    alone_b, alone_c = _segments_alone(cand, opp, ends, tp(pname), mc)
    np.testing.assert_array_equal(got_c.numpy(), alone_c)
    np.testing.assert_array_equal(got_b.numpy(), alone_b)
    if name == "G1":  # one segment filling the row: the unpacked automaton
        S = cand.shape[1]
        ub, uc = jax.jit(jax.vmap(lambda c, o: jautomaton.select_boundaries(
            c, o, S, JPARAMS[pname], max_chunks=mc)))(
                jnp.asarray(cand), jnp.asarray(opp))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(uc))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(ub))
    if name.startswith("random short"):
        assert int(got_c.max()) > mc  # emits were dropped


@pytest.mark.parametrize("select_impl", ["cuda", "bogus"])
def test_boundaries_packed_batch_select_impl(select_impl):
    """On CPU tensors ``select_impl="cuda"`` (the packed select kernel's
    wrapper, its plain version here) gives ``"torch"``'s bounds and
    counts; a name that is neither raises."""
    pname, S, rows = _packing_cases.case("random-increasing")
    p = repro_torch.params_from_reference(
        JParams(**_packing_cases.PARAMS[pname]))
    data, _, ends, _ = _packing_cases.pack(rows, S)
    x, e = torch.from_numpy(data), torch.from_numpy(ends)
    sep = segment_end_positions(e, S)
    mc = cases.true_max_chunks(S, p.min_size, ends.shape[1])
    if select_impl == "bogus":
        with pytest.raises(ValueError, match="select_impl"):
            boundaries_packed_batch(x, sep, e, p, select_impl=select_impl,
                                    max_chunks=mc)
        return
    got = boundaries_packed_batch(x, sep, e, p, select_impl=select_impl,
                                  max_chunks=mc)
    want = boundaries_packed_batch(x, sep, e, p, max_chunks=mc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_select_packed_wrapper_rejects_what_the_kernel_does_not_take():
    p = tp("small")
    e = torch.full((1, 4), 100, dtype=torch.int32)
    wide = torch.zeros((1, 1 << 17), dtype=torch.bool)
    with pytest.raises(ValueError, match="narrower"):
        kselp.select_boundaries_packed(wide, wide, e, p, max_chunks=8)
    x = torch.zeros((1, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bool"):
        kselp.select_boundaries_packed(x, x, e, p, max_chunks=8)
    b = torch.zeros((1, 1024), dtype=torch.bool)
    with pytest.raises(ValueError, match="bitmaps"):
        kselp.select_boundaries_packed(b, b[:, :512], e, p, max_chunks=8)


@pytest.mark.parametrize("pipeline_impl,with_fp,calls", [
    ("split", True, True), ("split", False, True), ("fused", False, True),
    ("fused", True, False)])
def test_packed_dispatches_run_the_packed_select(monkeypatch, pipeline_impl,
                                                 with_fp, calls):
    """The scheduler's packed split and chunk-only dispatches run the
    automaton through the packed select kernel's wrapper (interposed
    here); with fingerprints the fused pipeline takes the packed kernel
    instead.  The streams' chunks equal each stream chunked alone."""
    seen = []
    real = kselp.select_boundaries_packed

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(kselp, "select_boundaries_packed", spy)
    p = tp("small")
    sched = ChunkScheduler(p, device="cpu", slots=2, min_bucket=4096,
                           packing_impl="segments",
                           pipeline_impl=pipeline_impl,
                           with_fingerprints=with_fp)
    rng = np.random.default_rng(9)
    streams = [rng.integers(0, 256, int(n), dtype=np.uint8)
               for n in rng.integers(100, 900, 12)]
    for s in streams:
        sched.submit(s)
    results = sched.drain()
    assert bool(seen) == calls
    assert sched.stats.packed_streams == len(streams)
    for s, r in zip(streams, results):
        assert r.bounds.tolist() == boundaries_numpy(s, p).tolist()
