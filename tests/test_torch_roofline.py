"""The port's roofline layer against the reference's.

The ring model, the ``Roofline`` terms and ``model_flops_for`` against
``repro/roofline/analyze.py`` (the terms on H100 constants where the
reference's are a TPU's); the op counter (``roofline/cost.py``) counting
one rank's local FLOPs on a fake (4, 2) mesh; and its FLOPs for a reduced
llama train step against the reference's ``HloCostModel`` on the unrolled
compiled module.
"""
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.roofline import analyze as janalyze
from repro.roofline import constants as jconstants

from repro_torch import configs
from repro_torch.roofline import CostCounter, analyze, constants

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape", ["f32[1024]", "bf16[256,1024]",
                                   "s32[8,16,4]"])
def test_ring_model_matches_parse_collectives(kind, n, shape):
    """The same kind, output shape and group give the reference's
    ``parse_collectives`` bytes."""
    groups = 512 // n
    line = (f"  %c = {shape}{{0}} {kind}(%p), "
            f"replica_groups=[{groups},{n}]<=[512], to_apply=%add")
    text = f"HloModule t\nENTRY %main {{\n{line}\n}}\n"
    want = janalyze.parse_collectives(text).per_device_bytes
    nbytes = janalyze._shape_bytes(shape)
    assert analyze.ring_bytes(kind, nbytes, n) == pytest.approx(want)
    st = analyze.CollectiveStats()
    st.add(kind, nbytes, n)
    assert st.per_device_bytes == pytest.approx(want)
    rate = constants.NVLINK_BW if n <= 8 else constants.NETWORK_BW
    assert st.seconds == pytest.approx(want / rate)


def test_constants_h100():
    assert constants.PEAK_FLOPS_BF16 == 989e12
    assert constants.HBM_BW == 3.35e12
    assert constants.link_bw(8) == constants.NVLINK_BW == 450e9
    assert constants.link_bw(16) == constants.NETWORK_BW == 50e9
    assert constants.CHIP_HBM_BYTES > 80e9


def test_roofline_terms():
    """Twin of test_roofline.py's terms: one second each of compute, HBM
    and collective on H100 constants."""
    stats = analyze.CollectiveStats()
    stats.add("all-gather", 50e9 * 16 / 15, 16)  # 50 GB a device, network
    rl = analyze.Roofline(
        "a", "s", "m", 256,
        flops_per_device=989e12,
        bytes_per_device=3.35e12,
        collective=stats,
        model_flops=989e12 * 256 * 0.5,
    )
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(1.0)
    assert rl.t_collective == pytest.approx(1.0)
    assert rl.roofline_fraction == pytest.approx(0.5)
    assert rl.useful_flops_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_roofline_and_model_flops_match_reference(arch):
    jc, pc = jconfigs.get_config(arch), configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        want = janalyze.model_flops_for(jc, jconfigs.SHAPES[name])
        got = analyze.model_flops_for(pc, shape)
        assert got == want, (arch, name)
        flops, nbytes, coll = 3.1e14, 2.2e12, 4.0e10
        js = janalyze.CollectiveStats()
        js.add("all-gather", coll)
        ps = analyze.CollectiveStats()
        ps.add("all-gather", coll * 16 / 15, 16)
        jr = janalyze.Roofline(arch, name, "m", 256, flops, nbytes, js, want)
        pr = analyze.Roofline(arch, name, "m", 256, flops, nbytes, ps, got)
        assert pr.t_compute * constants.PEAK_FLOPS_BF16 == pytest.approx(
            jr.t_compute * jconstants.PEAK_FLOPS_BF16)
        assert pr.t_memory * constants.HBM_BW == pytest.approx(
            jr.t_memory * jconstants.HBM_BW)
        assert pr.t_collective * constants.NETWORK_BW == pytest.approx(
            jr.t_collective * jconstants.ICI_LINK_BW)
        assert pr.useful_flops_ratio == pytest.approx(jr.useful_flops_ratio)
        assert pr.roofline_fraction * constants.PEAK_FLOPS_BF16 == \
            pytest.approx(jr.roofline_fraction * jconstants.PEAK_FLOPS_BF16
                          * max(jr.t_compute, jr.t_memory, jr.t_collective)
                          / max(pr.t_compute, pr.t_memory, pr.t_collective))
        d = pr.to_dict()
        assert set(jr.to_dict()) <= set(d)
        assert d["bottleneck"] in ("compute", "memory", "collective")


def test_counter_counts_one_ranks_local_flops():
    """On a fake (4, 2) mesh the counter reads local shapes: a matmul with
    its batch on data and its output columns on model is global/8 FLOPs a
    rank; with both operands replicated every rank does the whole product.
    A redistribution is counted by the ring model."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import Mesh

    glob = 2 * 64 * 128 * 256
    with fake_world(Mesh({"data": 4, "model": 2})) as dm:
        a = DTensor.from_local(torch.empty(16, 128), dm,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(64, 128), stride=(128, 1))
        b = DTensor.from_local(torch.empty(128, 128), dm,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(128, 256), stride=(256, 1))
        c = CostCounter()
        with c:
            out = a @ b
        assert tuple(out.shape) == (64, 256)
        assert c.flops == glob / 8
        assert c.collectives.count == 0
        # local bytes: the (16, 128) and (128, 128) shards in, (16, 128) out
        assert c.bytes == 4 * (16 * 128 + 128 * 128 + 16 * 128)
        ra = DTensor.from_local(torch.empty(64, 128), dm,
                                [Replicate(), Replicate()], run_check=False)
        rb = DTensor.from_local(torch.empty(128, 256), dm,
                                [Replicate(), Replicate()], run_check=False)
        c = CostCounter()
        with c:
            ra @ rb
            a.redistribute(dm, [Replicate(), Replicate()])
        assert c.flops == glob
        # the all-gather of a's (64, 128) float32 over data's 4 ranks
        assert c.collectives.by_type == {
            "all-gather": pytest.approx(64 * 128 * 4 * 3 / 4)}


def test_counter_flops_match_hlo_cost_model_on_unrolled_train_step():
    """The counter's FLOPs for the port's train step of a 4-layer reduced
    llama (B 2, S 64) against the reference's ``HloCostModel`` on the
    compiled, unrolled reference step.  Both count every matrix product
    exactly (151.0 MFLOP of the ~160); the gap, about 2%, is in the
    elementwise ops, which the counter counts one a result element while
    XLA's fusions count theirs their own way, and in the optimizer's
    reductions; the tolerance is the reference's own between its model and
    XLA's ``cost_analysis`` (5%)."""
    from repro.configs import get_reduced as jget
    from repro.models import lm as jlm
    from repro.roofline.hlo_cost import HloCostModel
    from repro.train import OptConfig as JOpt
    from repro.train import make_train_step as jmake
    from repro.train import optim as joptim

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, make_train_step, opt_init

    B, S = 2, 64
    jc = jget("llama3.2-1b").replace(n_layers=4, scan_layers=False,
                                     attn_q_block=64)
    params = jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda: joptim.init(JOpt(), params))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    comp = jax.jit(jmake(jc, JOpt())).lower(params, opt, batch).compile()
    want = HloCostModel(comp.as_text()).total().flops

    pc = get_reduced("llama3.2-1b").replace(n_layers=4, attn_q_block=64)
    p = lm.init_params(pc, device="cpu")
    b = {"tokens": torch.zeros(B, S, dtype=torch.int64),
         "labels": torch.zeros(B, S, dtype=torch.int64)}
    c = CostCounter()
    with c:
        make_train_step(pc, OptConfig())(p, opt_init(OptConfig(), p), b)
    assert c.flops == pytest.approx(want, rel=0.05)
    matmul = sum(v for k, v in c.flops_by_op.items()
                 if k in ("aten.mm", "aten.bmm", "aten.addmm"))
    # forward 2·N·D + backward 4·N·D on the matrices, and attention's
    # two products a layer forward, four backward
    assert matmul == 150994944
