"""Training the port's recurrent families: the three scans' backwards
against autograd and against the JAX package, on the CPU.

Each scan's call that needs a gradient goes through its
``torch.autograd.Function`` (``LinearScan``, ``MLSTMScan``,
``SLSTMScan``), whose backward is a CUDA kernel on the card and, on a CPU
tensor, the plain backward written out in torch (``*_bwd_plain``).  Here:

(a) each plain backward against torch autograd of its own plain forward,
    in float64, random upstream gradients on every output: within 1e-10;
(b) each block's vector-Jacobian product (``rglru_block``, ``mlstm_block``,
    ``slstm_block``, from a carried state) against ``jax.vjp`` of the
    reference's block at reduced size, the weights carried across with
    ``params_from_jax``;
(c) the whole model: every gradient leaf of reduced recurrentgemma-2b and
    xlstm-125m against ``jax.grad`` of the reference's loss (three AdamW
    steps against the reference's are ``tests/test_torch_train.py``'s
    ``test_three_train_steps_match_reference``).

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import ssm as jssm

from repro_torch._tree import leaves
from repro_torch.configs import get_reduced
from repro_torch.kernels import linear_scan as kscan
from repro_torch.kernels import mlstm_scan as kmlstm
from repro_torch.kernels import slstm_scan as kslstm
from repro_torch.models import rglru, ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import grads_and_metrics

#: (a): a plain backward against autograd of its forward, both float64:
#: the same products summed in another order
F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    yield
    jax.clear_caches()


def _f64(rng, shape, lo=None, hi=None, std=1.0):
    x = (rng.uniform(lo, hi, shape) if lo is not None
         else rng.standard_normal(shape) * std)
    return torch.from_numpy(x).requires_grad_(True)


def _vjp(outs, ins, grads):
    """Autograd's vector-Jacobian product of ``outs`` at ``grads`` (zero
    for an input the outputs do not read: ``a`` of a one-step scan from
    zeros)."""
    return torch.autograd.grad(
        sum((o * g).sum() for o, g in zip(outs, grads)), ins,
        materialize_grads=True)


def _like(rng, outs):
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape))).to(o.dtype)
            for o in outs]


# -- (a) the plain backwards against autograd ---------------------------------


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("T,N", [(1, 5), (130, 33), (300, 40)])
def test_linear_scan_bwd_plain_is_autograd_of_the_plain_scan(T, N, with_h0):
    """T not a multiple of the kernel's 128-step tile, N not a multiple of
    its 32 channels."""
    rng = np.random.default_rng(T + N)
    a, b = _f64(rng, (2, T, N), 0.0, 0.95), _f64(rng, (2, T, N), std=0.5)
    h0 = _f64(rng, (2, N)) if with_h0 else None
    h, last = kscan.linear_scan_plain(a, b, h0)
    g, g_last = _like(rng, (h, last))
    ins = (a, b) + ((h0,) if with_h0 else ())
    want = _vjp((h, last), ins, (g, g_last))
    da, db, dh0 = kscan.linear_scan_bwd_plain(a.detach(), h.detach(), h0,
                                              g, g_last)
    got = (da, db) + ((dh0,) if with_h0 else ())
    assert dh0 is None or with_h0
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, **F64)
    # the Function takes the plain backward on a CPU tensor
    h2, last2 = kscan.linear_scan(a, b, h0)
    for x, w in zip(_vjp((h2, last2), ins, (g, g_last)), want):
        torch.testing.assert_close(x, w, **F64)


def _mlstm_inputs(rng, nc, carried, B=2, H=3, hd=5):
    ins = [_f64(rng, (B, nc, H), -5.0, 0.0), _f64(rng, (B, nc, H)),
           _f64(rng, (B, nc, H, hd, hd)), _f64(rng, (B, nc, H, hd))]
    if carried:
        ins += [_f64(rng, (B, H, hd, hd)), _f64(rng, (B, H, hd)),
                _f64(rng, (B, H))]
    else:  # the model's initial state: zeros and m = -1e30
        ins += [torch.zeros((B, H, hd, hd), dtype=torch.float64,
                            requires_grad=True),
                torch.zeros((B, H, hd), dtype=torch.float64,
                            requires_grad=True),
                torch.full((B, H), -1e30, dtype=torch.float64,
                           requires_grad=True)]
    return ins


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("nc", [1, 2, 5])
def test_mlstm_scan_bwd_plain_is_autograd_of_the_plain_carry(nc, carried):
    """Gradients on all six outputs (the state at every chunk start, m's
    included: the model's g reads it), all seven inputs'."""
    rng = np.random.default_rng(10 * nc + carried)
    ins = _mlstm_inputs(rng, nc, carried)
    outs = kmlstm.mlstm_scan_plain(*ins)
    grads = _like(rng, outs)
    want = _vjp(outs, ins, grads)
    got = kmlstm.mlstm_scan_bwd_plain(*(t.detach() for t in ins[:4]),
                                      *(t.detach() for t in outs[:3]),
                                      *grads)
    for name, x, w in zip(("btot", "mc", "kv_sum", "k_sum", "C0", "n0", "m0"),
                          got, want):
        torch.testing.assert_close(x, w, **F64, msg=name)
    for x, w in zip(_vjp(kmlstm.mlstm_scan(*ins), ins, grads), want):
        torch.testing.assert_close(x, w, **F64)


def test_mlstm_scan_bwd_plain_splits_a_tie_of_the_max():
    """Where ``btot + m`` equals ``mc``, m1's gradient goes half to each,
    as torch's ``maximum`` (and JAX's ``max``) splits it."""
    rng = np.random.default_rng(3)
    ins = _mlstm_inputs(rng, 2, True)
    with torch.no_grad():
        ins[1][:, 0] = ins[0][:, 0] + ins[6]  # chunk 0: mc = btot + m0
    outs = kmlstm.mlstm_scan_plain(*ins)
    grads = _like(rng, outs)
    want = _vjp(outs, ins, grads)
    for x, w in zip(_vjp(kmlstm.mlstm_scan(*ins), ins, grads), want):
        torch.testing.assert_close(x, w, **F64)


def _slstm_inputs(rng, B, S, H, hd, dtype):
    D = H * hd
    xg = _f64(rng, (B, S, 4, D), std=0.5)
    r = _f64(rng, (4, H, hd, hd), std=0.3)
    st = [_f64(rng, (B, D), std=0.3), _f64(rng, (B, D)),
          _f64(rng, (B, D), 0.5, 2.0), _f64(rng, (B, D))]
    if dtype != torch.float64:
        xg, r = (t.detach().to(dtype).requires_grad_(True) for t in (xg, r))
        if dtype == torch.float32:
            st = [t.detach().float().requires_grad_(True) for t in st]
    return xg, r, st


def _slstm_outs(fn, xg, r, st):
    hs, fin = fn(xg, r, kslstm.SLSTMState(*st))
    return [hs, *fin]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16],
                         ids=["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 17])
@pytest.mark.parametrize("hd", [4, 8])
def test_slstm_scan_bwd_plain_is_autograd_of_the_plain_loop(hd, S, dtype):
    """Gradients on hs and the final state.  float64: every input's within
    1e-10.  float32 (xg, r and the state): the same float32 operations in
    another order, within 1e-5.  bfloat16 xg and r with a float64 state:
    autograd of the float64 loop on the same values, its xg and r
    gradients rounded once to bfloat16 (as the backward rounds them) and
    equal to within one bfloat16 step; the state's within 1e-10."""
    rng = np.random.default_rng(100 * hd + S)
    xg, r, st = _slstm_inputs(rng, 2, S, 2, hd, dtype)
    outs = _slstm_outs(kslstm.slstm_scan_plain, xg, r, st)
    grads = _like(rng, outs)
    if dtype == torch.bfloat16:  # autograd in float64 on the same values
        x64, r64 = (t.detach().double().requires_grad_(True) for t in (xg, r))
        want = list(_vjp(_slstm_outs(kslstm.slstm_scan_plain, x64, r64, st),
                         [x64, r64, *st], grads))
        want[:2] = [w.to(dtype) for w in want[:2]]
        tols = [dict(rtol=2 ** -8, atol=1e-10)] * 2 + [F64] * 4
    else:
        want = _vjp(outs, [xg, r, *st], grads)
        tols = [F64 if dtype == torch.float64 else
                dict(rtol=1e-5, atol=1e-5)] * 6
    hs, _, _, _, _ = (t.detach() for t in outs)
    _, _, cnm = kslstm.slstm_scan_plain(xg.detach(), r.detach(),
                                        kslstm.SLSTMState(*st), keep=True)
    dxg, dr, d0 = kslstm.slstm_scan_bwd_plain(
        xg.detach(), r.detach(), kslstm.SLSTMState(*st), hs, cnm.detach(),
        grads[0], kslstm.SLSTMState(*grads[1:]))
    assert dxg.dtype == xg.dtype and dr.dtype == r.dtype
    names = ("xg", "r", "h0", "c0", "n0", "m0")
    for name, x, w, tol in zip(names, (dxg, dr, *d0), want, tols):
        torch.testing.assert_close(x, w.to(x.dtype), **tol, msg=name)
    got = _vjp(_slstm_outs(kslstm.slstm_scan, xg, r, st), [xg, r, *st],
               grads)
    for name, x, w, tol in zip(names, got, want, tols):
        torch.testing.assert_close(x, w.to(x.dtype), **tol, msg=name)


def test_slstm_card_route_dr_sums_in_float64(monkeypatch):
    """The card route's ``dr`` (``_recurrent_grad_f64`` over the backward
    kernel's dpre) at 64 rows x 16 steps x 2 heads of 64, the float32 card
    case whose float32 sum missed ``ACCURACY``: the float64 contraction of
    ``h_{t-1}`` and dpre rounded once to float32, apart from the plain
    backward's float32 sum (``_recurrent_grad``) only by that sum's own
    rounding (at most ``n u / (1 - n u)`` of the sum of the terms' sizes,
    n = B S terms, u = 2^-24), and in chunks of rows within a float32 step
    of it."""
    B, S, H, hd = 64, 16, 2, 64
    D = H * hd
    rng = np.random.default_rng(64)
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    h0, hs, dpre, r = f32(B, D), f32(B, S, D), f32(B, S, 4, D), f32(
        4, H, hd, hd)
    hp = kslstm._prev_h(h0, hs).double().reshape(B, S, H, hd)
    dp = dpre.double().reshape(B, S, 4, H, hd)
    exact = torch.einsum("bshd,bsghe->ghde", hp, dp)
    sizes = torch.einsum("bshd,bsghe->ghde", hp.abs(), dp.abs())
    got = kslstm._recurrent_grad_f64(h0, hs, dpre, r)
    assert got.dtype == torch.float32
    assert torch.equal(got, exact.float())
    plain = kslstm._recurrent_grad(h0, hs, dpre, r)
    n, u = B * S, 2.0 ** -24
    gap = (plain.double() - got.double()).abs()
    assert bool((gap <= n * u / (1 - n * u) * sizes + u * exact.abs()).all())
    assert float(gap.max()) > 0  # the float32 sum rounds along the way
    monkeypatch.setattr(kslstm, "_F64_CHUNK", 5 * S * 4 * D)  # 13 chunks
    chunked = kslstm._recurrent_grad_f64(h0, hs, dpre, r)
    torch.testing.assert_close(chunked.double(), exact, rtol=2.0 ** -23,
                               atol=1e-12 * float(sizes.max()))


def test_slstm_scan_bwd_plain_splits_ties_as_the_reference():
    """Both maxes of the cell at a tie: ``f_pre + m = i_pre`` (m1) and
    ``f n + i = 1e-6`` (the normaliser's floor, the reference's
    ``jnp.maximum``): the gradient splits evenly, as autograd of the plain
    loop (``torch.maximum``) splits it."""
    rng = np.random.default_rng(5)
    xg, r, st = _slstm_inputs(rng, 1, 1, 1, 4, torch.float64)
    with torch.no_grad():
        r.zero_()  # pre = xg: the ties are set by xg and the state alone
        xg[0, 0, 0, 0] = xg[0, 0, 1, 0] + st[3][0, 0]  # i_pre = f_pre + m
        # channel 1: m1 = f_pre + m = 0, i = exp(-1000) = 0, f = 1, so
        # f n + i = n: the state's n at the floor
        xg[0, 0, 1, 1], st[3][0, 1] = 0.0, 0.0
        xg[0, 0, 0, 1] = -1000.0
        st[2][0, 1] = 1e-6
    outs = _slstm_outs(kslstm.slstm_scan_plain, xg, r, st)
    assert float(outs[3][0, 1].detach()) == 1e-6
    grads = _like(rng, outs)
    want = _vjp(outs, [xg, r, *st], grads)
    got = _vjp(_slstm_outs(kslstm.slstm_scan, xg, r, st), [xg, r, *st],
               grads)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, **F64)


# -- (b) each block's VJP against jax.vjp of the reference's ------------------

#: float32 blocks against XLA's: the products blocked and summed in other
#: orders by both packages, gradients through tens of steps of a recurrence;
#: per leaf, ``|got - want| <= BLOCK_RTOL |want| + BLOCK_FLOOR max|want|``
#: (the floor relative to the leaf's largest gradient)
BLOCK_RTOL, BLOCK_FLOOR = 1e-4, 1e-5

#: (B, S): crosses the reduced mLSTM's chunk of 32 (a ragged tail), and is
#: no multiple of the linear scan's tile
BLOCK_B, BLOCK_S = 2, 40


def _block_params(template, seed):
    jp = jlayers.init_tree(template, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _normal(rng, shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _block_case(kind, rng):
    """(port block, reference block, cfg, jcfg, jp, p, state arrays, state
    types): a reduced config's block from a carried, non-zero state."""
    arch = "recurrentgemma-2b" if kind == "rglru" else "xlstm-125m"
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    B, D = BLOCK_B, cfg.d_model
    if kind == "rglru":
        jp, p = _block_params(jrglru.rglru_template(jcfg), 1)
        W = cfg.lru_width
        st = [_normal(rng, (B, W)), _normal(rng, (B, cfg.conv_width - 1, W))]
        return (rglru.rglru_block, jrglru.rglru_block, cfg, jcfg, jp, p, st,
                (rglru.RGLRUState, jrglru.RGLRUState))
    if kind == "mlstm":
        jp, p = _block_params(jssm.mlstm_template(jcfg), 2)
        H = cfg.n_heads
        hd = int(D * cfg.mlstm_proj_factor) // H
        st = [_normal(rng, (B, H, hd, hd), 0.1), _normal(rng, (B, H, hd), 0.1),
              _normal(rng, (B, H))]
        return (ssm.mlstm_block, jssm.mlstm_block, cfg, jcfg, jp, p, st,
                (ssm.MLSTMState, jssm.MLSTMState))
    jp, p = _block_params(jssm.slstm_template(jcfg), 3)
    st = [_normal(rng, (B, D), 0.3), _normal(rng, (B, D)),
          rng.uniform(0.5, 2.0, (B, D)).astype(np.float32),
          _normal(rng, (B, D))]
    return (ssm.slstm_block, jssm.slstm_block, cfg, jcfg, jp, p, st,
            (kslstm.SLSTMState, jssm.SLSTMState))


def _hold_leaves(got, want, rtol, floor, label):
    """Leaf by leaf: ``|got - want| <= rtol |want| + floor``."""
    for (name, g), w in zip(got, want):
        g = np.asarray(g, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape, (label, name)
        err = np.abs(g - w) - rtol * np.abs(w)
        assert float(err.max()) <= floor, (
            f"{label} {name}: max |got - want| "
            f"{float(np.abs(g - w).max()):.3g} against {floor:.3g} + "
            f"{rtol:g} |want| (largest |want| {float(np.abs(w).max()):.3g})")


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_block_vjp_matches_jax_vjp(kind):
    """Gradients of the block's output and new state (random cotangents)
    with respect to its weights, its input and its initial state."""
    rng = np.random.default_rng({"rglru": 1, "mlstm": 2, "slstm": 3}[kind])
    block, jblock, cfg, jcfg, jp, p, st, (Port, Ref) = _block_case(kind, rng)
    x = _normal(rng, (BLOCK_B, BLOCK_S, cfg.d_model), 0.5)

    def jfn(jp, x, st):
        return jblock(jp, x, jcfg, state=Ref(*st))

    (jout, jst), vjp = jax.vjp(jfn, jp, jnp.asarray(x),
                               [jnp.asarray(s) for s in st])
    cts = [_normal(rng, np.shape(o)) for o in (jout, *jst)]
    jg_p, jg_x, jg_st = vjp((jnp.asarray(cts[0]),
                             Ref(*(jnp.asarray(c) for c in cts[1:]))))

    tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = [torch.from_numpy(s).requires_grad_(True) for s in st]
    out, new = block(tp, tx, cfg, state=Port(*tst))
    names = sorted(tp)
    grads = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum()
            for o, c in zip((out, *new), cts)),
        [tp[k] for k in names] + [tx] + tst)
    want = [jg_p[k] for k in names] + [jg_x] + list(jg_st)
    labels = names + ["x"] + [f"state.{f}" for f in Port._fields]
    for name, g, w in zip(labels, grads, want):
        w = np.asarray(w)
        _hold_leaves([(name, g.numpy())], [w], BLOCK_RTOL,
                     BLOCK_FLOOR * float(np.abs(w).max()), kind)


# -- (c) the whole model's gradient against jax.grad --------------------------

#: float32 whole-model gradients against the reference's: per leaf,
#: ``|got - want| <= MODEL_RTOL |want| + MODEL_FLOOR g_max``, the floor tied
#: to the whole gradient's largest value ``g_max``.  A leaf-relative floor
#: cannot hold for every leaf: the sLSTM's input-gate bias (``bi``) has a
#: gradient that is zero in exact arithmetic (a common shift of every
#: ``i_pre`` scales c and n alike, so h does not move) and is rounding
#: noise in both packages, about 1e-10 against a g_max near 1, differing
#: there by 100% of itself
MODEL_RTOL, MODEL_FLOOR = 1e-4, 1e-6


def _model(arch, seed=0):
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, params, jparams


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_model_gradients_match_jax_grad_leaf_by_leaf(arch):
    """Reduced config, 2 x 40 tokens (the window of 32 and the mLSTM chunk
    of 32 both crossed), a fifth of the labels masked; the port's
    ``grads_and_metrics`` (the scans' Functions, their plain backwards on
    the CPU) against ``jax.grad`` of the reference's
    ``lm.loss_and_metrics``."""
    cfg, jcfg, params, jparams = _model(arch)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    lab[:, ::5] = -1
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    jgrads = jax.grad(lambda p: jlm.loss_and_metrics(jcfg, p, batch)[0])(
        jparams)
    grads, m = grads_and_metrics(cfg, params, {
        "tokens": torch.from_numpy(tok).long(),
        "labels": torch.from_numpy(lab).long()})
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    got = leaves(grads)
    assert len(got) == len(want)
    g_max = max(float(np.abs(w).max()) for w in want)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jgrads)]
    _hold_leaves(list(zip(paths, (g.numpy() for g in got))), want,
                 MODEL_RTOL, MODEL_FLOOR * g_max, arch)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert float(m["loss"]) == pytest.approx(float(jlm.loss_and_metrics(
        jcfg, jparams, batch)[0]), rel=2e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_remat_gives_equal_gradients_through_the_scans(arch, remat):
    """Under remat the backward recomputes each block, the scans' Functions
    and what they save included (the published configs train so: full and
    dots): the gradients equal those without it, as
    ``tests/test_torch_train.py`` holds llama3.2-1b's."""
    from repro_torch.models import lm

    cfg = get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 40)))
    batch = {"tokens": tok, "labels": tok}
    g0, m0 = grads_and_metrics(cfg, params, batch)
    g1, m1 = grads_and_metrics(cfg.replace(remat=remat), params, batch)
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
