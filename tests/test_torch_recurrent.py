"""The port's recurrent and hybrid families against the JAX package on the
CPU.

Reduced ``recurrentgemma-2b`` (RG-LRU blocks and local-window MQA) and
``xlstm-125m`` (mLSTM and sLSTM), the reference's parameters carried
across with ``params_from_jax``.  On a CPU tensor each new kernel's
wrapper takes its plain version, so these tests hold the plain versions
(and the batched products around them) against the reference's
functions: ``rglru_scan`` against ``lax.associative_scan`` with a non-zero
initial state, ``mlstm_chunkwise`` (the chunk carry's plain loop) at a
multiple of the chunk and at ragged lengths, from zero and from a carried
state, ``slstm_block`` (the cell's plain loop) and its decode step,
flash attention at head width 256 with one KV head and a window, then
``lm.forward`` logits, prefill plus eight decode steps and the gradient
route.  Inputs are made with numpy from a seed and handed to both
packages.  Tolerances: the kernels' own (``TOLERANCE`` in each kernel
module: float32 forms that differ in summation order) for a scan alone,
and 3e-4 (the reference's decode-vs-forward test's) for a block or model,
whose products XLA and torch block differently.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs import param_count as j_param_count
from repro.kernels.flash_attn import flash_attention_pallas
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.attention import _flash_attention as j_flash

from repro_torch._tree import tree_map
from repro_torch.configs import get_config, get_reduced, param_count
from repro_torch.kernels import flash_attn as kflash
from repro_torch.kernels import linear_scan as kscan
from repro_torch.kernels import mlstm_scan as kmlstm
from repro_torch.kernels import slstm_scan as kslstm
from repro_torch.models import layers, lm, rglru, ssm, transformer
from repro_torch.models.convert import params_from_jax

ARCHS = ("recurrentgemma-2b", "xlstm-125m")
TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no trace of
    the reference made here outlives the file (ROADMAP.md section 3)."""
    yield
    jax.clear_caches()


def _cfgs(arch, **kw):
    return (get_reduced(arch).replace(**kw),
            j_get_reduced(arch).replace(**kw))


def _model(arch, seed=0, **kw):
    cfg, jcfg = _cfgs(arch, **kw)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, params, jparams


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _block_params(template, seed):
    jp = jlayers.init_tree(template, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _normal(seed, shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * std).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


def _states_close(got, want, tol=TOL):
    if isinstance(got, (list, tuple)) and not hasattr(got, "shape"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _states_close(g, w, tol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want, tol)


# -- configurations ----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_s(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(j_get_config(arch)))
    assert (dataclasses.asdict(get_reduced(arch))
            == dataclasses.asdict(j_get_reduced(arch)))
    assert param_count(get_config(arch)) == j_param_count(j_get_config(arch))


@pytest.mark.parametrize("arch,n_params,kinds", [
    ("recurrentgemma-2b", 3_549_614_080,
     [("rglru", 2), ("attn", 1)] * 8 + [("rglru", 2)]),
    ("xlstm-125m", 154_238_976, [("mlstm", 5), ("slstm", 1)] * 2)])
def test_full_width_template_is_the_reference_s(arch, n_params, kinds):
    """The template at the published size: the reference's segments and
    leaf shapes, and the analytic ``param_count``."""
    cfg = get_config(arch)
    assert transformer.segments(cfg) == kinds
    assert param_count(cfg)[0] == n_params
    got, want = [], []
    layers.template_map(lambda t: got.append(t.shape), lm.lm_template(cfg))
    jlayers.template_map(lambda t: want.append(t.shape),
                         jlm.lm_template(j_get_config(arch)))
    assert sorted(got) == sorted(want)


# -- the scans against the reference's functions -------------------------------


def test_rglru_scan_with_a_carried_state_matches_associative_scan():
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    jp, p = _block_params(jrglru.rglru_template(jcfg), 1)
    u = _normal(2, (2, 37, cfg.lru_width), 0.5)
    h0 = _normal(3, (2, cfg.lru_width))
    got, got_last = rglru.rglru_scan(p, torch.from_numpy(u),
                                     torch.from_numpy(h0))
    want, want_last = jrglru.rglru_scan(jp, jnp.asarray(u), jnp.asarray(h0))
    _close(got.numpy(), want, kscan.TOLERANCE)
    _close(got_last.numpy(), want_last, kscan.TOLERANCE)
    assert got_last.dtype == torch.float32


@pytest.mark.parametrize("T", [1, 2, 37, 64])
def test_linear_scan_plain_is_the_recurrence(T):
    """The log-depth plain version against the recurrence stepped in
    float64, with a, b as the kernel's card tests draw them."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0, 0.95, (3, T, 5)).astype(np.float32)
    b = (rng.standard_normal((3, T, 5)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((3, 5)).astype(np.float32)
    h = h0.astype(np.float64)
    want = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got, last = kscan.linear_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    _close(got.numpy(), np.stack(want, 1), kscan.TOLERANCE)
    _close(last.numpy(), want[-1], kscan.TOLERANCE)


def _tiled_scan(a, b, h0, walk=0):
    """The card kernel's order of composition (``csrc/linear_scan.cu``) in
    float32 numpy: each sub-chunk of ``SUB_STEPS`` steps scanned from h = 0
    with its running product of a; the tile's sub-chunks composed in order
    into each one's incoming map and the tile's aggregate ``(A_k, B_k)``;
    the carry into tile k the look-back's: from the nearest predecessor's
    inclusive prefix, forward through the aggregates after it,
    ``P_j = A_j P_{j-1} + B_j``; each output ``A_t h_in + B_t``.  With
    ``walk`` > 0, every tile k that is a multiple of it and at least it
    finds no prefix nearer than tile k - walk (the walk of a tile whose
    predecessors have only published their aggregates); else each meets
    its predecessor's prefix.  Steps past T are the identity map, as the
    kernel pads them."""
    f = np.float32
    Bn, T, N = a.shape
    W, L = kscan.TILE_STEPS // kscan.SUB_STEPS, kscan.SUB_STEPS
    out = np.empty((Bn, T, N), f)
    aggs, prefix = [], []
    for k, k0 in enumerate(range(0, T, kscan.TILE_STEPS)):
        va, vb = [], []
        for w in range(W):  # each sub-chunk's local scan
            ta, tb = [], []
            for u in range(L):
                t = k0 + w * L + u
                at = a[:, t] if t < T else np.ones((Bn, N), f)
                bt = b[:, t] if t < T else np.zeros((Bn, N), f)
                if u:
                    bt, at = at * tb[-1] + bt, at * ta[-1]
                ta.append(at.astype(f))
                tb.append(bt.astype(f))
            va.append(ta)
            vb.append(tb)
        A, Bm, inc = np.ones((Bn, N), f), np.zeros((Bn, N), f), []
        for w in range(W):  # warp 0: incoming maps and the aggregate
            inc.append((A, Bm))
            Bm, A = va[w][-1] * Bm + vb[w][-1], va[w][-1] * A
        aggs.append((A, Bm))
        if k == 0:
            carry = h0.astype(f)
        else:
            depth = walk if walk and k >= walk and k % walk == 0 else 1
            carry = prefix[k - depth]
            for j in range(k - depth + 1, k):
                carry = aggs[j][0] * carry + aggs[j][1]
        prefix.append(A * carry + Bm)
        for w in range(W):
            hw = inc[w][0] * carry + inc[w][1]
            for u in range(L):
                t = k0 + w * L + u
                if t < T:
                    out[:, t] = va[w][u] * hw + vb[w][u]
    return out


@pytest.mark.parametrize("walk", [0, 3])
@pytest.mark.parametrize("T", [1, kscan.TILE_STEPS - 1, kscan.TILE_STEPS,
                               kscan.TILE_STEPS + 1,
                               7 * kscan.TILE_STEPS + 50])
def test_tiled_linear_scan_order_matches_associative_scan(T, walk):
    """The kernel's sub-chunk, tile and look-back order of composition
    against the reference's ``rglru_scan`` (its ``a``, ``b`` from
    ``_lru_coeffs``, a non-zero h0 folded into the first step), at
    ``kscan.TOLERANCE``, each tile joined by its predecessor's prefix or
    every third through the aggregates after an earlier prefix; the two
    joins give the same bits, as the kernel's do whatever the timing."""
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    jp, _ = _block_params(jrglru.rglru_template(jcfg), 1)
    u = jnp.asarray(_normal(2, (2, T, cfg.lru_width), 0.5))
    h0 = _normal(3, (2, cfg.lru_width))
    a, b = (np.asarray(x) for x in jrglru._lru_coeffs(jp, u))
    want, want_last = jrglru.rglru_scan(jp, u, jnp.asarray(h0))
    got = _tiled_scan(a, b, h0, walk)
    _close(got, want, kscan.TOLERANCE)
    _close(got[:, -1], want_last, kscan.TOLERANCE)
    if walk:
        np.testing.assert_array_equal(got, _tiled_scan(a, b, h0))


def test_rglru_block_prefill_and_decode_match_reference():
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    jp, p = _block_params(jrglru.rglru_template(jcfg), 4)
    x = _normal(5, (2, 24, cfg.d_model), 0.3)
    out, st = rglru.rglru_block(p, torch.from_numpy(x), cfg)
    jout, jst = jrglru.rglru_block(jp, jnp.asarray(x), jcfg)
    _close(out.numpy(), jout, TOL)
    _states_close(st, jst)
    for t in range(4):
        xt = _normal(6 + t, (2, 1, cfg.d_model), 0.3)
        out, st = rglru.rglru_block(p, torch.from_numpy(xt), cfg, state=st,
                                    decode=True)
        jout, jst = jrglru.rglru_block(jp, jnp.asarray(xt), jcfg, state=jst,
                                       decode=True)
        _close(out.numpy(), jout, TOL, f"decode step {t}")
    _states_close(st, jst)


def _mlstm_case(seed, S):
    cfg, jcfg = _cfgs("xlstm-125m")
    jp, p = _block_params(jssm.mlstm_template(jcfg), seed)
    du = int(cfg.d_model * cfg.mlstm_proj_factor)
    xu = _normal(seed + 1, (2, S, du), 0.1)
    return cfg, jcfg, jp, p, xu


@pytest.mark.parametrize("S", [64, 32, 45, 7, 96])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_reference(S, carried):
    """Chunk 32: S a multiple (64, 32, 96), ragged (45: one chunk and a
    13-token tail) and shorter than a chunk (7); from the zero state or
    from the state a 40-token prefix left (its own ragged split)."""
    cfg, jcfg, jp, p, xu = _mlstm_case(7, S)
    assert cfg.mlstm_chunk == 32
    st, jst = None, None
    if carried:
        pre = _normal(8, (2, 40, xu.shape[2]), 0.1)
        _, st = ssm.mlstm_chunkwise(p, torch.from_numpy(pre), cfg)
        _, jst = jssm.mlstm_chunkwise(jp, jnp.asarray(pre), jcfg)
    h, st = ssm.mlstm_chunkwise(p, torch.from_numpy(xu), cfg, st)
    jh, jst = jssm.mlstm_chunkwise(jp, jnp.asarray(xu), jcfg, jst)
    _close(h.numpy(), jh, TOL)
    _states_close(st, jst)


def test_mlstm_scan_plain_is_the_reference_carry():
    """The chunk carry alone, from the chunk sums the port forms, against
    the reference's carry formulas stepped in float64."""
    rng = np.random.default_rng(9)
    B, nc, H, hd = 2, 5, 3, 4
    btot = -rng.uniform(0, 3, (B, nc, H))
    mc = rng.standard_normal((B, nc, H))
    kv = rng.standard_normal((B, nc, H, hd, hd))
    ks = rng.standard_normal((B, nc, H, hd))
    C, n, m = (rng.standard_normal((B, H, hd, hd)),
               rng.standard_normal((B, H, hd)), rng.standard_normal((B, H)))
    ins = [torch.from_numpy(x.astype(np.float32))
           for x in (btot, mc, kv, ks, C, n, m)]
    got = kmlstm.mlstm_scan(*ins)
    for c in range(nc):
        for i, want in enumerate((C, n, m)):
            _close(got[i][:, c].numpy(), want, kmlstm.TOLERANCE,
                   f"chunk {c} start, output {i}")
        m1 = np.maximum(btot[:, c] + m, mc[:, c])
        f, s = np.exp(btot[:, c] + m - m1), np.exp(mc[:, c] - m1)
        C = f[..., None, None] * C + s[..., None, None] * kv[:, c]
        n = f[..., None] * n + s[..., None] * ks[:, c]
        m = m1
    for i, want in enumerate((C, n, m)):
        _close(got[3 + i].numpy(), want, kmlstm.TOLERANCE)


def test_mlstm_step_matches_reference():
    cfg, jcfg, jp, p, xu = _mlstm_case(10, 33)
    _, st = ssm.mlstm_chunkwise(p, torch.from_numpy(xu), cfg)
    _, jst = jssm.mlstm_chunkwise(jp, jnp.asarray(xu), jcfg)
    for t in range(3):
        xt = _normal(11 + t, (2, 1, xu.shape[2]), 0.1)
        h, st = ssm.mlstm_step(p, torch.from_numpy(xt), cfg, st)
        jh, jst = jssm.mlstm_step(jp, jnp.asarray(xt), jcfg, jst)
        _close(h.numpy(), jh, TOL, f"step {t}")
    _states_close(st, jst)


@pytest.mark.parametrize("S", [1, 19])
def test_slstm_block_matches_reference(S):
    """The scan from the zero state, again from the state it left, then
    three decode steps."""
    cfg, jcfg = _cfgs("xlstm-125m")
    jp, p = _block_params(jssm.slstm_template(jcfg), 12)
    st, jst = None, None
    for seed in (13, 14):
        x = _normal(seed, (2, S, cfg.d_model), 0.5)
        out, st = ssm.slstm_block(p, torch.from_numpy(x), cfg, state=st)
        jout, jst = jssm.slstm_block(jp, jnp.asarray(x), jcfg, state=jst)
        _close(out.numpy(), jout, TOL)
        _states_close(st, jst)
    for t in range(3):
        xt = _normal(15 + t, (2, 1, cfg.d_model), 0.5)
        out, st = ssm.slstm_block(p, torch.from_numpy(xt), cfg, state=st,
                                  decode=True)
        jout, jst = jssm.slstm_block(jp, jnp.asarray(xt), jcfg, state=jst,
                                     decode=True)
        _close(out.numpy(), jout, TOL, f"decode step {t}")
    _states_close(st, jst)


def test_slstm_scan_plain_is_the_cell_stepped():
    """The plain scan's outputs are its cell's states, step by step."""
    rng = np.random.default_rng(16)
    B, S, H, hd = 2, 6, 2, 3
    xg = torch.from_numpy(rng.standard_normal((B, S, 4, H * hd)).astype(
        np.float32))
    r = torch.from_numpy((rng.standard_normal((4, H, hd, hd)) * 0.3).astype(
        np.float32))
    st = kslstm.SLSTMState(*(torch.zeros(B, H * hd) for _ in range(3)),
                           torch.full((B, H * hd), -1e30))
    hs, fin = kslstm.slstm_scan(xg, r, st)
    for t in range(S):
        st = kslstm.slstm_step(xg[:, t], r, st)
        assert torch.equal(hs[:, t], st.h)
    assert all(torch.equal(a, b) for a, b in zip(fin, st))


# -- flash attention at RecurrentGemma's head width ------------------------------


@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_at_head_width_256_with_one_kv_head(window):
    """hd 256, MQA (4 query heads, 1 KV head), causal with and without a
    window: against the reference's ``_flash_attention`` (its serving
    route) and, without a window, its Pallas kernel in interpret mode
    (KV repeated upstream, as its contract says)."""
    B, S, H, hd = 1, 64, 4, 256
    q = _normal(17, (B, S, H, hd), 0.3)
    k = _normal(18, (B, S, 1, hd), 0.3)
    v = _normal(19, (B, S, 1, hd), 0.3)
    scale = 1.0 / hd**0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = kflash.flash_attention(tq, tk, tv, window=window, q_block=16,
                                 kv_block=16)
    jcfg = j_get_reduced("recurrentgemma-2b").replace(
        n_heads=H, n_kv_heads=1, head_dim=hd, attn_q_block=16,
        attn_kv_block=16, tp_head_pad=0)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                   scale, window=window)
    _close(got.numpy(), want, kflash.TOLERANCE[torch.float32])
    if not window:
        rep = [jnp.asarray(np.repeat(x, H, axis=2)) for x in (k, v)]
        want = flash_attention_pallas(jnp.asarray(q), *rep, q_block=16,
                                      kv_block=16, interpret=True)
        _close(got.numpy(), want, kflash.TOLERANCE[torch.float32])


# -- the whole model -----------------------------------------------------------


def test_params_from_jax_carries_stacked_segments(model):
    cfg, _, params, jparams = model
    for (kind, n, _), seg, jseg in zip(transformer.stack_templates(cfg),
                                       params["segments"],
                                       jparams["segments"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jseg):
            node = seg
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape
            if n > 1:
                assert node.shape[0] == n, (kind, path)
            assert np.array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("route", ["materialised", "flash"])
def test_forward_matches_reference(route):
    """Both archs' logits; for RecurrentGemma on the materialised route and
    on the flash route (blocks of 16, so the 48-token input takes the flash
    kernel's plain version with the window of 32)."""
    kw = dict(attn_q_block=16, attn_kv_block=16) if route == "flash" else {}
    for arch in ARCHS:
        if arch == "xlstm-125m" and route == "flash":
            continue  # no attention layer
        cfg, jcfg, params, jparams = _model(arch, 1, **kw)
        toks = _tokens(20, 2, 48, cfg.vocab_size)
        got = lm.forward(cfg, params,
                         {"tokens": torch.from_numpy(toks).long()})
        want = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
        assert got.shape == (2, 48, cfg.vocab_size)
        _close(got.numpy(), want, TOL, arch)


def test_prefill_and_eight_decode_steps_match_reference(model):
    """S 45 (RecurrentGemma's window is 32, so the rolling cache has
    wrapped; xLSTM's chunk is 32, so the prefill is ragged)."""
    cfg, jcfg, params, jparams = model
    S, cache_len = 45, 64
    toks = _tokens(21, 2, S, cfg.vocab_size)
    lg, caches = lm.prefill_step(cfg, params,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 cache_len)
    jlg, jcaches = jlm.prefill_step(jcfg, jparams,
                                    {"tokens": jnp.asarray(toks)}, cache_len)
    _close(lg.numpy(), jlg, TOL)
    _states_close(caches, jcaches)
    nxt = np.random.default_rng(22).integers(0, cfg.vocab_size, (8, 2, 1))
    for step in range(8):
        pos = S + step
        tok = nxt[step].astype(np.int32)
        p = pos if step % 2 else torch.full((2,), pos)
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.from_numpy(tok).long(), p)
        jlg, jcaches = jlm.decode_step(jcfg, jparams, jcaches,
                                       jnp.asarray(tok), pos)
        _close(lg.numpy(), jlg, TOL, f"decode step {step}")
    _states_close(caches, jcaches)


#: bf16 models: the port's logits are held to the reference's bf16 logits
#: within ``BF16_RATIO`` times the reference's own gap to the same weights
#: run in float32, plus ``BF16_ATOL``.  Two bf16 forms that round at other
#: places (XLA and torch fuse and block differently) each lie about that
#: gap from the float32 run, so they differ by at most the sum of the two:
#: twice it, as ``slstm_scan.ACCURACY`` holds a kernel to its float64 run;
#: the atol covers outputs where the gap is near zero
BF16_RATIO = 2.0
BF16_ATOL = 1e-3
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.parametrize("arch", ARCHS + ("llama3.2-1b",))
def test_bf16_prefill_and_decode_match_reference(arch):
    """Whole reduced models in bf16, the inputs of each family's
    ``test_prefill_and_eight_decode_steps_match_reference`` (llama3.2-1b's
    in ``test_torch_models.py``: the flash route, blocks of 16): the
    prefill's logits and eight decode steps', each within ``BF16_RATIO`` of
    the reference's bf16-vs-float32 gap on the same bf16 weights."""
    llama = arch == "llama3.2-1b"
    kw = dict(attn_q_block=16, attn_kv_block=16) if llama else {}
    S, seed = (48, 11) if llama else (45, 21)
    cfg, jcfg = _cfgs(arch, **BF16, **kw)
    _, jcfg32 = _cfgs(arch, **kw)
    jp32 = jlm.init_params(jcfg32, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp32)
    jp_up = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp32),
                             device="cpu")
    cache_len = 64
    toks = _tokens(seed, 2, S, cfg.vocab_size)
    nxt = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size,
                                                   (8, 2, 1))
    lg, caches = lm.prefill_step(cfg, params,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 cache_len)
    ref = [jlm.prefill_step(c, p, {"tokens": jnp.asarray(toks)}, cache_len)
           for c, p in ((jcfg, jp), (jcfg32, jp_up))]
    for step in range(9):
        want, want32 = (np.asarray(r[0], np.float32) for r in ref)
        got = lg.float().numpy()
        err = float(np.abs(got - want).max())
        own = float(np.abs(want - want32).max())
        assert err <= BF16_RATIO * own + BF16_ATOL, (
            f"{arch} step {step}: port vs reference bf16 {err}, reference "
            f"bf16 vs float32 {own}")
        if step == 8:
            break
        pos, tok = S + step, nxt[step].astype(np.int32)
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.from_numpy(tok).long(), pos)
        ref = [jlm.decode_step(c, p, r[1], jnp.asarray(tok), pos)
               for (c, p), r in zip(((jcfg, jp), (jcfg32, jp_up)), ref)]


def test_decode_matches_forward(model):
    """The reference's ``test_decode_matches_forward`` on the port alone:
    prefill logits equal the forward's last, and one greedy decode step
    equals the forward over the prompt and that token."""
    cfg, _, params, _ = model
    toks = torch.from_numpy(_tokens(23, 2, 40, cfg.vocab_size)).long()
    full = lm.forward(cfg, params, {"tokens": toks})
    lg, caches = lm.prefill_step(cfg, params, {"tokens": toks}, 44)
    _close(lg.numpy(), full[:, -1].numpy(), dict(rtol=2e-4, atol=2e-4))
    tok = torch.argmax(lg, -1)[:, None]
    lg, _ = lm.decode_step(cfg, params, caches, tok, 40)
    full = lm.forward(cfg, params, {"tokens": torch.cat([toks, tok], 1)})
    _close(lg.numpy(), full[:, -1].numpy(), TOL)


def test_caches_keep_the_reference_s_structure(model):
    cfg, jcfg, _, _ = model
    got = transformer.init_stack_states(cfg, 3, 40, torch.float32, "cpu")
    want = jlm.init_caches(jcfg, 3, 40, jnp.float32)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert [tuple(t.shape) for t in g] == [t.shape for t in w]
        assert [str(t.dtype).split(".")[-1] for t in g] == [
            str(t.dtype) for t in w]


def test_gradients_run_through_the_plain_versions_on_the_cpu(model):
    """On the CPU the scans' backward Functions take their plain
    backwards (the card's take the backward kernels): every parameter gets
    a finite gradient.  ``tests/test_torch_recurrent_train.py`` holds them
    against the reference's."""
    cfg, _, params, _ = model
    leaves = []

    def grad_leaf(t):
        t = t.detach().clone().requires_grad_(True)
        leaves.append(t)
        return t

    p = tree_map(grad_leaf, params)
    toks = torch.from_numpy(_tokens(24, 2, 40, cfg.vocab_size)).long()
    loss, _ = lm.loss_and_metrics(cfg, p, {"tokens": toks, "labels": toks})
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
