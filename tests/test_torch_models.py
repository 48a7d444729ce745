"""The port's dense LM (``repro_torch.models``) against the JAX package on
the CPU.

Reduced ``llama3.2-1b`` with ``attn_q_block = attn_kv_block = 16``, so the
32-64-token inputs here take the flash route (the plain version of the
flash kernel on the CPU) in every layer; the reference's parameters are
carried across with ``params_from_jax``.  ``forward`` logits,
``prefill_step`` logits and caches, and eight ``decode_step``s agree with
the reference in float32 to 3e-4 (the tolerance of the reference's own
decode-vs-forward test); the layers, the materialised route, rolling-window
caches and the template's parameter count are held too.  Token and noise
inputs are made with numpy from a seed.
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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm

from repro_torch.configs import get_config, get_reduced, param_count
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm, transformer
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no trace of
    the reference made here outlives the file (ROADMAP.md section 3)."""
    yield
    jax.clear_caches()


def _cfgs(**kw):
    """The port's and the reference's reduced llama3.2-1b, same fields."""
    return (get_reduced("llama3.2-1b").replace(**kw),
            j_get_reduced("llama3.2-1b").replace(**kw))


FLASH = dict(attn_q_block=16, attn_kv_block=16)


@pytest.fixture(scope="module")
def flash_model():
    cfg, jcfg = _cfgs(**FLASH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, params, jparams


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_configs_are_the_reference_s():
    """llama3.2-1b and deepseek-v3-671b (MLA) field for field; a name
    neither package registers raises, naming the registered ones."""
    for name in ("llama3.2-1b", "deepseek-v3-671b"):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(j_get_config(name)))
        assert (dataclasses.asdict(get_reduced(name))
                == dataclasses.asdict(j_get_reduced(name)))
    with pytest.raises(KeyError, match="deepseek-v3-671b"):
        get_config("deepseek-v4")


def test_template_param_count_equals_reference_at_full_width():
    cfg = get_config("llama3.2-1b")
    leaves = []
    layers.template_map(leaves.append, lm.lm_template(cfg))
    total = sum(int(np.prod(t.shape)) for t in leaves)
    # param_count leaves out the RMSNorm scales (two a layer, one final)
    norms = sum(int(np.prod(t.shape)) for t in leaves if t.init == "ones")
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    assert total - norms == j_param_count(j_get_config("llama3.2-1b"))[0]
    assert total - norms == param_count(cfg)[0] == 1_235_746_816


def test_other_block_kinds_raise_naming_roadmap():
    """Every block kind of the reference builds now: the MLA kinds
    (``mla_dense``, ``mla_moe``) a template with the reference's leaves
    and a latent cache, and deepseek-v3-671b's full-width template counts
    the reference's ``param_count``; a kind neither package knows raises,
    naming the kinds the port runs.  MoE and the embedding input modes
    build (held in tests/test_torch_families.py, MLA in
    tests/test_torch_mla.py, the recurrent kinds in
    tests/test_torch_recurrent.py)."""
    base = get_reduced("llama3.2-1b")
    mla_cfgs = (base.replace(use_mla=True, q_lora_rank=32, kv_lora_rank=16,
                             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
                get_reduced("deepseek-v3-671b"))
    for cfg in mla_cfgs:
        kinds = set(transformer.layer_kinds(cfg))
        assert kinds & {"mla_dense", "mla_moe"}, kinds
        assert kinds <= set(transformer.PORTED_KINDS)
        segs = lm.lm_template(cfg)["segments"]
        assert all("mla" in seg and "attn" not in seg for seg in segs)
        for kind in kinds:
            cache = transformer.init_block_cache(kind, cfg, 1, 8,
                                                 torch.float32, "cpu")
            assert (cache.c_kv.shape, cache.k_rope.shape) == (
                (1, 8, cfg.kv_lora_rank), (1, 8, cfg.qk_rope_dim))
    assert set(transformer.layer_kinds(mla_cfgs[1])) == {"mla_dense",
                                                         "mla_moe"}
    full = get_config("deepseek-v3-671b")
    leaves = []
    layers.template_map(leaves.append, lm.lm_template(full))
    # param_count leaves out the norm scales (MLA's q_norm and kv_norm too)
    counted = sum(int(np.prod(t.shape)) for t in leaves if t.init != "ones")
    assert counted == j_param_count(j_get_config("deepseek-v3-671b"))[0]
    assert counted == param_count(full)[0]
    with pytest.raises(NotImplementedError, match="mla_moe"):
        transformer.block_template("mla_sparse", base)
    with pytest.raises(NotImplementedError, match="mla_dense"):
        transformer.init_block_cache("mla_sparse", base, 1, 8, torch.float32,
                                     "cpu")
    moe = base.replace(family="moe", n_experts=4, moe_top_k=2,
                       d_ff_expert=32)
    assert set(transformer.layer_kinds(moe)) == {"moe"}
    assert "moe" in lm.lm_template(moe)["segments"][0]
    cache = transformer.init_block_cache("moe", moe, 1, 8, torch.float32,
                                         "cpu")
    assert cache.k.shape == (1, 8, 2, 16)
    emb = base.replace(input_mode="embeddings")
    x = torch.ones(1, 3, emb.d_model)
    assert torch.equal(lm.embed_inputs(emb, {}, {"embeds": x}), x)


def test_init_params_follows_the_template():
    cfg = get_reduced("llama3.2-1b")
    g = torch.Generator().manual_seed(0)
    p = lm.init_params(cfg, g, device="cpu")
    again = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    seg = p["segments"][0]
    assert seg["attn"]["wq"].shape == (2, 64, 4, 16)
    assert seg["mlp"]["down"].shape == (2, 128, 64)
    assert p["embed"].shape == (256, 64) and "unembed" not in p
    assert torch.equal(seg["ln1"], torch.ones(2, 64))
    assert all(torch.equal(a, b) for a, b in zip(
        (seg["attn"]["wq"], p["embed"]),
        (again["segments"][0]["attn"]["wq"], again["embed"])))
    # the reference's scales: 1/sqrt(fan_in) over every dim but the last
    # (the stack dim included), 0.02 for the embedding
    wq = seg["attn"]["wq"]
    assert abs(float(wq.std()) * (2 * 64 * 4) ** 0.5 - 1.0) < 0.05
    down = seg["mlp"]["down"]
    assert abs(float(down.std()) * (2 * 128) ** 0.5 - 1.0) < 0.05
    assert abs(float(p["embed"].std()) / 0.02 - 1.0) < 0.05
    full = lm.init_params(get_reduced("llama3.2-1b").replace(
        param_dtype="bfloat16"), device="cpu")
    assert full["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_mlp_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL
    got = layers.rmsnorm(tx, torch.from_numpy(scale).to(tdt), 1e-6)
    want = jlayers.rmsnorm(jx, jnp.asarray(scale).astype(jdt), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    got = layers.apply_rope(tx, torch.from_numpy(pos), 500_000.0)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 500_000.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_array_equal(layers.rope_freqs(16, 10_000.0).numpy(),
                                  np.asarray(jlayers.rope_freqs(16, 10_000.0)))
    w = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in
         (("gate", (16, 32)), ("up", (16, 32)), ("down", (32, 16)))}
    for act in ("silu", "gelu"):
        got = layers.mlp_apply({k: torch.from_numpy(v).to(tdt)
                                for k, v in w.items()}, tx, act)
        want = jlayers.mlp_apply({k: jnp.asarray(v).astype(jdt)
                                  for k, v in w.items()}, jx, act)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_unembed_untied_with_soft_cap_matches_reference():
    cfg, jcfg = _cfgs(tie_embeddings=False, logits_soft_cap=5.0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    got = layers.unembed_apply({"unembed": torch.from_numpy(w)},
                               torch.from_numpy(x), cfg)
    want = jlayers.unembed_apply({"unembed": jnp.asarray(w)},
                                 jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) <= 5.0


@pytest.mark.parametrize("S", [32, 48, 64])
def test_forward_matches_reference_on_the_flash_route(flash_model, S):
    cfg, jcfg, params, jparams = flash_model
    toks = _tokens(S, 2, S, cfg.vocab_size)
    assert cfg.attn_kv_block and S > cfg.attn_kv_block  # the flash route
    got = lm.forward(cfg, params, {"tokens": torch.from_numpy(toks).long()})
    want = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    assert got.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_block,q_block", [(0, 16), (0, 64), (64, 16)])
def test_forward_matches_reference_on_the_materialised_routes(kv_block,
                                                              q_block):
    """attn_kv_block=0 (or a prompt no longer than it) takes the query-block
    loop (S > q_block) or the single block (S <= q_block)."""
    cfg, jcfg = _cfgs(attn_q_block=q_block, attn_kv_block=kv_block)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = _tokens(7, 2, 48, cfg.vocab_size)
    got = lm.forward(cfg, params, {"tokens": torch.from_numpy(toks).long()})
    want = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            assert tuple(gt.shape) == tuple(wt.shape)
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_prefill_and_eight_decode_steps_match_reference(flash_model):
    cfg, jcfg, params, jparams = flash_model
    S, cache_len = 48, 64
    toks = _tokens(11, 2, S, cfg.vocab_size)
    lg, caches = lm.prefill_step(cfg, params,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 cache_len)
    jlg, jcaches = jlm.prefill_step(jcfg, jparams,
                                    {"tokens": jnp.asarray(toks)}, cache_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _caches_close(caches, jcaches)
    assert caches[0].k.shape == (cfg.n_layers, 2, cache_len, 2, 16)

    nxt = np.random.default_rng(12).integers(0, cfg.vocab_size, (8, 2, 1))
    for step in range(8):
        pos = S + step
        tok = nxt[step].astype(np.int32)
        # the port takes a scalar position or one per row
        p = pos if step % 2 else torch.full((2,), pos)
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.from_numpy(tok).long(), p)
        jlg, jcaches = jlm.decode_step(jcfg, jparams, jcaches,
                                       jnp.asarray(tok), pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"decode step {step}")
    _caches_close(caches, jcaches)


def test_decode_rows_at_different_positions(flash_model):
    """Rows of one decode step at their own positions equal each row
    decoded alone (the engine's slots)."""
    cfg, _, params, _ = flash_model
    lens = (32, 48)
    cache_len = 64
    one = []
    caches_full = lm.init_caches(cfg, 2, cache_len, device="cpu")
    for b, S in enumerate(lens):
        toks = torch.from_numpy(_tokens(20 + b, 1, S, cfg.vocab_size)).long()
        _, c = lm.prefill_step(cfg, params, {"tokens": toks}, cache_len)
        caches_full[0].k[:, b] = c[0].k[:, 0]
        caches_full[0].v[:, b] = c[0].v[:, 0]
        lg, _ = lm.decode_step(cfg, params, c, torch.tensor([[5]]), S)
        one.append(lg[0])
    lg, _ = lm.decode_step(cfg, params, caches_full, torch.tensor([[5], [5]]),
                           torch.tensor(lens))
    for b in range(2):
        np.testing.assert_allclose(lg[b].numpy(), one[b].numpy(), **TOL)


@pytest.mark.parametrize("window,S", [(8, 20), (24, 20), (8, 5)])
def test_rolling_window_cache_matches_reference(window, S):
    """Windowed attention (the rolling-buffer cache the hybrid families
    use): prefill fills slot t % window, decode wraps, both as the
    reference's attention layer does."""
    cfg, jcfg = _cfgs(attn_q_block=64, attn_kv_block=0)
    jp = jlayers.init_tree(jattn.attn_template(jcfg), jax.random.PRNGKey(4))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, S, 64)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    out, cache = attn.prefill_attention(p, torch.from_numpy(x), cfg,
                                        torch.from_numpy(pos.copy()), 32,
                                        window=window)
    jout, jcache = jattn.prefill_attention(jp, jnp.asarray(x), jcfg,
                                           jnp.asarray(pos), 32,
                                           window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    _caches_close([cache], [jcache])
    for step in range(window + 3):  # past one wrap of the buffer
        xt = (rng.standard_normal((2, 1, 64)) * 0.5).astype(np.float32)
        out, cache = attn.decode_attention(p, torch.from_numpy(xt), cfg,
                                           cache, S + step, window=window)
        jout, jcache = jattn.decode_attention(jp, jnp.asarray(xt), jcfg,
                                              jcache, S + step,
                                              window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL,
                                   err_msg=f"step {step}")
    _caches_close([cache], [jcache])


def test_decode_write_position_is_clamped_into_the_cache():
    """A position past the cache's end writes the last slot, as the
    reference's dynamic_update_slice clamps its start index."""
    cfg, jcfg = _cfgs()
    jp = jlayers.init_tree(jattn.attn_template(jcfg), jax.random.PRNGKey(6))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(7)
    ck = (rng.standard_normal((2, 8, 2, 16)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal((2, 8, 2, 16)) * 0.5).astype(np.float32)
    xt = (rng.standard_normal((2, 1, 64)) * 0.5).astype(np.float32)
    for pos in (7, 8, 12):
        cache = attn.KVCache(torch.from_numpy(ck.copy()),
                             torch.from_numpy(cv.copy()))
        out, cache = attn.decode_attention(p, torch.from_numpy(xt), cfg,
                                           cache, pos)
        jout, jcache = jattn.decode_attention(
            jp, jnp.asarray(xt), jcfg,
            jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)), pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        _caches_close([cache], [jcache])


def test_stack_caches_are_stacked_per_segment():
    cfg = get_reduced("llama3.2-1b")
    caches = transformer.init_stack_states(cfg, 3, 40, torch.float32, "cpu")
    assert len(caches) == 1
    assert caches[0].k.shape == (2, 3, 40, 2, 16)
    assert transformer.segments(cfg) == [("dense", 2)]
