"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla`` on the CPU.

Reduced ``deepseek-v3-671b`` (d_model 64, 4 heads, q_lora 32, kv_lora 16,
qk_nope 16 + qk_rope 8, v_head 16, query blocks of 64), float32; the MLA
parameters are the reference's first layer's, carried across with
``params_from_jax``, and the inputs are made with numpy from a seed.
Held: ``mla_attention`` below, at and above the query block (a multiple
of it; a ragged length above it stops at the tile assert in both
packages); ``mla_prefill``'s output and latent cache leaves; the absorbed
``mla_decode`` at one scalar position and at a position per row against
the reference run row by row (positions 0, inside, at the cache's end and
past it, where both clamp the write); on the port alone, the absorbed
decode against the materialised attention over the same tokens; and the
whole reduced model training: three train steps against the reference's
jitted step, and the remat modes' gradients.

Tolerances: against the reference ``TOL`` (1e-5: the same float32
operations, in another summation order); absorbed against materialised
``ABSORBED_TOL`` (2e-5: the two forms associate the products through
``wk_b`` and ``wv_b`` differently).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models import mla as jmla

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import mla
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
ABSORBED_TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no trace of
    the reference made here outlives the file (ROADMAP.md section 3)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def layer():
    """(cfg, jcfg, port MLA params, reference MLA params) of the reduced
    model's first layer (``mla_dense``, unstacked)."""
    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    assert cfg.n_dense_layers == 1
    return (cfg, jcfg, params["segments"][0]["mla"],
            jparams["segments"][0]["mla"])


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def _positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                           (B, S)).copy()


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


@pytest.mark.parametrize("S", [40, 64, 128, 192])
def test_mla_attention_matches_reference(layer, S):
    """Below the query block of 64 (one block), at it, and at two and
    three blocks (the reference's ``lax.scan`` over query blocks)."""
    cfg, jcfg, p, jp = layer
    x, pos = _x(S, 2, S, cfg.d_model), _positions(2, S)
    got = mla.mla_attention(p, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos).long())
    want = jmla.mla_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    assert got.shape == (2, S, cfg.d_model)
    _close(got.numpy(), want)


def test_ragged_length_above_the_query_block_raises_in_both(layer):
    cfg, jcfg, p, jp = layer
    x, pos = _x(1, 1, 100, cfg.d_model), _positions(1, 100)
    with pytest.raises(AssertionError):
        mla.mla_attention(p, torch.from_numpy(x), cfg,
                          torch.from_numpy(pos).long())
    with pytest.raises(AssertionError):
        jmla.mla_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))


@pytest.mark.parametrize("S", [24, 128])
def test_mla_prefill_output_and_caches_match_reference(layer, S):
    """The output, and the cache leaves ``c_kv`` (kv_lora_rank wide) and
    ``k_rope`` (qk_rope_dim), token t at slot t, zeros past the prompt."""
    cfg, jcfg, p, jp = layer
    cache_len = S + 16
    x, pos = _x(50 + S, 2, S, cfg.d_model), _positions(2, S)
    out, cache = mla.mla_prefill(p, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos).long(), cache_len)
    jout, jcache = jmla.mla_prefill(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), cache_len)
    _close(out.numpy(), jout)
    assert isinstance(cache, mla.MLACache)
    assert cache.c_kv.shape == (2, cache_len, cfg.kv_lora_rank)
    assert cache.k_rope.shape == (2, cache_len, cfg.qk_rope_dim)
    for got, want in zip(cache, jcache):
        _close(got.numpy(), want)
        assert not got[:, S:].any()
    with pytest.raises(ValueError, match="longer than the cache"):
        mla.mla_prefill(p, torch.from_numpy(x), cfg,
                        torch.from_numpy(pos).long(), S - 1)


def _cache(seed, cfg, B, S_c):
    """A filled latent cache (numpy), as a prefill would leave it."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S_c, cfg.kv_lora_rank)).astype(
                np.float32),
            rng.standard_normal((B, S_c, cfg.qk_rope_dim)).astype(
                np.float32))


def test_mla_decode_at_a_scalar_position_matches_reference(layer):
    """A 32-token prefill, then four absorbed decode steps at one scalar
    position for both rows: outputs and the whole cache after each."""
    cfg, jcfg, p, jp = layer
    S, cache_len = 32, 40
    x, pos = _x(60, 2, S, cfg.d_model), _positions(2, S)
    _, cache = mla.mla_prefill(p, torch.from_numpy(x), cfg,
                               torch.from_numpy(pos).long(), cache_len)
    _, jcache = jmla.mla_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 cache_len)
    for step in range(4):
        xt = _x(61 + step, 2, 1, cfg.d_model)
        out, cache = mla.mla_decode(p, torch.from_numpy(xt), cfg, cache,
                                    S + step)
        jout, jcache = jmla.mla_decode(jp, jnp.asarray(xt), jcfg, jcache,
                                       S + step)
        _close(out.numpy(), jout, msg=f"step {step}")
        for got, want in zip(cache, jcache):
            _close(got.numpy(), want, msg=f"cache, step {step}")


def test_mla_decode_per_row_positions_match_reference_row_by_row(layer):
    """Four rows at positions 0, 13, the cache's last slot and past the
    end, three steps: each row's output and cache row equal the
    reference's decode of that row alone at its scalar position (both
    clamp a write past the end onto the last slot and attend to every
    slot there).  The cache is updated in place."""
    cfg, jcfg, p, jp = layer
    S_c = 24
    ckv, krp = _cache(70, cfg, 4, S_c)
    cache = mla.MLACache(torch.from_numpy(ckv.copy()),
                         torch.from_numpy(krp.copy()))
    jcaches = [jmla.MLACache(jnp.asarray(ckv[b:b + 1]),
                             jnp.asarray(krp[b:b + 1])) for b in range(4)]
    pos = np.array([0, 13, S_c - 1, S_c + 2])
    for step in range(3):
        xt = _x(71 + step, 4, 1, cfg.d_model)
        out, new = mla.mla_decode(p, torch.from_numpy(xt), cfg, cache,
                                  torch.from_numpy(pos + step))
        assert all(a is b for a, b in zip(new, cache))
        for b in range(4):
            jout, jcaches[b] = jmla.mla_decode(
                jp, jnp.asarray(xt[b:b + 1]), jcfg, jcaches[b],
                int(pos[b] + step))
            _close(out[b:b + 1].numpy(), jout, msg=f"row {b} step {step}")
            for got, want in zip(cache, jcaches[b]):
                _close(got[b:b + 1].numpy(), want,
                       msg=f"cache row {b} step {step}")


def test_absorbed_decode_equals_materialised_attention(layer):
    """On the port alone: a 40-token prefill and one absorbed decode step
    give the materialised attention's last position over the 41 tokens
    (the latents of the first 40 equal the prefill's)."""
    cfg, _, p, _ = layer
    S = 40
    x = torch.from_numpy(_x(80, 2, S + 1, cfg.d_model))
    pos = torch.from_numpy(_positions(2, S + 1)).long()
    full = mla.mla_attention(p, x, cfg, pos)
    _, cache = mla.mla_prefill(p, x[:, :S], cfg, pos[:, :S], S + 8)
    out, _ = mla.mla_decode(p, x[:, S:], cfg, cache, S)
    _close(out[:, 0].numpy(), full[:, S].numpy(), ABSORBED_TOL)


def test_the_cache_holds_only_the_latents_at_full_width():
    """576 values a token a layer at the published size (512 of ``c_kv``,
    64 of ``k_rope``): 1,152 bytes in bf16, where the per-head K/V would
    take 128 x (192 + 128)."""
    cfg = get_config(ARCH)
    cache = mla.init_mla_cache(cfg, 4, 4160, torch.bfloat16, device="meta")
    assert cache.c_kv.shape == (4, 4160, 512)
    assert cache.k_rope.shape == (4, 4160, 64)
    assert sum(t.numel() * t.element_size() for t in cache) == (
        4 * 4160 * 576 * 2)


# -- training ----------------------------------------------------------------


def _train_batch(rng, cfg):
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    lab[0, :5] = -1
    return tok, lab


def test_three_train_steps_of_reduced_deepseek_match_reference():
    """Three steps of ``make_train_step`` on reduced deepseek-v3-671b (MLA,
    the MoE's aux in the loss) from the reference's parameters and
    optimizer state, against the reference's jitted step, held as
    ``tests/test_torch_train.py`` holds llama3.2-1b's: the loss, the
    gradient norm and the learning rate to ``LOSS_RTOL``, the parameters
    to ``PARAM_ATOL_PER_STEP`` a step."""
    from repro.train import OptConfig as RefOptConfig
    from repro.train import make_train_step as ref_make_train_step
    from repro.train import opt_init as ref_opt_init

    from repro_torch._tree import leaves
    from repro_torch.models.convert import opt_state_from_jax
    from repro_torch.train import OptConfig, make_train_step

    from test_torch_train import LOSS_RTOL, PARAM_ATOL_PER_STEP

    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jst = ref_opt_init(RefOptConfig(**kw), jp)
    host = jax.tree.map(np.asarray, (jp, jst))
    p = params_from_jax(cfg, host[0], device="cpu")
    st = opt_state_from_jax(cfg, host[1], device="cpu")
    jstep = jax.jit(ref_make_train_step(jcfg, RefOptConfig(**kw)))
    step = make_train_step(cfg, OptConfig(**kw))
    rng = np.random.default_rng(0)
    for i in range(3):
        tok, lab = _train_batch(rng, cfg)
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.asarray(lab)})
        p, st, m = step(p, st, {"tokens": torch.from_numpy(tok).long(),
                                "labels": torch.from_numpy(lab).long()})
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]),
                                                rel=LOSS_RTOL), k
        for a, b in zip(leaves(p), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL_PER_STEP * (i + 1))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_equal_gradients_through_mla(remat):
    """Checkpointed MLA and MoE blocks give the gradients and the loss of
    the run without checkpoints."""
    from repro_torch._tree import leaves
    from repro_torch.models import lm
    from repro_torch.train import grads_and_metrics

    cfg = get_reduced(ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tok, lab = _train_batch(np.random.default_rng(1), cfg)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    g0, m0 = grads_and_metrics(cfg, params, batch)
    g1, m1 = grads_and_metrics(cfg.replace(remat=remat), params, batch)
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["aux"]) == float(m1["aux"]) > 0
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
