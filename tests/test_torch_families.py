"""The rest of the dense family, the two embedding input modes, MoE and
MLA against the JAX package on the CPU.

Reduced ``granite-8b``, ``phi3-medium-14b``, ``qwen2-72b`` (QKV bias),
``musicgen-large`` (``embeddings`` mode, GeGLU, full MHA, untied and no
``embed`` leaf), ``llava-next-34b`` (``mixed`` mode: patch embeddings in
front of the text tokens), ``qwen3-moe-30b-a3b`` (MoE with q/k-norm) and
``deepseek-v3-671b`` (MLA, one ``mla_dense`` layer before two ``mla_moe``
with a shared expert), the reference's parameters carried across with
``params_from_jax`` and inputs made with numpy from a seed.  Held: the configurations and the
full-width templates; ``forward`` logits on the flash route (blocks of
16, the flash kernel's plain version) and the materialised route;
``loss_and_metrics`` with image positions masked and MoE's aux;
``prefill_step`` and eight ``decode_step``s, logits and caches; decode
against the port's own forward; bf16 for one dense model and the two
MoEs; the engine's greedy tokens; and MoE's dispatch bit for bit on
adversarial router inputs.

Tolerances: float32 logits within ``TOL`` (1e-5: the two packages run the
same float32 operations and differ in summation order only); decode
against forward within the reference's own test's 2e-4/3e-4; bf16 within
twice the reference's own bf16-vs-float32 gap plus 1e-3, as
``tests/test_torch_recurrent.py`` holds its families.
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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig

from repro_torch._tree import tree_map
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers, lm, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import MOE_KINDS, layer_kinds
from repro_torch.serve import Engine, ServeConfig

ARCHS = ("granite-8b", "phi3-medium-14b", "qwen2-72b", "musicgen-large",
         "llava-next-34b", "qwen3-moe-30b-a3b", "deepseek-v3-671b")
TOL = dict(rtol=1e-5, atol=1e-5)
#: the reference's test_decode_matches_forward tolerances
PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
#: query and KV blocks of 16: the 48-token inputs take the flash route
FLASH = dict(attn_q_block=16, attn_kv_block=16)


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
    return _model(request.param, **FLASH)


def _batch(cfg, seed, B, S, labels=False):
    """numpy inputs of the arch's input mode, (B, S) positions in all; in
    ``mixed`` mode the first ``img_tokens`` are patch embeddings, whose
    labels are -1."""
    rng = np.random.default_rng(seed)
    V, D, img = cfg.vocab_size, cfg.d_model, cfg.img_tokens
    b = {}
    if cfg.input_mode == "tokens":
        b["tokens"] = rng.integers(0, V, (B, S), dtype=np.int32)
    elif cfg.input_mode == "embeddings":
        b["embeds"] = (rng.standard_normal((B, S, D)) * 0.02).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(0, V, (B, S - img), dtype=np.int32)
        b["embeds"] = (rng.standard_normal((B, img, D)) * 0.02).astype(
            np.float32)
    if labels:
        lab = rng.integers(0, V, (B, S), dtype=np.int32)
        if cfg.input_mode == "mixed":
            lab[:, :img] = -1
        b["labels"] = lab
    return b


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


def _caches_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for gt, wt in zip(g, w):
            assert tuple(gt.shape) == tuple(wt.shape)
            _close(gt.numpy(), wt, tol)


# -- configurations and templates ---------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_s(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(j_get_config(arch)))
    assert (dataclasses.asdict(get_reduced(arch))
            == dataclasses.asdict(j_get_reduced(arch)))


def _template_leaves(template, pt_type):
    """(path, shape, init, scale) of every leaf of a template tree."""
    out = []

    def walk(node, path):
        if isinstance(node, pt_type):
            out.append((path, tuple(node.shape), node.init, node.scale))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}")
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")

    walk(template, "params")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_template_is_the_reference_s(arch):
    """Leaf for leaf the reference's template at the published size, and
    its count the reference's ``param_count`` once the leaves that count
    leaves out are taken out: the norm scales (q/k-norm's too) and the
    QKV biases; ``param_count`` counts an input embedding for every
    untied model, which the ``embeddings`` mode has no leaf for."""
    cfg = get_config(arch)
    got = _template_leaves(lm.lm_template(cfg), layers.PT)
    assert got == _template_leaves(jlm.lm_template(j_get_config(arch)),
                                   jlayers.PT)
    total = sum(int(np.prod(s)) for _, s, _, _ in got)
    left_out = sum(int(np.prod(s)) for _, s, init, _ in got
                   if init in ("ones", "zeros"))
    if cfg.qkv_bias:
        assert left_out > (2 * cfg.n_layers + 1) * cfg.d_model
    no_embed = (cfg.vocab_size * cfg.d_model
                if cfg.input_mode == "embeddings" else 0)
    assert total - left_out + no_embed == j_param_count(j_get_config(arch))[0]
    paths = {p for p, *_ in got}
    assert ("params.embed" in paths) == (cfg.input_mode != "embeddings")
    if cfg.n_experts:
        # the MoE layers after the first n_dense_layers, one segment
        seg = int(cfg.n_dense_layers > 0)
        assert (f"params.segments.{seg}.moe.gate",
                (cfg.n_layers - cfg.n_dense_layers, cfg.n_experts,
                 cfg.d_model, cfg.d_ff_expert), "normal", None) in got


def test_params_from_jax_carries_the_new_leaves(model):
    cfg, _, params, jparams = model
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    bad = jax.tree.map(np.asarray, jparams)
    bad["embed"] = np.zeros((cfg.vocab_size, cfg.d_model), np.float32)
    if cfg.input_mode == "embeddings":
        with pytest.raises(ValueError, match="keys"):
            params_from_jax(cfg, bad, device="cpu")


# -- the whole model against the reference ------------------------------------


@pytest.mark.parametrize("route", ["flash", "materialised"])
def test_forward_matches_reference(model, route):
    cfg, jcfg, params, jparams = model
    if route == "materialised":
        cfg, jcfg = (c.replace(attn_kv_block=0) for c in (cfg, jcfg))
    batch = _batch(cfg, 20, 2, 48)
    got = lm.forward(cfg, params, _torch(batch))
    want = jlm.forward(jcfg, jparams, _jax(batch))
    assert got.shape == (2, 48, cfg.vocab_size)
    _close(got.numpy(), want, TOL)


def test_loss_and_metrics_match_reference(model):
    """Cross entropy over the unmasked labels (llava's image positions are
    -1) and the MoE's aux, which enters the loss."""
    cfg, jcfg, params, jparams = model
    batch = _batch(cfg, 21, 2, 48, labels=True)
    loss, m = lm.loss_and_metrics(cfg, params, _torch(batch))
    jloss, jm = jlm.loss_and_metrics(jcfg, jparams, _jax(batch))
    for k in ("loss", "ce", "aux", "tokens"):
        _close(float(m[k]), float(jm[k]), TOL, k)
    _close(float(loss), float(jloss), TOL)
    assert float(m["tokens"]) == 2 * (48 - (cfg.img_tokens if
                                            cfg.input_mode == "mixed" else 0))
    assert (float(m["aux"]) > 0) == bool(cfg.n_experts)


def test_prefill_and_eight_decode_steps_match_reference(model):
    cfg, jcfg, params, jparams = model
    S, cache_len = 48, 64
    batch = _batch(cfg, 22, 2, S)
    lg, caches = lm.prefill_step(cfg, params, _torch(batch), cache_len)
    jlg, jcaches = jlm.prefill_step(jcfg, jparams, _jax(batch), cache_len)
    _close(lg.numpy(), jlg, TOL)
    _caches_close(caches, jcaches)
    nxt = np.random.default_rng(23).integers(0, cfg.vocab_size, (8, 2, 1))
    for step in range(8):
        pos = S + step
        tok = nxt[step].astype(np.int32)
        p = pos if step % 2 else torch.full((2,), pos)
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.from_numpy(tok).long(), p)
        jlg, jcaches = jlm.decode_step(jcfg, jparams, jcaches,
                                       jnp.asarray(tok), pos)
        _close(lg.numpy(), jlg, TOL, f"decode step {step}")
    _caches_close(caches, jcaches)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` on the port alone
    (B 2, S 32, capacity lifted for the MoE, 8 image tokens for llava):
    prefill logits equal the forward's last, and one greedy decode step
    equals the forward over the inputs and that token (embedded through
    the output head's transpose in the ``embeddings`` mode)."""
    cfg = get_reduced(arch)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=8.0)
    if cfg.input_mode == "mixed":
        cfg = cfg.replace(img_tokens=8)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    S = 32
    batch = _torch(_batch(cfg, 24, 2, S))
    full = lm.forward(cfg, params, batch)
    lg, caches = lm.prefill_step(cfg, params, batch, S + 4)
    _close(lg.numpy(), full[:, -1].numpy(), PREFILL_TOL)
    tok = torch.argmax(lg, -1)[:, None]
    lg, _ = lm.decode_step(cfg, params, caches, tok, S)
    batch2 = dict(batch)
    if cfg.input_mode == "embeddings":
        emb = params["unembed"].T[tok[:, 0]][:, None, :]
        batch2["embeds"] = torch.cat([batch["embeds"], emb], 1)
    else:
        batch2["tokens"] = torch.cat([batch["tokens"], tok], 1)
    full = lm.forward(cfg, params, batch2)
    _close(lg.numpy(), full[:, -1].numpy(), DECODE_TOL, arch)


BF16_RATIO = 2.0
BF16_ATOL = 1e-3
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _bf16_step(bits):
    """One bf16 step (2^-7 of its binade) at the size ``bits``."""
    return 2.0 ** (np.floor(np.log2(bits)) - 7)


def _flips(port, ref, K, where, ref32=None):
    """The routing decisions at positions ``where`` that differ between
    the packages' router logits (B, S, E), each as (gap, step, own): how
    far apart the experts that only one package chose lie, in the package
    that is nearer a tie, beside one bf16 step at their size and, given
    the reference's float32 router logits ``ref32``, the reference's own
    bf16-vs-float32 difference of that position's router logits (else
    None)."""
    out = []
    for b, t in where:
        lp, lr = port[b, t], ref[b, t]
        sp = set(np.argsort(-lp, kind="stable")[:K].tolist())
        sr = set(np.argsort(-lr, kind="stable")[:K].tolist())
        if sp == sr:
            continue
        P, R = sorted(sp - sr), sorted(sr - sp)
        gap = min(lp[P].min() - lp[R].max(), lr[R].min() - lr[P].max())
        out.append((float(gap), float(_bf16_step(
            np.abs(np.concatenate([lp[P], lp[R], lr[P], lr[R]])).max())),
            None if ref32 is None else float(np.abs(lr - ref32[b, t]).max())))
    return out


def _bf16_against_reference(arch, seed, monkeypatch):
    """The bf16 check of ``test_bf16_prefill_and_decode_match_reference``
    on the reference's weights from ``PRNGKey(seed)`` and prompts from
    the numpy seeds 25 + 2 seed and 26 + 2 seed: the steps (of 9) whose
    logits were compared.  An MLA model's routing differences are held to
    the reference's own bf16 noise of its router logits, and its logits
    compared at every step (the test's docstring says why)."""
    cfg, jcfg = _cfgs(arch, **BF16, **FLASH)
    own_gap = cfg.use_mla
    _, jcfg32 = _cfgs(arch, **FLASH)
    jcfg = jcfg.replace(scan_layers=False)
    if own_gap:  # its float32 router logits read too
        jcfg32 = jcfg32.replace(scan_layers=False)
    jp32 = jlm.init_params(jcfg32, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp32)
    jp_up = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp32),
                             device="cpu")
    routes = {"port": [], "ref": []}
    if own_gap:
        routes["ref32"] = []
    real, jreal = moe.dispatch, jmoe.moe_ffn

    def port_dispatch(p, x, c):
        routes["port"].append((x @ p["router"]).float().numpy())
        return real(p, x, c)

    def ref_moe(p, x, c):
        if x.dtype == jnp.bfloat16 or own_gap:
            routes["ref" if x.dtype == jnp.bfloat16 else "ref32"].append(
                np.asarray((x @ p["router"]).astype(jnp.float32)))
        return jreal(p, x, c)

    monkeypatch.setattr(moe, "dispatch", port_dispatch)
    monkeypatch.setattr(jmoe, "moe_ffn", ref_moe)
    S, cache_len = 48, 64
    toks = _batch(cfg, 25 + 2 * seed, 2, S)["tokens"]
    nxt = np.random.default_rng(26 + 2 * seed).integers(
        0, cfg.vocab_size, (8, 2, 1))
    lg, caches = lm.prefill_step(cfg, params,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 cache_len)
    ref = [jlm.prefill_step(c, p, {"tokens": jnp.asarray(toks)}, cache_len)
           for c, p in ((jcfg, jp), (jcfg32, jp_up))]
    checked = 0
    n_moe = sum(k in MOE_KINDS for k in layer_kinds(cfg))
    for step in range(9):
        assert all(len(r) == n_moe for r in routes.values())
        ref32 = routes.get("ref32", [None] * n_moe)
        flips = [f for lp, lr, l32 in zip(routes["port"], routes["ref"],
                                          ref32)
                 for f in _flips(lp, lr, cfg.moe_top_k,
                                 [(b, lp.shape[1] - 1) for b in range(2)],
                                 l32)]
        for r in routes.values():
            r.clear()
        for gap, bf16_step, own_router in flips:
            if own_router is None:
                assert gap <= bf16_step, (
                    f"{arch} step {step}: a routing difference {gap} "
                    f"apart, not a tie within one bf16 step ({bf16_step})")
            else:
                assert gap <= max(bf16_step, own_router), (
                    f"{arch} step {step}: a routing difference {gap} "
                    f"apart, past one bf16 step ({bf16_step}) and the "
                    f"reference's own bf16 noise there ({own_router})")
        if not flips or own_gap:
            want, want32 = (np.asarray(r[0], np.float32) for r in ref)
            err = float(np.abs(lg.float().numpy() - want).max())
            own = float(np.abs(want - want32).max())
            assert err <= BF16_RATIO * own + BF16_ATOL, (
                f"{arch} step {step}: port vs reference bf16 {err}, "
                f"reference bf16 vs float32 {own}")
            checked += 1
        if step == 8:
            break
        pos, tok = S + step, nxt[step].astype(np.int32)
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.from_numpy(tok).long(), pos)
        ref = [jlm.decode_step(c, p, r[1], jnp.asarray(tok), pos)
               for (c, p), r in zip(((jcfg, jp), (jcfg32, jp_up)), ref)]
    return checked


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_bf16_prefill_and_decode_match_reference(arch, monkeypatch):
    """The models in bf16 on the flash route: the prefill's logits and
    eight decode steps', each within ``BF16_RATIO`` of the reference's
    bf16-vs-float32 gap on the same bf16 weights plus ``BF16_ATOL``
    (``tests/test_torch_recurrent.py`` says why twice).

    The MoE's top-k is not continuous: bf16 rounds the router logits to 8
    bits, so two experts within one bf16 step of each other are a tie
    that each package may break by its own rounding, and a token routed
    to another expert takes another function.  So both packages' router
    logits are read at every layer (the reference unrolled,
    ``scan_layers=False``: the same operations, its values readable); a
    step where the compared position's routing differs is held to that:
    each differing choice a tie within one bf16 step in one package; the
    other steps, most of them, to the logits' tolerance.  Routing differs
    at 1 of the 9 steps on this seed (qwen3-moe-30b-a3b: 8 compared); the
    dense model compares all 9.

    MLA's model (``deepseek-v3-671b``, two ``mla_moe`` layers of 8
    experts, top 2) is held otherwise: its logits at every step, routing
    differences or not, and a routing difference may lie as far apart as
    the reference's own bf16-vs-float32 difference of that position's
    router logits (the reference's own rounding moves them that far; the
    one-step rule is relative to the logits' size, this noise is not).
    On this seed one difference at step 5 is 0.00122 apart (5 bf16 steps
    at its size 0.03-0.06) against the reference's own 0.00292 there, and
    the packages' router logits differ by 0.0015-0.0024 at every step
    against the reference's own 0.0020-0.0052; all 9 steps compared."""
    cfg = get_reduced(arch)
    checked = _bf16_against_reference(arch, 0, monkeypatch)
    if cfg.use_mla:
        assert checked == 9
    else:
        assert checked >= 7 if cfg.n_experts else checked == 9


def test_bf16_moe_matches_reference_on_a_second_seed(monkeypatch):
    """The same for qwen3-moe-30b-a3b on other weights and prompts
    (``PRNGKey(1)``): routing differs at none of the 9 steps here (9
    compared)."""
    assert _bf16_against_reference("qwen3-moe-30b-a3b", 1,
                                   monkeypatch) >= 7


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_moe_aux_and_gradients(remat):
    """The MoE's aux is summed over the layers under checkpointing as
    without it, and the gradients are the same."""
    cfg = get_reduced("qwen3-moe-30b-a3b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = _torch(_batch(cfg, 27, 2, 32, labels=True))
    out = {}
    for r in ("none", remat):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        loss, m = lm.loss_and_metrics(cfg.replace(remat=r), p, batch)
        loss.backward()
        out[r] = (m, p)
    (m0, p0), (m1, p1) = out["none"], out[remat]
    assert float(m0["aux"].detach()) > 0
    for k in ("loss", "aux"):
        _close(float(m1[k].detach()), float(m0[k].detach()), TOL, k)
    g0 = p0["segments"][0]["moe"]["router"].grad
    g1 = p1["segments"][0]["moe"]["router"].grad
    assert g0 is not None and float(g0.abs().max()) > 0
    _close(g1.numpy(), g0.numpy(), TOL)


# -- MoE's dispatch -----------------------------------------------------------


def _jax_dispatch(p, x, cfg):
    """The reference's routing and dispatch, step for step as
    ``repro/models/moe.py`` ``moe_ffn`` runs them, with its intermediates
    kept."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    C = max(1, int(S * K / E * cfg.capacity_factor))
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    counts = jnp.zeros((B, E), probs.dtype).at[
        jnp.arange(B)[:, None, None], gate_idx].add(1.0)
    aux = E * jnp.mean(jnp.sum(counts / (S * K) * probs.mean(axis=1),
                               axis=-1))
    tk = S * K
    eid = gate_idx.reshape(B, tk)
    tok = jnp.broadcast_to(jnp.arange(S)[:, None], (S, K)).reshape(tk)
    gw = gate_vals.reshape(B, tk)
    order = jnp.argsort(eid, axis=-1, stable=True)
    eid_s = jnp.take_along_axis(eid, order, axis=-1)
    starts = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(E)))(eid_s)
    rank = jnp.arange(tk)[None, :] - jnp.take_along_axis(starts, eid_s,
                                                         axis=-1)
    return dict(order=order, expert=eid_s, token=tok[order],
                weight=jnp.take_along_axis(gw, order, axis=-1), rank=rank,
                ok=rank < C, aux=aux)


def _moe_case(case):
    """(cfg, router, x) of an adversarial routing case."""
    cfg = get_reduced("qwen3-moe-30b-a3b")
    D, E = cfg.d_model, cfg.n_experts
    rng = np.random.default_rng(30)
    S = {"S1": 1, "S2": 2}.get(case, 37)
    router = (rng.standard_normal((D, E)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    if case == "zero router":
        # every probability ties: the lowest expert ids win, and each of
        # them takes all S tokens, far past the capacity
        router[:] = 0
    elif case == "one expert":
        # expert 3 wins every token, the others tie behind it (expert 0
        # second): two experts overflow
        router[:] = 0
        router[:, 3] = 1.0
        x = np.abs(x) + 1.0
    elif case == "shared experts":
        cfg = cfg.replace(n_shared_experts=2)
    return cfg, router, x


MOE_CASES = ("zero router", "one expert", "S1", "S2", "S37",
             "shared experts")


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_dispatch_is_the_reference_s_bit_for_bit(case):
    """Order, expert, token, rank and the kept mask (so the dropped pairs)
    bit-equal to the reference's, and aux where the router's probabilities
    are; the gates and the layer's output within ``TOL``."""
    cfg, router, x = _moe_case(case)
    jp = jlayers.init_tree(jmoe.moe_template(cfg), jax.random.PRNGKey(5))
    jp["router"] = jnp.asarray(router)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)),
                 jax.tree.map(np.asarray, jp))
    got = moe.dispatch(p, torch.from_numpy(x), cfg)
    want = _jax_dispatch(jp, jnp.asarray(x), cfg)
    for k in ("order", "expert", "token", "rank", "ok"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(want[k]), err_msg=k)
    # aux is bit-equal where the two packages' float32 softmax is (their
    # exp differs in the last bit on some inputs): then within 4 ulps
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    ulps = 0 if np.array_equal(probs.numpy(), np.asarray(jprobs)) else 4
    np.testing.assert_array_max_ulp(got.aux.numpy(), np.asarray(want["aux"]),
                                    ulps)
    _close(got.weight.numpy(), want["weight"], TOL)
    dropped = int((~got.ok).sum())
    C = moe.capacity(cfg, x.shape[1])
    if case in ("zero router", "one expert"):
        assert dropped == 2 * cfg.moe_top_k * (x.shape[1] - C) > 0
    if case == "zero router":
        assert set(got.expert.unique().tolist()) == set(
            range(cfg.moe_top_k))
    if case == "S1":  # C = 1, and a token's K experts are distinct
        assert dropped == 0
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    _close(out.numpy(), jout, TOL)
    np.testing.assert_array_max_ulp(aux.numpy(), np.asarray(jaux), ulps)


def test_moe_capacity_is_the_reference_s():
    cfg = get_config("qwen3-moe-30b-a3b")
    for S in (1, 2, 37, 2048, 4096):
        assert moe.capacity(cfg, S) == max(
            1, int(S * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))
    assert (moe.capacity(cfg, 1), moe.capacity(cfg, 4096)) == (1, 320)
    assert moe.capacity(cfg.replace(capacity_factor=8.0), 2056) == 1028


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_engine_matches_reference(arch):
    """More requests than slots, mixed prompt lengths, the longest on the
    flash route: the same greedy tokens as the reference's engine."""
    cfg, jcfg, params, jparams = _model(arch, **FLASH)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (48, 9, 32, 3)]
    serve = dict(max_slots=2, cache_len=64, max_new_tokens=5)
    eng = Engine(cfg, params, ServeConfig(**serve), device="cpu")
    jeng = JEngine(jcfg, jparams, JServeConfig(**serve))
    for pr in prompts:
        eng.submit(pr)
        jeng.submit(pr)
    assert eng.run() == jeng.run()


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_engine_and_cli_refuse_embedding_modes(arch, capsys):
    from repro_torch.launch import serve

    cfg = get_reduced(arch)
    with pytest.raises(ValueError, match=cfg.input_mode):
        Engine(cfg, {}, ServeConfig(), device="cpu")
    with pytest.raises(SystemExit, match=cfg.input_mode):
        serve.main(["--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-72b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_cli_serves_the_new_token_archs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--cache-len", "64"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 4 for v in out.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


# -- initialisation at full width ---------------------------------------------


def test_large_leaves_are_filled_slice_by_slice(monkeypatch):
    """A leaf above ``WHOLE_DRAW_ELEMENTS`` is filled in its dtype along its
    first dim, slices of at most ``SLICE_ELEMENTS`` (or one index), from
    the one generator, at the reference's scale (fan-in over the stack dim
    too); a leaf at or below it is the single float32 draw, scaled and
    cast, bit for bit."""
    t = layers.PT((6, 40, 30), ("stack", "embed", "mlp"))
    scale = 1.0 / np.sqrt(6 * 40)

    def single(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    def init(seed):
        return layers._init_one(t, torch.Generator().manual_seed(seed),
                                torch.bfloat16, "cpu")

    assert torch.equal(init(3), single(3, t.shape))
    monkeypatch.setattr(layers, "WHOLE_DRAW_ELEMENTS", 6 * 40 * 30 - 1)
    monkeypatch.setattr(layers, "SLICE_ELEMENTS", 2 * 40 * 30 + 7)
    got = init(3)
    assert got.dtype == torch.bfloat16 and got.shape == t.shape
    assert torch.equal(got, init(3))
    # two layers a slice, drawn one after the other from one generator
    g = torch.Generator().manual_seed(3)
    want = torch.cat([(torch.randn((2, 40, 30), generator=g) * scale).to(
        torch.bfloat16) for _ in range(3)])
    assert torch.equal(got, want)
    assert abs(float(got.float().std()) / scale - 1.0) < 0.05
    monkeypatch.setattr(layers, "SLICE_ELEMENTS", 1)  # one index a slice
    g = torch.Generator().manual_seed(4)
    want = torch.cat([(torch.randn((1, 40, 30), generator=g) * scale).to(
        torch.bfloat16) for _ in range(6)])
    assert torch.equal(init(4), want)
