"""The port's training runtime: twins of ``tests/test_train.py`` on the CPU,
and three train steps held against the JAX package.

AdamW, decay mask, clipping and schedule are held against the reference's
``update`` and ``schedule`` on the same trees; microbatching against the
full batch; the loop's restart against an unbroken run, bit for bit,
through the port's ``CheckpointManager``; ``make_train_step`` against the
reference's jitted step from one state (``params_from_jax``,
``opt_state_from_jax``) on both attention routes; the three remat modes
against each other; and the ``launch.train`` CLI end to end.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as ref_reduced
from repro.models import lm as ref_lm
from repro.train import OptConfig as RefOptConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train import opt_init as ref_opt_init
from repro.train import opt_update as ref_opt_update
from repro.train.optim import schedule as ref_schedule

from repro_torch._tree import leaves, tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import LoaderConfig, TokenLoader
from repro_torch.models import lm
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import (
    LoopConfig,
    OptConfig,
    StragglerMonitor,
    Trainer,
    grads_and_metrics,
    make_eval_step,
    make_train_step,
    opt_init,
    opt_update,
)
from repro_torch.train.optim import _decay_mask, schedule

ROOT = os.path.join(os.path.dirname(__file__), "..")

#: float32 tolerances against the reference, whose XLA programs sum in
#: another order: the loss and the gradient norm to a few float32 ulps
#: (rtol 2e-6); parameters after AdamW steps to 1% of one step of lr
#: 1e-3 each (atol 1e-5 a step): a weight whose gradient is near AdamW's
#: eps (1e-8) moves by mu/(sqrt(nu)+eps), which takes the last bits of
#: its gradient up to the step size
LOSS_RTOL = 2e-6
PARAM_ATOL_PER_STEP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    yield
    jax.clear_caches()


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"mat": rng.standard_normal((6, 5)).astype(np.float32),
            "seg": [{"w": rng.standard_normal((3, 4, 2)).astype(np.float32),
                     "b": rng.standard_normal((4,)).astype(np.float32)}],
            "vec": rng.standard_normal((7,)).astype(np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, **tol):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_matches_reference_update(clip):
    """Four steps of the port's update against the reference's on random
    trees (matrices decayed, vectors not; clipping on and off)."""
    kw = dict(lr=0.05, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.1,
              grad_clip=clip, warmup_steps=2, total_steps=10,
              min_lr_frac=0.1)
    pc, rc = OptConfig(**kw), RefOptConfig(**kw)
    p, rp = _to_torch(_np_tree(0)), _to_jax(_np_tree(0))
    st, rst = opt_init(pc, p), ref_opt_init(rc, rp)
    for i in range(4):
        g = _np_tree(10 + i)
        p, st, m = opt_update(pc, _to_torch(g), st, p)
        rp, rst, rm = ref_opt_update(rc, _to_jax(g), rst, rp)
        _close(p, rp, rtol=1e-6, atol=1e-7)
        _close(st.mu, rst.mu, rtol=1e-6, atol=1e-8)
        _close(st.nu, rst.nu, rtol=1e-6, atol=1e-8)
        assert int(st.count) == int(rst.count) == i + 1
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)


def test_adamw_matches_numpy():
    cfg = OptConfig(lr=0.1, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                    grad_clip=1e9, warmup_steps=0, total_steps=10**9,
                    min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([0.5])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3]), "b": torch.tensor([1.0])}
    new_p, _, _ = opt_update(cfg, g, opt_init(cfg, p), p)
    gw = g["w"].numpy().astype(np.float64)
    mhat = 0.1 * gw / (1 - 0.9)
    vhat = 0.001 * gw ** 2 / (1 - 0.999)
    want = p["w"].numpy() - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)


def test_weight_decay_only_on_matrices():
    cfg = OptConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9, warmup_steps=0,
                    min_lr_frac=1.0)
    p = {"mat": torch.ones((4, 4)), "vec": torch.ones((4,))}
    assert _decay_mask(p) == {"mat": True, "vec": False}
    g = tree_map(torch.zeros_like, p)
    new_p, _, _ = opt_update(cfg, g, opt_init(cfg, p), p)
    assert float(new_p["mat"][0, 0]) < 1.0  # decayed
    assert float(new_p["vec"][0]) == 1.0  # not decayed


def test_grad_clip():
    cfg = OptConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, min_lr_frac=1.0,
                    weight_decay=0.0)
    p = {"w": torch.zeros((3,))}
    g = {"w": torch.tensor([30.0, 40.0, 0.0])}  # norm 50
    new_p, st, m = opt_update(cfg, g, opt_init(cfg, p), p)
    assert float(m["grad_norm"]) == pytest.approx(50.0)
    # clipped to norm 1 before the moments
    np.testing.assert_allclose(st.mu["w"].numpy(), [0.06, 0.08, 0.0],
                               rtol=1e-6)


def test_schedule_shape_and_reference():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    rcfg = RefOptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_frac=0.1)
    steps = [0, 5, 10, 37, 60, 110, 200]
    lrs = [float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[4] < 1.0
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)
    assert lrs[6] == pytest.approx(0.1, abs=1e-6)
    want = [float(ref_schedule(rcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-7)


def _batch(cfg, B=8, S=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}


def test_microbatch_equals_full_batch():
    """Grad accumulation over 4 microbatches == single-shot gradients."""
    cfg = get_reduced("llama3.2-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _batch(cfg)
    g_full, m_full = grads_and_metrics(cfg, params, batch)
    g_micro, m_micro = grads_and_metrics(cfg.replace(microbatch=4), params,
                                         batch)
    assert float(m_full["loss"]) == pytest.approx(float(m_micro["loss"]),
                                                  rel=1e-5)
    for a, b in zip(leaves(g_full), leaves(g_micro)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_loss_masks_negative_labels_and_eval_step():
    cfg = get_reduced("llama3.2-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _batch(cfg, B=2, S=16)
    loss, m = lm.loss_and_metrics(cfg, params, batch)
    assert float(m["tokens"]) == 32.0
    masked = dict(batch, labels=batch["labels"].clone())
    masked["labels"][:, 8:] = -1
    loss_m, mm = lm.loss_and_metrics(cfg, params, masked)
    assert float(mm["tokens"]) == 16.0 and float(mm["aux"]) == 0.0
    # the masked loss is the mean over the first 8 positions only
    logits = lm.forward(cfg, params, batch).to(torch.float32)
    nll = torch.nn.functional.cross_entropy(
        logits[:, :8].reshape(-1, cfg.vocab_size),
        batch["labels"][:, :8].reshape(-1))
    assert float(loss_m) == pytest.approx(float(nll), rel=1e-5)
    ev = make_eval_step(cfg)(params, batch)
    assert float(ev["loss"]) == float(loss) == float(ev["ce"])


def _ref_and_port(kv_block: int, arch: str = "llama3.2-1b"):
    rcfg = ref_reduced(arch).replace(attn_kv_block=kv_block)
    cfg = get_reduced(arch).replace(attn_kv_block=kv_block)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rst = ref_opt_init(RefOptConfig(**kw), rparams)
    host = jax.tree.map(np.asarray, (rparams, rst))
    params = params_from_jax(cfg, host[0], device="cpu")
    st = opt_state_from_jax(cfg, host[1], device="cpu")
    return (rcfg, rparams, rst, RefOptConfig(**kw)), (cfg, params, st,
                                                      OptConfig(**kw))


#: the recurrent families' parameters a step.  AdamW moves an element by
#: ``lr m / (sqrt(v) + eps)``; where a step's gradient is within an order of
#: eps (``0 < |g| < NOISE_GRAD``), below what either package's float32
#: gradient resolves, that ratio carries rounding noise up to lr itself, so
#: such an element is held to ``2 lr`` a step (the most AdamW can move two
#: runs apart), every other to ``PARAM_ATOL_PER_STEP``.  Measured: a few
#: elements of the reduced models (recurrentgemma-2b's MLP gate, xlstm-125m's
#: mLSTM q and k, first-step gradients near 1e-8) differ by up to 7.4e-5,
#: the rest within 1e-5; the sLSTM's input-gate bias, whose gradient is zero
#: in exact arithmetic (a common shift of every ``i_pre`` scales c and n
#: alike, so h does not move), is noise near 1e-10 in both packages.  The
#: reference's gradient of step t is read from its first moment, ``(mu_t -
#: b1 mu_{t-1}) / (1 - b1)`` (an exact zero moves neither package)
NOISE_GRAD = 1e-7
#: from the second step the parameters differ by those elements, and the
#: gradient norm by up to 3.6e-6 relative (xlstm-125m, step 2; autograd
#: through the plain loops, before the scans had backward Functions, gave
#: 4.4e-6 on the same data): the loss stays within ``LOSS_RTOL``
RECURRENT_NORM_RTOL = 1e-5


@pytest.mark.parametrize("arch,kv_block,shape", [
    ("llama3.2-1b", 1024, (4, 32)), ("llama3.2-1b", 16, (4, 32)),
    ("recurrentgemma-2b", 1024, (2, 40)), ("xlstm-125m", 1024, (2, 40))],
    ids=["1024", "16", "recurrentgemma-2b", "xlstm-125m"])
def test_three_train_steps_match_reference(arch, kv_block, shape):
    """Three steps of ``make_train_step`` from the reference's state: for
    llama3.2-1b on the materialised attention route (kv_block 1024 > S)
    and on the flash route (kv_block 16 < S 32, the autograd route of the
    flash kernel); for the recurrent families at 2 x 40 tokens, so the
    window of 32 and the mLSTM chunk of 32 are both crossed (the three
    scans' Functions, their plain backwards on the CPU)."""
    (rcfg, rp, rst, rocfg), (cfg, p, st, ocfg) = _ref_and_port(kv_block,
                                                               arch)
    rstep = jax.jit(ref_make_train_step(rcfg, rocfg))
    step = make_train_step(cfg, ocfg)
    rng = np.random.default_rng(0)
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(rp)]
    noisy = [np.zeros(np.shape(x), bool) for x in jax.tree.leaves(rp)]
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        lab = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        lab[0, :5] = -1
        mu0 = [np.asarray(x) for x in jax.tree.leaves(rst.mu)]
        rp, rst, rm = rstep(rp, rst, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.asarray(lab)})
        p, st, m = step(p, st, {"tokens": torch.from_numpy(tok).long(),
                                "labels": torch.from_numpy(lab).long()})
        for k in ("loss", "grad_norm", "lr"):
            rel = (RECURRENT_NORM_RTOL if k == "grad_norm" and i
                   and not arch.startswith("llama") else LOSS_RTOL)
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=rel)
        if arch.startswith("llama"):
            _close(p, rp, rtol=0, atol=PARAM_ATOL_PER_STEP * (i + 1))
        else:
            b1 = rocfg.betas[0]
            for path, a, b, mu, mu_was, nz in zip(
                    paths, leaves(p), jax.tree.leaves(rp),
                    jax.tree.leaves(rst.mu), mu0, noisy):
                g = np.abs((np.asarray(mu) - b1 * mu_was) / (1 - b1))
                nz |= (g > 0) & (g < NOISE_GRAD)
                atol = np.where(nz, 2 * rocfg.lr, PARAM_ATOL_PER_STEP)
                err = np.abs(a.numpy() - np.asarray(b)) - atol * (i + 1)
                assert float(err.max()) <= 0, path
        assert int(st.count) == int(rst.count) == i + 1


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("kv_block", [1024, 16])
def test_remat_gives_equal_gradients(remat, kv_block):
    cfg = get_reduced("llama3.2-1b").replace(attn_kv_block=kv_block)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _batch(cfg, B=2)
    g0, m0 = grads_and_metrics(cfg, params, batch)
    g1, m1 = grads_and_metrics(cfg.replace(remat=remat), params, batch)
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_remat_rejects_unknown_mode():
    cfg = get_reduced("llama3.2-1b").replace(remat="everything")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError):
        lm.loss_and_metrics(cfg, params, _batch(cfg, B=1, S=8))


def _mk_trainer(tmp, total=24, ckpt_every=8, ckpt_async=False):
    cfg = get_reduced("llama3.2-1b")
    corpus = np.random.default_rng(0).integers(0, 200, 60_000, dtype=np.uint8)
    loader = TokenLoader(corpus, LoaderConfig(batch_size=4, seq_len=32))
    ckpt = CheckpointManager(os.path.join(tmp, "ck"), keep=2, device="cpu")
    return Trainer(
        cfg,
        OptConfig(lr=1e-3, warmup_steps=4, total_steps=total),
        LoopConfig(total_steps=total, ckpt_every=ckpt_every, log_every=0,
                   ckpt_async=ckpt_async),
        loader,
        ckpt,
        device="cpu",
    )


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_loop_restart_bit_determinism(tmp_path, ckpt_async):
    """Run 24 steps straight; run 16 + crash + resume to 24: identical
    params and optimizer state."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    t_full = _mk_trainer(str(tmp_path / "a"), ckpt_async=ckpt_async)
    p_full, o_full = t_full.run(gen())

    t_ab = _mk_trainer(str(tmp_path / "b"), ckpt_async=ckpt_async)
    t_ab.run(gen(), steps=16)  # "crash" after step 15 (ckpt at step 15)
    t_resume = _mk_trainer(str(tmp_path / "b"), ckpt_async=ckpt_async)
    p_resume, o_resume = t_resume.run(gen())
    assert t_resume.history[0]["step"] == 16  # resumed, not restarted
    assert [h["loss"] for h in t_resume.history] == [
        h["loss"] for h in t_full.history[16:]]
    for a, b in zip(leaves((p_full, o_full)), leaves((p_resume, o_resume))):
        assert torch.equal(a, b)
    assert t_resume.ckpt.steps() == [15, 23]
    assert t_resume.ckpt.dedup_savings >= 0.0


def test_loader_restart_determinism():
    corpus = np.random.default_rng(0).integers(0, 256, 10_000, dtype=np.uint8)
    l1 = TokenLoader(corpus, LoaderConfig(batch_size=4, seq_len=16))
    l2 = TokenLoader(corpus, LoaderConfig(batch_size=4, seq_len=16))
    for step in (0, 7, 123):
        np.testing.assert_array_equal(l1.batch_at(step)[0],
                                      l2.batch_at(step)[0])


def test_loader_host_sharding():
    corpus = np.random.default_rng(0).integers(0, 256, 10_000, dtype=np.uint8)
    full = TokenLoader(corpus, LoaderConfig(batch_size=8, seq_len=16))
    h0 = TokenLoader(corpus, LoaderConfig(batch_size=8, seq_len=16,
                                          host_index=0, host_count=2))
    h1 = TokenLoader(corpus, LoaderConfig(batch_size=8, seq_len=16,
                                          host_index=1, host_count=2))
    np.testing.assert_array_equal(
        np.concatenate([h0.batch_at(3)[0], h1.batch_at(3)[0]]),
        full.batch_at(3)[0])


def test_straggler_monitor():
    events = []
    mon = StragglerMonitor(factor=3.0, alpha=0.5, policy=events.append)
    for _ in range(5):
        mon.observe(0, 0.1)
    mon.observe(5, 1.0)  # 10x the EWMA -> event
    assert len(mon.events) == 1 and events[0]["dt"] == 1.0
    mon.observe(6, 0.1)
    assert len(mon.events) == 1


@pytest.mark.timeout(120)
def test_launch_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "4", "--batch", "4", "--seq", "64", "--corpus-mb", "2",
         "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=110)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert any(l.startswith("dedup ingest:") for l in lines)
    final = [l for l in lines if l.startswith("final loss")]
    assert final and "(4 steps run)" in final[0]
    assert math.isfinite(float(final[0].split()[2]))
    assert any(l.startswith("checkpoint store savings:") for l in lines)
    assert sorted(os.listdir(tmp_path / "ck"))[:2] == [
        "latest", "manifest-00000001.json"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-2b"])
def test_launch_train_cli_on_cpu_trains_the_recurrent_families(arch):
    """``--arch ... --reduced`` on the CPU: the scans' Functions (their
    plain backwards) through the CLI, a few steps, a finite final loss."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "48", "--corpus-mb", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=110)
    assert out.returncode == 0, out.stderr[-2000:]
    final = [l for l in out.stdout.splitlines() if l.startswith("final loss")]
    assert final and "(3 steps run)" in final[0]
    assert math.isfinite(float(final[0].split()[2]))
