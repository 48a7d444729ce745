"""The port's serving engine against the JAX package's, on the CPU.

Reduced ``llama3.2-1b`` with the reference's parameters carried across:
the port's ``Engine`` (slots as a batch dimension written out, one
position per slot) gives the same greedy token lists as the reference's
(``vmap`` over B=1 slot caches) for the requests of ``tests/test_serve.py``
— more requests than slots, mixed prompt lengths — for prompts on the
flash route, and for a request that runs until it retires at
``cache_len - 1`` while the other slots keep decoding.  The same for the
recurrent and hybrid families (reduced ``recurrentgemma-2b`` and
``xlstm-125m``), whose slots hold recurrent states: each slot's state
equals its request's state served alone.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig

from repro_torch.configs import get_reduced
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine, ServeConfig


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no trace of
    the reference made here outlives the file (ROADMAP.md section 3)."""
    yield
    jax.clear_caches()


def _model(arch="llama3.2-1b", **kw):
    jcfg = j_get_reduced(arch).replace(**kw)
    cfg = get_reduced(arch).replace(**kw)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def model():
    return _model()


def _both(model, prompts, **serve):
    cfg, params, jcfg, jparams = model
    eng = Engine(cfg, params, ServeConfig(**serve), device="cpu")
    jeng = JEngine(jcfg, jparams, JServeConfig(**serve))
    rids = [eng.submit(p) for p in prompts]
    jrids = [jeng.submit(p) for p in prompts]
    assert rids == jrids
    got = eng.run()
    # the engine's stats account for every token it produced
    st = eng.stats
    assert sorted(n for n, _ in st.prefill) == sorted(len(p) for p in prompts)
    assert len(st.prefill) + st.decode_tokens == sum(map(len, got.values()))
    assert st.decode_steps > 0 and st.decode_s > 0
    return got, jeng.run(), rids


def test_engine_matches_reference_single_request(model):
    prompt = np.arange(9) % 256
    got, want, rids = _both(model, [prompt], max_slots=2, cache_len=64,
                            max_new_tokens=8)
    assert got == want
    assert len(got[rids[0]]) == 8


def test_continuous_batching_mixed_lengths_matches_reference(model):
    prompts = [np.arange(3 + 5 * i) % 256 for i in range(5)]
    got, want, rids = _both(model, prompts, max_slots=2, cache_len=96,
                            max_new_tokens=6)
    assert set(got) == set(rids)
    assert got == want


def test_prompts_on_the_flash_route_match_reference():
    """attn_kv_block=16: the 32- and 48-token prompts take the flash route
    (its plain version on the CPU), the others the materialised one."""
    model = _model(attn_q_block=16, attn_kv_block=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n) for n in (48, 16, 32, 9, 48)]
    got, want, _ = _both(model, prompts, max_slots=2, cache_len=64,
                         max_new_tokens=7)
    assert got == want


def test_request_retiring_at_the_cache_end_matches_reference(model):
    """The first request fills its slot's cache and retires at cache_len-1;
    that slot is then decoded while free (at the position it last held, the
    cache's last slot) until the queue refills it."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n) for n in (30, 5, 12, 7)]
    got, want, rids = _both(model, prompts, max_slots=2, cache_len=40,
                            max_new_tokens=20)
    assert got == want
    assert len(got[rids[0]]) == 40 - 1 - 30 + 1  # stopped by the cache
    assert all(len(got[r]) == 20 for r in rids[1:])


def test_temperature_sampling_is_seeded_and_in_range(model):
    cfg, params, _, _ = model
    prompts = [np.arange(5 + i) % 256 for i in range(3)]

    def run(temperature):
        eng = Engine(cfg, params, ServeConfig(
            max_slots=2, cache_len=32, max_new_tokens=6, greedy=False,
            temperature=temperature), device="cpu")
        for p in prompts:
            eng.submit(p)
        return eng.run()

    a, b = run(1.5), run(1.5)
    assert a == b  # the engine's own generator, seeded
    assert all(0 <= t < cfg.vocab_size for v in a.values() for t in v)
    assert all(len(v) == 6 for v in a.values())


def test_eos_stops_a_request_early_as_in_reference(model):
    """A decoded token equal to ``eos_id`` ends its request (the prefill's
    token is not checked, in either package)."""
    prompts = [np.arange(9) % 256, np.arange(4, 20) % 256]
    full, _, rids = _both(model, prompts, max_slots=2, cache_len=64,
                          max_new_tokens=8)
    eos = full[rids[1]][4]
    got, want, rids = _both(model, prompts, max_slots=2, cache_len=64,
                            max_new_tokens=8, eos_id=eos)
    assert got == want
    assert len(got[rids[1]]) < 8 and got[rids[1]][-1] == eos


def test_cli_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                      "4", "--cache-len", "64"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 4 for v in out.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_engine_needs_a_card_by_default(model):
    cfg, params, _, _ = model
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        Engine(cfg, params, ServeConfig())


RECURRENT = ("recurrentgemma-2b", "xlstm-125m")


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent_model(request):
    return _model(request.param)


def test_recurrent_families_match_reference_mixed_lengths(recurrent_model):
    """Five requests on two slots, prompts of 45 (past RecurrentGemma's
    32-token window and xLSTM's 32-token chunk), 9, 33, 16 and 50 tokens."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in (45, 9, 33, 16, 50)]
    got, want, rids = _both(recurrent_model, prompts, max_slots=2,
                            cache_len=96, max_new_tokens=6)
    assert set(got) == set(rids)
    assert got == want


def test_hybrid_prompts_on_the_flash_route_match_reference():
    """RecurrentGemma with attn_kv_block=16: the 32- and 48-token prompts
    take the flash route with the local window (its plain version on the
    CPU)."""
    model = _model("recurrentgemma-2b", attn_q_block=16, attn_kv_block=16)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n) for n in (48, 16, 32, 9)]
    got, want, _ = _both(model, prompts, max_slots=2, cache_len=64,
                         max_new_tokens=7)
    assert got == want


def _slot_state(eng, slot):
    """Slot ``slot``'s leaves of every segment's decode state."""
    out = []
    for (_, n, _), seg in zip(tfm.stack_templates(eng.cfg), eng._caches):
        out += [t[:, slot] if n > 1 else t[slot] for t in seg]
    return out


def test_each_slot_holds_its_request_s_state(recurrent_model):
    """Two requests of each family in two slots: after their prefills and
    three decode steps, each slot's state (recurrent states, rolling KV
    caches) equals that of the same request served alone in slot 0, to
    float32 rounding (a batch of two rows against one)."""
    cfg, params, _, _ = recurrent_model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n) for n in (37, 20)]
    scfg = ServeConfig(max_slots=2, cache_len=64, max_new_tokens=8)

    def served(ps, steps=4):
        eng = Engine(cfg, params, scfg, device="cpu")
        for p in ps:
            eng.submit(p)
        for _ in range(steps):  # the prefills, then three decode steps
            eng.step()
        return eng

    both = served(prompts)
    assert [r.rid for r in both._slots] == [0, 1]
    for slot, p in enumerate(prompts):
        alone = served([p])
        assert alone._slots[0].generated == both._slots[slot].generated
        for got, want in zip(_slot_state(both, slot), _slot_state(alone, 0)):
            np.testing.assert_allclose(got.float().numpy(),
                                       want.float().numpy(), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", RECURRENT)
def test_cli_serves_the_recurrent_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--cache-len", "64"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 4 for v in out.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
