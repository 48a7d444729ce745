"""The port's flash attention (plain version and wrapper) against the JAX
package on the CPU.

The plain block loop, which the wrapper takes for CPU tensors and which the
card tests hold the CUDA kernel against, is compared with the reference's
Pallas kernel ``flash_attention_pallas`` in interpret mode over the shape
sweep, non-causal and bfloat16 cases of ``tests/test_kernels.py``, and
with the reference's ``_flash_attention`` (the ``lax.scan`` form on the
serving path) under grouped KV heads, a local window and padded heads, as
``tests/test_models.py::test_flash_equals_reference`` does.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention_pallas
from repro.models.attention import _flash_attention as j_flash
from repro.models.attention import causal_attention as j_causal

from repro_torch.kernels import flash_attn as kflash


@pytest.fixture(scope="module", autouse=True)
def _leave_no_jax_trace():
    """Clear JAX's caches once this file's tests are done, so no trace of
    the reference made here outlives the file (ROADMAP.md section 3)."""
    yield
    jax.clear_caches()


def _qkv(seed, B, S, H, KV, hd, std=0.4):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * std).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize(
    "B,S,H,hd,qb,kvb",
    [(2, 64, 2, 16, 16, 16), (1, 128, 4, 32, 32, 64),
     (2, 96, 3, 8, 32, 32), (1, 256, 2, 64, 64, 64)],
)
def test_plain_matches_pallas_kernel(B, S, H, hd, qb, kvb):
    q, k, v = _qkv(0, B, S, H, H, hd)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_block=qb, kv_block=kvb,
                                  interpret=True)
    got = kflash.flash_attention_plain(*_t(q, k, v), q_block=qb,
                                       kv_block=kvb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_matches_pallas_kernel_noncausal():
    q, k, v = _qkv(1, 1, 64, 2, 2, 16)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, q_block=32,
                                  kv_block=32, interpret=True)
    got = kflash.flash_attention_plain(*_t(q, k, v), causal=False,
                                       q_block=32, kv_block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(2, 1, 64, 2, 2, 16)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, q_block=16, kv_block=16,
                                  interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jq, jk, jv))
    got = kflash.flash_attention_plain(tq, tk, tv, q_block=16, kv_block=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kflash.TOLERANCE[torch.bfloat16])
    # and the reference's materialised oracle, as tests/test_kernels.py has
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.flash_attention(jq, jk, jv), np.float32),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("kv_heads,pad_to", [(4, 0), (2, 0), (2, 8), (1, 8)])
def test_plain_matches_reference_flash_attention(window, kv_heads, pad_to):
    """GQA by indexing (the plain version repeats K/V, the kernel indexes
    them), local windows and padded heads against ``_flash_attention``."""
    cfg = get_reduced("llama3.2-1b").replace(
        n_heads=4, n_kv_heads=kv_heads, head_dim=16, attn_q_block=16,
        attn_kv_block=0, tp_head_pad=pad_to)
    B, S, H, hd = 2, 64, 4, 16
    q, k, v = _qkv(3, B, S, H, kv_heads, hd, std=0.3)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = np.asarray(j_causal(jq, jk, jv, cfg, window=window))
    for kvb in (16, 32, 64):
        want = j_flash(jq, jk, jv, cfg.replace(attn_kv_block=kvb),
                       1.0 / hd**0.5, window=window, pad_to=pad_to)
        got = kflash.flash_attention_plain(*_t(q, k, v), scale=1.0 / hd**0.5,
                                           window=window, q_block=16,
                                           kv_block=kvb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=f"kvb={kvb}")
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5,
                                   err_msg=f"kvb={kvb} vs materialised")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 24)])
def test_ragged_lengths_and_blocks_agree(causal, window):
    """A length that no block divides (96 over 64-row tiles, the kernel's)
    gives what one block over the whole sequence gives, and what a
    materialised softmax under the same mask gives."""
    q, k, v = _qkv(4, 1, 96, 4, 2, 16)
    tq, tk, tv = _t(q, k, v)
    got = kflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    one = kflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, q_block=96,
                                       kv_block=96)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=2e-5,
                               atol=2e-5)
    i = torch.arange(96)
    keep = torch.ones((96, 96), dtype=torch.bool)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    kr = tk.repeat_interleave(2, dim=2)
    vr = tv.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, kr) / 4.0
    s = s.masked_fill(~keep, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_autograd_route_gradient_equals_reference_grad(window, kv_heads):
    """A flash call that needs a gradient goes through ``FlashAttention``
    (forward: the kernel on the card, the plain loop here; backward: the
    plain loop recomputed): its q, k, v gradients equal ``jax.vjp`` of the
    reference's ``_flash_attention`` under one cotangent.  Both configs
    set ``attn_kv_block=32``, so the 128-token sequence takes the flash
    route (tiles 64 x 32).  Float32 tolerance: atol 1e-5 on gradients of
    magnitude up to about 1, the two summing in different orders."""
    from repro_torch.configs import get_reduced as port_reduced
    from repro_torch.models.attention import _flash_attention as p_flash

    B, S, H, hd = 2, 128, 4, 16
    cfg = get_reduced("llama3.2-1b").replace(
        n_heads=H, n_kv_heads=kv_heads, head_dim=hd, attn_kv_block=32)
    pcfg = port_reduced("llama3.2-1b").replace(
        n_heads=H, n_kv_heads=kv_heads, head_dim=hd, attn_kv_block=32)
    assert S > cfg.attn_kv_block and (cfg.attn_q_block, pcfg.attn_q_block) \
        == (64, 64)
    q, k, v = _qkv(6, B, S, H, kv_heads, hd, std=0.5)
    cot = np.random.default_rng(7).standard_normal((B, S, H, hd)).astype(
        np.float32)
    scale = 1.0 / hd**0.5
    want_out, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, cfg, scale, window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(cot))

    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = p_flash(tq, tk, tv, pcfg, scale, window=window)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-5, atol=2e-5)
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=f"d{name}")


def test_no_grad_call_bypasses_the_autograd_route():
    """Without a gradient (serving) the wrapper returns the plain version
    (the kernel on the card) directly, with no graph attached."""
    q, k, v = _t(*_qkv(8, 1, 64, 4, 2, 16))
    out = kflash.flash_attention(q, k, v)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert kflash.flash_attention(qg, k, v).grad_fn is None
    assert torch.equal(kflash.flash_attention(qg, k, v).detach(), out)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _t(*_qkv(5, 1, 8, 4, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        kflash.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(5, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        kflash.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError, match="window"):
        kflash.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        kflash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_is_registered_with_its_tpu_kernel():
    from repro_torch.kernels import KERNELS

    assert kflash.KERNEL in KERNELS
    assert kflash.KERNEL.source.name == "flash_attn.cu"
    assert kflash.KERNEL.source.exists()
    assert kflash.KERNEL.replaces == "src/repro/kernels/flash_attn.py:76"
