"""DeepSeek-V3 Multi-head Latent Attention (MLA).

The port of ``repro/models/mla.py``.  Prefill and training reconstruct
each head's K/V from the compressed latents and attend in query blocks of
``cfg.attn_q_block``, scores materialised and softmaxed in float32, as the
reference does.  Decode is the *absorbed* form: ``wk_b`` is folded into
the query and ``wv_b`` into the output, so the cache holds only ``c_kv``
(``kv_lora_rank``) and ``k_rope`` (``qk_rope_dim``) a token, 512 + 64 at
the published size, and no head's K/V is ever built.

The reference has no Pallas kernel here: it is einsums and a float32
softmax, so this is plain torch, and MLA does not take the flash route.
As in ``attention.py``, :func:`mla_decode` writes the new cache entry in
place and takes a position per row (the engine's slots), where the
reference takes one scalar position and returns a new cache; at one
position for every row the two agree.  :func:`mla_prefill` computes the
latents once where the reference computes them twice (the same values).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .attention import NEG_INF, _row_positions
from .layers import PT, apply_rope, rmsnorm


def mla_template(cfg) -> Dict[str, PT]:
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": PT((d, ql), ("embed", "q_lora")),
        "q_norm": PT((ql,), ("q_lora",), "ones"),
        "wq_b": PT((ql, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "wkv_a": PT((d, kl + dr), ("embed", "kv_lora")),
        "kv_norm": PT((kl,), ("kv_lora",), "ones"),
        "wk_b": PT((kl, h, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": PT((kl, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": PT((h, dv, d), ("heads", "head_dim", "embed")),
    }


def _latents(p, x, cfg, positions):
    """Shared down-projections: (q_nope, q_rope, c_kv, k_rope)."""
    dn, kl = cfg.qk_nope_dim, cfg.kv_lora_rank
    cq = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsl,lhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p["wkv_a"]  # (B, S, kl + dr)
    c_kv = rmsnorm(ckv_full[..., :kl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., kl:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _scale(cfg) -> float:
    return 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)


def _materialised(p, cfg, q_nope, q_rope, c_kv, k_rope):
    """Causal attention over the latents of a whole sequence: each head's
    K/V built from ``c_kv``, the rope channel shared by the heads, query
    blocks of ``cfg.attn_q_block`` when the sequence is longer."""
    B, S = c_kv.shape[:2]
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["wv_b"])
    scale = _scale(cfg)
    kpos = torch.arange(S, device=c_kv.device)
    qb = cfg.attn_q_block

    def block(qn, qr, qpos):
        s = (torch.einsum("bqhk,bshk->bhqs", qn, k_nope)
             + torch.einsum("bqhk,bsk->bhqs", qr, k_rope))
        s = s.to(torch.float32) * scale
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bshk->bqhk", w, v)

    if S <= qb:
        ctx = block(q_nope, q_rope, kpos)
    else:
        assert S % qb == 0, (S, qb)
        ctx = torch.cat([
            block(q_nope[:, i:i + qb], q_rope[:, i:i + qb],
                  i + torch.arange(qb, device=c_kv.device))
            for i in range(0, S, qb)], dim=1)
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


def mla_attention(p, x, cfg, positions):
    """Train/prefill path: K/V materialised per head, query blocks."""
    return _materialised(p, cfg, *_latents(p, x, cfg, positions))


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S_cache, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S_cache, qk_rope_dim)


def init_mla_cache(cfg, batch: int, cache_len: int, dtype,
                   device="cuda") -> MLACache:
    return MLACache(
        torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                    device=device))


def mla_prefill(p, x, cfg, positions, cache_len: int):
    """Full-sequence pass that also fills the compressed decode cache:
    (out, MLACache) with token t at slot t, zero-padded to ``cache_len``."""
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, positions)
    out = _materialised(p, cfg, q_nope, q_rope, c_kv, k_rope)
    S = x.shape[1]
    if cache_len < S:
        raise ValueError(f"prompt of {S} tokens longer than the cache "
                         f"({cache_len})")
    pad = (0, 0, 0, cache_len - S)
    return out, MLACache(F.pad(c_kv, pad), F.pad(k_rope, pad))


def mla_decode(p, x, cfg, cache: MLACache, pos):
    """Absorbed one-token decode.  x: (B, 1, D); pos: a scalar, or one
    position per row (B,).

    Each row writes its ``c_kv`` and ``k_rope`` into ``cache`` in place at
    slot ``pos`` clamped into ``[0, S_c - 1]`` (the reference's
    ``dynamic_update_slice`` clamps so) and attends over the slots
    ``idx <= pos``, in the latent space: the query through ``wk_b``, the
    context back through ``wv_b``.  Returns (out, cache)."""
    B = x.shape[0]
    pos = _row_positions(pos, B, x.device)
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, pos[:, None])
    ckv, krp = cache
    S_c = ckv.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = pos.clamp(0, S_c - 1)
    ckv[rows, slot] = c_kv[:, 0].to(ckv.dtype)
    krp[rows, slot] = k_rope[:, 0].to(krp.dtype)

    q_abs = torch.einsum("bqhk,lhk->bqhl", q_nope, p["wk_b"])
    s = (torch.einsum("bqhl,bsl->bhqs", q_abs, ckv)
         + torch.einsum("bqhk,bsk->bhqs", q_rope, krp))
    s = s.to(torch.float32) * _scale(cfg)
    valid = torch.arange(S_c, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(ckv.dtype)
    ctx_l = torch.einsum("bhqs,bsl->bqhl", w, ckv)  # latent-space context
    ctx = torch.einsum("bqhl,lhk->bqhk", ctx_l, p["wv_b"])
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"]), cache
