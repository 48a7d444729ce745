"""GQA/MQA/MHA attention with RoPE, KV caches, local windows, query blocks.

The port of ``repro/models/attention.py`` for the dense block and the
hybrid family's local-window MQA (the ``attn`` kind; MLA has its own
module, ``mla.py``).  The score/softmax/context
cores and the decode core are plain torch, as the reference leaves them to
XLA; prompts longer than ``cfg.attn_kv_block`` take :func:`_flash_attention`,
which is the hand-written CUDA kernel on a CUDA tensor
(``kernels/flash_attn.py``) and its plain block loop on a CPU tensor.
The reference's ``constrain`` sharding hints stand where it has them
(``distributed/sharding.py``: under ``use_rules`` they redistribute a
DTensor activation, elsewhere they return their input).  Its
``tp_head_pad`` heads are dropped: zeros appended to the activations and
sliced off after the context, they change no real head's result.

KV cache layout: ``(B, S_max, n_kv, head_dim)`` per layer; local-window
configurations keep a rolling cache of ``window`` entries instead.  Unlike
the reference, :func:`decode_attention` writes the new entry into the cache
in place (the cache is the serving path's largest buffer; a functional
update would copy it every step) and takes a position per row.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, heads_local
from ..kernels import flash_attn
from .layers import PT, apply_rope, rmsnorm

NEG_INF = -1e30


def attn_template(cfg) -> Dict[str, PT]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": PT((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": PT((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PT((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PT((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = PT((h, hd), ("heads", "head_dim"), "zeros")
        t["bk"] = PT((kv, hd), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = PT((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = PT((hd,), ("head_dim",), "ones")
        t["k_norm"] = PT((hd,), ("head_dim",), "ones")
    return t


def _qkv(p, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _bias(mask: torch.Tensor) -> torch.Tensor:
    """The additive float32 form of a boolean mask (0 kept, NEG_INF not)."""
    return torch.where(mask, 0.0, NEG_INF)


def _scores_softmax_ctx(q, k, v, mask, scale):
    """Attention core for prefill: the repeat-KV form with materialised
    scores.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask (B,Sq,Sk) bool."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q = constrain(q, "batch", None, "heads_act", None)
    k = constrain(k, "batch", None, "heads_act", None)
    v = constrain(v, "batch", None, "heads_act", None)
    s = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    s = s + _bias(mask[:, None, :, :])
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _decode_ctx(q, k, v, mask, scale):
    """Attention core for decode: the grouped-query form against the cache
    at KV width (no repeat).  q (B,1,H,hd), k/v (B,S_c,KV,hd), mask
    (B,1,S_c) bool."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32) * scale
    s = s + _bias(mask[:, None, None, :, :])
    w = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return ctx.reshape(B, Sq, H, hd)


def _flash_attention(q, k, v, cfg, scale, *, window: int = 0):
    """Online-softmax causal attention over (qb, kvb) tiles.

    The reference's two nested ``lax.scan``s; here the flash kernel on a
    CUDA tensor (one launch, GQA by indexing) and its plain block loop on a
    CPU tensor, at the reference's tiles.  When a gradient is needed the
    backward recomputes the plain loop at those tiles
    (``kernels/flash_attn.py`` ``FlashAttention``)."""
    B, S, H, hd = q.shape
    qb = min(cfg.attn_q_block, S)
    kvb = min(cfg.attn_kv_block or S, S)
    assert S % qb == 0 and S % kvb == 0, (S, qb, kvb)
    q = constrain(q, "batch", None, "heads_act", None)
    k = constrain(k, "batch", None, "heads_act", None)
    v = constrain(v, "batch", None, "heads_act", None)

    def flash(q, k, v):
        return flash_attn.flash_attention(q, k, v, scale=scale, causal=True,
                                          window=window, q_block=qb,
                                          kv_block=kvb)

    # sharded (DTensor) activations: each rank runs the kernel on its heads
    out = heads_local(flash, q, k, v)
    return flash(q, k, v) if out is None else out


def causal_attention(q, k, v, cfg, *, window: int = 0):
    """Full-sequence causal attention, query blocks when long."""
    B, S, H, hd = q.shape
    scale = 1.0 / (hd**0.5) if not cfg.use_mla else 1.0 / (
        (cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    if cfg.attn_kv_block and S > cfg.attn_kv_block:
        return _flash_attention(q, k, v, cfg, scale, window=window)
    qb = cfg.attn_q_block
    kpos = torch.arange(S, device=q.device)

    def block_mask(qpos):
        m = kpos[None, :] <= qpos[:, None]
        if window:
            m &= kpos[None, :] > qpos[:, None] - window
        return m

    if S <= qb:
        mask = block_mask(torch.arange(S, device=q.device)).expand(B, S, S)
        return _scores_softmax_ctx(q, k, v, mask, scale)

    assert S % qb == 0, (S, qb)
    ctxs = []
    for i in range(S // qb):
        qpos = i * qb + torch.arange(qb, device=q.device)
        mask = block_mask(qpos).expand(B, qb, S)
        ctxs.append(_scores_softmax_ctx(q[:, i * qb:(i + 1) * qb], k, v,
                                        mask, scale))
    return torch.cat(ctxs, dim=1)


def attention(p, x, cfg, positions, *, window: int = 0):
    q, k, v = _qkv(p, x, cfg, positions)
    ctx = causal_attention(q, k, v, cfg, window=window)
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, KV, hd)
    v: torch.Tensor


def init_cache(cfg, batch: int, cache_len: int, dtype,
               device="cuda") -> KVCache:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def prefill_attention(p, x, cfg, positions, cache_len: int, *,
                      window: int = 0):
    """Full-sequence pass that also fills the decode cache.

    Returns (out (B,S,D), KVCache).  Full caches hold token t at slot t
    (zero-padded to ``cache_len``); windowed caches are rolling buffers
    with token t at slot ``t % window``, the layout
    :func:`decode_attention` expects."""
    q, k, v = _qkv(p, x, cfg, positions)
    ctx = causal_attention(q, k, v, cfg, window=window)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    B, S = x.shape[:2]
    if window:
        win = min(window, cache_len)
        cache = init_cache(cfg, B, win, k.dtype, k.device)
        keep = min(S, win)
        slots = torch.arange(S - keep, S, device=k.device) % win
        cache.k[:, slots] = k[:, S - keep:]
        cache.v[:, slots] = v[:, S - keep:]
        return out, cache
    if cache_len < S:
        raise ValueError(f"prompt of {S} tokens longer than the cache "
                         f"({cache_len})")
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return out, KVCache(F.pad(k, pad), F.pad(v, pad))


def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (a scalar, or one position per row) as a (B,) int64 tensor."""
    t = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return t.expand(batch) if t.ndim == 0 else t.reshape(batch)


def decode_attention(p, x, cfg, cache: KVCache, pos, *, window: int = 0):
    """One-token decode.  x: (B, 1, D); pos: the current index, a scalar or
    one per row (B,).

    Each row writes its new K/V entry into ``cache`` in place, at slot
    ``pos`` (``pos % window`` for a rolling cache) clamped into
    ``[0, S_c - 1]`` as the reference's ``dynamic_update_slice`` clamps its
    start index, and attends over the slots the mask keeps (``idx <= pos``;
    the whole rolling buffer once it has wrapped).  Returns (out, cache)."""
    B = x.shape[0]
    pos = _row_positions(pos, B, x.device)
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    S_c = cache.k.shape[1]
    slot = pos % max(S_c, 1) if window else pos
    slot = slot.clamp(0, S_c - 1)
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    # decode shards the cache's *sequence* dim (seq_kv -> model): the KV
    # cache is decode's working set and is not replicated over model
    ck = constrain(cache.k, "batch", "seq_kv", "kv_heads", "head_dim")
    cv = constrain(cache.v, "batch", "seq_kv", "kv_heads", "head_dim")

    scale = 1.0 / (cfg.head_dim**0.5)
    idx = torch.arange(S_c, device=x.device)
    if window:
        # the rolling buffer is fully valid once it has wrapped
        valid = (idx[None, :] <= slot[:, None]) | (pos[:, None] >= S_c)
    else:
        valid = idx[None, :] <= pos[:, None]
    ctx = _decode_ctx(q, ck, cv, valid[:, None, :], scale)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    return out, cache
