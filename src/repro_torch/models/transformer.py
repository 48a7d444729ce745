"""Model assembly: blocks, run-length layer segments, the layer stack.

The port of ``repro/models/transformer.py`` for the ``dense`` block kind.
Layers are segmented into runs of one kind as in the reference, and a
segment of more than one layer keeps its parameters stacked ``(L, ...)``;
where the reference scans over the stack, the port loops over it in
Python, and decode caches come back stacked ``(L, B, S_c, KV, hd)`` as the
reference's scan stacks them.  Other block kinds (MoE, MLA, mLSTM, sLSTM,
RG-LRU, hybrid local attention) raise ``NotImplementedError``.
``cfg.remat``, ``cfg.fsdp``, ``cfg.microbatch`` and ``cfg.scan_layers``
are training and lowering knobs with no effect here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn_mod
from .layers import mlp_apply, mlp_template, norm_template, rmsnorm, stack_template

#: the block kinds the port runs
PORTED_KINDS = ("dense",)


def _unported(kind: str):
    return NotImplementedError(
        f"block kind {kind!r} is not ported: the port runs {PORTED_KINDS}; "
        f"the other families wait in ROADMAP.md's module queue (LM "
        f"substrate)")


def layer_kinds(cfg) -> List[str]:
    kinds = []
    for i in range(cfg.n_layers):
        k = cfg.block_kind(i)
        if cfg.use_mla:
            k = "mla_dense" if k == "dense" else ("mla_moe" if k == "moe" else k)
        kinds.append(k)
    return kinds


def segments(cfg) -> List[Tuple[str, int]]:
    """Run-length encoding of layer kinds."""
    out: List[Tuple[str, int]] = []
    for k in layer_kinds(cfg):
        if out and out[-1][0] == k:
            out[-1] = (k, out[-1][1] + 1)
        else:
            out.append((k, 1))
    return out


def block_template(kind: str, cfg) -> Dict[str, Any]:
    if kind != "dense":
        raise _unported(kind)
    d = cfg.d_model
    return {
        "ln1": norm_template(d),
        "attn": attn_mod.attn_template(cfg),
        "ln2": norm_template(d),
        "mlp": mlp_template(d, cfg.d_ff),
    }


def stack_templates(cfg) -> List[Tuple[str, int, Any]]:
    """[(kind, n, template)] per segment; n > 1 -> stacked parameters."""
    out = []
    for kind, n in segments(cfg):
        t = block_template(kind, cfg)
        if n > 1:
            t = stack_template(t, n)
        out.append((kind, n, t))
    return out


def init_block_cache(kind: str, cfg, batch: int, cache_len: int, dtype,
                     device="cuda"):
    """Decode state of one layer of the given kind."""
    if kind != "dense":
        raise _unported(kind)
    return attn_mod.init_cache(cfg, batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# per-kind forward (sequence) and decode (single token)
# ---------------------------------------------------------------------------


def block_forward(kind: str, cfg, p, x, positions, state=None):
    """Full-sequence pass.  Returns (x, new_state_or_None, aux)."""
    if kind != "dense":
        raise _unported(kind)
    aux = torch.zeros((), dtype=x.dtype, device=x.device)
    h = attn_mod.attention(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                           cfg, positions)
    x = x + h
    y = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], y, cfg.act), None, aux


def block_prefill(kind: str, cfg, p, x, positions, cache_len: int):
    """Full-sequence pass that also produces the decode cache: (x, cache)."""
    if kind != "dense":
        raise _unported(kind)
    h, cache = attn_mod.prefill_attention(
        p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, positions,
        cache_len)
    x = x + h
    y = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], y, cfg.act), cache


def block_decode(kind: str, cfg, p, x, cache, pos):
    """Single-token pass (the cache is updated in place): (x, cache)."""
    if kind != "dense":
        raise _unported(kind)
    h, cache = attn_mod.decode_attention(
        p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, cache, pos)
    x = x + h
    y = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], y, cfg.act), cache


# ---------------------------------------------------------------------------
# stack execution
# ---------------------------------------------------------------------------


def _layer(tree, li: int):
    """Layer ``li`` of a stacked tree (dicts, tuples, tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(v, li) for v in tree))
    return tree[li]


def _layers(seg_params, n: int):
    """The per-layer parameter trees of a segment of ``n`` layers."""
    return [seg_params] if n == 1 else [_layer(seg_params, li)
                                        for li in range(n)]


def forward_stack(cfg, seg_params, x, positions, states=None):
    """Run all segments over a full sequence: (x, new_states, aux_total)."""
    aux_total = torch.zeros((), dtype=x.dtype, device=x.device)
    new_states = []
    for (kind, n, _), p in zip(stack_templates(cfg), seg_params):
        for pl in _layers(p, n):
            x, _, aux = block_forward(kind, cfg, pl, x, positions)
            aux_total = aux_total + aux
        new_states.append(None)  # dense blocks carry no sequence state
    return x, new_states, aux_total


def prefill_stack(cfg, seg_params, x, positions, cache_len: int):
    """Full-sequence pass through all segments, producing decode caches
    parallel to the segments (stacked along the layer dim where n > 1),
    the structure :func:`decode_stack` consumes."""
    caches = []
    for (kind, n, _), p in zip(stack_templates(cfg), seg_params):
        cs = []
        for pl in _layers(p, n):
            x, c = block_prefill(kind, cfg, pl, x, positions, cache_len)
            cs.append(c)
        caches.append(cs[0] if n == 1 else type(cs[0])(
            *(torch.stack(parts) for parts in zip(*cs))))
    return x, caches


def decode_stack(cfg, seg_params, x, caches, pos):
    """Single-token pass through all segments: (x, caches), the caches
    updated in place."""
    for (kind, n, _), p, cache in zip(stack_templates(cfg), seg_params,
                                      caches):
        for li, pl in enumerate(_layers(p, n)):
            cl = cache if n == 1 else _layer(cache, li)
            x, _ = block_decode(kind, cfg, pl, x, cl, pos)
    return x, caches


def init_stack_states(cfg, batch: int, cache_len: int, dtype,
                      device="cuda"):
    """Decode caches parallel to the segment structure (stacked where
    n > 1)."""
    out = []
    for kind, n, _ in stack_templates(cfg):
        one = init_block_cache(kind, cfg, batch, cache_len, dtype, device)
        out.append(type(one)(*(torch.stack([a] * n) for a in one))
                   if n > 1 else one)
    return out
