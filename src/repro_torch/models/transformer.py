"""Model assembly: blocks, run-length layer segments, the layer stack.

The port of ``repro/models/transformer.py`` for all its block kinds:
``dense``, ``moe`` (the dense block's attention before a mixture of
experts), ``mla_dense`` and ``mla_moe`` (the same two with DeepSeek's
latent attention, ``models/mla.py``), ``attn`` (the hybrid family's
local-window attention), ``rglru`` (the RG-LRU), ``mlstm`` and
``slstm``.  Layers are segmented into runs of one kind as in the
reference, and a segment of more than one layer keeps its parameters
stacked ``(L, ...)``; where the reference scans over the stack, the port
loops over it in Python, and decode caches (attention KV caches, the
recurrent kinds' states, MLA's latent caches) come back stacked along a
leading layer dim as the reference's scan stacks them.
``cfg.remat`` checkpoints each block of :func:`forward_stack` as the
reference's ``_maybe_remat`` does: ``"full"`` recomputes the whole block
in the backward, ``"dots"`` keeps the outputs of its matrix products
without a batch dimension and recomputes the rest.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import mlp_apply, mlp_template, norm_template, rmsnorm, stack_template

#: the block kinds the port runs
PORTED_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "attn", "rglru",
                "mlstm", "slstm")
#: the kinds whose decode state is a recurrence's (not a KV cache): their
#: prefill state is the decode cache, and a decode step returns a new one
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")
#: the kinds whose attention is MLA (``models/mla.py``): a compressed
#: latent cache, no flash route
MLA_KINDS = ("mla_dense", "mla_moe")
#: the kinds whose feed-forward part is the mixture of experts
MOE_KINDS = ("moe", "mla_moe")


def _unported(kind: str):
    return NotImplementedError(
        f"unknown block kind {kind!r}: the port runs {PORTED_KINDS}")


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
    d = cfg.d_model
    if kind in ("dense", "attn"):
        return {
            "ln1": norm_template(d),
            "attn": attn_mod.attn_template(cfg),
            "ln2": norm_template(d),
            "mlp": mlp_template(d, cfg.d_ff),
        }
    if kind == "moe":
        return {
            "ln1": norm_template(d),
            "attn": attn_mod.attn_template(cfg),
            "ln2": norm_template(d),
            "moe": moe_mod.moe_template(cfg),
        }
    if kind in MLA_KINDS:
        return {
            "ln1": norm_template(d),
            "mla": mla_mod.mla_template(cfg),
            "ln2": norm_template(d),
            **({"moe": moe_mod.moe_template(cfg)} if kind == "mla_moe"
               else {"mlp": mlp_template(d, cfg.d_ff)}),
        }
    if kind == "mlstm":
        return {"ln": norm_template(d), "cell": ssm_mod.mlstm_template(cfg)}
    if kind == "slstm":
        return {"ln": norm_template(d), "cell": ssm_mod.slstm_template(cfg)}
    if kind == "rglru":
        return {
            "ln1": norm_template(d),
            "rec": rglru_mod.rglru_template(cfg),
            "ln2": norm_template(d),
            "mlp": mlp_template(d, cfg.d_ff),
        }
    raise _unported(kind)


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
    if kind in ("dense", "moe"):
        return attn_mod.init_cache(cfg, batch, cache_len, dtype, device)
    if kind in MLA_KINDS:
        return mla_mod.init_mla_cache(cfg, batch, cache_len, dtype, device)
    if kind == "attn":  # hybrid local window: a rolling buffer
        win = min(cfg.window_size, cache_len) or cache_len
        return attn_mod.init_cache(cfg, batch, win, dtype, device)
    if kind == "mlstm":
        du = int(cfg.d_model * cfg.mlstm_proj_factor)
        return ssm_mod.mlstm_init_state(batch, cfg.n_heads,
                                        du // cfg.n_heads, device=device)
    if kind == "slstm":
        return ssm_mod.slstm_init_state(batch, cfg.d_model, device=device)
    if kind == "rglru":
        return rglru_mod.rglru_init_state(batch, cfg.lru_width,
                                          cfg.conv_width, device=device)
    raise _unported(kind)


# ---------------------------------------------------------------------------
# per-kind forward (sequence) and decode (single token)
# ---------------------------------------------------------------------------


def _recurrent_block(kind: str, cfg, p, x, state, decode: bool):
    """A recurrent kind's block over a sequence (or one decode step): norm,
    the cell, the residual, and the RG-LRU block's MLP.  Returns (x, new
    state)."""
    if kind == "rglru":
        out, st = rglru_mod.rglru_block(
            p["rec"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, state=state,
            decode=decode)
        x = x + out
        y = rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], y, cfg.act), st
    cell = ssm_mod.mlstm_block if kind == "mlstm" else ssm_mod.slstm_block
    out, st = cell(p["cell"], rmsnorm(x, p["ln"], cfg.norm_eps), cfg,
                   state=state, decode=decode)
    return x + out, st


#: the kinds whose block is ``attention.py``'s attention (the flash route
#: for long prompts) then a feed-forward part; the MLA kinds are built
#: the same way around ``mla.py`` (``MLA_KINDS``)
ATTENTION_KINDS = ("dense", "moe", "attn")


def _ffn(kind: str, cfg, p, x):
    """The block's feed-forward half after attention: x plus the MLP (or
    the mixture of experts) of its norm.  Returns (x, aux)."""
    y = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind in MOE_KINDS:
        out, aux = moe_mod.moe_ffn(p["moe"], y, cfg)
    else:
        out, aux = mlp_apply(p["mlp"], y, cfg.act), None
    return x + out, aux


def block_forward(kind: str, cfg, p, x, positions, state=None):
    """Full-sequence pass.  Returns (x, new_state_or_None, aux): aux is the
    MoE's load-balance loss, 0 for the other kinds."""
    if kind in ATTENTION_KINDS:
        win = cfg.window_size if kind == "attn" else 0
        h = attn_mod.attention(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                               cfg, positions, window=win)
        x, aux = _ffn(kind, cfg, p, x + h)
        st = None
    elif kind in MLA_KINDS:
        h = mla_mod.mla_attention(p["mla"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                                  cfg, positions)
        x, aux = _ffn(kind, cfg, p, x + h)
        st = None
    elif kind in RECURRENT_KINDS:
        x, st = _recurrent_block(kind, cfg, p, x, state, decode=False)
        aux = None
    else:
        raise _unported(kind)
    if aux is None:
        aux = torch.zeros((), dtype=x.dtype, device=x.device)
    return x, st, aux


def block_prefill(kind: str, cfg, p, x, positions, cache_len: int):
    """Full-sequence pass that also produces the decode cache: (x, cache).

    Attention caches (MLA's latent ones too) are filled at slots [0, S)
    (rolling for the local window); the recurrent kinds return their
    final state."""
    if kind in ATTENTION_KINDS:
        win = cfg.window_size if kind == "attn" else 0
        h, cache = attn_mod.prefill_attention(
            p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, positions,
            cache_len, window=win)
        return _ffn(kind, cfg, p, x + h)[0], cache
    if kind in MLA_KINDS:
        h, cache = mla_mod.mla_prefill(
            p["mla"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, positions,
            cache_len)
        return _ffn(kind, cfg, p, x + h)[0], cache
    if kind in RECURRENT_KINDS:  # the forward state IS the decode cache
        x, st, _ = block_forward(kind, cfg, p, x, positions, state=None)
        return x, st
    raise _unported(kind)


def block_decode(kind: str, cfg, p, x, cache, pos):
    """Single-token pass: (x, cache).  An attention cache (MLA's latent
    one too, read in the absorbed form) is updated in place and returned;
    a recurrent kind returns its new state."""
    if kind in ATTENTION_KINDS:
        win = cfg.window_size if kind == "attn" else 0
        h, cache = attn_mod.decode_attention(
            p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, cache, pos,
            window=win)
        return _ffn(kind, cfg, p, x + h)[0], cache
    if kind in MLA_KINDS:
        h, cache = mla_mod.mla_decode(
            p["mla"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, cache, pos)
        return _ffn(kind, cfg, p, x + h)[0], cache
    if kind in RECURRENT_KINDS:
        return _recurrent_block(kind, cfg, p, x, cache, decode=True)
    raise _unported(kind)


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
    """The per-layer parameter trees of a segment of ``n`` layers.

    Each stacked leaf is split with ``unbind``, whose backward stacks the
    layers' gradients once; indexing a layer out instead would write a
    zero gradient of the whole stack for every layer and add them up."""
    if n == 1:
        return [seg_params]

    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: parts[k][li] for k in tree} for li in range(n)]
        return tree.unbind(0)

    return split(seg_params)


#: matrix products without a batch dimension: the outputs ``"dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``checkpoint_dots_with_no_batch_dims``)."""
    if op in _DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            torch_checkpoint.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _dots_policy))
    raise ValueError(cfg.remat)


def _stacked(states, n: int):
    """One segment's per-layer states as one tree, stacked along a leading
    layer dim where n > 1 (None for kinds that carry none)."""
    if states[0] is None:
        return None
    if n == 1:
        return states[0]
    return type(states[0])(*(torch.stack(parts) for parts in zip(*states)))


def forward_stack(cfg, seg_params, x, positions, states=None):
    """Run all segments over a full sequence: (x, new_states, aux_total).

    ``states``: optional per-segment states of the recurrent kinds (stacked
    where n > 1), the initial state of each layer; the new ones come back
    in the same structure (None for the attention kinds)."""
    aux_total = torch.zeros((), dtype=x.dtype, device=x.device)
    new_states = []
    for si, ((kind, n, _), p) in enumerate(zip(stack_templates(cfg),
                                               seg_params)):
        st_in = states[si] if states is not None else None
        block = _maybe_remat(functools.partial(block_forward, kind, cfg), cfg)
        sts = []
        for li, pl in enumerate(_layers(p, n)):
            sl = st_in if st_in is None or n == 1 else _layer(st_in, li)
            x, st, aux = block(pl, x, positions, sl)
            aux_total = aux_total + aux
            sts.append(st)
        new_states.append(_stacked(sts, n))
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
        caches.append(_stacked(cs, n))
    return x, caches


def decode_stack(cfg, seg_params, x, caches, pos):
    """Single-token pass through all segments: (x, caches), the caches
    updated in place (a recurrent kind's new state is copied into its
    cache)."""
    for (kind, n, _), p, cache in zip(stack_templates(cfg), seg_params,
                                      caches):
        for li, pl in enumerate(_layers(p, n)):
            cl = cache if n == 1 else _layer(cache, li)
            x, new = block_decode(kind, cfg, pl, x, cl, pos)
            if kind in RECURRENT_KINDS:
                for dst, src in zip(cl, new):
                    dst.copy_(src)
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
