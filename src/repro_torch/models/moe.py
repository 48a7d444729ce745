"""Mixture-of-Experts FFN: top-k router and sort-based capacity dispatch.

The port of ``repro/models/moe.py``, step for step.  Tokens are grouped per
sequence (the batch row), then

  1. router logits, softmax in float32, top-k gates renormalised;
  2. a group-local stable sort of the (token, k) pairs by expert id;
  3. each pair's rank within its expert from the run starts
     (``searchsorted``): the reference's GShard position-in-expert without
     the one-hot dispatch tensor;
  4. a capacity-clipped scatter into (B, E, C, D): pairs ranked at or past
     the capacity C are dropped (they fall through on the residual path);
  5. the grouped SwiGLU einsums over experts, then the expert outputs
     gathered back to their pairs, weighted by the gates and added up by
     token.

A Switch-style load-balance aux loss comes back beside the output.

The reference has no Pallas kernel here, so this is plain torch.  Where
the reference's primitives leave an order open in torch, the port pins it
to the reference's: the top-k is the first K of a stable descending sort
(``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
documents no order), the pair sort is ``argsort(..., stable=True)``, and
integer arithmetic stays in int64.  The reference's ``mode="drop"``
scatter becomes an overflow row E of the buffer that takes every dropped
pair and is sliced off: no host sync to find the kept pairs.  A decode
step (S = 1) has C = 1, and the K distinct experts of a token never
overflow; the einsums still read every expert's weights, as the
reference's do.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .layers import PT, mlp_apply, mlp_template


def moe_template(cfg) -> Dict[str, PT]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    t = {
        "router": PT((d, e), ("embed", "experts"), "normal", 0.02),
        "gate": PT((e, d, ff), ("experts", "embed", "expert_mlp")),
        "up": PT((e, d, ff), ("experts", "embed", "expert_mlp")),
        "down": PT((e, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        t["shared"] = mlp_template(d, ff * cfg.n_shared_experts)
    return t


def capacity(cfg, S: int) -> int:
    """Slots an expert holds in a group of S tokens, in Python floats as
    the reference computes it."""
    return max(1, int(S * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))


class Dispatch(NamedTuple):
    """Where each (token, k) pair of a group goes, in expert-sorted order:
    every field (B, S*K) but ``aux`` (a float32 scalar)."""

    order: torch.Tensor  # the stable sort of the pairs by expert
    expert: torch.Tensor  # each sorted pair's expert id
    token: torch.Tensor  # its source token
    weight: torch.Tensor  # its renormalised gate (float32)
    rank: torch.Tensor  # its position among its expert's pairs
    ok: torch.Tensor  # rank < capacity: kept, else dropped
    aux: torch.Tensor  # the load-balance loss


def dispatch(p, x: torch.Tensor, cfg) -> Dispatch:
    """Route x (B, S, D): gates, the sorted pairs, ranks and the capacity
    mask, and the aux loss."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    logits = x @ p["router"]  # (B, S, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top.values[..., :K]
    gate_idx = top.indices[..., :K]  # (B, S, K) int64
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch-style load-balance loss: E * sum_e fraction_e * prob_e
    counts = torch.zeros((B, E), dtype=probs.dtype, device=x.device)
    counts.scatter_add_(1, gate_idx.reshape(B, S * K),
                        torch.ones((B, S * K), dtype=probs.dtype,
                                   device=x.device))
    frac = counts / (S * K)
    mean_prob = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(frac * mean_prob, dim=-1))

    # group-local (per-sequence) sort of the (token, k) pairs by expert
    tk = S * K
    eid = gate_idx.reshape(B, tk)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)  # (tk,)
    gw = gate_vals.reshape(B, tk)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    tok_s = tok[order]
    gw_s = torch.gather(gw, 1, order)

    # rank within expert = index - start of the expert's run
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(eid_s, experts)  # (B, E)
    rank = (torch.arange(tk, device=x.device)[None, :]
            - torch.gather(starts, 1, eid_s))
    return Dispatch(order, eid_s, tok_s, gw_s, rank, rank < capacity(cfg, S),
                    aux)


def moe_ffn(p, x: torch.Tensor, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux loss 0-d in x's dtype)."""
    B, S, D = x.shape
    E, C = cfg.n_experts, capacity(cfg, S)
    d = dispatch(p, x, cfg)
    rows = torch.arange(B, device=x.device)[:, None]
    # scatter the kept pairs into (B, E, C, D); dropped ones land in the
    # overflow row E, which is cut off
    e_dst = torch.where(d.ok, d.expert, E)
    r_dst = torch.where(d.ok, d.rank, 0)
    src = x[rows, d.token]  # (B, tk, D) gathered token embeddings
    buf = torch.zeros((B, E + 1, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, e_dst, r_dst), src, accumulate=True)
    buf = buf[:, :E]

    # grouped expert SwiGLU
    g = torch.einsum("becd,edf->becf", buf, p["gate"])
    u = torch.einsum("becd,edf->becf", buf, p["up"])
    h = F.silu(g) * u
    y = torch.einsum("becf,efd->becd", h, p["down"])  # (B, E, C, D)

    # combine: the expert outputs back at their pairs, weighted, added up
    y_slots = y[rows, e_dst.clamp_max(E - 1), r_dst]  # (B, tk, D)
    y_slots = torch.where(d.ok[..., None], y_slots, 0.0)
    out = torch.zeros_like(x)
    out.index_put_((rows, d.token),
                   y_slots * d.weight[..., None].to(y_slots.dtype),
                   accumulate=True)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, d.aux.to(x.dtype)
