"""RecurrentGemma's recurrent block: the RG-LRU and its causal convolution.

The port of ``repro/models/rglru.py``.  The RG-LRU is a diagonal linear
recurrence (its gates depend on the input, not on the hidden state), so a
prompt runs as one scan over the sequence: on a CUDA tensor the
``linear_scan`` kernel (``kernels/linear_scan.py``), where the reference
takes ``lax.associative_scan``; on a CPU tensor its plain log-depth
version.  Decode is a one-step update with constant state (the LRU's h and
the convolution's last ``conv_width - 1`` inputs), elementwise torch as in
the reference.  The local-window MQA layers of the hybrid pattern are the
``attn`` block kind of ``models/attention.py``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_local
from ..kernels.linear_scan import linear_scan
from .layers import PT

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)


def rglru_template(cfg) -> Dict[str, PT]:
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv_width
    return {
        "in_x": PT((d, w), ("embed", "lru")),
        "in_y": PT((d, w), ("embed", "lru")),
        "conv": PT((cw, w), ("conv", "lru"), "normal", 0.1),
        "conv_b": PT((w,), ("lru",), "zeros"),
        "wr": PT((w, w), ("lru", "lru2"), "normal", 0.02),
        "br": PT((w,), ("lru",), "zeros"),
        "wi": PT((w, w), ("lru", "lru2"), "normal", 0.02),
        "bi": PT((w,), ("lru",), "zeros"),
        "lam": PT((w,), ("lru",), "ones"),  # softplus(lam) > 0
        "out": PT((w, d), ("lru", "embed")),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, W) recurrent state
    conv_tail: torch.Tensor  # (B, conv_width-1, W) last inputs


def rglru_init_state(batch: int, width: int, conv_width: int,
                     dtype=torch.float32, device="cuda") -> RGLRUState:
    return RGLRUState(
        torch.zeros((batch, width), dtype=dtype, device=device),
        torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                    device=device),
    )


def _causal_conv(p, u, tail):
    """u: (B,S,W); tail: (B,cw-1,W) previous inputs.  Returns the
    same-shape output and the new tail, in u's dtype."""
    cw = p["conv"].shape[0]
    S = u.shape[1]
    ext = torch.cat([tail.to(u.dtype), u], dim=1)  # (B, S+cw-1, W)
    out = sum(ext[:, j:j + S] * p["conv"][j][None, None, :]
              for j in range(cw))
    return out + p["conv_b"], ext[:, -(cw - 1):]


def _lru_coeffs(p, u):
    """a (decay) and b (input) coefficients, float32.  u: (..., W)."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf @ p["wr"].to(torch.float32) + p["br"])
    i = torch.sigmoid(uf @ p["wi"].to(torch.float32) + p["bi"])
    log_a = -_C * F.softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i * uf)
    return a, b


def rglru_scan(p, u, h0):
    """The RG-LRU over (B,S,W) from the state h0 (B,W): (h in u's dtype,
    the last h in float32).  h0 enters folded into the first input term,
    as the reference folds it."""
    a, b = _lru_coeffs(p, u)
    res = batch_local(linear_scan, (a, b, h0))  # sharded: a rank's rows
    hh, h_last = linear_scan(a, b, h0) if res is None else res
    return hh.to(u.dtype), h_last


def rglru_block(p, x, cfg, *, state: RGLRUState | None = None,
                decode=False):
    """The full recurrent block (norm and residual by the caller):
    (out, new state)."""
    B = x.shape[0]
    if state is None:
        state = rglru_init_state(B, cfg.lru_width, cfg.conv_width,
                                 device=x.device)
    y = F.gelu(x @ p["in_y"], approximate="tanh")  # jax.nn.gelu's default
    u = x @ p["in_x"]
    u, tail = _causal_conv(p, u, state.conv_tail)
    if decode:
        a, b = _lru_coeffs(p, u[:, 0])
        h1 = a * state.h.to(torch.float32) + b
        out = (h1[:, None, :].to(x.dtype) * y) @ p["out"]
        return out, RGLRUState(h1.to(state.h.dtype), tail)
    hh, h_last = rglru_scan(p, u, state.h)
    out = (hh * y) @ p["out"]
    return out, RGLRUState(h_last.to(state.h.dtype), tail)
