"""Parameter templates, initialisers and the dense block's layers.

The port of ``repro/models/layers.py`` for the parts the dense block needs.
Templates are trees (dicts and lists) of :class:`PT` leaves, as in the
reference, and :func:`init_tree` materialises them with the same
initialisers and scales (normal x 1/sqrt(fan_in), embed x 0.02, ones,
zeros) from an explicit ``torch.Generator``: the bits differ from
``jax.random``'s, the distributions do not.  Tests carry the reference's
weights across with ``models.convert.params_from_jax`` instead.

The layers keep the reference's cast order: :func:`rmsnorm` normalises in
float32, casts back, then multiplies by the scale; :func:`apply_rope`
rotates in float32 with the half-split (not interleaved) convention.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PT:
    """Parameter template: shape, per-dim logical axes, init spec."""

    shape: tuple
    axes: tuple
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def template_map(fn: Callable, template):
    """Map over the PT leaves of a template tree (dicts, lists, tuples)."""
    if isinstance(template, PT):
        return fn(template)
    if isinstance(template, dict):
        return {k: template_map(fn, v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(template_map(fn, v) for v in template)
    raise TypeError(f"not a template node: {type(template)}")


def stack_template(template: Dict[str, Any], n: int):
    """Prepend a ``stack`` dim of size n to every leaf (stacked layers)."""
    return template_map(
        lambda t: PT((n,) + t.shape, ("stack",) + t.axes, t.init, t.scale),
        template,
    )


#: a normal leaf of at most this many elements is drawn in one float32
#: call (4 GiB); a larger one (a stacked full-width leaf: llava-next-34b's
#: MLP is 8.8 G elements) is filled in its dtype slice by slice along its
#: first dim, each slice's float32 draw at most SLICE_ELEMENTS elements or
#: one index of that dim, whichever is larger (one layer of every stacked
#: leaf the registered configurations have)
WHOLE_DRAW_ELEMENTS = 1 << 30
SLICE_ELEMENTS = 1 << 28


def _init_one(t: PT, generator: torch.Generator, dtype, device):
    if t.init == "zeros":
        return torch.zeros(t.shape, dtype=dtype, device=device)
    if t.init == "ones":
        return torch.ones(t.shape, dtype=dtype, device=device)
    if t.init == "embed":
        scale = t.scale if t.scale is not None else 1.0
    else:
        # as in the reference, fan_in spans every dim but the last, the
        # stack dim of stacked layers included
        fan_in = t.shape[0] if len(t.shape) == 1 else int(np.prod(t.shape[:-1]))
        scale = t.scale if t.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

    def draw(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)

    if math.prod(t.shape) <= WHOLE_DRAW_ELEMENTS:
        return draw(t.shape)
    out = torch.empty(t.shape, dtype=dtype, device=device)
    step = max(1, SLICE_ELEMENTS // math.prod(t.shape[1:]))
    for i in range(0, t.shape[0], step):
        part = out[i:i + step]
        part.copy_(draw(part.shape))
    return out


def init_tree(template, generator: torch.Generator, dtype=torch.float32,
              device="cuda"):
    """Materialise a parameter tree from a template tree on ``device``.

    Leaves draw from ``generator`` (which must live on ``device``) in the
    reference's flattening order (dict keys sorted), so one seed gives one
    tree."""
    def build(node):
        if isinstance(node, PT):
            return _init_one(node, generator, dtype, device)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    return build(template)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def norm_template(d: int) -> PT:
    return PT((d,), ("embed",), "ones")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """:func:`rope_freqs` kept on ``device``: copying it there at every
    call would wait for the card twice a layer (a pageable host-to-device
    copy synchronises the stream).  Made outside inference mode, so the
    cached tensor serves both modes."""
    with torch.inference_mode(False):
        return rope_freqs(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    inv = _rope_freqs_on(hd, float(theta), x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, hd/2)
    if x.ndim == ang.ndim + 1:  # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_template(d: int, d_ff: int) -> Dict[str, PT]:
    return {
        "gate": PT((d, d_ff), ("embed", "mlp")),
        "up": PT((d, d_ff), ("embed", "mlp")),
        "down": PT((d_ff, d), ("mlp", "embed")),
    }


def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ p["gate"]
    u = x @ p["up"]
    # jax.nn.gelu is the tanh approximation by default
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ p["down"]


def embed_template(vocab: int, d: int) -> PT:
    return PT((vocab, d), ("vocab", "embed"), "embed", 0.02)


def unembed_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits head; tied or untied."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    if cfg.logits_soft_cap:
        c = cfg.logits_soft_cap
        logits = torch.tanh(logits / c) * c
    return logits
