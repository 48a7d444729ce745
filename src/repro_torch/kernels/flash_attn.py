"""CUDA kernel: causal (or full) flash attention forward.

Replaces ``repro/kernels/flash_attn.py:flash_attention_pallas`` and, on the
serving path, the ``lax.scan`` form ``repro/models/attention.py:
_flash_attention``: both compute softmax attention with an online-softmax
``(m, l, acc)`` state in float32.  The kernel (``csrc/flash_attn.cu``)
takes q ``(B,S,H,hd)`` and k, v ``(B,S,KV,hd)`` with H a multiple of KV
(grouped-query attention by indexing the KV head ``h // (H/KV)``, not by
repeating K/V), float32 or bfloat16, ``hd`` in 16/32/64/128/256, the causal
mask or none, and an optional local ``window``.  bfloat16 inputs run on
the tensor cores (``mma.sync``, float32 accumulation, P split into two
bfloat16 halves against V), float32 inputs on the CUDA cores in full
float32.  At the serving shapes it is bound by operations; the bound is in
``chip_smoke.py`` and PERF.md.

:func:`flash_attention_plain` is its plain version: the block loop of the
reference's ``_flash_attention`` in torch, every tile upcast to float32 as
the Pallas kernel does, fully masked tiles above the diagonal skipped.
The kernel has no backward: a call that needs a gradient goes through
:class:`FlashAttention`, whose backward recomputes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

KERNEL = Kernel(
    "flash_attn",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    replaces="src/repro/kernels/flash_attn.py:76",
)

#: head widths the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: ``|got - want| <= atol + rtol * |want|`` between two forms that compute
#: in float32 and differ in summation order only (the kernel, its plain
#: version, the reference's Pallas kernel): atol in float32; in bfloat16
#: each rounds its float32 result once, so they differ by at most one
#: bfloat16 step of the result, which is at most 2^-7 of its magnitude
TOLERANCE = {torch.float32: dict(rtol=0.0, atol=2e-5),
             torch.bfloat16: dict(rtol=2.0**-7, atol=2e-5)}
NEG_INF = -1e30


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,hd), k = v (B,S,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"query heads {H} are not a multiple of kv heads "
                         f"{k.shape[2]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None, causal: bool = True,
                          window: int = 0, q_block: int = 64,
                          kv_block: int = 64) -> torch.Tensor:
    """Block-loop online-softmax attention in torch (the kernel's plain
    version).  Masks: ``j <= i`` when ``causal``, ``j > i - window`` when
    ``window``; returns ``(B,S,H,hd)`` in q's dtype."""
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if scale is None:
        scale = 1.0 / (hd**0.5)
    f32 = torch.float32
    qh = q.to(f32).transpose(1, 2)  # (B,H,S,hd)
    kh = k.to(f32).transpose(1, 2)
    vh = v.to(f32).transpose(1, 2)
    if KV != H:
        kh = kh.repeat_interleave(H // KV, dim=1)
        vh = vh.repeat_interleave(H // KV, dim=1)
    qb = max(1, min(q_block, S))
    kvb = max(1, min(kv_block, S))
    out = torch.empty((B, H, S, hd), dtype=f32, device=q.device)
    for q0 in range(0, S, qb):
        q1 = min(S, q0 + qb)
        qi = qh[:, :, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)
        m = torch.full((B, H, q1 - q0), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, H, q1 - q0), dtype=f32, device=q.device)
        acc = torch.zeros((B, H, q1 - q0, hd), dtype=f32, device=q.device)
        for k0 in range(0, S, kvb):
            if causal and k0 > q1 - 1:
                break  # every later tile lies above the diagonal
            k1 = min(S, k0 + kvb)
            kpos = torch.arange(k0, k1, device=q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kh[:, :, k0:k1]) * scale
            msk = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = s + torch.where(msk, 0.0, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vh[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale,
            causal: bool, window: int) -> torch.Tensor:
    """The kernel on CUDA tensors (or a raise); no autograd."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"expected float32 or bfloat16 q, k, v of one "
                         f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if scale is None:
        scale = 1.0 / (hd**0.5)
    # contiguous, at 16-byte aligned addresses (the kernel's copy width)
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, S, H, k.shape[2], hd, float(scale),
                      int(bool(causal)), int(window),
                      int(q.dtype == torch.bfloat16),
                      stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out


class FlashAttention(torch.autograd.Function):
    """Flash attention with an exact backward.

    Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    Backward: :func:`flash_attention_plain` recomputed on detached q, k, v
    under ``torch.enable_grad()`` at the caller's tiles, and its
    vector-Jacobian product returned.  That is exactly the gradient of the
    plain block loop, the function the reference trains through
    (``repro/models/attention.py`` ``_flash_attention``, a differentiable
    ``lax.scan``; the JAX package has no backward kernel to port).  Only a
    call that needs a gradient comes here, so serving, which needs none,
    launches the kernel as before and its numbers do not move.  Neither
    the kernel nor the recompute uses atomics: the route is deterministic.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_block, kv_block):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, causal=causal, window=window,
                        q_block=q_block, kv_block=kv_block)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, **ctx.args)
        return _launch(q, k, v, scale, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, **ctx.args)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int = 0, q_block: int = 64,
                    kv_block: int = 64) -> torch.Tensor:
    """Flash attention of q ``(B,S,H,hd)`` over k, v ``(B,S,KV,hd)``.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (or raise).  A call that needs a gradient goes through
    :class:`FlashAttention`, whose backward recomputes the plain version
    at tiles ``(q_block, kv_block)`` (the CPU forward uses them too; the
    kernel needs none)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, causal, window, q_block,
                                    kv_block)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window, q_block=q_block,
                                     kv_block=kv_block)
    return _launch(q, k, v, scale, causal, window)
