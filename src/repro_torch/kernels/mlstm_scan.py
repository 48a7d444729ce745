"""CUDA kernel: the mLSTM's carry of ``(C, n, m)`` from chunk to chunk.

The device form of the ``lax.scan`` over chunks in
``repro/models/ssm.py:mlstm_chunkwise`` (its carry, ``ssm.py:123-131``;
the reference has no Pallas kernel for it).  ``models/ssm.py`` computes,
for all chunks at once by batched products, each chunk's total log-decay
``btot``, its own stabiliser ``mc = max_l(btot - b_l + a_l)`` and its sums
``kv_sum = sum_l exp(btot - b_l + a_l - mc) k_l v_l^T`` and ``k_sum``
(likewise with ``k_l``); the kernel (``csrc/mlstm_scan.cu``) walks the
chunks from the state ``(C0, n0, m0)``:

    m1 = max(btot + m, mc)
    C1 = exp(btot + m - m1) C + exp(mc - m1) kv_sum    (n likewise)

and returns the state at every chunk's start and after the last.  It is
bound by bytes; one thread per entry of ``[C | n]``.

:func:`mlstm_scan_plain` is its plain version, a loop over chunks in
torch; the CPU takes it.  On a CUDA tensor that needs a gradient the
wrapper raises (no backward kernel yet, ROADMAP.md).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel
from .linear_scan import _needs_grad, no_backward

KERNEL = Kernel(
    "mlstm_scan",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4,
    replaces="src/repro/models/ssm.py:139",
)

#: ``|got - want| <= atol + rtol * |want|`` between the kernel and its plain
#: version: the same float32 operations a chunk, the kernel's ``expf`` and
#: multiply-add against torch's, a few units in the last place a chunk that
#: the decay factors (at most 1) keep from growing
TOLERANCE = dict(rtol=1e-5, atol=1e-6)


def _check(btot, mc, kv_sum, k_sum, C0, n0, m0):
    if btot.ndim != 3 or mc.shape != btot.shape:
        raise ValueError(f"expected btot = mc (B,nc,H); got "
                         f"{tuple(btot.shape)}, {tuple(mc.shape)}")
    B, nc, H = btot.shape
    if kv_sum.ndim != 5 or kv_sum.shape[:3] != btot.shape:
        raise ValueError(f"kv_sum {tuple(kv_sum.shape)} is not (B,nc,H,hd,hd)")
    hd = kv_sum.shape[3]
    want = {"kv_sum": ((B, nc, H, hd, hd), kv_sum),
            "k_sum": ((B, nc, H, hd), k_sum), "C0": ((B, H, hd, hd), C0),
            "n0": ((B, H, hd), n0), "m0": ((B, H), m0)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    if nc == 0:
        raise ValueError("no chunks to carry")


def mlstm_scan_plain(btot, mc, kv_sum, k_sum, C0, n0, m0):
    """``(C_start, n_start, m_start, C, n, m)``: the state at each chunk's
    start ``(B,nc,...)`` and after the last, by a loop over chunks."""
    _check(btot, mc, kv_sum, k_sum, C0, n0, m0)
    C, n, m = C0, n0, m0
    Cs, ns, ms = [], [], []
    for c in range(btot.shape[1]):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        bt, mcc = btot[:, c], mc[:, c]
        m1 = torch.maximum(bt + m, mcc)
        f = torch.exp(bt + m - m1)
        s = torch.exp(mcc - m1)
        C = f[..., None, None] * C + s[..., None, None] * kv_sum[:, c]
        n = f[..., None] * n + s[..., None] * k_sum[:, c]
        m = m1
    return (torch.stack(Cs, 1), torch.stack(ns, 1), torch.stack(ms, 1),
            C, n, m)


def mlstm_scan(btot, mc, kv_sum, k_sum, C0, n0, m0):
    """The mLSTM chunk carry (float32 in, float32 out): CPU tensors take
    :func:`mlstm_scan_plain`, CUDA tensors launch the kernel (or raise)."""
    ins = (btot, mc, kv_sum, k_sum, C0, n0, m0)
    if btot.device.type == "cpu":
        return mlstm_scan_plain(*ins)
    if btot.device.type != "cuda":
        raise ValueError(f"unsupported device {btot.device}")
    if _needs_grad(*ins):
        raise no_backward("mlstm_scan")
    _check(*ins)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"expected float32 inputs; got "
                         f"{[str(t.dtype) for t in ins]}")
    if any(t.device != btot.device for t in ins):
        raise ValueError("every input must be on one device")
    ins = tuple(t.contiguous() for t in ins)
    B, nc, H = btot.shape
    hd = kv_sum.shape[3]
    dev = btot.device
    outs = (torch.empty((B, nc, H, hd, hd), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H, hd), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H), dtype=torch.float32, device=dev),
            torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev),
            torch.empty((B, H, hd), dtype=torch.float32, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev))
    if B * H * hd == 0:
        return outs
    with torch.cuda.device(dev):
        KERNEL.launch(*(t.data_ptr() for t in ins + outs), B, nc, H, hd,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    return outs
