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
torch; the CPU takes it.

A call that needs a gradient goes through :class:`MLSTMScan`, whose
backward walks the chunks from the last: the gradient of ``[C | n]``
carried back through ``f``, each chunk's sums' gradient ``s dX``, and per
``(b, h)`` two inner products a chunk (``<dX_{c+1}, X_c>`` and
``<dX_{c+1}, KV_c>`` over ``[C | n]``) that take the scalars ``btot``,
``mc`` and ``m`` back through ``f``, ``s`` and ``m1`` (the ``max`` splits
a tie evenly, as torch's and JAX's do): on a CUDA tensor the kernel
``csrc/mlstm_scan_bwd.cu`` (:data:`BWD_KERNEL`), on a CPU tensor
:func:`mlstm_scan_bwd_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel
from .linear_scan import _needs_grad

KERNEL = Kernel(
    "mlstm_scan",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4,
    replaces="src/repro/models/ssm.py:139",
)
#: the backward (the reference differentiates its ``lax.scan`` over chunks
#: by autodiff)
BWD_KERNEL = Kernel(
    "mlstm_scan_bwd",
    [ctypes.c_void_p] * 21 + [ctypes.c_longlong] + [ctypes.c_int] * 4,
    replaces="src/repro/models/ssm.py:139",
)

#: ``|got - want| <= atol + rtol * |want|`` between the kernel and its plain
#: version: the same float32 operations a chunk, the kernel's ``expf`` and
#: multiply-add against torch's, a few units in the last place a chunk that
#: the decay factors (at most 1) keep from growing
TOLERANCE = dict(rtol=1e-5, atol=1e-6)
#: the backward kernel against its plain version, per output: ``|got -
#: want| <= rtol |want| + atol max|want|`` (:func:`bwd_tolerance_used`).
#: The carried gradients differ as the forward's state does; the scalars'
#: are inner products over the ``hd^2 + hd`` entries of a chunk, float32
#: sums of ~150,000 terms at xLSTM's width that the kernel adds in another
#: order (warps, blocks, then blocks in turn) than torch: their rounding
#: scales with the output's largest value, not with each element
BWD_TOLERANCE = dict(rtol=1e-4, atol=1e-5)


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


def mlstm_scan_bwd_plain(btot, mc, kv_sum, k_sum, C_start, n_start,
                         m_start, dC_start, dn_start, dm_start, dC, dn, dm):
    """The vector-Jacobian product of :func:`mlstm_scan_plain` from its
    inputs and outputs (the state at each chunk start) and the gradients of
    its six outputs: ``(dbtot, dmc, dkv_sum, dk_sum, dC0, dn0, dm0)``, by a
    loop over the chunks from the last.  ``(dC, dn, dm)`` is the gradient
    of the state after chunk c; at chunk c, with ``u = btot + m``, ``m1 =
    max(u, mc)``, ``f = exp(u - m1)``, ``s = exp(mc - m1)``:
    ``dkv_sum = s dC``, ``dk_sum = s dn``; ``P1 = <dC, C_c> + <dn, n_c>``,
    ``P2 = <dC, kv_sum> + <dn, k_sum>``; ``dm1 = dm - f P1 - s P2``, which
    goes to ``u`` or ``mc`` by the ``max`` (half each at a tie); then
    ``dbtot = f P1 + dm1 [u wins]``, ``dmc = s P2 + dm1 [mc wins]``, and
    the state before the chunk gets ``f dC + dC_start``, ``f dn +
    dn_start`` and ``dbtot + dm_start``."""
    nc = btot.shape[1]
    outs = {k: [None] * nc for k in ("bt", "mc", "kv", "k")}
    for c in reversed(range(nc)):
        u = btot[:, c] + m_start[:, c]
        mcc = mc[:, c]
        m1 = torch.maximum(u, mcc)
        f = torch.exp(u - m1)
        s = torch.exp(mcc - m1)
        outs["kv"][c] = s[..., None, None] * dC
        outs["k"][c] = s[..., None] * dn
        p1 = (dC * C_start[:, c]).sum((-2, -1)) + (dn * n_start[:, c]).sum(-1)
        p2 = (dC * kv_sum[:, c]).sum((-2, -1)) + (dn * k_sum[:, c]).sum(-1)
        dm1 = dm - f * p1 - s * p2
        share = torch.where(u > mcc, 1.0, torch.where(u < mcc, 0.0, 0.5)
                            ).to(dm1.dtype)
        du = f * p1 + share * dm1
        outs["mc"][c] = s * p2 + (1 - share) * dm1
        outs["bt"][c] = du
        dC = f[..., None, None] * dC + dC_start[:, c]
        dn = f[..., None] * dn + dn_start[:, c]
        dm = du + dm_start[:, c]
    return (torch.stack(outs["bt"], 1), torch.stack(outs["mc"], 1),
            torch.stack(outs["kv"], 1), torch.stack(outs["k"], 1), dC, dn,
            dm)


def bwd_tolerance_used(got, want) -> float:
    """The largest share of :data:`BWD_TOLERANCE` that any of the paired
    outputs uses (at most 1 when they agree); raises on a shape mismatch
    or a value that is not finite."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to(torch.float64), w.to(torch.float64)
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}, or not finite")
        if not w.numel():
            continue
        allowed = (BWD_TOLERANCE["rtol"] * w.abs()
                   + BWD_TOLERANCE["atol"] * float(w.abs().max()))
        worst = max(worst, float(((g - w).abs() / allowed.clamp_min(1e-30))
                                 .max()))
    return worst


def _check_cuda(ins):
    _check(*ins)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"expected float32 inputs; got "
                         f"{[str(t.dtype) for t in ins]}")
    if any(t.device != ins[0].device for t in ins):
        raise ValueError("every input must be on one device")


def _launch(btot, mc, kv_sum, k_sum, C0, n0, m0):
    """The forward kernel on CUDA tensors: the six outputs."""
    ins = (btot, mc, kv_sum, k_sum, C0, n0, m0)
    _check_cuda(ins)
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


#: threads a block of the backward kernel (``csrc/mlstm_scan_bwd.cu``
#: kThreads): each block leaves its two partial inner products a chunk in a
#: buffer the wrapper allocates (the kernel allocates nothing)
BWD_THREADS = 256


def _launch_bwd(*ins):
    """The backward kernel on CUDA tensors (the arguments of
    :func:`mlstm_scan_bwd_plain`): the seven gradients."""
    btot, kv_sum = ins[0], ins[2]
    B, nc, H = btot.shape
    hd = kv_sum.shape[3]
    dev = btot.device
    ins = tuple(t.to(torch.float32).contiguous() for t in ins)
    outs = (torch.empty((B, nc, H), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H, hd, hd), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H, hd), dtype=torch.float32, device=dev),
            torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev),
            torch.empty((B, H, hd), dtype=torch.float32, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev))
    if B * H * hd == 0:
        return outs
    blocks = -(-(hd * hd + hd) // BWD_THREADS)
    partial = torch.empty((B * H, nc, blocks, 2), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        BWD_KERNEL.launch(*(t.data_ptr() for t in ins + outs),
                          partial.data_ptr(), partial.numel(), B, nc, H, hd,
                          stream=torch.cuda.current_stream(dev).cuda_stream)
    return outs


class MLSTMScan(torch.autograd.Function):
    """The chunk carry with its backward: the kernels on CUDA tensors, the
    plain versions on CPU ones.  It saves its first four inputs and the
    state at each chunk start (its own first three outputs)."""

    @staticmethod
    def forward(ctx, btot, mc, kv_sum, k_sum, C0, n0, m0):
        ins = (btot, mc, kv_sum, k_sum, C0, n0, m0)
        outs = (mlstm_scan_plain(*ins) if btot.device.type == "cpu"
                else _launch(*ins))
        ctx.save_for_backward(btot, mc, kv_sum, k_sum, *outs[:3])
        ctx.dtypes = tuple(t.dtype for t in ins)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        bwd = (mlstm_scan_bwd_plain if saved[0].device.type == "cpu"
               else _launch_bwd)
        return tuple(g.to(dt) for g, dt in zip(bwd(*saved, *grads),
                                               ctx.dtypes))


def mlstm_scan(btot, mc, kv_sum, k_sum, C0, n0, m0):
    """The mLSTM chunk carry (float32 in, float32 out): CPU tensors take
    :func:`mlstm_scan_plain`, CUDA tensors launch the kernel (or raise).  A
    call that needs a gradient goes through :class:`MLSTMScan`."""
    ins = (btot, mc, kv_sum, k_sum, C0, n0, m0)
    if btot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {btot.device}")
    if _needs_grad(*ins):
        return MLSTMScan.apply(*ins)
    if btot.device.type == "cpu":
        return mlstm_scan_plain(*ins)
    return _launch(*ins)
