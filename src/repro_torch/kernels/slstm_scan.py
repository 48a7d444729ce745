"""CUDA kernel: the sLSTM recurrence over a sequence.

The device form of the per-step ``lax.scan`` in
``repro/models/ssm.py:slstm_block`` over the cell ``_slstm_cell`` (the
reference has no Pallas kernel for it).  The kernel
(``csrc/slstm_scan.cu``) takes the gate inputs ``xg (B,S,4,D)`` (``x @ w_g
+ b_g`` for the gates i, f, z, o, plain products outside the scan), the
block-diagonal recurrent weights ``r (4,H,hd,hd)`` and the float32 state
``(h, c, n, m)``, and returns h for every step ``(B,S,D)`` float32 and the
final state, at the head widths of :data:`HEAD_WIDTHS`.  It is bound by
the chain of S steps: a thread-block cluster a (b, head), each CTA
holding its channels' columns of r in registers, h exchanged through
distributed shared memory and one mbarrier wait a step (the note in the source has the design).

:func:`slstm_step` is one step of the cell in torch (the reference's
``_slstm_cell``; the model's decode step calls it), and
:func:`slstm_scan_plain` the kernel's plain version, a loop of it over the
steps; the CPU takes it.  On a CUDA tensor that needs a gradient the
wrapper raises (no backward kernel yet, ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel
from .linear_scan import _needs_grad, no_backward

KERNEL = Kernel(
    "slstm_scan",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6,
    replaces="src/repro/models/ssm.py:251",
)

#: Head widths the kernel takes, by the weights' type: (multiple, widest).
#: The kernel splits a head over C CTAs, C the least power of two with at
#: most 32 channels a CTA (``csrc/slstm_scan.cu``), and takes hd up to 256
#: where C divides it: a multiple of 8 up to 256 always splits (C <= 8), a
#: multiple of 4 up to 128 (C <= 4).  Float32 weights keep the narrower set,
#: the widths the card tests hold.
HEAD_WIDTHS = {torch.bfloat16: (8, 256), torch.float32: (4, 128)}

#: ``|got - want| <= atol + rtol * |want|`` between two float32 forms of the
#: cell over a short sequence (tens of steps): the same float32 cell, the
#: recurrent products summed in another order and ``expf``/``tanhf``
#: against torch's
TOLERANCE = dict(rtol=1e-4, atol=1e-5)
#: Over long sequences no fixed tolerance holds between two float32 forms:
#: the stabiliser m random-walks to hundreds, its rounding enters c and n
#: through exp, and nothing decays the error once the forget weight is 1,
#: so the plain version in float32 drifts from its own float64 run as the
#: sequence grows (``chip_smoke.py`` phase 3 prints that drift at 4,096
#: and 32,768 steps).  So the kernel is held to the plain version run in
#: float64: per output, its largest error at most ``ACCURACY`` times the
#: float32 plain version's own, plus ``TOLERANCE["atol"]``
#: (:func:`accuracy_ratio`)
ACCURACY = 2.0


class SLSTMState(NamedTuple):
    h: torch.Tensor  # (B, D) float32
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def _check(xg, r, state):
    if xg.ndim != 4 or xg.shape[2] != 4:
        raise ValueError(f"expected xg (B,S,4,D); got {tuple(xg.shape)}")
    B, S, _, D = xg.shape
    if r.ndim != 4 or r.shape[0] != 4 or r.shape[2] != r.shape[3] or (
            r.shape[1] * r.shape[2] != D):
        raise ValueError(f"expected r (4,H,hd,hd) with H*hd = {D}; got "
                         f"{tuple(r.shape)}")
    for name, t in zip(SLSTMState._fields, state):
        if tuple(t.shape) != (B, D):
            raise ValueError(f"state {name} {tuple(t.shape)}, expected "
                             f"{(B, D)}")


def slstm_step(xg_t: torch.Tensor, r: torch.Tensor,
               st: SLSTMState) -> SLSTMState:
    """One step of the cell: xg_t ``(B,4,D)`` gate inputs at time t."""
    B, D = st.h.shape
    H, hd = r.shape[1], r.shape[2]
    hh = st.h.reshape(B, H, hd)

    def pre(g):  # the gate input in its own type, added in float32
        rec = torch.einsum("bhd,hde->bhe", hh, r[g].to(hh.dtype))
        return (xg_t[:, g] + rec.reshape(B, D)).to(torch.float32)

    i_pre, f_pre = pre(0), pre(1)
    z = torch.tanh(pre(2))
    o = torch.sigmoid(pre(3))
    m1 = torch.maximum(f_pre + st.m, i_pre)
    ip = torch.exp(i_pre - m1)
    fp = torch.exp(f_pre + st.m - m1)
    c1 = fp * st.c + ip * z
    n1 = torch.clamp_min(fp * st.n + ip, 1e-6)
    return SLSTMState(o * (c1 / n1), c1, n1, m1)


def slstm_scan_plain(xg: torch.Tensor, r: torch.Tensor, state: SLSTMState):
    """``(hs (B,S,D) float32, final state)`` by a loop of
    :func:`slstm_step` over the steps."""
    _check(xg, r, state)
    st = SLSTMState(*state)
    hs = []
    for t in range(xg.shape[1]):
        st = slstm_step(xg[:, t], r, st)
        hs.append(st.h)
    return torch.stack(hs, dim=1), st


def accuracy_ratio(got, plain32, plain64) -> float:
    """The largest, over the outputs ``(hs, (h, c, n, m))``, of ``got``'s
    largest error against ``plain64`` (the plain version in float64) over
    ``ACCURACY`` times ``plain32``'s plus ``TOLERANCE["atol"]``: at most 1
    when the kernel is as accurate as the plain version in float32."""
    def outs(r):
        return [r[0], *r[1]]

    worst = 0.0
    for g, p, w in zip(outs(got), outs(plain32), outs(plain64)):
        w = w.to(torch.float64)
        err = float((g.to(torch.float64) - w).abs().max())
        own = float((p.to(torch.float64) - w).abs().max())
        worst = max(worst, err / (ACCURACY * own + TOLERANCE["atol"]))
    return worst


def slstm_scan(xg: torch.Tensor, r: torch.Tensor, state: SLSTMState):
    """The sLSTM over ``xg``'s S steps from ``state``: CPU tensors take
    :func:`slstm_scan_plain`, CUDA tensors launch the kernel (or raise)."""
    state = SLSTMState(*state)
    if xg.device.type == "cpu":
        return slstm_scan_plain(xg, r, state)
    if xg.device.type != "cuda":
        raise ValueError(f"unsupported device {xg.device}")
    if _needs_grad(xg, r, *state):
        raise no_backward("slstm_scan")
    _check(xg, r, state)
    types = (torch.float32, torch.bfloat16)
    if xg.dtype not in types or r.dtype not in types:
        raise ValueError(f"expected float32 or bfloat16 xg and r; got "
                         f"{xg.dtype}, {r.dtype}")
    if any(t.device != xg.device for t in (r, *state)):
        raise ValueError("xg, r and the state must be on one device")
    B, S, _, D = xg.shape
    H, hd = r.shape[1], r.shape[2]
    multiple, widest = HEAD_WIDTHS[r.dtype]
    if hd % multiple or hd > widest:
        raise ValueError(f"head width {hd}: the kernel takes multiples of "
                         f"{multiple} up to {widest} for {r.dtype} weights")
    xg, r = xg.contiguous(), r.contiguous()
    st = [t.to(torch.float32).contiguous() for t in state]
    hs = torch.empty((B, S, D), dtype=torch.float32, device=xg.device)
    fin = SLSTMState(*(torch.empty_like(t) for t in st))
    if B * S * D == 0:
        return hs, SLSTMState(*st)
    with torch.cuda.device(xg.device):
        KERNEL.launch(xg.data_ptr(), r.data_ptr(),
                      *(t.data_ptr() for t in st), hs.data_ptr(),
                      *(t.data_ptr() for t in fin), B, S, H, hd,
                      int(xg.dtype == torch.bfloat16),
                      int(r.dtype == torch.bfloat16),
                      stream=torch.cuda.current_stream(xg.device).cuda_stream)
    return hs, fin
