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
steps; the CPU takes it.

A call that needs a gradient goes through :class:`SLSTMScan`.  Its
forward also keeps ``(c, n, m)`` after every step (the forward kernel
writes them beside hs when asked; serving does not ask); its backward
walks the steps from the last, the cell differentiated exactly as
:func:`slstm_step` computes it, and exchanges the gates' gradients
``dpre`` where the forward exchanges h: on a CUDA tensor the kernel
``csrc/slstm_scan_bwd.cu`` (:data:`BWD_KERNEL`), on a CPU tensor
:func:`slstm_scan_bwd_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel
from .linear_scan import _needs_grad

KERNEL = Kernel(
    "slstm_scan",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6,
    replaces="src/repro/models/ssm.py:251",
)
#: the backward (the reference differentiates its ``lax.scan`` over the
#: steps by autodiff)
BWD_KERNEL = Kernel(
    "slstm_scan_bwd",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5,
    replaces="src/repro/models/ssm.py:251",
)

#: Head widths the kernels take, by the weights' type: (multiple, widest)
#: pairs, a width taken where one pair admits it.  The kernels split a
#: head over C CTAs, C the least power of two with at most 32 channels a
#: CTA (``csrc/slstm_scan.cu``), and take hd up to 256 where C divides it:
#: a multiple of 8 up to 256 always splits (C <= 8), a multiple of 4 up to
#: 128 (C <= 4).  Float32 weights take both sets (the full-width gradient
#: check trains xLSTM's heads of 192 in float32), bfloat16 the first, the
#: widths the card tests hold
HEAD_WIDTHS = {torch.bfloat16: ((8, 256),),
               torch.float32: ((4, 128), (8, 256))}

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


def _gate_pre(xg_t: torch.Tensor, r: torch.Tensor, h: torch.Tensor):
    """The four gates' pre-activations at one step, ``(B,D)`` each: the
    gate input in its own type plus the state's recurrent product, added
    in float32 (float64 for a float64 state)."""
    B, D = h.shape
    H, hd = r.shape[1], r.shape[2]
    hh = h.reshape(B, H, hd)
    out = []
    for g in range(4):
        rec = torch.einsum("bhd,hde->bhe", hh, r[g].to(hh.dtype))
        s = xg_t[:, g] + rec.reshape(B, D)
        out.append(s.to(torch.promote_types(s.dtype, torch.float32)))
    return out


class _Cell(NamedTuple):
    """One step's values: the gates' activations and the new state."""
    z: torch.Tensor
    o: torch.Tensor
    fm: torch.Tensor  # f_pre + m
    ip: torch.Tensor
    fp: torch.Tensor
    c1: torch.Tensor
    nn: torch.Tensor  # f n + i, before the floor
    n1: torch.Tensor
    m1: torch.Tensor


def _cell(pre, c, n, m) -> _Cell:
    """The cell at one step from its gates' pre-activations and the state
    before it, as the reference's ``_slstm_cell`` computes it."""
    i_pre, f_pre, z_pre, o_pre = pre
    fm = f_pre + m
    m1 = torch.maximum(fm, i_pre)
    ip = torch.exp(i_pre - m1)
    fp = torch.exp(fm - m1)
    z = torch.tanh(z_pre)
    c1 = fp * c + ip * z
    nn = fp * n + ip
    # the reference's jnp.maximum: a tie splits the gradient, as here
    n1 = torch.maximum(nn, torch.full_like(nn, 1e-6))
    return _Cell(z, torch.sigmoid(o_pre), fm, ip, fp, c1, nn, n1, m1)


def slstm_step(xg_t: torch.Tensor, r: torch.Tensor,
               st: SLSTMState) -> SLSTMState:
    """One step of the cell: xg_t ``(B,4,D)`` gate inputs at time t."""
    k = _cell(_gate_pre(xg_t, r, st.h), st.c, st.n, st.m)
    return SLSTMState(k.o * (k.c1 / k.n1), k.c1, k.n1, k.m1)


def slstm_scan_plain(xg: torch.Tensor, r: torch.Tensor, state: SLSTMState,
                     keep: bool = False):
    """``(hs (B,S,D) float32, final state)`` by a loop of
    :func:`slstm_step` over the steps; with ``keep``, also the state's
    ``(c, n, m)`` after every step, ``(B,S,3,D)`` (what the backward
    reads)."""
    _check(xg, r, state)
    st = SLSTMState(*state)
    hs, kept = [], []
    for t in range(xg.shape[1]):
        st = slstm_step(xg[:, t], r, st)
        hs.append(st.h)
        if keep:
            kept.append(torch.stack(st[1:], dim=1))
    if keep:
        return torch.stack(hs, dim=1), st, torch.stack(kept, dim=1)
    return torch.stack(hs, dim=1), st


def _share(x, y):
    """The share of ``max(x, y)``'s gradient that goes to x: 1, 0, or a
    half at a tie (torch's ``maximum`` and JAX's ``max`` alike)."""
    return torch.where(x > y, 1.0, torch.where(x < y, 0.0, 0.5)).to(x.dtype)


def slstm_scan_bwd_plain(xg, r, state, hs, cnm, dhs, dfinal):
    """The vector-Jacobian product of :func:`slstm_scan_plain` from its
    inputs, its outputs ``hs`` and the kept ``(c, n, m)`` of every step:
    ``(dxg, dr, dstate)`` for the gradients ``dhs`` of hs and ``dfinal`` of
    the final state.  A loop over the steps from the last: each step's
    pre-activations rebuilt from the saved ``h_{t-1}`` and ``xg_t``, the
    cell differentiated as :func:`slstm_step` computes it (the ``m`` chain
    through both ``maximum``\\ s and ``exp``\\ s, a tie split evenly), which
    gives ``dpre_t (B,4,D)``; ``dh_{t-1} = sum_g r_g dpre_g``, plus what
    flows from c, n and m.  ``dxg`` is ``dpre`` rounded once to xg's type
    and ``dr = sum_{b,t} h_{t-1} (x) dpre_t``, rounded once to r's."""
    B, S, _, D = xg.shape
    H, hd = r.shape[1], r.shape[2]
    state = SLSTMState(*state)
    dh, dc, dn, dm = (t.to(torch.promote_types(t.dtype, torch.float32))
                      for t in dfinal)
    dpre = [None] * S
    for t in reversed(range(S)):
        if t:
            h, (c, n, m) = hs[:, t - 1], cnm[:, t - 1].unbind(1)
        else:
            h, c, n, m = state
        pre = _gate_pre(xg[:, t], r, h)
        k = _cell(pre, c, n, m)
        dh = dh + dhs[:, t]
        d_ratio = dh * k.o
        dc1 = dc + d_ratio / k.n1
        dnn = (dn - d_ratio * k.c1 / (k.n1 * k.n1)) * _share(
            k.nn, k.n1.new_tensor(1e-6))
        gi = (dc1 * k.z + dnn) * k.ip
        gf = (dc1 * c + dnn * n) * k.fp
        dm1 = dm - gi - gf
        share = _share(k.fm, pre[0])
        d_f = gf + share * dm1
        dpre[t] = torch.stack([gi + (1 - share) * dm1, d_f,
                               dc1 * k.ip * (1 - k.z * k.z),
                               dh * (k.c1 / k.n1) * k.o * (1 - k.o)], dim=1)
        dh = torch.einsum("bghe,ghde->bhd", dpre[t].reshape(B, 4, H, hd),
                          r.to(dpre[t].dtype)).reshape(B, D)
        dc, dn, dm = dc1 * k.fp, dnn * k.fp, d_f
    dpre = torch.stack(dpre, dim=1)
    dr = _recurrent_grad(state.h, hs, dpre, r)
    dstate = SLSTMState(dh, dc, dn, dm)
    return dpre.to(xg.dtype), dr, dstate


def _prev_h(h0, hs):
    """``h_{t-1}`` for every step: ``(B,S,D)``, ``h0`` first."""
    return torch.cat([h0.to(hs.dtype)[:, None], hs[:, :-1]], dim=1)


def _recurrent_grad(h0, hs, dpre, r):
    """``dr = sum_{b,t} h_{t-1} (x) dpre_t`` per gate and head, a batched
    product, rounded once to r's type."""
    B, S, _, D = dpre.shape
    H, hd = r.shape[1], r.shape[2]
    hp = _prev_h(h0, hs).to(dpre.dtype).reshape(B, S, H, hd)
    return torch.einsum("bshd,bsghe->ghde", hp,
                        dpre.reshape(B, S, 4, H, hd)).to(r.dtype)


#: float64 entries of ``dpre`` a chunk of rows of :func:`_recurrent_grad_f64`
#: takes at once (256 MiB)
_F64_CHUNK = 1 << 25


def _recurrent_grad_f64(h0, hs, dpre, r):
    """:func:`_recurrent_grad` with the sum over b and t taken in float64
    and rounded once to r's type: the card route's ``dr``.  One float32
    sum over B·S steps loses more than the float32 plain loop's own error
    (at 64 rows r's error was 1.16 of ``ACCURACY``).  Rows go in chunks
    of at most ``_F64_CHUNK`` float64 entries of dpre, each chunk's
    product added to a float64 sum."""
    B, S, _, D = dpre.shape
    H, hd = r.shape[1], r.shape[2]
    hp = _prev_h(h0, hs)
    acc = torch.zeros((4, H, hd, hd), dtype=torch.float64,
                      device=dpre.device)
    rows = max(1, _F64_CHUNK // max(1, S * 4 * D))
    for b in range(0, B, rows):
        acc += torch.einsum(
            "bshd,bsghe->ghde",
            hp[b:b + rows].to(torch.float64).reshape(-1, S, H, hd),
            dpre[b:b + rows].to(torch.float64).reshape(-1, S, 4, H, hd))
    return acc.to(r.dtype)


def accuracy_ratio(got, plain32, plain64) -> float:
    """The largest, over the outputs (``(hs, (h, c, n, m))``, or the
    backward's ``(dxg, dr, (dh, dc, dn, dm))``), of ``got``'s largest error
    against ``plain64`` (the plain version in float64) over ``ACCURACY``
    times ``plain32``'s plus ``TOLERANCE["atol"]``: at most 1 when the
    kernel is as accurate as the plain version in float32."""
    def outs(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for part in x for t in outs(part)]

    worst = 0.0
    for g, p, w in zip(outs(got), outs(plain32), outs(plain64)):
        w = w.to(torch.float64)
        err = float((g.to(torch.float64) - w).abs().max())
        own = float((p.to(torch.float64) - w).abs().max())
        worst = max(worst, err / (ACCURACY * own + TOLERANCE["atol"]))
    return worst


def _check_cuda(xg, r, state):
    _check(xg, r, state)
    types = (torch.float32, torch.bfloat16)
    if xg.dtype not in types or r.dtype not in types:
        raise ValueError(f"expected float32 or bfloat16 xg and r; got "
                         f"{xg.dtype}, {r.dtype}")
    if any(t.device != xg.device for t in (r, *state)):
        raise ValueError("xg, r and the state must be on one device")
    hd = r.shape[2]
    if not any(hd % multiple == 0 and hd <= widest
               for multiple, widest in HEAD_WIDTHS[r.dtype]):
        raise ValueError(f"head width {hd}: the kernels take multiples of "
                         f"m up to w for (m, w) in "
                         f"{HEAD_WIDTHS[r.dtype]} for {r.dtype} weights")


def _launch(xg, r, state, keep: bool = False):
    """The forward kernel on CUDA tensors: ``(hs, final state)``, and with
    ``keep`` the ``(c, n, m)`` of every step ``(B,S,3,D)``, which the
    kernel then writes beside hs (serving does not ask for them)."""
    _check_cuda(xg, r, state)
    B, S, _, D = xg.shape
    H, hd = r.shape[1], r.shape[2]
    xg, r = xg.contiguous(), r.contiguous()
    st = [t.to(torch.float32).contiguous() for t in state]
    hs = torch.empty((B, S, D), dtype=torch.float32, device=xg.device)
    fin = SLSTMState(*(torch.empty_like(t) for t in st))
    cnm = (torch.empty((B, S, 3, D), dtype=torch.float32, device=xg.device)
           if keep else None)
    if B * S * D == 0:
        out = (hs, SLSTMState(*st))
        return out + (cnm,) if keep else out
    with torch.cuda.device(xg.device):
        KERNEL.launch(xg.data_ptr(), r.data_ptr(),
                      *(t.data_ptr() for t in st), hs.data_ptr(),
                      *(t.data_ptr() for t in fin),
                      cnm.data_ptr() if keep else None, B, S, H, hd,
                      int(xg.dtype == torch.bfloat16),
                      int(r.dtype == torch.bfloat16),
                      stream=torch.cuda.current_stream(xg.device).cuda_stream)
    return (hs, fin, cnm) if keep else (hs, fin)


def bwd_plan(B: int, H: int, hd: int) -> dict:
    """The backward kernel's launch plan for ``B`` rows of ``H`` heads of
    width ``hd`` on the current CUDA device, as the kernel computes it
    (``csrc/slstm_scan_bwd.cu``): the cluster size ``C``, the batch rows a
    cluster serves ``R``, the clusters launched (``ceil(B / R) H``), the
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``;
    one wave when ``clusters`` is at most this) and the threads a CTA.
    Launches nothing."""
    plan = (ctypes.c_int * 5)()
    BWD_KERNEL.call("slstm_scan_bwd_plan", [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)], B, H, hd, plan)
    return dict(zip(("C", "R", "clusters", "max_active_clusters",
                     "threads"), plan))


def _launch_bwd(xg, r, state, hs, cnm, dhs, dfinal):
    """The backward on CUDA tensors, as :func:`slstm_scan_bwd_plain`: the
    pre-activations of every step rebuilt at once from the saved hs and xg
    (one batched product, off the chain), the kernel's reverse walk over
    the steps for ``dpre`` and the initial state's gradient, then ``dr``
    by batched products summed in float64 (:func:`_recurrent_grad_f64`)."""
    B, S, _, D = xg.shape
    H, hd = r.shape[1], r.shape[2]
    dev = xg.device
    st = [t.to(torch.float32).contiguous() for t in state]
    hp = _prev_h(st[0], hs).reshape(B, S, H, hd)
    pre = (xg.to(torch.float32) + torch.einsum(
        "bshd,ghde->bsghe", hp, r.to(torch.float32)).reshape(B, S, 4, D)
           ).contiguous()
    del hp
    r = r.contiguous()
    grads = [t.to(torch.float32).contiguous() for t in (dhs, *dfinal)]
    cnm = cnm.contiguous()
    dpre = torch.empty((B, S, 4, D), dtype=torch.float32, device=dev)
    d0 = SLSTMState(*(torch.empty((B, D), dtype=torch.float32, device=dev)
                      for _ in range(4)))
    with torch.cuda.device(dev):
        BWD_KERNEL.launch(pre.data_ptr(), r.data_ptr(),
                          *(t.data_ptr() for t in st[1:]), cnm.data_ptr(),
                          *(t.data_ptr() for t in grads), dpre.data_ptr(),
                          *(t.data_ptr() for t in d0), B, S, H, hd,
                          int(r.dtype == torch.bfloat16),
                          stream=torch.cuda.current_stream(dev).cuda_stream)
    del pre
    return (dpre.to(xg.dtype), _recurrent_grad_f64(st[0], hs, dpre, r),
            d0)


class SLSTMScan(torch.autograd.Function):
    """The sLSTM scan with its backward: the kernels on CUDA tensors, the
    plain versions on CPU ones.  The forward keeps the ``(c, n, m)`` of
    every step (float32, ``B S 3 D``) beside its output hs; the backward
    rebuilds the rest."""

    @staticmethod
    def forward(ctx, xg, r, h0, c0, n0, m0):
        st = SLSTMState(h0, c0, n0, m0)
        run = slstm_scan_plain if xg.device.type == "cpu" else _launch
        hs, fin, cnm = run(xg, r, st, keep=True)
        ctx.save_for_backward(xg, r, h0, c0, n0, m0, hs, cnm)
        return (hs, *fin)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        xg, r, *st, hs, cnm = ctx.saved_tensors
        bwd = (slstm_scan_bwd_plain if xg.device.type == "cpu"
               else _launch_bwd)
        dxg, dr, d0 = bwd(xg, r, SLSTMState(*st), hs, cnm, dhs,
                          SLSTMState(dh, dc, dn, dm))
        return (dxg, dr, *(g.to(t.dtype) for g, t in zip(d0, st)))


def slstm_scan(xg: torch.Tensor, r: torch.Tensor, state: SLSTMState):
    """The sLSTM over ``xg``'s S steps from ``state``: CPU tensors take
    :func:`slstm_scan_plain`, CUDA tensors launch the kernel (or raise).  A
    call that needs a gradient goes through :class:`SLSTMScan`."""
    state = SLSTMState(*state)
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xg.device}")
    if _needs_grad(xg, r, *state):
        hs, *fin = SLSTMScan.apply(xg, r, *state)
        return hs, SLSTMState(*fin)
    if xg.device.type == "cpu":
        return slstm_scan_plain(xg, r, state)
    return _launch(xg, r, state)
