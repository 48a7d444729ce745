"""CUDA kernel: the diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

The device form of ``repro/models/rglru.py:rglru_scan``'s
``lax.associative_scan`` (the RG-LRU's prefill; the reference has no
Pallas kernel for it).  The kernel (``csrc/linear_scan.cu``) takes a, b
``(B,T,N)`` and h0 ``(B,N)`` in float32 and returns every ``h_t`` and the
last, with h0 entering as the reference folds it into the first input
term.  It is bound by bytes (12 an element), and reads a and b once: a
single pass over tiles of :data:`TILE_CHANNELS` channels by
:data:`TILE_STEPS` steps, joined by a decoupled look-back that gives the
same bits on every run, through status words tagged with the launch's
generation, which the wrapper keeps on each stream from launch to launch
(the note in the source has the design).

:func:`linear_scan_plain` is its plain version: a log-depth
(Hillis-Steele) scan in torch; the CPU takes it.

A call that needs a gradient goes through :class:`LinearScan`, whose
backward is the same recurrence run from the end (``dh_t = g_t +
a_{t+1} dh_{t+1}``, ``db = dh``, ``da_t = dh_t h_{t-1}``): on a CUDA
tensor the kernel ``csrc/linear_scan_bwd.cu`` (:data:`BWD_KERNEL`), on a
CPU tensor its plain version :func:`linear_scan_bwd_plain`.  Serving
needs no gradient and launches the forward kernel alone.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ._build import Kernel

KERNEL = Kernel(
    "linear_scan",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_uint],
    replaces="src/repro/models/rglru.py:82",
)
#: the backward: the reference differentiates the ``associative_scan`` by
#: autodiff (``jax.grad`` through ``rglru.py:82``)
BWD_KERNEL = Kernel(
    "linear_scan_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_uint],
    replaces="src/repro/models/rglru.py:82",
)

#: A tile of the kernel: ``TILE_CHANNELS`` channels by ``TILE_STEPS`` steps,
#: in sub-chunks of ``SUB_STEPS`` steps (``csrc/linear_scan.cu`` kLanes,
#: kTile, kSteps)
TILE_CHANNELS, TILE_STEPS, SUB_STEPS = 32, 128, 16
#: The status words' tags hold a launch's generation in 30 bits
#: (``csrc/linear_scan.cu`` kGenerations): at the wrap the scratch is zeroed
GENERATIONS = 1 << 30

#: ``|got - want| <= atol + rtol * |want|`` between the kernel (fused
#: multiply-adds in sub-chunks, tiles and a carry across tiles), the plain
#: version (a log-depth tree) and the reference's ``associative_scan``
#: (another tree): all float32,
#: they differ in summation order only.  With ``|a| < 1`` an error decays,
#: so each output carries the rounding of about ``1 / (1 - a)`` terms: for
#: ``a <= 0.95`` and ``|b| <= 1`` that is under 1e-5 of ``|h| <= 20``.
#: The backward kernel is held to its plain version by the same rule: the
#: same scan run from the end, then one product (``da``)
TOLERANCE = dict(rtol=1e-4, atol=1e-5)


def _check(a, b, h0):
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a = b (B,T,N); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,N) of "
                         f"{tuple(a.shape)}")
    if a.shape[1] == 0:
        raise ValueError("an empty sequence has no last state")


def _float(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 where it is: the plain versions compute
    in the wider of the two, so the tests can hold them in float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None):
    """``(h (B,T,N), h_last (B,N))`` in float32 (float64 for float64
    inputs) by a Hillis-Steele scan: after the pass of stride d, each (a, b)
    pair composes the d steps before it with its own."""
    _check(a, b, h0)
    a, b = _float(a), _float(b)
    if h0 is not None:  # the reference's fold of h0 into the first input
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(b.dtype)[:, None],
                       b[:, 1:]], dim=1)
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def linear_scan_bwd_plain(a, h, h0, g, g_last):
    """The vector-Jacobian product of :func:`linear_scan_plain` at its
    output ``h``: ``(da, db, dh0)`` (``dh0`` None when ``h0`` is) for the
    upstream gradients ``g`` of ``h`` and ``g_last`` of ``h_last``.  The
    reverse recurrence ``dh_T = g_T + g_last``, ``dh_t = g_t + a_{t+1}
    dh_{t+1}`` runs as the plain scan over the reversed steps (its first
    coefficient 1, its initial state ``g_last``); then ``db = dh``,
    ``da_t = dh_t h_{t-1}`` (``h0``, or zero, before the first) and
    ``dh0 = a_1 dh_1``."""
    a, h, g, g_last = _float(a), _float(h), _float(g), _float(g_last)
    after = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    dh, _ = linear_scan_plain(after.flip(1), g.flip(1), g_last)
    dh = dh.flip(1)
    first = (torch.zeros_like(h[:, :1]) if h0 is None
             else _float(h0)[:, None].to(h.dtype))
    da = dh * torch.cat([first, h[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0] * dh[:, 0]
    return da, dh, dh0


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _check_cuda(a, b, h0):
    _check(a, b, h0)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"expected float32 a, b; got {a.dtype}, {b.dtype}")
    if b.device != a.device or (h0 is not None and h0.device != a.device):
        raise ValueError("a, b and h0 must be on one device")


def _launch(a, b, h0):
    """The forward kernel on CUDA tensors: ``(h, h_last)``."""
    _check_cuda(a, b, h0)
    B, T, N = a.shape
    if h0 is None:
        h0 = torch.zeros((B, N), dtype=torch.float32, device=a.device)
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    last = torch.empty((B, N), dtype=torch.float32, device=a.device)
    if B * N == 0:
        return out, last
    stream = torch.cuda.current_stream(a.device)
    scratch, gen = _scratch.take(stream, 1 + _tiles(B, T, N) * 2
                                 * TILE_CHANNELS)
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      out.data_ptr(), last.data_ptr(), scratch.data_ptr(),
                      scratch.numel(), B, T, N, gen,
                      stream=stream.cuda_stream)
    return out, last


def _launch_bwd(a, h, h0, g, g_last):
    """The backward kernel on CUDA tensors: ``(da, db, dh0)``, ``dh0``
    None when ``h0`` is."""
    B, T, N = a.shape
    dev = a.device
    a, h, g, g_last = (t.to(torch.float32).contiguous()
                       for t in (a, h, g, g_last))
    h0c = (torch.zeros((B, N), dtype=torch.float32, device=dev)
           if h0 is None else h0.to(torch.float32).contiguous())
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B * N == 0:
        return da, db, None if h0 is None else dh0
    stream = torch.cuda.current_stream(dev)
    scratch, gen = _scratch.take(stream, 1 + _tiles(B, T, N) * 2
                                 * TILE_CHANNELS)
    with torch.cuda.device(dev):
        BWD_KERNEL.launch(a.data_ptr(), h.data_ptr(), h0c.data_ptr(),
                          g.data_ptr(), g_last.data_ptr(), da.data_ptr(),
                          db.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), B, T, N, gen,
                          stream=stream.cuda_stream)
    return da, db, None if h0 is None else dh0


def _tiles(B: int, T: int, N: int) -> int:
    return B * -(-N // TILE_CHANNELS) * -(-T // TILE_STEPS)


class LinearScan(torch.autograd.Function):
    """The scan with its backward: the kernels on CUDA tensors, the plain
    versions on CPU ones.  It saves a, h0 and its output h, from which the
    backward reads ``h_{t-1}``."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if a.device.type == "cpu":
            h, last = linear_scan_plain(a, b, h0)
        else:
            h, last = _launch(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.dtypes = (a.dtype, b.dtype, None if h0 is None else h0.dtype)
        return h, last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h0, h = ctx.saved_tensors
        bwd = (linear_scan_bwd_plain if a.device.type == "cpu"
               else _launch_bwd)
        da, db, dh0 = bwd(a, h, h0, g, g_last)
        ta, tb, th = ctx.dtypes
        return (da.to(ta), db.to(tb),
                None if dh0 is None else dh0.to(th))


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None):
    """``h_t = a_t * h_{t-1} + b_t`` over ``(B,T,N)`` from ``h0`` (zeros
    when None): ``(h (B,T,N), h_last (B,N))`` in float32.  CPU tensors
    take :func:`linear_scan_plain`; CUDA tensors launch the kernel (or
    raise).  A call that needs a gradient goes through
    :class:`LinearScan`."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if _needs_grad(a, b, h0):
        return LinearScan.apply(a, b, h0)
    if a.device.type == "cpu":
        return linear_scan_plain(a, b, h0)
    return _launch(a, b, h0)


class _Scratch:
    """The look-back's ticket and status words, one buffer a stream, kept
    from launch to launch: the kernel leaves the ticket at 0 and tags each
    status word with its launch's generation, so a launch needs no zeroing
    unless its buffer is new (or larger) or the generation wraps."""

    def __init__(self):
        self.lock = threading.Lock()
        self.bufs: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}

    def take(self, stream: torch.cuda.Stream, words: int):
        """``(buffer, gen)`` for the next launch on ``stream``."""
        key = (stream.device.index, stream.cuda_stream)
        with self.lock:
            buf, gen = self.bufs.get(key, (None, 0))
            if buf is None or buf.numel() < words:
                buf = torch.zeros(words, dtype=torch.int64,
                                  device=stream.device)
                gen = 0
            gen += 1
            if gen == GENERATIONS:
                buf.zero_()
                gen = 1
            self.bufs[key] = (buf, gen)
        return buf, gen


_scratch = _Scratch()
