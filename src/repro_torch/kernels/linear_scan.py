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
(Hillis-Steele) scan in torch, which autograd can differentiate; the CPU
takes it.  On a CUDA tensor that needs a gradient the wrapper raises: the
kernel has no backward yet (ROADMAP.md, training of the recurrent
families).
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
#: ``a <= 0.95`` and ``|b| <= 1`` that is under 1e-5 of ``|h| <= 20``
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


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None):
    """``(h (B,T,N), h_last (B,N))`` in float32 by a Hillis-Steele scan:
    after the pass of stride d, each (a, b) pair composes the d steps
    before it with its own."""
    _check(a, b, h0)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if h0 is not None:  # the reference's fold of h0 into the first input
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def no_backward(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {name} kernel has no backward: training the recurrent "
        f"families on the card waits for its backward kernel (ROADMAP.md, "
        f"later work); a CPU tensor trains through the plain version")


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None):
    """``h_t = a_t * h_{t-1} + b_t`` over ``(B,T,N)`` from ``h0`` (zeros
    when None): ``(h (B,T,N), h_last (B,N))`` in float32.  CPU tensors
    take :func:`linear_scan_plain`; CUDA tensors launch the kernel (or
    raise)."""
    if a.device.type == "cpu":
        return linear_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if _needs_grad(a, b, h0):
        raise no_backward("linear_scan")
    _check(a, b, h0)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"expected float32 a, b; got {a.dtype}, {b.dtype}")
    B, T, N = a.shape
    if h0 is None:
        h0 = torch.zeros((B, N), dtype=torch.float32, device=a.device)
    if b.device != a.device or h0.device != a.device:
        raise ValueError("a, b and h0 must be on one device")
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    last = torch.empty((B, N), dtype=torch.float32, device=a.device)
    if B * N == 0:
        return out, last
    tiles = B * -(-N // TILE_CHANNELS) * -(-T // TILE_STEPS)
    stream = torch.cuda.current_stream(a.device)
    scratch, gen = _scratch.take(stream, 1 + tiles * 2 * TILE_CHANNELS)
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      out.data_ptr(), last.data_ptr(), scratch.data_ptr(),
                      scratch.numel(), B, T, N, gen,
                      stream=stream.cuda_stream)
    return out, last


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
