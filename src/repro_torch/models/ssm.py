"""xLSTM blocks: the chunkwise mLSTM and the recurrent sLSTM.

The port of ``repro/models/ssm.py``.

mLSTM: a matrix memory C (hd x hd) a head with stabilised exponential
gating.  A prompt runs the chunkwise form.  Where the reference scans the
chunks with ``lax.scan`` and computes each chunk's terms inside the scan,
the port computes every term that does not depend on the carried state
for all chunks at once with batched products (the in-chunk decay matrix,
``q k^T``, the in-chunk numerator and normaliser, and each chunk's sums
of ``k v^T`` for the carry), hands the carry of ``(C, n, m)`` from chunk
to chunk to the ``mlstm_scan`` kernel (``kernels/mlstm_scan.py``; its
plain loop on a CPU tensor), and then reads each chunk's inter-chunk term
as one batched product of its queries with the C the kernel wrote for the
chunk's start.  Decode is the one-step recurrence, torch as in the
reference.

sLSTM: a scalar memory with recurrent gate connections (block-diagonal a
head), sequential by nature.  A prompt's four input-gate products are
plain products; the recurrence over the steps is the ``slstm_scan``
kernel (``kernels/slstm_scan.py``; its plain loop of the cell on a CPU
tensor); decode is one step of the cell.

Under a gradient (training) both scans go through their
``torch.autograd.Function``, whose backward is a kernel on the card and a
plain backward on the CPU; nothing here changes for it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_local
from ..kernels.mlstm_scan import mlstm_scan
from ..kernels.slstm_scan import SLSTMState, slstm_scan, slstm_step
from .layers import PT, rmsnorm

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_template(cfg) -> Dict[str, PT]:
    d = cfg.d_model
    du = int(d * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    return {
        "up_x": PT((d, du), ("embed", "mlp")),
        "up_g": PT((d, du), ("embed", "mlp")),
        "wq": PT((du, du), ("mlp", "mlp2")),
        "wk": PT((du, du), ("mlp", "mlp2")),
        "wv": PT((du, du), ("mlp", "mlp2")),
        "wi": PT((du, h), ("mlp", "heads"), "normal", 0.01),
        "wf": PT((du, h), ("mlp", "heads"), "normal", 0.01),
        "bi": PT((h,), ("heads",), "zeros"),
        "bf": PT((h,), ("heads",), "ones"),  # forget-bias > 0
        "out_norm": PT((du,), ("mlp",), "ones"),
        "down": PT((du, d), ("mlp", "embed")),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd)
    n: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H)


def mlstm_init_state(batch: int, heads: int, hd: int, dtype=torch.float32,
                     device="cuda") -> MLSTMState:
    return MLSTMState(
        torch.zeros((batch, heads, hd, hd), dtype=dtype, device=device),
        torch.zeros((batch, heads, hd), dtype=dtype, device=device),
        torch.full((batch, heads), -1e30, dtype=dtype, device=device),
    )


def _gates(p, xu):
    """log-input-gate a (B,S,H), log-forget logf (B,S,H), float32."""
    a = (xu @ p["wi"] + p["bi"]).to(torch.float32)
    f_pre = (xu @ p["wf"] + p["bf"]).to(torch.float32)
    return a, F.logsigmoid(f_pre)


def mlstm_chunkwise(p, xu, cfg, state: MLSTMState | None = None):
    """xu: (B, S, du) -> (h (B,S,du), final state).

    A ragged sequence (S % chunk != 0) runs the whole multiple of the chunk
    and then the remainder as one short chunk carrying the state, as in the
    reference (the recurrence is associative across chunk splits)."""
    B, S, du = xu.shape
    H = cfg.n_heads
    hd = du // H
    L = min(cfg.mlstm_chunk, S)
    if S % L != 0:
        main = (S // L) * L
        h1, st = mlstm_chunkwise(p, xu[:, :main], cfg, state)
        h2, st = mlstm_chunkwise(p, xu[:, main:], cfg, st)
        return torch.cat([h1, h2], dim=1), st
    nc = S // L
    scale = 1.0 / (hd**0.5)
    f32 = torch.float32

    q = (xu @ p["wq"]).reshape(B, nc, L, H, hd).to(f32)
    k = (xu @ p["wk"]).reshape(B, nc, L, H, hd).to(f32)
    v = (xu @ p["wv"]).reshape(B, nc, L, H, hd).to(f32)
    a, logf = _gates(p, xu)
    a = a.reshape(B, nc, L, H)
    logf = logf.reshape(B, nc, L, H)
    if state is None:
        state = mlstm_init_state(B, H, hd, device=xu.device)

    b = torch.cumsum(logf, dim=2)  # inclusive in-chunk log-decay (B,nc,L,H)
    btot = b[:, :, -1]  # (B,nc,H)
    # the carry's inputs, every chunk at once: the chunk's own stabiliser
    # and its sums of k v^T and k weighted relative to it
    wlog = btot[:, :, None] - b + a  # (B,nc,L,H)
    mc = wlog.amax(dim=2)
    w = torch.exp(wlog - mc[:, :, None])
    wk = w[..., None] * k
    kv_sum = torch.einsum("bclhd,bclhe->bchde", wk, v)
    k_sum = wk.sum(dim=2)
    C0, n0, m0 = (t.to(f32) for t in state)
    ins = (btot, mc, kv_sum, k_sum, C0, n0, m0)
    res = batch_local(mlstm_scan, ins)  # sharded runs: a rank's own rows
    C_start, n_start, m_start, C1, n1, m1 = (mlstm_scan(*ins) if res is None
                                             else res)

    # in-chunk weights D[j, l] = b_j - b_l + a_l (l <= j)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xu.device))
    D = b[:, :, :, None, :] - b[:, :, None, :, :] + a[:, :, None, :, :]
    D = D.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    g = b + m_start[:, :, None, :]  # the state path's log-decay (B,nc,L,H)
    m_j = torch.maximum(g, D.amax(dim=3))  # (B,nc,L,H)
    sD = torch.exp(D - m_j[:, :, :, None, :])  # (B,nc,j,l,H)
    sG = torch.exp(g - m_j)

    qk = torch.einsum("bcjhd,bclhd->bcjlh", q, k) * scale
    num_intra = torch.einsum("bcjlh,bclhd->bcjhd", qk * sD, v)
    num_inter = torch.einsum("bcjhd,bchde->bcjhe", q, C_start) * (
        sG[..., None] * scale)
    num = num_intra + num_inter
    n_j = torch.einsum("bcjlh,bclhd->bcjhd", sD, k) + (
        sG[..., None] * n_start[:, :, None])
    qn = torch.abs(torch.einsum("bcjhd,bcjhd->bcjh", q * scale, n_j))
    denom = torch.maximum(qn, torch.exp(-m_j))
    h = num / denom[..., None]  # (B,nc,L,H,hd)
    return h.reshape(B, S, du).to(xu.dtype), MLSTMState(C1, n1, m1)


def mlstm_step(p, xu, cfg, state: MLSTMState):
    """Single-token recurrence.  xu: (B, 1, du)."""
    B, _, du = xu.shape
    H = cfg.n_heads
    hd = du // H
    scale = 1.0 / (hd**0.5)
    f32 = torch.float32
    q = (xu @ p["wq"]).reshape(B, H, hd).to(f32)
    k = (xu @ p["wk"]).reshape(B, H, hd).to(f32)
    v = (xu @ p["wv"]).reshape(B, H, hd).to(f32)
    a, logf = _gates(p, xu)  # (B,1,H)
    a, logf = a[:, 0], logf[:, 0]
    C0, n0, m0 = state
    m1 = torch.maximum(logf + m0, a)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(a - m1)
    C1 = fp[..., None, None] * C0 + ip[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n1 = fp[..., None] * n0 + ip[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q * scale, C1)
    qn = torch.abs(torch.einsum("bhd,bhd->bh", q * scale, n1))
    denom = torch.maximum(qn, torch.exp(-m1))
    h = (num / denom[..., None]).reshape(B, 1, du)
    return h.to(xu.dtype), MLSTMState(C1, n1, m1)


def mlstm_block(p, x, cfg, *, state=None, decode=False):
    """norm -> up -> mLSTM -> gate -> norm -> down (residual by caller)."""
    xu = x @ p["up_x"]
    gate = x @ p["up_g"]
    if decode:
        h, st = mlstm_step(p, xu, cfg, state)
    else:
        h, st = mlstm_chunkwise(p, xu, cfg, state)
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    return (h * F.silu(gate)) @ p["down"], st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_SLSTM_GATES = ("i", "f", "z", "o")  # the order of the kernel's gate axis


def slstm_template(cfg) -> Dict[str, PT]:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    t = {}
    for gname in _SLSTM_GATES:
        t[f"w{gname}"] = PT((d, d), ("embed", "embed2"))
        t[f"r{gname}"] = PT((h, hd, hd), ("heads", "head_dim", "head_dim2"),
                            "normal", 0.02)
        t[f"b{gname}"] = PT((d,), ("embed",),
                            "ones" if gname == "f" else "zeros")
    t["out_norm"] = PT((d,), ("embed",), "ones")
    return t


def slstm_init_state(batch: int, d: int, dtype=torch.float32,
                     device="cuda") -> SLSTMState:
    def z():
        return torch.zeros((batch, d), dtype=dtype, device=device)

    return SLSTMState(z(), z(), z(),
                      torch.full((batch, d), -1e30, dtype=dtype,
                                 device=device))


def slstm_block(p, x, cfg, *, state=None, decode=False):
    """x: (B,S,D): the recurrence over S (prefill) or (B,1,D) one step."""
    B, S, D = x.shape
    if state is None:
        state = slstm_init_state(B, D, device=x.device)
    xg = torch.stack([x @ p[f"w{g}"] + p[f"b{g}"] for g in _SLSTM_GATES],
                     dim=2)  # (B,S,4,D) in x's dtype
    r = torch.stack([p[f"r{g}"] for g in _SLSTM_GATES])  # (4,H,hd,hd)
    if decode:
        st = slstm_step(xg[:, 0], r, SLSTMState(*state))
        out = st.h[:, None, :]
    else:
        # sharded runs: each rank scans its own batch rows
        res = batch_local(lambda xg, *st: slstm_scan(xg, st[-1],
                                                     SLSTMState(*st[:-1])),
                          (xg, *state), (r,))
        out, st = slstm_scan(xg, r, state) if res is None else res
    out = rmsnorm(out.to(x.dtype), p["out_norm"], cfg.norm_eps)
    return out, st
