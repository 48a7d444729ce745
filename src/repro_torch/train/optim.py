"""AdamW from scratch + warmup-cosine schedule.

The port of ``repro/train/optim.py`` over trees of tensors, in the same
float32 math: decoupled weight decay (no decay on norms/biases/1-D
params), global-norm gradient clipping, float32 moments by default with an
``opt_dtype`` knob (bfloat16 moments halve the optimizer's memory).  The
optimizer state mirrors the parameter tree leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    opt_dtype: str = "float32"  # moment dtype: float32 | bfloat16


class OptState(NamedTuple):
    mu: Any  # first moment  (tree like params)
    nu: Any  # second moment (tree like params)
    count: torch.Tensor  # step counter (0-d int32)


def schedule(cfg: OptConfig, step):
    """Warmup-linear then cosine to ``min_lr_frac * lr`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: OptConfig, params) -> OptState:
    dt = getattr(torch, cfg.opt_dtype)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(zeros, tree_map(torch.clone, zeros),
                    torch.zeros((), dtype=torch.int32, device=dev))


def _decay_mask(params):
    """True where weight decay applies: >=2-D parameter matrices only."""
    return tree_map(lambda p: p.ndim >= 2, params)


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def update(cfg: OptConfig, grads, state: OptState, params):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.betas
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    dt = getattr(torch, cfg.opt_dtype)

    def leaf(p, g, mu, nu, decay):
        g32 = g.to(torch.float32) * scale
        mu32 = mu.to(torch.float32) * b1 + g32 * (1.0 - b1)
        nu32 = nu.to(torch.float32) * b2 + torch.square(g32) * (1.0 - b2)
        step = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
        if decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * step).to(p.dtype)
        return new_p, mu32.to(dt), nu32.to(dt)

    out = tree_map(leaf, params, grads, state.mu, state.nu,
                   _decay_mask(params))
    # ``out`` holds a (p, mu, nu) triple where params hold a leaf
    new_p = tree_map(lambda _, o: o[0], params, out)
    new_mu = tree_map(lambda _, o: o[1], params, out)
    new_nu = tree_map(lambda _, o: o[2], params, out)
    return new_p, OptState(new_mu, new_nu, count), {"grad_norm": gnorm,
                                                    "lr": lr}
