"""Train step builder: loss -> grads (optionally microbatched) -> AdamW.

The port of ``repro/train/step.py``.  Gradient accumulation loops over
microbatches (the reference's ``lax.scan``) with float32 accumulators;
per-microbatch gradients are in the model's compute dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.models import lm

from . import optim


def loss_fn(cfg, params, batch):
    loss, metrics = lm.loss_and_metrics(cfg, params, batch)
    return loss, metrics


def _split_micro(batch: Dict[str, torch.Tensor], m: int):
    """(B, ...) -> m dicts of (B/m, ...) tensors."""
    for x in batch.values():
        assert x.shape[0] % m == 0, (x.shape[0], m)
    return [{k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(m)]


def _value_and_grad(cfg, params, batch):
    """(loss, metrics, grads): grads a tree like ``params``."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, ps, batch)
    grads = unflatten(ps, torch.autograd.grad(loss, leaves(ps)))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def grads_and_metrics(cfg, params, batch):
    """Loss and gradients, microbatched with float32 accumulators when
    ``cfg.microbatch`` > 1."""
    m = cfg.microbatch
    if not m or m <= 1:
        loss, metrics, grads = _value_and_grad(cfg, params, batch)
        return grads, {**metrics, "loss": loss}

    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=leaves(params)[0].device)
    for mb in _split_micro(batch, m):
        loss, _, grads = _value_and_grad(cfg, params, mb)
        g_acc = tree_map(lambda a, g: a + g.to(torch.float32) / m, g_acc,
                         grads)
        l_acc = l_acc + loss / m
    grads = tree_map(lambda g, p: g.to(p.dtype), g_acc, params)
    return grads, {"loss": l_acc}


def make_train_step(cfg, opt_cfg: optim.OptConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        grads, metrics = grads_and_metrics(cfg, params, batch)
        params, opt_state, opt_metrics = optim.update(
            opt_cfg, grads, opt_state, params
        )
        m = {
            "loss": metrics["loss"],
            "grad_norm": opt_metrics["grad_norm"],
            "lr": opt_metrics["lr"],
        }
        return params, opt_state, m

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(cfg, params, batch)
        return {"loss": loss, "ce": metrics["ce"]}

    return eval_step
