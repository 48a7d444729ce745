"""Abstract input/state specs for every (architecture x input-shape) cell.

The port of ``repro/launch/specs.py``: :func:`input_specs` returns every
model input of a cell as a tensor on the ``meta`` device (a shape and a
dtype, no storage), in place of the reference's ``ShapeDtypeStruct``s,
plus the ``PT`` templates (logical axes) from which
``distributed.sharding`` derives each input's placements.  This is what
``launch/dryrun.py`` shards and runs, and what the roofline reads.

Cell kinds (``configs.base.SHAPES``):
  train    -> train_step(params, opt_state, batch)
  prefill  -> prefill_step(params, batch) -> (last logits, caches)
  decode   -> decode_step(params, caches, tokens, pos)  [one new token
              against a seq_len-long KV cache]
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import PT, template_map
from repro_torch.train import optim


def abstract_tree(template, dtype):
    """PT tree -> tree of ``meta`` tensors."""
    return template_map(
        lambda t: torch.empty(t.shape, dtype=dtype, device="meta"), template)


def params_template(cfg: ModelConfig):
    return lm.lm_template(cfg)


def abstract_params(cfg: ModelConfig):
    return abstract_tree(params_template(cfg), getattr(torch, cfg.param_dtype))


def opt_template(cfg: ModelConfig):
    """Optimizer state template mirroring the parameter tree (mu, nu, count)."""
    pt = params_template(cfg)
    return optim.OptState(pt, pt, PT((), (), "zeros"))


def abstract_opt(cfg: ModelConfig, opt_dtype: str = "float32"):
    pt = params_template(cfg)
    mu = abstract_tree(pt, getattr(torch, opt_dtype))
    return optim.OptState(mu, mu, torch.empty((), dtype=torch.int32,
                                              device="meta"))


def batch_template(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, PT]:
    """Model input templates for a train/prefill cell (per input mode)."""
    B, S = shape.global_batch, shape.seq_len
    t: Dict[str, PT] = {}
    if cfg.input_mode == "tokens":
        t["tokens"] = PT((B, S), ("batch", "seq"), "zeros")
    elif cfg.input_mode == "embeddings":
        t["embeds"] = PT((B, S, cfg.d_model), ("batch", "seq", None), "zeros")
    else:  # mixed: anyres patch embeddings + text tokens
        s_txt = S - cfg.img_tokens
        assert s_txt > 0, (S, cfg.img_tokens)
        t["tokens"] = PT((B, s_txt), ("batch", "seq"), "zeros")
        t["embeds"] = PT((B, cfg.img_tokens, cfg.d_model),
                         ("batch", "seq", None), "zeros")
    if shape.kind == "train":
        t["labels"] = PT((B, S), ("batch", "seq"), "zeros")
    return t


def batch_dtype(cfg: ModelConfig, key: str) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype) if key == "embeds" else torch.int32


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig):
    return {k: torch.empty(pt.shape, dtype=batch_dtype(cfg, k), device="meta")
            for k, pt in batch_template(cfg, shape).items()}


def caches_template(cfg: ModelConfig, shape: ShapeConfig):
    return tfm.stack_cache_template(cfg, shape.global_batch, shape.seq_len)


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig):
    return [abstract_tree(t, getattr(torch, cfg.compute_dtype))
            for t in caches_template(cfg, shape)]


def decode_template(cfg: ModelConfig, shape: ShapeConfig) -> PT:
    """The decode cell's new tokens, (B, 1) over the batch axes."""
    return PT((shape.global_batch, 1), ("batch", None), "zeros")


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, pos) abstract inputs for a decode cell."""
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                         device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return tokens, pos


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every abstract input of the cell, keyed by role (the dry-run contract)."""
    out: Dict[str, Any] = {"params": abstract_params(cfg)}
    if shape.kind == "train":
        out["opt_state"] = abstract_opt(cfg)
        out["batch"] = abstract_batch(cfg, shape)
    elif shape.kind == "prefill":
        out["batch"] = abstract_batch(cfg, shape)
    else:  # decode
        out["caches"] = abstract_caches(cfg, shape)
        tokens, pos = decode_inputs(cfg, shape)
        out["tokens"], out["pos"] = tokens, pos
    return out
