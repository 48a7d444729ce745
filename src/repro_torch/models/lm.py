"""Top-level language model: embed -> block stack -> norm -> logits.

The port of ``repro/models/lm.py``, with its three input modes:

* ``tokens``: int token ids, ``batch["tokens"]`` (B, S);
* ``embeddings`` (musicgen): the frontend's frame embeddings arrive
  precomputed as ``batch["embeds"]`` (B, S, D); the head still predicts
  codec ids over ``vocab_size``, and decode embeds the generated ids with
  the output head's transpose (no ``embed`` leaf when untied);
* ``mixed`` (llava-next): ``batch["embeds"]`` (B, img_tokens, D), the
  precomputed patch embeddings, go in front of the embedded
  ``batch["tokens"]``; labels of -1 mask the image positions.

Beside the serving functions it has the training loss
:func:`loss_and_metrics`.  Parameters are a plain tree of tensors shaped
by :func:`lm_template`, the reference's layout (``segments`` a list of
stacked per-segment dicts, ``final_norm``, ``embed``, ``unembed``);
:func:`init_params` makes them from a seed on the card unless asked for
another device, and ``models.convert.params_from_jax`` carries the
reference's across.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..distributed.sharding import constrain, gather_fsdp
from . import transformer as tfm
from .layers import PT, embed_template, init_tree, norm_template, rmsnorm, unembed_apply

Params = Dict[str, Any]


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def lm_template(cfg) -> Params:
    t: Params = {
        "segments": [tpl for (_, _, tpl) in tfm.stack_templates(cfg)],
        "final_norm": norm_template(cfg.d_model),
    }
    if cfg.input_mode in ("tokens", "mixed"):
        t["embed"] = embed_template(cfg.vocab_size, cfg.d_model)
    if not cfg.tie_embeddings:
        t["unembed"] = PT(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "normal", 0.02
        )
    return t


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda") -> Params:
    """Parameters from a seeded generator on ``device`` (seed 0 when none
    is given, as the reference's CLI uses ``PRNGKey(0)``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return init_tree(lm_template(cfg), generator, dtype=param_dtype(cfg),
                     device=device)


def embed_inputs(cfg, params: Params, batch: Dict[str, torch.Tensor]):
    """(B, S, D) input activations from the arch's input mode."""
    dt = compute_dtype(cfg)
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"]].to(dt)
    elif cfg.input_mode == "embeddings":
        x = batch["embeds"].to(dt)
    elif cfg.input_mode == "mixed":
        xt = params["embed"][batch["tokens"]].to(dt)
        x = torch.cat([batch["embeds"].to(dt), xt], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    # (batch, seq, -): the activations do not take the table's sharding
    return constrain(x, "batch", "seq", None)


def _head(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    # the (B, S, V) logits are the largest activation: vocab on model
    return constrain(unembed_apply(params, x, cfg), "batch", "seq", "vocab")


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def forward(cfg, params: Params, batch: Dict[str, torch.Tensor]):
    """Full-sequence logits (B, S, V)."""
    params = gather_fsdp(cfg, params)  # sharded runs only
    x = embed_inputs(cfg, params, batch)
    x, _, _ = tfm.forward_stack(cfg, params["segments"], x, _positions(x))
    return _head(cfg, params, x)


def loss_and_metrics(cfg, params: Params, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy (f32 reductions) + MoE aux loss.

    ``batch["labels"]`` is (B, S) int with -1 = masked (padding, image
    positions).  Returns (loss, metrics dict), 0-d float32 tensors.
    """
    params = gather_fsdp(cfg, params)  # sharded runs only
    x = embed_inputs(cfg, params, batch)
    x, _, aux = tfm.forward_stack(cfg, params["segments"], x, _positions(x))
    logits = _head(cfg, params, x)

    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lab = labels.clamp_min(0).to(torch.int64)
    # max-shifted logsumexp in float32, the shift outside the gradient
    logits32 = logits.to(torch.float32)
    m = logits32.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    tgt = torch.gather(logits32, -1, lab[..., None])[..., 0]
    nll = (lse - tgt) * mask
    denom = mask.sum().clamp_min(1.0)
    ce = nll.sum() / denom
    aux32 = aux.to(torch.float32)
    loss = ce + cfg.moe_aux_coef * aux32
    return loss, {"loss": loss, "ce": ce, "aux": aux32, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# serving path
# ---------------------------------------------------------------------------


def init_caches(cfg, batch: int, cache_len: int, dtype=None, device="cuda"):
    """Decode caches, parallel to the segment structure."""
    return tfm.init_stack_states(cfg, batch, cache_len,
                                 dtype or compute_dtype(cfg), device)


def prefill_step(cfg, params: Params, batch: Dict[str, torch.Tensor],
                 cache_len: int):
    """Process the prompt; returns (last-token logits (B, V), caches).

    Only the final position's logits are computed."""
    params = gather_fsdp(cfg, params)  # sharded runs only
    x = embed_inputs(cfg, params, batch)
    x, caches = tfm.prefill_stack(cfg, params["segments"], x, _positions(x),
                                  cache_len)
    logits = _head(cfg, params, x[:, -1:, :])
    return logits[:, 0], caches


def decode_step(cfg, params: Params, caches, tokens: torch.Tensor, pos):
    """One decode step.  tokens (B, 1) int, pos the absolute position: a
    scalar, or one per row (B,) for rows at different positions (the
    engine's slots).  Returns (logits (B, V), caches), the caches updated
    in place.  In the ``embeddings`` mode the generated codec ids are
    embedded with the output head's transpose (the frontend stub has no
    encoder at decode time)."""
    params = gather_fsdp(cfg, params)  # sharded runs only
    if cfg.input_mode in ("tokens", "mixed") or cfg.tie_embeddings:
        w = params["embed"]
    else:
        w = params["unembed"].T
    x = w[tokens].to(compute_dtype(cfg))
    x, caches = tfm.decode_stack(cfg, params["segments"], x, caches, pos)
    logits = _head(cfg, params, x)
    return logits[:, 0], caches
