"""repro_torch.models — the LM substrate's dense decoder on torch.

``layers`` (templates, initialisers, RMSNorm, RoPE, MLP, head),
``attention`` (GQA attention, KV caches; the flash kernel on long
prompts), ``transformer`` (the dense block and the layer stack), ``lm``
(embed -> stack -> logits, prefill and decode steps) and ``convert`` (the
reference's parameters carried across).
"""
from .lm import (  # noqa: F401
    decode_step,
    embed_inputs,
    forward,
    init_caches,
    init_params,
    lm_template,
    loss_and_metrics,
    prefill_step,
)
