"""repro_torch.models — the LM substrate's decoders on torch.

``layers`` (templates, initialisers, RMSNorm, RoPE, MLP, head),
``attention`` (GQA attention, KV caches; the flash kernel on long
prompts), ``moe`` (top-k routing and the capacity dispatch), ``rglru`` and
``ssm`` (the recurrent kinds), ``transformer`` (the blocks and the layer
stack), ``lm`` (the three input modes -> stack -> logits, prefill and
decode steps, the loss) and ``convert`` (the reference's parameters
carried across).
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
