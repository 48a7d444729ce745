"""Qwen3-30B-A3B: 48L MoE, 128 experts top-8, GQA kv=4, q/k-norm.

[hf:Qwen/Qwen3-30B-A3B] — d_model 2048, 32 heads (head_dim 128, decoupled
from d_model/heads = 64), expert FFN 768, vocab 151936, no shared experts,
every layer MoE. A copy of the reference's
``repro/configs/qwen3_moe_30b_a3b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,  # unused: all layers are MoE
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    moe_top_k=8,
    d_ff_expert=768,
    n_shared_experts=0,
    n_dense_layers=0,
    attn_kv_block=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="data",
    microbatch=8,  # peak activation HBM measured 60 GiB/dev without accumulation
)


def reduced() -> ModelConfig:
    """Family-preserving smoke config: tiny MoE with q/k-norm + GQA."""
    return CONFIG.replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=32,
        microbatch=0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        fsdp="none",
        attn_q_block=64,
    )
