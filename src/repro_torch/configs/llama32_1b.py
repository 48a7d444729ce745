"""Llama-3.2-1B: 16L dense, GQA kv=8, tied embeddings.

[hf:meta-llama/Llama-3.2-1B] — d_model 2048, 32 heads (head_dim 64),
FFN 8192, vocab 128256, rope theta 500000.  A copy of the reference's
``repro/configs/llama32_1b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
    attn_kv_block=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="data",
    microbatch=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        microbatch=0,
        fsdp="none",
        attn_q_block=64,
    )
