"""Qwen2-72B: 80L dense, GQA kv=8, QKV bias.

[arXiv:2407.10671] — d_model 8192, 64 heads (head_dim 128), FFN 29568, vocab
152064, rope theta 1e6. A copy of the reference's
``repro/configs/qwen2_72b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    attn_kv_block=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="pod_data",
    microbatch=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        fsdp="none",
        microbatch=0,
        attn_q_block=64,
    )
