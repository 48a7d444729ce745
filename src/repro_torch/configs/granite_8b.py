"""Granite-8B (code): 36L dense llama-arch, GQA kv=8.

[arXiv:2405.04324] — d_model 4096, 32 heads (head_dim 128), FFN 14336, vocab
49152. A copy of the reference's ``repro/configs/granite_8b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    attn_kv_block=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="data",
    microbatch=8,
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
