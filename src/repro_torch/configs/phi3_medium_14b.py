"""Phi-3-medium 14B: 40L dense, GQA kv=10, SwiGLU 17920.

[arXiv:2404.14219] — d_model 5120, 40 heads (head_dim 128), vocab 100352. A
copy of the reference's ``repro/configs/phi3_medium_14b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10_000.0,
    tp_head_pad=48,
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
        d_ff=192,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        microbatch=0,
        fsdp="none",
        attn_q_block=64,
    )
