"""RecurrentGemma-2B: RG-LRU + local sliding-window MQA, pattern (R,R,A).

[arXiv:2402.19427] — 26 layers, d_model 2560, 10 heads (MQA kv=1,
head_dim 256), GeGLU FFN 7680 (paper: expansion 3), lru_width 2560,
window 2048, logits soft cap 30.  Constant decode state (lru h + conv tail +
2048-window cache) -> runs the long_500k cell (DESIGN.md SS5).  A copy of the
reference's ``repro/configs/recurrentgemma_2b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="gelu",
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    window_size=2048,
    conv_width=4,
    logits_soft_cap=30.0,
    rope_theta=10_000.0,
    tp_head_pad=16,
    attn_kv_block=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="data",
    microbatch=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        lru_width=64,
        window_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        microbatch=0,
        fsdp="none",
        attn_q_block=64,
    )
