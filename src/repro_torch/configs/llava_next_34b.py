"""LLaVA-NeXT-34B backbone: 60L dense, 56 heads, anyres tiling stub.

[hf:llava-hf/llava-v1.6; unverified] — d_model 7168, 56 heads (GQA kv=8,
head_dim 128), FFN 20480, vocab 64000. The ViT/anyres frontend is a STUB:
the batch's ``embeds`` carries 2880 precomputed patch embeddings (5 tiles x
576) per sample, prepended to the text tokens (input_mode "mixed").

56 heads do not divide the 16-way model axis: the sharding layer replicates
what cannot shard or lets GSPMD pad (12.5% waste at 16-way) — recorded in
the roofline notes. A copy of the reference's
``repro/configs/llava_next_34b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    input_mode="mixed",
    img_tokens=2880,  # 5 anyres tiles x 576 patches
    rope_theta=5_000_000.0,
    tp_head_pad=64,
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
        d_ff=128,
        vocab_size=256,
        img_tokens=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        fsdp="none",
        microbatch=0,
        attn_q_block=64,
    )
