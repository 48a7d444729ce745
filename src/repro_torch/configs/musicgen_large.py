"""MusicGen-large backbone: 48L decoder-only over EnCodec tokens, MHA.

[arXiv:2306.05284] — d_model 2048, 32 heads (kv=32, i.e. full MHA), FFN
8192, vocab 2048 (codec codebook). The EnCodec frontend is a STUB: the
batch's ``embeds`` carries precomputed frame embeddings (input_mode
"embeddings"); cross-attention text conditioning is out of scope (DESIGN.md
SS8). A copy of the reference's ``repro/configs/musicgen_large.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeddings",
    act="gelu",
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
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        microbatch=0,
        fsdp="none",
        attn_q_block=64,
    )
