"""xLSTM-125M: 12 blocks of mLSTM with interleaved sLSTM.

[arXiv:2405.04517; unverified] — d_model 768, 4 heads, vocab 50304 (GPT-2
rounded), d_ff 0 (the mLSTM up-projection replaces the FFN).  We use an
xLSTM[5:1]-style ratio: every 6th block is sLSTM (2 of 12).  Constant-size
recurrent state -> runs the long_500k cell (DESIGN.md SS5).  A copy of the
reference's ``repro/configs/xlstm_125m.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    slstm_every=6,
    mlstm_proj_factor=2.0,
    mlstm_chunk=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
    fsdp="none",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        vocab_size=256,
        slstm_every=3,
        mlstm_chunk=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
