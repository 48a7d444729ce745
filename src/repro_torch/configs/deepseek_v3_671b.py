"""DeepSeek-V3 671B: 61L, MLA attention, 1 shared + 256 routed experts top-8.

[arXiv:2412.19437] — d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora 512,
qk_nope 128 + qk_rope 64, v_head 128), first 3 layers dense (FFN 18432),
expert FFN 2048, vocab 129280.  The MTP head (multi-token prediction) is an
optional flag, off for the dry-run cells. A copy of the reference's
``repro/configs/deepseek_v3_671b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # qk_nope + qk_rope (used only for analytics; MLA has own dims)
    d_ff=18432,  # the 3 leading dense layers
    vocab_size=129280,
    rope_theta=10_000.0,
    n_experts=256,
    moe_top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="full",
    fsdp="pod_data",
    microbatch=16,
)


def reduced() -> ModelConfig:
    """Smoke config: tiny MLA + shared/routed MoE with 3-dense prefix -> 1."""
    return CONFIG.replace(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=24,
        d_ff=128,
        vocab_size=256,
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=32,
        n_dense_layers=1,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        fsdp="none",
        microbatch=0,
        attn_q_block=64,
    )
