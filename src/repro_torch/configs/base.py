"""Model/shape configuration schema for the assigned architectures.

A copy of the reference's ``repro/configs/base.py`` (pure Python), so the
port's configurations and ``param_count`` equal the reference's field for
field.

One frozen dataclass covers all four families (dense / moe / ssm / hybrid);
each architecture file in this package instantiates it with the exact public
numbers, plus a family-preserving ``reduced()`` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    input_mode: str = "tokens"  # tokens | embeddings | mixed
    img_tokens: int = 0  # mixed mode: precomputed patch embeddings per sample

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0  # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01  # load-balance loss coefficient

    # MLA (DeepSeek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (xLSTM)
    slstm_every: int = 0  # every k-th block is sLSTM (0 = none)
    mlstm_proj_factor: float = 2.0
    mlstm_chunk: int = 256

    # hybrid (RecurrentGemma)
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    window_size: int = 0  # local attention window
    conv_width: int = 4
    logits_soft_cap: float = 0.0

    # distribution
    tp_head_pad: int = 0  # pad attention-activation heads to this for TP
                          # (params keep the exact public head count)

    # numerics / lowering
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "none"  # none | full | dots
    fsdp: str = "none"  # none | data | pod_data
    attn_q_block: int = 1024  # query-block size for chunked attention
    attn_kv_block: int = 0  # kv-block size for online-softmax (flash-style)
                            # attention; 0 = materialize (qb, S) score tiles
    microbatch: int = 0  # grad-accumulation microbatches (0 = off)

    # -- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def block_kind(self, layer: int) -> str:
        """Block type for a layer index (handles hybrid/ssm/moe patterns)."""
        if self.family == "hybrid" and self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        if self.family == "ssm":
            if self.slstm_every and (layer + 1) % self.slstm_every == 0:
                return "slstm"
            return "mlstm"
        if self.family == "moe" and layer >= self.n_dense_layers:
            return "moe"
        return "dense"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic state); all others skip it
SUBQUADRATIC = ("xlstm-125m", "recurrentgemma-2b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in SUBQUADRATIC
    return True


def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total_params, active_params_per_token) — analytic, for rooflines."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = emb
    active = emb
    for layer in range(cfg.n_layers):
        kind = cfg.block_kind(layer)
        if cfg.use_mla:
            attn = (
                d * cfg.q_lora_rank
                + cfg.q_lora_rank * h * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * h * (cfg.qk_nope_dim + cfg.v_head_dim)
                + h * cfg.v_head_dim * d
            )
        elif kind in ("mlstm", "slstm"):
            attn = 0
        else:
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = 3 * d * cfg.d_ff
        if kind == "moe":
            ff_e = cfg.d_ff_expert
            router = d * cfg.n_experts
            total += attn + 3 * d * ff_e * (cfg.n_experts + cfg.n_shared_experts) + router
            active += attn + 3 * d * ff_e * (cfg.moe_top_k + cfg.n_shared_experts) + router
        elif kind == "mlstm":
            du = int(d * cfg.mlstm_proj_factor)
            blk = 2 * d * du + 3 * du * du + du * d  # up(x2), qkv, down
            total += blk
            active += blk
        elif kind == "slstm":
            blk = 8 * d * d  # 4 gates x (input + recurrent)
            total += blk
            active += blk
        elif kind == "rglru":
            w = cfg.lru_width
            blk = 2 * d * w + w * cfg.conv_width + 2 * w * w + w * d + mlp
            total += blk
            active += blk
        else:  # dense / hybrid-attn blocks: attention + own MLP
            total += attn + mlp
            active += attn + mlp
    return total, active
