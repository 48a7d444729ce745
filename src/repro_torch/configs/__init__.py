"""Architecture registry of the port: the configurations it can serve.

``get_config(name)`` returns the exact public configuration and
``get_reduced(name)`` the family-preserving smoke variant the CPU tests
use, as in the reference's ``repro/configs``.  The port runs the dense,
MoE, MLA (``mla_dense``, ``mla_moe``), hybrid (RG-LRU and local
attention) and SSM (mLSTM, sLSTM) block kinds and all three input modes,
so it registers every architecture of the reference, in its order.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import (  # noqa: F401
    SHAPES,
    SUBQUADRATIC,
    ModelConfig,
    ShapeConfig,
    param_count,
    shape_applicable,
)

_MODULES: Dict[str, str] = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama3.2-1b": "llama32_1b",
    "qwen2-72b": "qwen2_72b",
    "granite-8b": "granite_8b",
    "musicgen-large": "musicgen_large",
    "llava-next-34b": "llava_next_34b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    try:
        mod = _MODULES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}: the port serves "
                       f"{list(_MODULES)}") from None
    return importlib.import_module(f"{__name__}.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
