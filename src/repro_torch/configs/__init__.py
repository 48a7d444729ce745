"""Architecture registry of the port: the configurations it can serve.

``get_config(name)`` returns the exact public configuration and
``get_reduced(name)`` the family-preserving smoke variant the CPU tests
use, as in the reference's ``repro/configs``.  The port runs the dense,
hybrid (RG-LRU and local attention) and SSM (mLSTM, sLSTM) block kinds, so
it registers ``llama3.2-1b``, ``recurrentgemma-2b`` and ``xlstm-125m``; any
other name raises a ``KeyError`` that points at the module queue in
ROADMAP.md.
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
    "llama3.2-1b": "llama32_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-125m": "xlstm_125m",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    try:
        mod = _MODULES[name]
    except KeyError:
        raise KeyError(
            f"arch {name!r} is not ported: the port serves {list(_MODULES)}; "
            f"the other families (MoE, MLA) wait in "
            f"ROADMAP.md's module queue (LM substrate)") from None
    return importlib.import_module(f"{__name__}.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
