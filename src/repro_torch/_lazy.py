"""PEP-562 lazy package exports, shared by the ``service``/``dedup`` inits.

A copy of the reference's ``repro/_lazy.py``.  Both packages mix
numpy+stdlib modules (store, objects, transport, depot) with torch ones
(scheduler, index), and the spawned shard-server processes import the
former without paying torch's import.  One helper owns the resolution,
caching and ``__dir__`` behaviour so the two package inits cannot drift.
"""
from __future__ import annotations

import importlib
import sys
from typing import Dict, Sequence, Tuple


def install(module_name: str, exports: Dict[str, str],
            submodules: Sequence[str]) -> Tuple:
    """Build ``(__getattr__, __dir__)`` for a lazy package ``__init__``.

    ``exports`` maps public name -> defining submodule (relative, ``.api``
    style); ``submodules`` lists names resolvable as plain submodules.
    Resolved exports are cached on the package module, so the second access
    skips ``__getattr__`` entirely.
    """

    def __getattr__(name: str):
        if name in exports:
            value = getattr(
                importlib.import_module(exports[name], module_name), name
            )
            setattr(sys.modules[module_name], name, value)
            return value
        if name in submodules:
            return importlib.import_module("." + name, module_name)
        raise AttributeError(
            f"module {module_name!r} has no attribute {name!r}"
        )

    def __dir__():
        return sorted(
            set(vars(sys.modules[module_name])) | set(exports) | set(submodules)
        )

    return __getattr__, __dir__
