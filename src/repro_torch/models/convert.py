"""Carry a parameter tree (and optimizer state) of the reference across into
the port.

``params_from_jax`` takes the reference package's LM parameters as numpy
arrays (``jax.tree.map(np.asarray, params)``: dicts and lists of arrays,
bfloat16 ones as ``ml_dtypes`` arrays) and returns the port's tree of
tensors, checked leaf by leaf against :func:`lm.lm_template`'s shapes.
:func:`opt_state_from_jax` carries the reference's optimizer state across
the same way, so both packages can train from one state.  It imports
neither jax nor the reference: only the arrays cross.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lm
from .layers import PT


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiu":  # ml_dtypes bfloat16 and the like
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_jax(cfg, tree, device="cuda", dtype: torch.dtype | None = None):
    """The port's parameters from the reference's parameter tree (numpy
    leaves), on ``device`` in ``dtype`` (default: ``cfg.param_dtype``)."""
    dtype = dtype or lm.param_dtype(cfg)

    def build(t, node, path):
        if isinstance(t, PT):
            arr = np.asarray(node)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{path}: shape {arr.shape}, template "
                                 f"{t.shape}")
            return _tensor(arr, dtype, device)
        if isinstance(t, dict):
            if set(t) != set(node):
                raise ValueError(f"{path}: keys {sorted(node)}, template "
                                 f"{sorted(t)}")
            return {k: build(t[k], node[k], f"{path}.{k}") for k in t}
        if len(t) != len(node):
            raise ValueError(f"{path}: {len(node)} entries, template "
                             f"{len(t)}")
        return [build(a, b, f"{path}.{i}") for i, (a, b) in
                enumerate(zip(t, node))]

    return build(lm.lm_template(cfg), tree, "params")


def opt_state_from_jax(cfg, state, device="cuda"):
    """The port's :class:`~repro_torch.train.optim.OptState` from the
    reference's (numpy leaves: ``mu`` and ``nu`` trees like the parameters,
    in the moments' dtype, float32 or bfloat16; ``count`` a 0-d int32)."""
    from repro_torch._tree import leaves
    from repro_torch.train.optim import OptState

    mu, nu, count = state
    dt = (torch.bfloat16 if str(np.asarray(leaves(mu)[0]).dtype) == "bfloat16"
          else torch.float32)
    return OptState(
        params_from_jax(cfg, mu, device, dt),
        params_from_jax(cfg, nu, device, dt),
        torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                     device=device))
