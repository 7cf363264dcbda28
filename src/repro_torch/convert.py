"""Carry parameters between the JAX package and the port.

The reference's parameters, as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``), become the port's parameters and
back.  Both sides use the same tree (the reference's leaves, stacked
layer weights, the MoE subtree and xLSTM's list of layers included), so
this only moves data: it checks every leaf's path and shape against the
family's ``param_shapes`` and sets each leaf's dtype as the reference
has it (the config's, but float32 for the MoE router).  numpy
has no bfloat16 of its own; such arrays (``ml_dtypes.bfloat16``) pass
through float32, which is exact both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree as T
from .models.config import ModelConfig
from .models.registry import leaf_dtype, param_shapes


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Numpy parameter tree (the reference's) → the port's tensors on
    ``device``, each in its leaf's dtype (:func:`leaf_dtype`)."""
    want = dict(T.flatten(param_shapes(cfg)))
    got = T.flatten(tree)
    if set(want) != {p for p, _ in got}:
        raise ValueError(
            f"parameter tree mismatch: missing "
            f"{sorted(set(want) - {p for p, _ in got})}, unexpected "
            f"{sorted({p for p, _ in got} - set(want))}")
    out: dict = {}
    for path, arr in got:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[path]):
            raise ValueError(f"{'.'.join(map(str, path))}: shape "
                             f"{arr.shape}, config wants {want[path]}")
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr)).to(leaf_dtype(cfg, path))
        T.assign(out, path, t.to(device) if device is not None else t)
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's parameters → nested dict of numpy arrays (bfloat16
    leaves come back as float32, exactly)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return T.map_leaves(conv, params)
