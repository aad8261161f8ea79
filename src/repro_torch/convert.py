"""Carry the reference's parameters across to the port.

``params_from_jax`` takes the JAX package's ``lm_init`` params as a nested
dict of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's params: the same nested dict of float32 tensors on ``device``.  The
layouts are the same one to one (stacked ``(L, ...)`` layers, ``(K, N)``
weights), so tests run both sides from identical weights.  This module
imports no JAX: the caller converts to numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    out = {}
    for name, val in tree.items():
        if isinstance(val, Mapping):
            out[name] = params_from_jax(val, device)
        else:
            out[name] = torch.from_numpy(
                np.array(val, dtype=np.float32)).to(device)
    return out
