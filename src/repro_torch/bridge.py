"""Carry the reference model's weights into the PyTorch port.

``params_from_numpy`` takes the pytree of ``repro.models.transformer.
init_params`` with every leaf converted to a numpy array (the caller does
the conversion, e.g. ``jax.tree.map(np.asarray, params)``, so nothing here
imports JAX) and returns the port's parameters: the per-pattern-position
leaves stacked over ``repeats`` become one dict per layer, layer
``r * len(pattern) + i`` taking slice ``r`` of position ``i``.  bf16
leaves go through float32, which is exact, and keep their dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _tensor(a, device) -> torch.Tensor:
    dtype = _DTYPES[str(a.dtype)]
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], cfg, device) -> Dict[str, Any]:
    """The port's parameters from the reference's (numpy leaves), on
    ``device`` (named by the caller: there is no default)."""
    out = {k: _tensor(v, device) for k, v in tree.items() if k != "blocks"}
    n_pat = len(cfg.pattern)
    out["layers"] = [
        _map(tree["blocks"][layer % n_pat],
             lambda a, r=layer // n_pat: _tensor(a[r], device))
        for layer in range(cfg.n_layers)]
    return out
