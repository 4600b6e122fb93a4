"""Weights between the JAX package's parameter tree and the port's modules.

The JAX package keeps parameters as nested dicts (``{"b0": {"L3": {"w1":
...}}}``); the port's modules hold the same leaves under the same names, so
the tree's key path joined by dots is the module's ``state_dict`` key
(``b0.L3.w1``). Shapes and the ``(in, out)`` weight orientation are the
same on both sides.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flat(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_numpy(tree: Mapping[str, Any], device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> ``state_dict`` for the port's model."""
    return {
        k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device) for k, v in _flat(tree)
    }


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The model's state as the JAX package's nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def load_params(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a JAX-layout parameter tree into ``model``; every key and shape
    must match (``load_state_dict`` with ``strict=True``)."""
    device = next(iter(model.state_dict().values())).device
    model.load_state_dict(params_from_numpy(tree, device=device), strict=True)
