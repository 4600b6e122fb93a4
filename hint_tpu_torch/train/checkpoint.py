"""Weights-only npz checkpoints in the JAX package's key layout.

``hint_tpu.train.checkpoint`` writes every leaf under ``prefix + keystr``:
``params['b0']['L3']['w1']`` for a parameter, with ``mu[...]``, ``nu[...]``,
``opt_step`` and ``epoch`` beside them in a full training state. This module
reads the ``params`` entries of either file and writes weights-only files
that the JAX package's ``load_params_npz`` reads.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Union

import numpy as np
from torch import nn

from hint_tpu_torch.convert import params_to_numpy

_KEY = re.compile(r"\['([^']*)'\]")


def _keystr(path) -> str:
    """JAX's ``keystr`` of a path of dict keys: ``['b0']['L3']['w1']``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree: Mapping[str, Any], prefix: str, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix, path + (k,))
        else:
            yield prefix + _keystr(path + (k,)), np.asarray(v)


def save_params_npz(path: str, params: Union[nn.Module, Mapping[str, Any]]) -> None:
    """Write a model's (or a nested tree's) parameters as ``params[...]``."""
    tree = params_to_numpy(params) if isinstance(params, nn.Module) else params
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **dict(_flatten(tree, "params")))


def load_params_npz(path: str) -> Dict[str, Any]:
    """The ``params[...]`` entries of a weights-only or full-state npz, as
    a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as arrays:
        for key in arrays.files:
            if not key.startswith("params["):
                continue
            parts = _KEY.findall(key[len("params") :])
            if _keystr(parts) != key[len("params") :]:
                raise ValueError(f"unreadable checkpoint key {key!r}")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arrays[key]
    if not tree:
        raise ValueError(f"{path}: no params[...] entries")
    return tree
