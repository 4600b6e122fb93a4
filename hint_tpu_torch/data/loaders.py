"""Data pipelines: npy caching and device-resident tensors (port of
``hint_tpu/data/loaders.py``).

The full train/test arrays are uploaded to the device once; per-epoch
shuffling is a permutation gather there and batches are static slices, so
the epoch loop moves nothing between host and device.

* ``prepare_toy_data`` caches generated (x, y) under
  ``{cache_dir}/{name}_{x,y}_{train,test}.npy`` and regenerates when a file
  is missing or short (data.py:466-489 of the reference), from the native
  C++ generator (``data/native.py``) or the numpy one;
* ``prepare_uci_data`` dispatches to Power/Gas/Miniboone by name; the test
  set is one full-size batch with dummy zero labels (data.py:493-508).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

Arrays = Tuple[np.ndarray, Optional[np.ndarray]]


def prepare_toy_data(
    model, n_train: int, n_test: int, cache_dir: str = "data", engine: str = "auto"
) -> Tuple[Arrays, Arrays]:
    """Returns ((x_train, y_train), (x_test, y_test)) float32 numpy arrays.

    engine: "auto" (the native C++ generator when it builds, else numpy),
    "native" (raises ``NativeUnavailable`` when it cannot be built), or
    "numpy". The native generator is 15-65x faster per sample; it matches
    the numpy pipeline's geometry exactly and its distribution statistically
    (its RNG stream differs).
    """
    if engine not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown engine {engine!r}")
    os.makedirs(cache_dir, exist_ok=True)

    def generate(n: int, seed: int):
        if engine != "numpy":
            from hint_tpu_torch.data import native

            try:
                return native.sample_joint(model.name, n, seed=seed)
            except native.NativeUnavailable as e:
                if engine == "native":
                    raise
                print(f"native generator unavailable ({e!r}); numpy fallback (15-65x slower)")
        return model.sample_joint(n)

    def load_or_generate(split: str, n: int):
        fx = os.path.join(cache_dir, f"{model.name}_x_{split}.npy")
        fy = os.path.join(cache_dir, f"{model.name}_y_{split}.npy")
        try:
            x = np.load(fx)[:n, :]
            y = np.load(fy)[:n]
            if x.shape[0] < n:
                raise ValueError("cache too small")
        except (OSError, ValueError, EOFError):  # missing, short or truncated
            print(
                f'Not enough {split} data for model "{model.name}" found, '
                f"generating {n} new samples..."
            )
            x, y = generate(n, seed=0 if split == "train" else 1)
            np.save(fx, x)
            np.save(fy, y)
        return x.astype(np.float32), y.astype(np.float32)

    return load_or_generate("train", n_train), load_or_generate("test", n_test)


def prepare_uci_data(dataset_name: str = "power", root: str = ".") -> Tuple[Arrays, Arrays]:
    """Returns ((x_train, zeros), (x_test, zeros)) float32; the test set is
    one full batch (data.py:505-506)."""
    from hint_tpu_torch.data.uci import Gas, Miniboone, Power

    sets = {"power": Power, "gas": Gas, "miniboone": Miniboone}
    if dataset_name not in sets:
        raise ValueError("Dataset not known.")
    data = sets[dataset_name](root)
    x_tr = data.trn.astype(np.float32)
    x_te = data.tst.astype(np.float32)
    return (x_tr, np.zeros((len(x_tr), 1), np.float32)), (x_te, np.zeros((len(x_te), 1), np.float32))


def to_device(arrays: Arrays, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Upload (x, y) once to the named torch device."""
    x, y = arrays
    return (
        torch.as_tensor(x, device=device),
        torch.as_tensor(y, device=device) if y is not None else None,
    )
