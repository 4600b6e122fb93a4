"""ctypes bindings for the native (C++) toy-data generator (port of
``hint_tpu/data/native.py``).

Builds ``hint_tpu_torch/native/libhintgeom.so`` from the package's own copy
of ``geometry.cc`` on first use (g++ and make; plain C ABI). A file lock
keeps processes that load it at the same time from building it over each
other. The native samplers draw the same distributions as the numpy pipeline
(``hint_tpu_torch/data/fourier.py``) from their own RNG stream
(std::mt19937_64); the geometry entry points match the numpy geometry to
~1e-9 on identical inputs.

Use ``engine="native"`` in ``prepare_toy_data`` and
``hint_tpu_torch.evaluation.abc.prepare_samples``, or call the samplers:

    from hint_tpu_torch.data import native
    x, y = native.sample_joint("plus-shape", 1_000_000, seed=0)
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "native"))
_SRC = os.path.join(_NATIVE_DIR, "geometry.cc")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhintgeom.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    return not os.path.exists(_LIB_PATH) or os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)


def _build() -> None:
    """``make`` under an exclusive file lock, so that one process builds and
    the others wait for its library."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            subprocess.run(["make", "-s", "libhintgeom.so"], cwd=_NATIVE_DIR, check=True, capture_output=True)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            try:
                _build()
            except (OSError, subprocess.CalledProcessError) as e:  # no compiler, build failure
                detail = getattr(e, "stderr", b"") or b""
                raise NativeUnavailable(f"could not build libhintgeom.so: {e} {detail.decode(errors='replace')}") from e
        lib = ctypes.CDLL(_LIB_PATH)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.hint_lens_ring.restype = ctypes.c_int
        lib.hint_lens_ring.argtypes = [ctypes.c_double] * 6 + [dp, ctypes.c_int]
        lib.hint_plus_outline.restype = ctypes.c_int
        lib.hint_plus_outline.argtypes = [ctypes.c_double] * 6 + [dp, ctypes.c_int]
        lib.hint_lens_batch.restype = None
        lib.hint_lens_batch.argtypes = [ctypes.c_uint64, ctypes.c_int, dp, dp]
        lib.hint_plus_batch.restype = None
        lib.hint_plus_batch.argtypes = [ctypes.c_uint64, ctypes.c_int, dp, dp]
        lib.hint_plus_conditional_batch.restype = ctypes.c_int
        lib.hint_plus_conditional_batch.argtypes = [
            ctypes.c_uint64, ctypes.c_int, dp, ctypes.c_double, ctypes.c_long, dp, dp,
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lens_ring(x0, y0, r0, x1, y1, r1, cap: int = 512) -> np.ndarray:
    lib = load()
    out = np.empty((cap, 2), np.float64)
    n = lib.hint_lens_ring(x0, y0, r0, x1, y1, r1, _dp(out), cap)
    return out[:n]


def plus_outline(xlength, ylength, xwidth, ywidth, xshift, yshift, cap: int = 64) -> np.ndarray:
    lib = load()
    out = np.empty((cap, 2), np.float64)
    n = lib.hint_plus_outline(xlength, ylength, xwidth, ywidth, xshift, yshift, _dp(out), cap)
    return out[:n]


def sample_plus_conditional(
    target, n: int, tol: float = 0.05, seed: int = 0, max_trials: int = 200_000_000
) -> Tuple[np.ndarray, np.ndarray]:
    """Target-conditioned plus-shape rejection sampling
    (rejection_sampling.py:113-127 of the reference): returns (x (m,100),
    y (m,4)) with m <= n accepted samples whose labels are within ``tol`` of
    ``target``."""
    lib = load()
    t = np.ascontiguousarray(np.asarray(target, np.float64).reshape(4))
    x = np.empty((n, 100), np.float64)
    y = np.empty((n, 4), np.float64)
    got = lib.hint_plus_conditional_batch(seed, n, _dp(t), tol, max_trials, _dp(x), _dp(y))
    return x[:got].astype(np.float32), y[:got].astype(np.float32)


def sample_joint(model_name: str, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) batch from the native generator. model_name: 'plus-shape' or
    'lens-shape'/'lens-shape1'."""
    lib = load()
    if model_name.startswith("lens-shape"):
        x = np.empty((n, 20), np.float64)
        y = np.empty((n, 2), np.float64)
        lib.hint_lens_batch(seed, n, _dp(x), _dp(y))
    elif model_name == "plus-shape":
        x = np.empty((n, 100), np.float64)
        y = np.empty((n, 4), np.float64)
        lib.hint_plus_batch(seed, n, _dp(x), _dp(y))
    else:
        raise ValueError(f"unknown data model {model_name!r}")
    return x.astype(np.float32), y.astype(np.float32)
