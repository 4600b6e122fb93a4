"""Scalar evaluation metrics (a copy of ``hint_tpu/evaluation/metrics.py``;
line numbers are the reference's).

* ``uci_log_likelihood`` — LL = −loss − (d/2)·ln 2π
  (run_uci_experiments.py:71-72);
* ``per_dim_likelihood`` — −loss / d (run_experiments.py:210);
* ``correlation_mse`` — nanmean((corrcoef(samples) − corr_true)²)
  (run_experiments.py:211-221);
* ``mean_target_distance`` — mean ℓ2 between forward_process(samples) and the
  target observation (rejection_sampling.py:99-103).
"""

from __future__ import annotations

import numpy as np


def uci_log_likelihood(test_loss: float, n_dims: int) -> float:
    return -test_loss - (n_dims / 2.0) * np.log(2.0 * np.pi)


def per_dim_likelihood(test_loss: float, n_dims: int) -> float:
    return -test_loss / n_dims


def correlation_mse(samples: np.ndarray, corr_true: np.ndarray) -> float:
    corr = np.corrcoef(samples.T)
    return float(np.nanmean(np.square(corr - corr_true)))


def mean_target_distance(data_model, y_target: np.ndarray, x: np.ndarray) -> float:
    y = data_model.forward_process(np.asarray(x))
    d = np.sqrt(np.sum((y - np.asarray(y_target)[None, :]) ** 2, axis=1))
    return float(d.mean())
