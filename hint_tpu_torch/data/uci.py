"""UCI density-estimation datasets: POWER, GAS, MINIBOONE (a copy of
``hint_tpu/data/uci.py``: numpy only, but reachable there only through a
package that imports JAX).

Byte-parity re-implementation of the reference preprocessing (data.py:283-462
of the reference, itself adapted from github.com/LukasRinder/normalizing-flows).
Every step is kept exactly:

* POWER (d=6): seeded shuffle ``RandomState(42)``, drop columns 3 then 1,
  per-column dequantization noise (gap 0.001, voltage 0.01, 3×U(0,1), time 0),
  90/10 then 90/10 split from the end, z-score by train+val moments
  (data.py:302-350);
* GAS (d=8): drop Meth/Eth/Time, iteratively drop the FIRST column whose
  pairwise *signed* correlation count exceeds 1 at threshold +0.98 (anti-
  correlated columns are never pruned), z-score, then 81/9/10 split
  (data.py:353-418). It reads a pandas pickle, so pandas is imported by
  ``Gas.load_data`` alone;
* MINIBOONE (d=42): 80/10/10 split, z-score by train+val moments, and the
  reference drops the last column *after* normalization via ``trn.x[:, 0:-1]``
  (data.py:428-430).

Data files are expected under ``<root>/uci_data/{power/data.npy,
gas/ethylene_CO.pickle, miniboone/data.npy}`` — the reference's layout
(data.py:304,358,426). ``root`` is configurable (default ``./``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]


class Power:
    name = "power"
    n_parameters = 6

    def __init__(self, root: str = "."):
        self.trn, self.val, self.tst = self.load_data_normalised(root)
        self.n_dims = self.trn.shape[1]

    @classmethod
    def load_data(cls, root: str = ".") -> np.ndarray:
        return np.load(os.path.join(root, "uci_data/power/data.npy"))

    @classmethod
    def load_data_split_with_noise(cls, root: str = ".") -> Split:
        rng = np.random.RandomState(42)
        data = cls.load_data(root)
        rng.shuffle(data)
        n = data.shape[0]
        data = np.delete(data, 3, axis=1)
        data = np.delete(data, 1, axis=1)
        voltage_noise = 0.01 * rng.rand(n, 1)
        gap_noise = 0.001 * rng.rand(n, 1)
        sm_noise = rng.rand(n, 3)
        time_noise = np.zeros((n, 1))
        noise = np.hstack((gap_noise, voltage_noise, sm_noise, time_noise))
        data = data + noise

        n_test = int(0.1 * data.shape[0])
        data_test = data[-n_test:]
        data = data[0:-n_test]
        n_validate = int(0.1 * data.shape[0])
        data_validate = data[-n_validate:]
        data_train = data[0:-n_validate]
        return data_train, data_validate, data_test

    @classmethod
    def load_data_normalised(cls, root: str = ".") -> Split:
        tr, va, te = cls.load_data_split_with_noise(root)
        data = np.vstack((tr, va))
        mu, s = data.mean(axis=0), data.std(axis=0)
        return (tr - mu) / s, (va - mu) / s, (te - mu) / s

    @classmethod
    def mean_and_std(cls, root: str = "."):
        tr, va, _ = cls.load_data_split_with_noise(root)
        data = np.vstack((tr, va))
        return data.mean(axis=0), data.std(axis=0)


class Gas:
    name = "gas"
    n_parameters = 8

    def __init__(self, root: str = "."):
        self.trn, self.val, self.tst = self.load_data_and_clean_and_split(
            os.path.join(root, "uci_data/gas/ethylene_CO.pickle")
        )
        self.n_dims = self.trn.shape[1]

    @classmethod
    def load_data(cls, file: str):
        import pandas as pd

        data = pd.read_pickle(file)
        data.drop("Meth", axis=1, inplace=True)
        data.drop("Eth", axis=1, inplace=True)
        data.drop("Time", axis=1, inplace=True)
        return data

    @classmethod
    def get_correlation_numbers(cls, data):
        c = data.corr()
        a = c > 0.98
        return a.values.sum(axis=1)

    @classmethod
    def load_data_and_clean(cls, file: str):
        data = cls.load_data(file)
        b = cls.get_correlation_numbers(data)
        while np.any(b > 1):
            col_to_remove = np.where(b > 1)[0][0]
            col_name = data.columns[col_to_remove]
            data.drop(col_name, axis=1, inplace=True)
            b = cls.get_correlation_numbers(data)
        data = (data - data.mean()) / data.std()
        return data

    @classmethod
    def load_data_and_clean_and_split(cls, file: str) -> Split:
        data = cls.load_data_and_clean(file).values
        n_test = int(0.1 * data.shape[0])
        data_test = data[-n_test:]
        data_train = data[0:-n_test]
        n_validate = int(0.1 * data_train.shape[0])
        data_validate = data_train[-n_validate:]
        data_train = data_train[0:-n_validate]
        return data_train, data_validate, data_test

    @classmethod
    def mean_and_std(cls, file: str):
        data = cls.load_data(file)
        b = cls.get_correlation_numbers(data)
        while np.any(b > 1):
            col_to_remove = np.where(b > 1)[0][0]
            col_name = data.columns[col_to_remove]
            data.drop(col_name, axis=1, inplace=True)
            b = cls.get_correlation_numbers(data)
        return data.mean(), data.std()


class Miniboone:
    name = "miniboone"
    n_parameters = 42

    def __init__(self, root: str = "."):
        trn, val, tst = self.load_data_normalised(os.path.join(root, "uci_data/miniboone/data.npy"))
        # last column dropped after normalization (data.py:428-430)
        self.trn, self.val, self.tst = trn[:, 0:-1], val[:, 0:-1], tst[:, 0:-1]
        self.n_dims = self.trn.shape[1]

    @classmethod
    def load_data(cls, root_path: str) -> Split:
        data = np.load(root_path)
        n_test = int(0.1 * data.shape[0])
        data_test = data[-n_test:]
        data = data[0:-n_test]
        n_validate = int(0.1 * data.shape[0])
        data_validate = data[-n_validate:]
        data_train = data[0:-n_validate]
        return data_train, data_validate, data_test

    @classmethod
    def load_data_normalised(cls, root_path: str) -> Split:
        tr, va, te = cls.load_data(root_path)
        data = np.vstack((tr, va))
        mu, s = data.mean(axis=0), data.std(axis=0)
        return (tr - mu) / s, (va - mu) / s, (te - mu) / s

    @classmethod
    def mean_and_std(cls, root_path: str):
        tr, va, _ = cls.load_data(root_path)
        data = np.vstack((tr, va))
        return data.mean(axis=0), data.std(axis=0)
