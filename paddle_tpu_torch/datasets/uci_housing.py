"""UCI housing reader creators (parity: paddle/dataset/uci_housing.py —
13 normalized features, float target)."""

import os

import numpy as np

from . import common

FEATURE_NUM = 13


def _data(seed):
    path = common.cache_path("uci_housing", "housing.data")
    if os.path.exists(path):
        raw = np.loadtxt(path).astype("float32")
        xs, ys = raw[:, :-1], raw[:, -1:]
        xs = (xs - xs.mean(0)) / (xs.std(0) + 1e-6)
    else:
        common.warn_synthetic("uci_housing")
        rng = np.random.RandomState(seed)
        xs = rng.randn(506, FEATURE_NUM).astype("float32")
        w = rng.randn(FEATURE_NUM, 1).astype("float32")
        ys = (xs @ w + 0.1 * rng.randn(506, 1)).astype("float32")
    return xs, ys


def train():
    xs, ys = _data(13)
    n = int(len(xs) * 0.8)
    return common.reader_from_arrays(xs[:n], ys[:n])


def test():
    xs, ys = _data(13)
    n = int(len(xs) * 0.8)
    return common.reader_from_arrays(xs[n:], ys[n:])
