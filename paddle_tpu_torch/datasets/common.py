"""Shared loader plumbing (from ``paddle_tpu/datasets/common.py``: the cache
probe, the synthetic fallback notice, and the array helpers MNIST uses).

``DATA_HOME`` is ``$PADDLE_TPU_DATA_HOME``, else ``build/dataset`` inside
this checkout (ignored by git): the port reads nothing outside its
checkout unless told to.  Place a corpus there in the reference's cache
layout, e.g. ``build/dataset/wmt16/wmt16.tar.gz``."""

import os
import warnings
from pathlib import Path

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    str(Path(__file__).resolve().parent.parent.parent / "build" / "dataset"))

_warned = set()


def cache_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def warn_synthetic(corpus):
    if corpus not in _warned:
        warnings.warn(
            "paddle_tpu_torch.datasets.%s: corpus not found under %s and "
            "this environment has no network egress — serving the "
            "deterministic SYNTHETIC stand-in (real shapes/dtypes/label "
            "ranges; not the real data)" % (corpus, DATA_HOME), stacklevel=3)
        _warned.add(corpus)


def reader_from_arrays(xs, ys):
    def reader():
        for x, y in zip(xs, ys):
            yield x, y

    return reader


def synthetic_classification(seed, n, feat_shape, num_classes,
                             dtype="float32"):
    """Linearly-separable-ish deterministic synthetic set: labels come from
    a fixed random projection so models can genuinely converge on it."""
    rng = np.random.RandomState(seed)
    d = int(np.prod(feat_shape))
    W = rng.randn(d, num_classes).astype("f8")
    xs = rng.uniform(-1, 1, (n, d))
    ys = np.argmax(xs @ W + 0.1 * rng.randn(n, num_classes), axis=1)
    return (xs.reshape((n,) + tuple(feat_shape)).astype(dtype),
            ys.astype("int64"))
