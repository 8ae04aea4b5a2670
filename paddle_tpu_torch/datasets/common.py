"""Shared loader plumbing (from ``paddle_tpu/datasets/common.py``: the cache
probe and the synthetic fallback notice; its array helpers come with the
loaders that use them).

``DATA_HOME`` is ``$PADDLE_TPU_DATA_HOME``, else ``build/dataset`` inside
this checkout (ignored by git): the port reads nothing outside its
checkout unless told to.  Place a corpus there in the reference's cache
layout, e.g. ``build/dataset/wmt16/wmt16.tar.gz``."""

import os
import warnings
from pathlib import Path

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
