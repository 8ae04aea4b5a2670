"""MNIST reader creators (parity: paddle/dataset/mnist.py — train()/test()
yield (784-float normalized to [-1,1], int label)).  A copy of the JAX
package's ``datasets/mnist.py``: the idx files under
``common.DATA_HOME/mnist`` when they are there, else the deterministic
synthetic stand-in."""

import gzip
import os
import struct

import numpy as np

from . import common

TRAIN_N, TEST_N = 60000, 10000


def _load_idx(img_path, lab_path):
    with gzip.open(lab_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int64")
    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    imgs = imgs.astype("float32") / 255.0 * 2.0 - 1.0
    return imgs, labels


def _reader(split, n):
    img = common.cache_path("mnist", "%s-images-idx3-ubyte.gz" % split)
    lab = common.cache_path("mnist", "%s-labels-idx1-ubyte.gz" % split)
    if os.path.exists(img) and os.path.exists(lab):
        xs, ys = _load_idx(img, lab)
    else:
        common.warn_synthetic("mnist")
        xs, ys = common.synthetic_classification(
            seed=90 if split.startswith("t10k") else 9,
            n=min(n, 4096), feat_shape=(784,), num_classes=10)
    return common.reader_from_arrays(xs, ys)


def train():
    return _reader("train", TRAIN_N)


def test():
    return _reader("t10k", TEST_N)
