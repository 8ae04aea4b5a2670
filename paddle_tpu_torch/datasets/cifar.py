"""CIFAR reader creators (parity: paddle/dataset/cifar.py — train10/test10
and train100/test100 yield (3072-float in [0,1] CHW, int label))."""

import os
import pickle
import tarfile

import numpy as np

from . import common


def _load_tar(path, keys):
    xs, ys = [], []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            if any(k in m.name for k in keys):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                xs.append(np.asarray(d[b"data"], "float32") / 255.0)
                lab = d.get(b"labels", d.get(b"fine_labels"))
                ys.append(np.asarray(lab, "int64"))
    return np.concatenate(xs), np.concatenate(ys)


def _reader(tarname, keys, num_classes, seed):
    path = common.cache_path("cifar", tarname)
    if os.path.exists(path):
        xs, ys = _load_tar(path, keys)
    else:
        common.warn_synthetic("cifar")
        xs, ys = common.synthetic_classification(
            seed=seed, n=2048, feat_shape=(3072,), num_classes=num_classes)
    return common.reader_from_arrays(xs, ys)


def train10():
    return _reader("cifar-10-python.tar.gz", ["data_batch"], 10, 10)


def test10():
    return _reader("cifar-10-python.tar.gz", ["test_batch"], 10, 110)


def train100():
    return _reader("cifar-100-python.tar.gz", ["train"], 100, 100)


def test100():
    return _reader("cifar-100-python.tar.gz", ["test"], 100, 1100)
