"""Oxford 102 flowers reader creators (parity: paddle/dataset/flowers.py —
train/test/valid() yield (CHW float image, 0-based label)).

Cache layout probed: DATA_HOME/flowers/{102flowers.tgz, imagelabels.mat,
setid.mat}.  Real parsing needs PIL + scipy (gated); otherwise the
deterministic synthetic fallback serves 3x32x32 images whose class is
recoverable from the dominant color patch.

A copy of the JAX package's ``datasets/flowers.py``, which imports no JAX.
"""

import os
import tarfile

import numpy as np

from . import common

NUM_CLASSES = 102


def _have_real():
    base = common.cache_path("flowers")
    ok = all(os.path.exists(os.path.join(base, f)) for f in
             ("102flowers.tgz", "imagelabels.mat", "setid.mat"))
    if not ok:
        return False
    try:
        import scipy.io  # noqa: F401
        from PIL import Image  # noqa: F401
        return True
    except ImportError:
        return False


def _real_reader(split):
    import io as _io

    import scipy.io
    from PIL import Image

    base = common.cache_path("flowers")
    labels = scipy.io.loadmat(os.path.join(base, "imagelabels.mat"))["labels"][0]
    setid = scipy.io.loadmat(os.path.join(base, "setid.mat"))
    ids = {"train": setid["trnid"], "test": setid["tstid"],
           "valid": setid["valid"]}[split][0]

    def reader():
        with tarfile.open(os.path.join(base, "102flowers.tgz")) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for i in ids:
                name = "jpg/image_%05d.jpg" % i
                data = tf.extractfile(members[name]).read()
                img = Image.open(_io.BytesIO(data)).convert("RGB")
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                yield arr, int(labels[i - 1]) - 1

    return reader


def _syn_reader(split):
    common.warn_synthetic("flowers")
    seed = {"train": 43, "test": 47, "valid": 53}[split]
    n = {"train": 512, "test": 128, "valid": 128}[split]

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, NUM_CLASSES))
            img = rng.rand(3, 32, 32).astype("f4") * 0.3
            r, c = divmod(label % 64, 8)
            img[label % 3, r * 4:r * 4 + 4, c * 4:c * 4 + 4] += 0.7
            yield img, label

    return reader


def _creator(split):
    return _real_reader(split) if _have_real() else _syn_reader(split)


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _creator("train")


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _creator("test")


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _creator("valid")
