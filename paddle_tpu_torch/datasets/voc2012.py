"""Pascal VOC2012 segmentation reader creators (parity:
paddle/dataset/voc2012.py — train/test/val() yield (HWC image array,
HW label-mask array)).

Cache layout probed: DATA_HOME/voc2012/VOCtrainval_11-May-2012.tar.  Real
parsing needs PIL (gated); the synthetic fallback serves 32x32 images with
rectangle masks over 21 classes.

A copy of the JAX package's ``datasets/voc2012.py``, which imports no JAX.
"""

import io as _io
import os
import tarfile

import numpy as np

from . import common

SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
NUM_CLASSES = 21


def _archive():
    p = common.cache_path("voc2012", "VOCtrainval_11-May-2012.tar")
    if not os.path.exists(p):
        return None
    try:
        from PIL import Image  # noqa: F401
        return p
    except ImportError:
        return None


def _real_reader(sub_name):
    from PIL import Image

    path = _archive()

    def reader():
        with tarfile.open(path) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for line in tf.extractfile(members[SET_FILE.format(sub_name)]):
                name = line.decode().strip()
                if not name:
                    continue
                img = Image.open(_io.BytesIO(
                    tf.extractfile(members[DATA_FILE.format(name)]).read()))
                lab = Image.open(_io.BytesIO(
                    tf.extractfile(members[LABEL_FILE.format(name)]).read()))
                yield np.array(img), np.array(lab)

    return reader


def _syn_reader(sub_name):
    common.warn_synthetic("voc2012")
    seed = {"trainval": 59, "train": 61, "val": 67}[sub_name]
    n = {"trainval": 256, "train": 192, "val": 64}[sub_name]

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = (rng.rand(32, 32, 3) * 255).astype("u1")
            mask = np.zeros((32, 32), "u1")
            cls = int(rng.randint(1, NUM_CLASSES))
            r, c = int(rng.randint(0, 20)), int(rng.randint(0, 20))
            mask[r:r + 12, c:c + 12] = cls
            img[r:r + 12, c:c + 12] = (cls * 12) % 255
            yield img, mask

    return reader


def _creator(sub_name):
    return (_real_reader(sub_name) if _archive() is not None
            else _syn_reader(sub_name))


def train():
    return _creator("trainval")


def test():
    return _creator("train")


def val():
    return _creator("val")
