"""WMT14 en-fr reader creators (parity: paddle/dataset/wmt14.py —
train/test(dict_size) yield (src_ids, trg_ids, trg_ids_next); get_dict.

Archive layout probed: DATA_HOME/wmt14/wmt14.tgz containing *src.dict /
*trg.dict members (one word per line, <s>/<e>/<unk> first) and train/test
members, each line 'src \\t trg'; sequences longer than 80 are dropped like
the reference.

A copy of the JAX package's ``datasets/wmt14.py``, which imports no JAX.
"""

import os
import tarfile

import numpy as np

from . import common

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_SYN_VOCAB = 150


def _archive():
    p = common.cache_path("wmt14", "wmt14.tgz")
    return p if os.path.exists(p) else None


def _read_dicts(dict_size):
    path = _archive()
    if path is None:
        common.warn_synthetic("wmt14")
        base = [START, END, UNK]
        src = {w: i for i, w in enumerate(
            base + ["en%d" % i for i in range(_SYN_VOCAB)][:dict_size - 3])}
        trg = {w: i for i, w in enumerate(
            base + ["fr%d" % i for i in range(_SYN_VOCAB)][:dict_size - 3])}
        return src, trg

    def to_dict(f, size):
        d = {}
        for i, line in enumerate(f):
            if i >= size:
                break
            d[line.decode("utf-8", "replace").strip()] = i
        return d

    with tarfile.open(path) as tf:
        src_name = [m.name for m in tf if m.name.endswith("src.dict")]
        trg_name = [m.name for m in tf if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1, (src_name, trg_name)
        return (to_dict(tf.extractfile(src_name[0]), dict_size),
                to_dict(tf.extractfile(trg_name[0]), dict_size))


def _pairs(which):
    path = _archive()
    if path is not None:
        with tarfile.open(path) as tf:
            for m in tf:
                if m.name.endswith(which):
                    for raw in tf.extractfile(m):
                        parts = raw.decode("utf-8", "replace").strip().split("\t")
                        if len(parts) == 2:
                            yield parts[0].split(), parts[1].split()
        return
    rng = np.random.RandomState(29 if which == "train" else 31)
    for _ in range(400 if which == "train" else 80):
        length = int(rng.randint(3, 12))
        ids = rng.randint(0, _SYN_VOCAB, (length,))
        yield ["en%d" % i for i in ids], ["fr%d" % i for i in ids]


def _reader_creator(which, dict_size):
    def reader():
        src_dict, trg_dict = _read_dicts(dict_size)
        for src_words, trg_words in _pairs(which):
            src_ids = [src_dict.get(w, UNK_IDX)
                       for w in [START] + src_words + [END]]
            trg = [trg_dict.get(w, UNK_IDX) for w in trg_words]
            if len(src_ids) > 80 or len(trg) > 80:
                continue
            yield src_ids, [trg_dict[START]] + trg, trg + [trg_dict[END]]

    return reader


def train(dict_size):
    return _reader_creator("train", dict_size)


def test(dict_size):
    return _reader_creator("test", dict_size)


def get_dict(dict_size, reverse=True):
    src, trg = _read_dicts(dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg
