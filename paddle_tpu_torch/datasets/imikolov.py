"""PTB language-model reader creators (parity: paddle/dataset/imikolov.py —
build_dict(min_word_freq), train/test(word_idx, n, data_type) yielding
n-grams or full sequences from simple-examples.tgz)."""

import collections
import os
import tarfile

import numpy as np

from . import common

TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
TEST_FILE = "./simple-examples/data/ptb.valid.txt"


class DataType:
    NGRAM = 1
    SEQ = 2


def _archive():
    p = common.cache_path("imikolov", "simple-examples.tgz")
    return p if os.path.exists(p) else None


def _lines(member):
    path = _archive()
    if path is not None:
        with tarfile.open(path) as tf:
            # accept both './simple-examples/...' and 'simple-examples/...'
            names = {m.name.lstrip("./"): m.name for m in tf.getmembers()}
            f = tf.extractfile(names.get(member.lstrip("./"), member))
            for raw in f:
                yield raw.decode("utf-8", "replace")
        return
    common.warn_synthetic("imikolov")
    # deterministic synthetic corpus over a zipf-ish vocab of common tokens
    rng = np.random.RandomState(11 if "train" in member else 13)
    vocab = ["tok%d" % i for i in range(200)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    for _ in range(600 if "train" in member else 120):
        length = int(rng.randint(4, 18))
        yield " ".join(rng.choice(vocab, size=length, p=probs)) + "\n"


def build_dict(min_word_freq=50):
    """Word -> id over train+valid, sorted by (-freq, word); '<unk>' last."""
    freq = collections.defaultdict(int)
    for member in (TRAIN_FILE, TEST_FILE):
        for line in _lines(member):
            for w in line.strip().split():
                freq[w] += 1
            freq["<s>"] += 1
            freq["<e>"] += 1
    freq.pop("<unk>", None)
    if _archive() is None:
        min_word_freq = min(min_word_freq, 1)   # tiny synthetic corpus
    items = [kv for kv in freq.items() if kv[1] > min_word_freq]
    items.sort(key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _reader_creator(member, word_idx, n, data_type):
    def reader():
        unk = word_idx["<unk>"]
        for line in _lines(member):
            if data_type == DataType.NGRAM:
                assert n > -1, "Invalid gram length"
                toks = ["<s>"] + line.strip().split() + ["<e>"]
                if len(toks) >= n:
                    ids = [word_idx.get(w, unk) for w in toks]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            elif data_type == DataType.SEQ:
                toks = line.strip().split()
                ids = [word_idx.get(w, unk) for w in toks]
                src = [word_idx["<s>"]] + ids
                trg = ids + [word_idx["<e>"]]
                yield src, trg
            else:
                raise ValueError("Unknown data type: %r" % (data_type,))

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator(TRAIN_FILE, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator(TEST_FILE, word_idx, n, data_type)
