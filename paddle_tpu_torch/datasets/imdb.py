"""IMDB sentiment reader creators (parity: paddle/dataset/imdb.py —
build_dict(pattern, cutoff), word_dict(), train/test(word_idx) yield
(word-id list, 0/1 label) parsed from aclImdb_v1.tar.gz)."""

import os
import re
import string
import tarfile

import numpy as np

from . import common

VOCAB = 5147 + 2   # the reference's cutoff-150 vocab size + <unk>/<pad>

_TOK = re.compile(r"[a-z0-9]+")


def _archive():
    p = common.cache_path("imdb", "aclImdb_v1.tar.gz")
    return p if os.path.exists(p) else None


def tokenize(text):
    """Lowercase, strip punctuation, split (ref imdb.py tokenize)."""
    return _TOK.findall(text.lower().translate(
        str.maketrans("", "", string.punctuation)))


def _docs(pattern):
    """Yield token lists for tar members matching `pattern` (compiled re)."""
    with tarfile.open(_archive()) as tf:
        for member in tf.getmembers():
            if pattern.match(member.name):
                data = tf.extractfile(member).read().decode(
                    "utf-8", "replace")
                yield tokenize(data)


def build_dict(pattern, cutoff=150):
    """Word -> id over matching docs, keeping words with freq > cutoff;
    '<unk>' last (ref imdb.py build_dict)."""
    freq = {}
    for toks in _docs(pattern):
        for w in toks:
            freq[w] = freq.get(w, 0) + 1
    freq.pop("<unk>", None)
    items = [kv for kv in freq.items() if kv[1] > cutoff]
    items.sort(key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


_cached_dict = None


def word_dict():
    global _cached_dict
    if _cached_dict is not None:
        return _cached_dict
    if _archive() is not None:
        _cached_dict = build_dict(
            re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
            150)
    else:
        _cached_dict = {("w%d" % i): i for i in range(VOCAB - 1)}
        _cached_dict["<unk>"] = VOCAB - 1
    return _cached_dict


def _real_reader(word_idx, which):
    pos = re.compile(r"aclImdb/%s/pos/.*\.txt$" % which)
    neg = re.compile(r"aclImdb/%s/neg/.*\.txt$" % which)
    unk = word_idx["<unk>"]

    def reader():
        # reference label convention (imdb.py reader_creator): pos=0, neg=1
        for pattern, label in ((pos, 0), (neg, 1)):
            for toks in _docs(pattern):
                yield [word_idx.get(w, unk) for w in toks], label

    return reader


def _syn_reader(seed, n=1024):
    common.warn_synthetic("imdb")
    # positive docs drawn from the low-id band, negative from the high band,
    # with overlap — learnable but not trivial.  The RandomState is created
    # inside reader() so every epoch replays the same fixed corpus.
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            lo, hi = (0, VOCAB // 2 + 500) if label else (VOCAB // 2 - 500,
                                                          VOCAB)
            length = int(rng.randint(8, 64))
            yield rng.randint(lo, hi, (length,)).astype("int64").tolist(), label

    return reader


def train(word_idx=None):
    if _archive() is not None:
        return _real_reader(word_idx or word_dict(), "train")
    return _syn_reader(7)


def test(word_idx=None):
    if _archive() is not None:
        return _real_reader(word_idx or word_dict(), "test")
    return _syn_reader(77)
