"""NLTK movie_reviews sentiment reader creators (parity:
paddle/dataset/sentiment.py — get_word_dict(), train()/test() yield
(word-id list, 0/1); 1600 train / 400 test interleaved neg/pos).

Cache layout probed: DATA_HOME/corpora/movie_reviews/{neg,pos}/*.txt
(the nltk download layout, unzipped).

A copy of the JAX package's ``datasets/sentiment.py``, which imports no JAX.
"""

import glob
import os
import re

import numpy as np

from . import common

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

_TOK = re.compile(r"[a-z0-9']+")


def _corpus_dir():
    p = common.cache_path("corpora", "movie_reviews")
    return p if os.path.isdir(p) else None


def _docs():
    """Yield (tokens, label) interleaved neg/pos (ref sort_files order)."""
    base = _corpus_dir()
    if base is not None:
        neg = sorted(glob.glob(os.path.join(base, "neg", "*.txt")))
        pos = sorted(glob.glob(os.path.join(base, "pos", "*.txt")))
        for nf, pf in zip(neg, pos):
            for path, label in ((nf, 0), (pf, 1)):
                with open(path, encoding="utf-8", errors="replace") as f:
                    yield _TOK.findall(f.read().lower()), label
        return
    common.warn_synthetic("sentiment")
    rng = np.random.RandomState(23)
    vocab = ["word%d" % i for i in range(800)]
    for _ in range(NUM_TOTAL_INSTANCES // 2):
        for label in (0, 1):
            length = int(rng.randint(20, 120))
            lo, hi = (0, 500) if label == 0 else (300, 800)
            ids = rng.randint(lo, hi, (length,))
            yield [vocab[i] for i in ids], label


_word_dict = None


def get_word_dict():
    """[(word, id)] sorted by frequency (most frequent first)."""
    global _word_dict
    if _word_dict is None:
        freq = {}
        for toks, _ in _docs():
            for w in toks:
                freq[w] = freq.get(w, 0) + 1
        ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        _word_dict = [(w, i) for i, (w, _) in enumerate(ranked)]
    return _word_dict


def _data():
    ids = dict(get_word_dict())
    return [([ids[w] for w in toks], label) for toks, label in _docs()]


def _reader_creator(lo, hi):
    def reader():
        for sample in _data()[lo:hi]:
            yield sample

    return reader


def train():
    return _reader_creator(0, NUM_TRAINING_INSTANCES)


def test():
    return _reader_creator(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES)
