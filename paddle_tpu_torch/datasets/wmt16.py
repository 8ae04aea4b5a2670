"""WMT16 (Multi30K) en-de reader creators (copy of
``paddle_tpu/datasets/wmt16.py``; parity: paddle/dataset/wmt16.py —
train/test/validation(src_dict_size, trg_dict_size, src_lang) yielding
(src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> ids 0/1/2; get_dict),
and ``wmt16_batch``, the padded NMT batch ``bench.py``'s NMT line builds.

Archive layout probed under DATA_HOME: wmt16/wmt16.tar.gz containing members
wmt16/{train,val,test}, each line 'en-sentence \\t de-sentence'."""

import collections
import os
import tarfile

import numpy as np

from . import common

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"

_SYN_VOCAB = 200


def _archive():
    p = common.cache_path("wmt16", "wmt16.tar.gz")
    return p if os.path.exists(p) else None


def _pairs(member):
    """Yield (en, de) token-list pairs for 'train'/'val'/'test'."""
    path = _archive()
    if path is not None:
        with tarfile.open(path) as tf:
            for raw in tf.extractfile("wmt16/%s" % member):
                parts = raw.decode("utf-8", "replace").strip().split("\t")
                if len(parts) == 2:
                    yield parts[0].split(), parts[1].split()
        return
    common.warn_synthetic("wmt16")
    rng = np.random.RandomState({"train": 3, "val": 5, "test": 9}[member])
    n = {"train": 800, "val": 100, "test": 100}[member]
    for _ in range(n):
        length = int(rng.randint(3, 15))
        ids = rng.randint(0, _SYN_VOCAB, (length,))
        # 'translation' = same ids in the other language's token space
        yield (["en%d" % i for i in ids], ["de%d" % i for i in ids])


def _build_dict(dict_size, lang):
    freq = collections.defaultdict(int)
    for en, de in _pairs("train"):
        for w in (en if lang == "en" else de):
            freq[w] += 1
    words = [w for w, _ in sorted(freq.items(), key=lambda kv: -kv[1])]
    vocab = [START_MARK, END_MARK, UNK_MARK] + words[:max(dict_size - 3, 0)]
    return {w: i for i, w in enumerate(vocab)}


_dict_cache = {}


def get_dict(lang, dict_size, reverse=False):
    dict_size = min(dict_size,
                    TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS)
    key = (lang, dict_size)
    if key not in _dict_cache:
        _dict_cache[key] = _build_dict(dict_size, lang)
    d = _dict_cache[key]
    return {v: k for k, v in d.items()} if reverse else d


def _reader_creator(member, src_dict_size, trg_dict_size, src_lang):
    def reader():
        src_dict = get_dict(src_lang, src_dict_size)
        trg_lang = "de" if src_lang == "en" else "en"
        trg_dict = get_dict(trg_lang, trg_dict_size)
        start, end, unk = (src_dict[START_MARK], src_dict[END_MARK],
                           src_dict[UNK_MARK])
        for en, de in _pairs(member):
            src_words, trg_words = (en, de) if src_lang == "en" else (de, en)
            src_ids = ([start] + [src_dict.get(w, unk) for w in src_words]
                       + [end])
            trg = [trg_dict.get(w, unk) for w in trg_words]
            yield src_ids, [start] + trg, trg + [end]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("val", src_dict_size, trg_dict_size, src_lang)


def wmt16_batch(cfg, B, Ss, St, split="train"):
    """One padded batch of ``B`` pairs from the ``split`` reader (restarted
    when it runs out), as ``bench.py``'s NMT line builds it: ids cut to
    ``Ss`` / ``St`` and zero-padded, masks 1.0 over the kept ids.
    ``cfg``: anything with ``src_vocab`` and ``tgt_vocab``.  Returns numpy
    arrays: src_ids, tgt_in, tgt_out int32; src_mask, tgt_mask float32."""
    make = {"train": train, "test": test, "val": validation}[split]
    src = np.zeros((B, Ss), np.int32)
    tin = np.zeros((B, St), np.int32)
    tout = np.zeros((B, St), np.int32)
    smask = np.zeros((B, Ss), np.float32)
    tmask = np.zeros((B, St), np.float32)
    it = iter(make(cfg.src_vocab, cfg.tgt_vocab)())
    samples = []
    while len(samples) < B:
        try:
            samples.append(next(it))
        except StopIteration:
            it = iter(make(cfg.src_vocab, cfg.tgt_vocab)())
    for i, (s, t, tn) in enumerate(samples):
        s, t, tn = s[:Ss], t[:St], tn[:St]
        src[i, :len(s)] = s
        tin[i, :len(t)] = t
        tout[i, :len(tn)] = tn
        smask[i, :len(s)] = 1.0
        tmask[i, :len(tn)] = 1.0
    return {"src_ids": src, "src_mask": smask, "tgt_in": tin,
            "tgt_out": tout, "tgt_mask": tmask}


def fetch():
    """No network egress here; real data must be placed under DATA_HOME."""
    return _archive()
