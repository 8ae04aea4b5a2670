"""CoNLL-2005 SRL reader creators (parity: paddle/dataset/conll05.py —
test() yields the 9 slots the label_semantic_roles book test feeds:
word_idx, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_idx, mark, label_idx;
get_dict() -> (word_dict, verb_dict, label_dict)).

Cache layout probed under DATA_HOME/conll05st/: wordDict.txt, verbDict.txt,
targetDict.txt, conll05st-tests.tar.gz (with test.wsj words/props .gz
members, the reference's props bracket format)."""

import gzip
import os
import tarfile

import numpy as np

from . import common

UNK_IDX = 0

_WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"


def _have_real():
    base = common.cache_path("conll05st")
    return all(os.path.exists(os.path.join(base, f)) for f in
               ("wordDict.txt", "verbDict.txt", "targetDict.txt",
                "conll05st-tests.tar.gz"))


def load_dict(path):
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def load_label_dict(path):
    """targetDict lines carry B-/I- tags; rebuild the {B-,I-}xTAG + O map."""
    tags = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(("B-", "I-")):
                tags.add(line[2:])
    d = {}
    for tag in sorted(tags):
        d["B-" + tag] = len(d)
        d["I-" + tag] = len(d)
    d["O"] = len(d)
    return d


_SYN_TAGS = ("A0", "A1", "AM-TMP", "V")
_SYN_VOCAB = 150
_SYN_VERBS = 20


def _syn_dicts():
    word_dict = {"w%d" % i: i for i in range(_SYN_VOCAB)}
    word_dict["bos"] = len(word_dict)
    word_dict["eos"] = len(word_dict)
    verb_dict = {"v%d" % i: i for i in range(_SYN_VERBS)}
    label_dict = {}
    for tag in _SYN_TAGS:
        label_dict["B-" + tag] = len(label_dict)
        label_dict["I-" + tag] = len(label_dict)
    label_dict["O"] = len(label_dict)
    return word_dict, verb_dict, label_dict


def get_dict():
    if _have_real():
        base = common.cache_path("conll05st")
        return (load_dict(os.path.join(base, "wordDict.txt")),
                load_dict(os.path.join(base, "verbDict.txt")),
                load_label_dict(os.path.join(base, "targetDict.txt")))
    common.warn_synthetic("conll05")
    return _syn_dicts()


def get_embedding():
    """Path to the pretrained embedding file if cached, else None."""
    p = common.cache_path("conll05st", "emb")
    return p if os.path.exists(p) else None


def _parse_props_column(labels):
    """One predicate's bracket column -> BIO tag list ('(A0*', '*', '*)'…)."""
    out, cur, inside = [], "O", False
    for tok in labels:
        if tok.startswith("(") and tok.endswith("*)"):
            cur = tok[1:tok.find("*")]
            out.append("B-" + cur)
            inside = False
        elif tok.startswith("("):
            cur = tok[1:tok.find("*")]
            out.append("B-" + cur)
            inside = True
        elif tok.endswith(")"):
            out.append("I-" + cur if inside else "O")
            inside = False
        else:
            out.append("I-" + cur if inside else "O")
    return out


def _sentences_real():
    tar = common.cache_path("conll05st", "conll05st-tests.tar.gz")
    with tarfile.open(tar) as tf:
        with gzip.GzipFile(fileobj=tf.extractfile(_WORDS_MEMBER)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(_PROPS_MEMBER)) as pf:
            words, prop_rows = [], []
            for wline, pline in zip(wf, pf):
                w = wline.decode().strip()
                p = pline.decode().strip().split()
                if not p:                      # blank line = end of sentence
                    if words:
                        yield words, prop_rows
                    words, prop_rows = [], []
                    continue
                words.append(w)
                prop_rows.append(p)
            if words:
                yield words, prop_rows


def _samples_real():
    """Yield (sentence_words, predicate_word, bio_labels) per predicate."""
    for words, rows in _sentences_real():
        verbs = [r[0] for r in rows]           # column 0: verb or '-'
        ncols = len(rows[0]) - 1
        for col in range(ncols):
            column = [r[col + 1] for r in rows]
            bio = _parse_props_column(column)
            if "B-V" not in bio:
                continue
            vi = bio.index("B-V")
            if verbs[vi] == "-":
                continue
            yield words, verbs[vi], bio


def _samples_synthetic():
    rng = np.random.RandomState(17)
    for _ in range(300):
        n = int(rng.randint(5, 18))
        words = ["w%d" % i for i in rng.randint(0, _SYN_VOCAB, (n,))]
        vi = int(rng.randint(1, n - 1))
        verb = "v%d" % rng.randint(0, _SYN_VERBS)
        bio = ["O"] * n
        bio[vi] = "B-V"
        # A0 span before the verb, A1 span after (the canonical SRL shape)
        a0 = int(rng.randint(0, vi))
        bio[a0] = "B-A0"
        for i in range(a0 + 1, vi):
            bio[i] = "I-A0"
        if vi + 1 < n:
            bio[vi + 1] = "B-A1"
            for i in range(vi + 2, min(n, vi + 1 + int(rng.randint(1, 4)))):
                bio[i] = "I-A1"
        yield words, verb, bio


def test():
    word_dict, verb_dict, label_dict = get_dict()
    samples = _samples_real if _have_real() else _samples_synthetic

    def reader():
        for sentence, predicate, labels in samples():
            n = len(sentence)
            vi = labels.index("B-V")
            mark = [0] * n
            ctx = {}
            for off, name in ((-2, "n2"), (-1, "n1"), (0, "0"), (1, "p1"),
                              (2, "p2")):
                j = vi + off
                if 0 <= j < n:
                    mark[j] = 1
                    ctx[name] = sentence[j]
                else:
                    ctx[name] = "bos" if off < 0 else "eos"
            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctxs = [[word_dict.get(ctx[name], UNK_IDX)] * n
                    for name in ("n2", "n1", "0", "p1", "p2")]
            pred_idx = [verb_dict.get(predicate, 0)] * n
            label_idx = [label_dict.get(l, label_dict["O"]) for l in labels]
            yield tuple([word_idx] + ctxs + [pred_idx, mark, label_idx])

    return reader
