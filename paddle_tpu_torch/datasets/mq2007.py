"""MQ2007 LETOR learning-to-rank reader creators (parity:
paddle/dataset/mq2007.py — Query/QueryList parsing of the LETOR text format
'rel qid:N 1:v 2:v ... #docid = ...', with pointwise/pairwise/listwise
reader modes).

Cache layout probed: DATA_HOME/MQ2007/Fold1/{train,vali,test}.txt (the
extracted rar layout; no rar parsing here — extract once by hand).

A copy of the JAX package's ``datasets/mq2007.py``, which imports no JAX.
"""

import itertools
import os

import numpy as np

from . import common

FEATURE_DIM = 46


class Query:
    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None,
                 description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    def __str__(self):
        return "%s %s %s" % (self.relevance_score, self.query_id,
                             " ".join(str(f) for f in self.feature_vector))

    @classmethod
    def parse(cls, line):
        """Parse one LETOR line: 'rel qid:10 1:0.5 ... 46:0.1 #docid = X'."""
        body, _, desc = line.partition("#")
        parts = body.split()
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        feats = [0.0] * FEATURE_DIM
        for tok in parts[2:]:
            k, _, v = tok.partition(":")
            idx = int(k) - 1
            if 0 <= idx < FEATURE_DIM:
                feats[idx] = float(v)
        return cls(qid, rel, feats, desc.strip())


class QueryList:
    """All documents of one query id."""

    def __init__(self, querylist=None):
        self.querylist = querylist or []
        self.query_id = self.querylist[0].query_id if self.querylist else -1

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def add(self, q):
        if not self.querylist:
            self.query_id = q.query_id
        self.querylist.append(q)


def _lines(which):
    path = common.cache_path("MQ2007", "Fold1", "%s.txt" % which)
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield line
        return
    common.warn_synthetic("mq2007")
    rng = np.random.RandomState(37 if which == "train" else 41)
    w = rng.randn(FEATURE_DIM)
    for qid in range(1, 41):
        for _ in range(int(rng.randint(4, 12))):
            feats = rng.rand(FEATURE_DIM)
            rel = int(np.clip(round(feats @ w * 0.5 + rng.randn() * 0.2), 0, 2))
            yield "%d qid:%d %s #docid = synthetic\n" % (
                rel, qid, " ".join("%d:%.4f" % (i + 1, v)
                                   for i, v in enumerate(feats)))


def _query_lists(which):
    current = QueryList()
    for line in _lines(which):
        q = Query.parse(line)
        if current.querylist and q.query_id != current.query_id:
            yield current
            current = QueryList()
        current.add(q)
    if current.querylist:
        yield current


def __reader__(which, format="pairwise", shuffle=False, fill_missing=-1):
    if format == "pointwise":
        for ql in _query_lists(which):
            for q in ql:
                yield np.array(q.feature_vector, "f4"), q.relevance_score
    elif format == "pairwise":
        for ql in _query_lists(which):
            for a, b in itertools.combinations(ql, 2):
                if a.relevance_score == b.relevance_score:
                    continue
                hi, lo = ((a, b) if a.relevance_score > b.relevance_score
                          else (b, a))
                yield (np.array(hi.feature_vector, "f4"),
                       np.array(lo.feature_vector, "f4"))
    elif format == "listwise":
        for ql in _query_lists(which):
            yield ([np.array(q.feature_vector, "f4") for q in ql],
                   [q.relevance_score for q in ql])
    else:
        raise ValueError("unknown format %r" % (format,))


def train(format="pairwise", shuffle=False, fill_missing=-1):
    return lambda: __reader__("train", format, shuffle, fill_missing)


def test(format="pairwise", shuffle=False, fill_missing=-1):
    return lambda: __reader__("test", format, shuffle, fill_missing)
