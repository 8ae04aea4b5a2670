"""The port's copies of the JAX package's remaining corpus loaders
(``datasets/`` flowers, voc2012, mq2007, sentiment, wmt14 and the ``image``
transforms) on the CPU: with an empty data home both packages serve their
deterministic synthetic stand-ins, and the first samples of every reader
are equal, value for value, to the JAX package's."""

import itertools
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.datasets as jds
import paddle_tpu_torch.datasets as pds


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 6


@pytest.fixture(autouse=True)
def _synthetic_corpora(monkeypatch, tmp_path):
    """Both packages read an empty data home, with the sentiment word
    dict's module cache cleared (another test of the same process may have
    filled it from a corpus of its own)."""
    for pkg in (pds, jds):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(pkg.sentiment, "_word_dict", None)

READERS = {
    "flowers.train": lambda d: d.flowers.train(),
    "flowers.valid": lambda d: d.flowers.valid(),
    "voc2012.val": lambda d: d.voc2012.val(),
    "mq2007.pairwise": lambda d: d.mq2007.train(format="pairwise"),
    "mq2007.listwise": lambda d: d.mq2007.test(format="listwise"),
    "sentiment.train": lambda d: d.sentiment.train(),
    "wmt14.train": lambda d: d.wmt14.train(dict_size=100),
}


def _first(reader):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return list(itertools.islice(reader(), N))


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_jax(name):
    got, want = _first(READERS[name](pds)), _first(READERS[name](jds))
    assert len(got) == len(want) == N
    _same(got, want)


def test_dicts_match_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        assert pds.sentiment.get_word_dict() == jds.sentiment.get_word_dict()
        assert pds.wmt14.get_dict(100) == jds.wmt14.get_dict(100)


def test_image_transforms_match_jax():
    im = np.random.RandomState(3).rand(40, 52, 3).astype(np.float32)
    for mod in ("resize_short", "center_crop"):
        _same(getattr(pds.image, mod)(im, 24), getattr(jds.image, mod)(im, 24))
    _same(pds.image.simple_transform(im, 32, 24, is_train=False),
          jds.image.simple_transform(im, 32, 24, is_train=False))
    _same(pds.image.to_chw(im), jds.image.to_chw(im))
