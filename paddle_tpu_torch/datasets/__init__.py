"""Corpus readers (counterpart of ``paddle_tpu/datasets``): WMT16, the NMT
slice's corpus; MNIST, LeNet's; the book suite's imikolov (word2vec),
movielens (recommender), imdb (sentiment), conll05 (semantic roles),
uci_housing (fit_a_line) and cifar (image classification); and wmt14,
sentiment (movie reviews), mq2007 (learning to rank), flowers and voc2012
(images) with the ``image`` transforms.  Copies of the JAX package's
jax-free loaders.

Offline contract, as in the reference: a loader first looks for the
corpus's cache layout under ``common.DATA_HOME`` and otherwise serves a
DETERMINISTIC synthetic corpus with the real shapes, dtypes and id ranges,
and says so once per corpus."""

from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import wmt16  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import wmt14  # noqa: F401
from . import sentiment  # noqa: F401
from . import mq2007  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import image  # noqa: F401

__all__ = ["common", "mnist", "wmt16", "cifar", "uci_housing", "imdb",
           "imikolov", "movielens", "conll05", "wmt14", "sentiment",
           "mq2007", "flowers", "voc2012", "image"]
