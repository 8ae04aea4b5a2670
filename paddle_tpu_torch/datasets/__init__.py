"""Corpus readers (counterpart of ``paddle_tpu/datasets``): so far WMT16,
the NMT slice's corpus, and MNIST, LeNet's.  Copies of the JAX package's
jax-free loaders.

Offline contract, as in the reference: a loader first looks for the
corpus's cache layout under ``common.DATA_HOME`` and otherwise serves a
DETERMINISTIC synthetic corpus with the real shapes, dtypes and id ranges,
and says so once per corpus."""

from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import wmt16  # noqa: F401

__all__ = ["common", "mnist", "wmt16"]
