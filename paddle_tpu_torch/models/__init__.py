"""Model builders (counterpart of ``paddle_tpu/models``): ``bert``,
``resnet``, ``deepfm``, ``transformer_nmt``, the Fluid builders ``lenet``
and ``book`` (the book suite), and the ``parity`` recipes."""

from . import transformer_nmt  # noqa: F401

__all__ = ["transformer_nmt"]
