"""Model builders (counterpart of ``paddle_tpu/models``): ``bert``,
``resnet``, ``deepfm``, ``transformer_nmt`` and the ``parity`` recipes."""

from . import transformer_nmt  # noqa: F401

__all__ = ["transformer_nmt"]
