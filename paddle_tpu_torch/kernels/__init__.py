"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of ``paddle_tpu/kernels``): ``layer_norm``,
``flash_attention``, ``fused_bn``, ``segment_update`` and ``conv``;
``_common`` holds the build and the launch counts."""

from ._common import launches, reset_launches

__all__ = ["launches", "reset_launches"]
