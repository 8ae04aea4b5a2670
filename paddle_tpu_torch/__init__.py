"""PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find:

- ``kernels``: the hand-written CUDA kernels (LayerNorm, flash attention,
  fused batch norm, the segment sum of sparse rows, the conv filter
  gradient) with their launch counters and plain PyTorch versions;
- ``parallel``: transformer blocks, optimizers and the train step at one
  device;
- ``models.bert``, ``models.resnet``, ``models.deepfm``: the BERT
  pretraining, ResNet and DeepFM CTR training trainers; ``models.parity``
  the DeepFM learning criterion;
- ``sparse``: SelectedRows and ``merge_rows``;
- ``convert``: parameter trees to and from the JAX package's numpy form.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.  Nothing here imports
JAX or the JAX package.
"""

from .kernels._common import resolve_device

__all__ = ["resolve_device"]
