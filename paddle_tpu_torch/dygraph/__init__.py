"""DyGraph imperative mode (parity: paddle/fluid/imperative/ C++ +
python/paddle/fluid/dygraph/ — Tracer tracer.h:44, VarBase/OpBase layer.h:55,
BasicEngine engine.h:69, Layer layers.py:33, nn.py layer library,
DataParallel parallel.py:84, checkpoint.py save/load_dygraph, jit.py
TracedLayer).

The counterpart of the JAX package's ``dygraph``: ops run eagerly on
torch tensors on the tracer's device (``guard(CPUPlace())`` the CPU,
``guard()`` the card), the tape records each op as a node with its own
autograd graph, and ``loss.backward()`` sweeps the tape in reverse, the
BasicEngine's dependency-ordered gradient accumulation.  ``TracedLayer``
captures the layer's forward with ``torch.export``, one program per call
signature, replayed on the card as a CUDA graph."""

from .base import (
    guard,
    enabled,
    enable_dygraph,
    disable_dygraph,
    to_variable,
    no_grad,
    VarBase,
    Tracer,
)
from .layers import Layer
from . import nn
from .nn import Conv2D, Pool2D, Linear, FC, BatchNorm, Embedding, LayerNorm, GRUUnit
from .checkpoint import save_dygraph, load_dygraph
from .parallel import DataParallel, ParallelEnv, prepare_context
from .jit import TracedLayer
from .learning_rate_scheduler import *  # noqa: F401,F403
