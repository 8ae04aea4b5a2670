"""PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find:

- the Fluid program mode: ``framework`` (``Program``, ``Block``,
  ``Variable``, places), ``layers``, ``nets``, ``initializer``,
  ``backward``, ``optimizer``, ``ops`` (the op rules behind ``registry``)
  and ``executor``, which runs a program op by op on tensors (with the
  SelectedRows path of ``is_sparse`` lookups and, for a program ``amp``
  tagged, bf16 compute with f32 masters); with ``import paddle_tpu_torch
  as fluid`` a program written for the JAX package (``models/lenet.py``,
  the book suite's ``models/book.py``) runs unchanged;
- ``kernels``: the hand-written CUDA kernels (LayerNorm, flash attention,
  fused batch norm, the segment sum of sparse rows, the conv filter
  gradient) with their launch counters and plain PyTorch versions;
- ``parallel``: transformer blocks, optimizers and the train step at one
  device;
- the deployment path: ``io`` (``save_inference_model`` and the other
  savers and loaders, in the JAX package's file format), ``inference``
  (``Predictor``, ``create_predictor``, and ``export_inference_model`` /
  ``ExportedPredictor``, a ``torch.export`` program served by one CUDA
  graph per feed signature), ``metrics``, ``compiler`` (``CompiledProgram``
  at one device) and ``serving.lattice``;
- ``models.bert``, ``models.resnet``, ``models.deepfm``,
  ``models.transformer_nmt``, ``models.lenet``: the trainers and builders of
  the five BASELINE configs; ``models.book`` the Fluid book suite;
  ``models.parity`` the learning criteria;
- ``amp`` (and ``contrib.mixed_precision``): ``decorate``, ``amp_guard``;
- ``monitor`` (run telemetry: timeline, spans, Prometheus, recompiles,
  MemScope, the TrainSentinel), ``profiler`` (``torch.profiler`` behind
  the Fluid profiler API), ``flags`` (``FLAGS_check_nan_inf``) and
  ``ft.chaos`` (the executor's fault drills);
- ``sparse``: SelectedRows and ``merge_rows``;
- ``convert``: parameter trees and scopes to and from the JAX package's
  numpy form.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` (or
``CPUPlace()`` to an ``Executor``); without a card and without that request
they raise.  Nothing here imports JAX or the JAX package.
"""

from . import unique_name
from .kernels._common import resolve_device
from .framework import (
    Program,
    Block,
    Operator,
    Variable,
    Parameter,
    program_guard,
    default_main_program,
    default_startup_program,
    name_scope,
    CPUPlace,
    CUDAPlace,
    TPUPlace,
    CUDAPinnedPlace,
    in_dygraph_mode,
)
from .scope import Scope, global_scope, scope_guard
from .executor import Executor
from .backward import append_backward, gradients
from . import initializer
from . import layers
from . import optimizer
from . import regularizer
from . import clip
from . import nets
from . import data_feeder
from .data_feeder import DataFeeder
from .param_attr import ParamAttr
from . import datasets
from . import metrics
from . import io
from . import inference
from . import compiler
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy
from .io import load, save
from . import amp
from .amp import amp_guard
from . import contrib
from . import flags
from .flags import set_flags, get_flags
from . import monitor
from . import profiler
from . import ft
from .param_attr import WeightNormParamAttr

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "program_guard",
    "default_main_program", "default_startup_program", "name_scope",
    "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace", "in_dygraph_mode",
    "Scope", "global_scope", "scope_guard", "Executor", "append_backward",
    "gradients", "initializer", "layers", "optimizer", "regularizer", "clip",
    "nets", "data_feeder", "DataFeeder", "ParamAttr", "datasets",
    "unique_name", "resolve_device", "metrics", "io", "inference",
    "compiler", "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
    "load", "save", "amp", "amp_guard", "contrib", "flags", "set_flags",
    "get_flags", "monitor", "profiler", "ft", "WeightNormParamAttr",
]
