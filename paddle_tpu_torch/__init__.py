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
- ``parallel``: transformer blocks, optimizers, the train step, the mesh
  and collectives over a ``torch.distributed`` world, ZeRO, and the
  batch-axis table of program-mode data parallelism (``batch_axes``);
- the deployment path: ``io`` (``save_inference_model`` and the other
  savers and loaders, in the JAX package's file format), ``inference``
  (``Predictor``, ``create_predictor``, and ``export_inference_model`` /
  ``ExportedPredictor``, a ``torch.export`` program served by one CUDA
  graph per feed signature), ``metrics``, ``compiler`` (``CompiledProgram``,
  ``with_data_parallel`` over the world's ranks) and ``serving.lattice``;
- ``models.bert``, ``models.resnet``, ``models.deepfm``,
  ``models.transformer_nmt``, ``models.lenet``: the trainers and builders of
  the five BASELINE configs; ``models.book`` the Fluid book suite;
  ``models.parity`` the learning criteria;
- ``amp`` (and ``contrib.mixed_precision``): ``decorate``, ``amp_guard``;
- ``monitor`` (run telemetry: timeline, spans, Prometheus, recompiles,
  MemScope, the TrainSentinel), ``profiler`` (``torch.profiler`` behind
  the Fluid profiler API), ``flags`` (``FLAGS_check_nan_inf``) and
  ``ft`` (``CheckpointPolicy``, the sharded checkpoint and TrainGuard
  behind ``train_from_dataset(checkpoint=...)`` and ``TrainLoop``, the
  preemption agreement, the fault drills of ``ft.chaos``);
- the data path: ``dataset`` (``DatasetFactory``, ``QueueDataset``,
  ``InMemoryDataset`` over the native MultiSlot parser of ``runtime``),
  ``feed_pipe`` (``DeviceFeedPipe``, ``InFlightWindow``), ``reader``
  (``DataLoader``), ``layers.io``'s ``py_reader`` family, ``trainer``
  (``Executor.train_from_dataset``) and ``async_executor``;
- ``sparse``: SelectedRows and ``merge_rows``;
- ``lod`` (``LoDTensor``, ``LoDTensorArray``, ``Tensor``) and
  ``learning_rate_decay``, the compat names the JAX package exports;
- ``ir`` (the ``Pass`` registry and ``PassManager``), ``transpiler`` and
  ``distributed`` (``fleet``, the launcher, the ``DistributeTranspiler``,
  whose tagged programs the executor runs data-parallel, the GeoSGD
  ``Communicator`` and the heartbeats), ``install_check`` (``run_check``)
  and ``contrib.layers``;
- ``dygraph`` (the imperative mode: ``guard``, ``VarBase`` and its tape,
  ``Layer``, the ``nn`` layers, ``TracedLayer``, ``DataParallel`` at one
  rank, ``save_dygraph`` / ``load_dygraph``, the schedulers) and
  ``dygraph_grad_clip``; ``optimizer.*.minimize`` under ``dygraph.guard()``
  updates the parameters eagerly;
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
from .ft import CheckpointPolicy  # noqa: F401
from .param_attr import WeightNormParamAttr
from .trainer import FetchHandler
from .reader import DataLoader
from . import dataset
from .dataset import DatasetFactory
from .async_executor import AsyncExecutor
from .layers.io import EOFException
from . import learning_rate_decay  # noqa: F401
from .lod import LoDTensor, LoDTensorArray, Tensor  # noqa: F401
from . import transpiler  # noqa: F401
from . import install_check  # noqa: F401
from . import ir  # noqa: F401
from . import distributed  # noqa: F401
from . import dygraph  # noqa: F401
from . import dygraph_grad_clip  # noqa: F401

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
    "get_flags", "monitor", "profiler", "ft", "CheckpointPolicy",
    "WeightNormParamAttr",
    "FetchHandler", "DataLoader", "dataset", "DatasetFactory",
    "AsyncExecutor", "EOFException", "learning_rate_decay", "LoDTensor",
    "LoDTensorArray", "Tensor", "transpiler", "install_check", "ir",
    "distributed", "dygraph", "dygraph_grad_clip",
]
