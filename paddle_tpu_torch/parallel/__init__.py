"""The distributed engine (counterpart of ``paddle_tpu/parallel``): the
mesh of data-parallel ranks over ``torch.distributed`` (one process per
rank), named-axis collectives, the sharding rules, transformer blocks,
optimizers, the train step and its ZeRO form.  Tensor, sequence, ring and
pipeline parallelism, MoE, the sharded embedding, local SGD and the
checkpoint wait (ROADMAP.md Queue 1 items 5-C and 5-D)."""

from .mesh import MeshSpec, make_mesh, axis_size  # noqa: F401
from . import rules  # noqa: F401  (the sharding authority)
from .rules import match_partition_rules, ShardingAuthority  # noqa: F401
from . import collectives  # noqa: F401
from .optim import sgd, momentum, adam, lamb, adamw  # noqa: F401
from .transformer import TransformerConfig  # noqa: F401
from .train import make_train_step, TrainState  # noqa: F401
