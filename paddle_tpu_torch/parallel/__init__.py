"""The distributed engine (counterpart of ``paddle_tpu/parallel``): the
mesh of ranks (dp, pp, tp) over ``torch.distributed`` (one process per
rank), named-axis collectives, the sharding rules, transformer blocks in
the Megatron-SP and ring layouts, the GPipe pipeline, ring attention,
expert-parallel MoE, optimizers, the train step and its ZeRO form, the
row-sharded embedding tables and Local SGD.  The sharded checkpoint waits
(ROADMAP.md Queue 1 item 5-D)."""

from .mesh import MeshSpec, make_mesh, axis_size  # noqa: F401
from . import rules  # noqa: F401  (the sharding authority)
from .rules import match_partition_rules, ShardingAuthority  # noqa: F401
from . import collectives  # noqa: F401
from .optim import sgd, momentum, adam, lamb, adamw  # noqa: F401
from .transformer import TransformerConfig  # noqa: F401
from .pipeline import gpipe  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from . import moe  # noqa: F401
from .train import make_train_step, TrainState  # noqa: F401
from .embedding import (  # noqa: F401
    sharded_embedding_lookup, init_sharded_table, init_embedding_table,
    embedding_spec, enable_host_sparse_table)
from . import local_sgd  # noqa: F401
