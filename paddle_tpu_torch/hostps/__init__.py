"""HostPS — host-RAM sparse parameter service for beyond-HBM embedding
tables.

Counterpart of ``paddle_tpu/hostps/``.  The reference's PSLib/Downpour
sparse service (framework/fleet/fleet_wrapper.h:55: sparse CTR tables too
big for accelerator memory live in pserver RAM), with the pserver
processes collapsed into this process's host RAM; the RPC pull/push becomes
a PCIe copy from pinned staging and an eager push after backward, with a
hot-row cache on the card in front:

- table.py    — host-RAM table, init-on-first-pull, per-row moment slots
- optimizer.py— host-side sparse appliers (SGD/Adagrad/lazy Adam), the
                Downpour "server-side update"
- cache.py    — hot-ID device cache (LRU, one fixed slot buffer, profiler
                hit/miss counters)
- service.py  — pull/push pipeline: prefetch-thread double buffering,
                SelectedRows push with merge_rows semantics, the merged
                push through the segment-sum kernel, checkpoint via io.py
                shards
- wire.py     — ShardPS fault-tolerant request-reply transport between
                fleet processes (deadlines, ps_wire-surfaced retries,
                idempotent sequence-numbered mutation, chaos points)
- shard_router.py — the live table runtime-sharded across processes by
                parallel/rules.hostps_row_range: ShardServer (owner),
                ShardRouter (table-shaped client: sync or GEO bounded-
                staleness apply, dead-shard degradation + replay, live
                repartition), ShardedHostPSEmbedding

Entry points: the capacity router `parallel.embedding.init_embedding_table`
returns a HostPSEmbedding when the vocab exceeds the HBM budget and
`DistributedStrategy.use_host_sparse_table` is set (distributed/fleet.py).
"""

from .table import HostSparseTable, default_row_initializer  # noqa: F401
from .optimizer import HostSGD, HostAdagrad, HostAdam  # noqa: F401
from .cache import HotRowCache  # noqa: F401
from .service import (  # noqa: F401
    HostPSEmbedding,
    register_prefetch_hook,
    unregister_prefetch_hook,
    has_prefetch_hooks,
    notify_next_batch,
)
from .shard_router import (  # noqa: F401
    ShardRouter,
    ShardServer,
    ShardedHostPSEmbedding,
    repartition_tables,
)

__all__ = [
    "HostSparseTable", "default_row_initializer",
    "HostSGD", "HostAdagrad", "HostAdam",
    "HotRowCache", "HostPSEmbedding",
    "ShardRouter", "ShardServer", "ShardedHostPSEmbedding",
    "repartition_tables",
    "register_prefetch_hook", "unregister_prefetch_hook",
    "has_prefetch_hooks", "notify_next_batch",
]
