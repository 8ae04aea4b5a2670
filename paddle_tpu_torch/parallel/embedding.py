"""Row-sharded embedding tables over the mesh (counterpart of
``paddle_tpu/parallel/embedding.py``).

Parity: the reference's sharded-embedding stack, the pserver-row-sharded
distributed_lookup_table (operators/distributed_ops/
distributed_lookup_table_op.cc, split by row blocks across pservers) and
the PSLib sparse pull/push (framework/fleet/fleet_wrapper.h:76
PullSparseVarsSync, :97 PushDenseVarsAsync).

Each rank of an axis holds one row block of the [V, D] table; a lookup is a
local gather of the rows this rank owns (zeros elsewhere) and a sum over the
axis, the collective the parameter server's RPC becomes.  The gradient flows
back through the same collectives (their transposes are sums), so each rank
receives exactly its own rows' gradient and the optimizer's update is local:
the Downpour "server-side update" without a server.

The backward of the owned-rows gather (``_OwnedRows``) merges duplicate ids
with the segment-sum kernel (``kernels/segment_update.py``
``dedup_segment_sum``) and writes each merged row once into the shard's
dense gradient, the rule the port's one-device DeepFM step uses; it is
deterministic, unlike ``index_add_``'s atomics.  On CPU tensors the kernel's
wrapper runs its plain version.

The capacity guard reads the device's own memory: a configured budget
(``configure_hbm_budget``, or ``monitor.memscope.configure``), else the
smallest total memory of the visible cards.  With neither (a host without a
card and nothing configured) it raises and asks for one; it never guesses a
size.  A table past the budget is the host-RAM parameter server's, which
waits for ROADMAP Queue 1 item 7 (HostPS) in this port.
"""

import torch

from ..kernels._common import resolve_device
from ..kernels.segment_update import dedup_segment_sum, scatter_rows_drop
from . import collectives as col
from .mesh import DP

__all__ = [
    "shard_rows",
    "embedding_spec",
    "sharded_embedding_lookup",
    "init_sharded_table",
    "init_embedding_table",
    "table_fits",
    "enable_host_sparse_table",
    "host_sparse_table_enabled",
]

_HOSTPS = "ROADMAP Queue 1 item 7, HostPS"


def embedding_spec(axis=DP):
    """PartitionSpec of a row-sharded [V, D] table, from the sharding
    authority (``parallel/rules.py`` ``row_sharded_table_spec``)."""
    from . import rules as shard_rules

    return shard_rules.row_sharded_table_spec(axis)


def shard_rows(vocab_size, n_shards):
    """Rows per shard for the block layout (shard i owns
    [i*rows, (i+1)*rows)); the vocabulary must divide evenly: pad the table
    when it is made (``init_sharded_table`` does)."""
    if vocab_size % n_shards:
        raise ValueError(
            "vocab %d not divisible by %d shards; pad the table "
            "(init_sharded_table rounds up)" % (vocab_size, n_shards))
    return vocab_size // n_shards


# the byte budget a device gives the tables: None reads the device
_HBM_BYTES_PER_CHIP = None
_HBM_TABLE_FRACTION = 0.6       # leave room for activations and moments


def configure_hbm_budget(bytes_per_chip, table_fraction=0.6):
    """Set the per-device byte budget the table-capacity guard checks."""
    global _HBM_BYTES_PER_CHIP, _HBM_TABLE_FRACTION
    _HBM_BYTES_PER_CHIP = int(bytes_per_chip)
    _HBM_TABLE_FRACTION = float(table_fraction)


def _hbm_bytes_per_chip():
    """The configured budget, else ``memscope.min_device_bytes_limit``
    (memscope's configured limit, else the smallest card's total memory).
    Raises when neither gives a number."""
    if _HBM_BYTES_PER_CHIP is not None:
        return _HBM_BYTES_PER_CHIP
    from ..monitor import memscope

    limit = memscope.min_device_bytes_limit()
    if not limit:
        raise ValueError(
            "the embedding table capacity guard has no device memory size: "
            "no card is visible and no budget is configured; call "
            "parallel.embedding.configure_hbm_budget(bytes_per_device) or "
            "monitor.memscope.configure(bytes_limit=...)")
    return int(limit)


# routing flag: set by DistributedStrategy.use_host_sparse_table
# (distributed/fleet.py) or directly
_HOST_SPARSE_TABLE = False
_HOST_SPARSE_CACHE_SLOTS = 0    # default hot-row cache size for routed tables


def enable_host_sparse_table(on=True, cache_slots=None):
    """Route tables past the device budget to the host-RAM parameter
    server (the fleet strategy knob ``use_host_sparse_table`` calls this);
    ``cache_slots``, when given, is the default hot-row cache size of a
    routed table (the knob ``host_sparse_cache_slots``)."""
    global _HOST_SPARSE_TABLE, _HOST_SPARSE_CACHE_SLOTS
    _HOST_SPARSE_TABLE = bool(on)
    if cache_slots is not None:
        _HOST_SPARSE_CACHE_SLOTS = int(cache_slots)


def host_sparse_table_enabled():
    return _HOST_SPARSE_TABLE


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def table_fits(vocab_size, dim, n_shards=1, dtype=torch.float32):
    """Whether a [vocab, dim] table fits the mesh's aggregate table budget
    (``init_embedding_table``'s routing predicate)."""
    table_bytes = vocab_size * dim * _itemsize(dtype)
    return (table_bytes
            <= n_shards * _hbm_bytes_per_chip() * _HBM_TABLE_FRACTION)


def _check_table_fits(vocab_size, dim, n_shards, dtype):
    """Mesh-sharded tables cap out at the devices' aggregate memory; the
    reference's PSLib host-RAM sparse service (fleet_wrapper.h:55) exists
    for what lies beyond.  Past the limit, fail naming that route rather
    than let the first allocation run out of memory."""
    if table_fits(vocab_size, dim, n_shards, dtype):
        return
    table_bytes = vocab_size * dim * _itemsize(dtype)
    per_chip = _hbm_bytes_per_chip()
    budget = n_shards * per_chip * _HBM_TABLE_FRACTION
    raise ValueError(
        "embedding table [%d x %d] (%s) needs %.1f GiB but the %d-shard "
        "mesh has only ~%.1f GiB of device memory budgeted for tables "
        "(%.0f%% of %d x %.1f GiB). Tables past the devices' aggregate "
        "memory are served by the host-RAM parameter-server (the "
        "reference's PSLib/Downpour design), which waits for %s in this "
        "port: DistributedStrategy.use_host_sparse_table = True "
        "(distributed/fleet.py) or parallel.embedding."
        "enable_host_sparse_table() selects that route. Otherwise shard "
        "over more devices, shrink dim, use a smaller dtype, or hash the "
        "vocabulary. The budget is set by parallel.embedding."
        "configure_hbm_budget()."
        % (vocab_size, dim, str(dtype).replace("torch.", ""),
           table_bytes / 1024 ** 3, n_shards, budget / 1024 ** 3,
           _HBM_TABLE_FRACTION * 100, n_shards, per_chip / 1024 ** 3,
           _HOSTPS))


def init_sharded_table(gen, vocab_size, dim, n_shards, scale=None,
                       dtype=torch.float32, device=None):
    """A [V_padded, D] table, V_padded the vocabulary rounded up to a
    multiple of ``n_shards`` (the row-block split of the transpiler's
    slice_var_up, distribute_transpiler.py:131), N(0, scale^2) with scale
    1/sqrt(D) by default, drawn from ``gen`` (a CPU ``torch.Generator``)
    and placed on ``device`` (``cuda`` unless named).  Each rank keeps its
    row block (``train.shard_pytree`` with ``embedding_spec``).  Raises
    when the table cannot fit the mesh's aggregate budget."""
    pad = (-vocab_size) % n_shards
    v = vocab_size + pad
    _check_table_fits(v, dim, n_shards, dtype)
    scale = scale if scale is not None else dim ** -0.5
    # drawn in the target dtype where it is a float: an f32 staging copy
    # would take the very memory the guard just counted for a narrower one
    gen_dtype = dtype if dtype.is_floating_point else torch.float32
    t = torch.randn(v, dim, generator=gen, dtype=gen_dtype) * scale
    return t.to(dtype).to(resolve_device(device))


def init_embedding_table(gen, vocab_size, dim, n_shards=1, scale=None,
                         dtype=torch.float32, host_optimizer=None,
                         host_initializer=None, cache_slots=0, device=None,
                         name="embedding"):
    """The capacity router for sparse tables (the fleet_wrapper.h:55
    decision point): a vocabulary that fits the mesh's aggregate budget
    gets the row-sharded table (``init_sharded_table``); one past it
    raises the capacity error, naming the host route, unless
    ``use_host_sparse_table`` is on, where the reference hands the table to
    its host-RAM parameter server; that server waits for item 7 here.
    ``host_optimizer``, ``host_initializer`` and ``cache_slots`` belong to
    that route."""
    pad = (-vocab_size) % n_shards
    v = vocab_size + pad
    if table_fits(v, dim, n_shards, dtype):
        return init_sharded_table(gen, vocab_size, dim, n_shards, scale=scale,
                                  dtype=dtype, device=device)
    if not host_sparse_table_enabled():
        _check_table_fits(v, dim, n_shards, dtype)      # raises
    raise NotImplementedError(
        "embedding table %r [%d x %d] is past the devices' budget and "
        "use_host_sparse_table routes it to the host-RAM parameter-server "
        "(HostPSEmbedding, %d hot-row cache slots), which waits (%s)"
        % (name, vocab_size, dim, cache_slots or _HOST_SPARSE_CACHE_SLOTS,
           _HOSTPS))


class _OwnedRows(torch.autograd.Function):
    """``where(own, shard[local], 0)`` for flat ids already shifted into
    the shard's rows.  The backward merges duplicate ids with the
    segment-sum kernel and adds each merged row once into a zero gradient
    of the shard (ids the shard does not own are dropped)."""

    @staticmethod
    def forward(ctx, shard, local):
        rows = shard.shape[0]
        own = (local >= 0) & (local < rows)
        vals = shard[local.clamp(0, max(rows - 1, 0))]
        vals = torch.where(own[:, None], vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))
        ctx.save_for_backward(torch.where(own, local,
                                          torch.full_like(local, rows)))
        ctx.shape = shard.shape
        return vals

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = ctx.shape[0]
        mrows, mvals = dedup_segment_sum(ids, g.contiguous(), rows)
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return scatter_rows_drop(grad, mrows, mvals), None


def _owned_gather(table_shard, ids, lo):
    """The rows of ``ids`` (any shape) this shard owns, zeros elsewhere:
    [..., D]."""
    local = (ids.long() - lo).reshape(-1)
    vals = _OwnedRows.apply(table_shard, local)
    return vals.reshape(tuple(ids.shape) + tuple(table_shard.shape[1:]))


def sharded_embedding_lookup(table_shard, ids, axis):
    """Lookup on a row-block-sharded table: ``table_shard`` this rank's
    [V/n, D] block, ``ids`` replicated over ``axis`` (full-vocabulary ids);
    returns the replicated [..., D] rows.  One owned-rows gather and one
    psum.  As in the reference, psum's transpose is psum, so a loss
    computed on every rank from this output must be averaged over the axis
    for the table's gradient to come out unscaled.  For batch-sharded ids
    use ``sharded_embedding_lookup_dp``."""
    lo = col.axis_index(axis) * table_shard.shape[0]
    return col.psum(_owned_gather(table_shard, ids, lo), axis)


def sharded_embedding_lookup_dp(table_shard, ids_local, axis):
    """Row-sharded table and batch-sharded ids, the production CTR layout
    (each rank holds a batch shard and a row block): every rank's ids
    gathered [n, ...], the owned rows of all of them gathered, then each
    rank receives the sum of its own slot (the reference's
    ``psum_scatter(tiled=False)``).  The port's ``reduce_scatter`` keeps the
    scattered dim at n / n = 1 rows, and indexing it drops that dim, which
    is ``tiled=False``'s result.  Its transpose is the all-gather: each
    owner rank receives its rows' cotangents from every rank's batch."""
    ids_all = col.all_gather(ids_local.unsqueeze(0), axis, 0)     # [n, ...]
    lo = col.axis_index(axis) * table_shard.shape[0]
    vals = _owned_gather(table_shard, ids_all, lo)
    return col.reduce_scatter(vals, axis, 0)[0]
