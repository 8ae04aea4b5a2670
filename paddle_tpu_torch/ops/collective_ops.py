"""Collective communication ops (counterpart of
``paddle_tpu/ops/collective_ops.py``).

Reference parity: operators/collective/ — c_allreduce_{sum,max,min,prod},
c_allgather, c_reducescatter, c_broadcast, c_comm_init*, c_gen_nccl_id,
c_sync_*_stream (c_allreduce_op.h:58-108).

A ring_id maps to a mesh axis through ``ctx.axis_env``; each op takes that
axis's collective of ``parallel/collectives.py`` (in the active mesh), as
the JAX rule takes the ``lax`` collective.  With no axis for the ring (an
empty ``axis_env``, which is every JAX path: its executor never fills it)
the ops are identities — the single-process behaviour of an uninitialised
ring.
"""

import torch

from ..parallel import collectives as col
from ..registry import register_op
from .common import x, out


def _axis(ctx, attrs):
    ring = int(attrs.get("ring_id", 0))
    return ctx.axis_env.get(ring) if ctx.axis_env else None


@register_op("c_allreduce_sum")
def _c_allreduce_sum(ins, attrs, ctx):
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    return out(Out=col.psum(v, ax) if ax else v)


@register_op("c_allreduce_max")
def _c_allreduce_max(ins, attrs, ctx):
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    return out(Out=col.pmax(v, ax) if ax else v)


@register_op("c_allreduce_min")
def _c_allreduce_min(ins, attrs, ctx):
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    return out(Out=col.pmin(v, ax) if ax else v)


@register_op("c_allreduce_prod")
def _c_allreduce_prod(ins, attrs, ctx):
    """exp of the psum of logs, as the reference (NaN for a negative X)."""
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    if not ax:
        return out(Out=v)
    return out(Out=torch.exp(col.psum(torch.log(v), ax)))


@register_op("c_allgather")
def _c_allgather(ins, attrs, ctx):
    """The ranks' X stacked on a new leading axis, then flattened into
    dim 0."""
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    if not ax:
        return out(Out=v)
    g = col.all_gather(v.unsqueeze(0), ax, dim=0)      # [nranks, ...]
    return out(Out=g.reshape((-1,) + tuple(v.shape[1:])))


@register_op("c_reducescatter")
def _c_reducescatter(ins, attrs, ctx):
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    if not ax:
        return out(Out=v)
    return out(Out=col.reduce_scatter(v, ax, dim=0))


@register_op("c_broadcast")
def _c_broadcast(ins, attrs, ctx):
    """The root's X on every rank: the psum of X masked to the root."""
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    if not ax:
        return out(Out=v)
    root = int(attrs.get("root", 0))
    # a where on every rank, so that each rank's backward runs the same psum
    is_root = torch.tensor(col.axis_index(ax) == root, device=v.device)
    masked = torch.where(is_root, v, torch.zeros_like(v))
    return out(Out=col.psum(masked, ax))


@register_op("c_ppermute")
def _c_ppermute(ins, attrs, ctx):
    """Ring shift (the building block of ring attention and the pipeline)."""
    v = x(ins, "X")
    ax = _axis(ctx, attrs)
    if not ax:
        return out(Out=v)
    return out(Out=col.ppermute_shift(v, ax, int(attrs.get("shift", 1))))


@register_op("c_sync_calc_stream")
def _c_sync_calc(ins, attrs, ctx):
    # the port's collectives run on the ranks' current streams in order
    return out(Out=x(ins, "X"))


@register_op("c_sync_comm_stream")
def _c_sync_comm(ins, attrs, ctx):
    return out(Out=x(ins, "X"))


@register_op("c_comm_init")
def _c_comm_init(ins, attrs, ctx):
    # the ring bootstrap is fleet.init() / init_process_group; inside a
    # program this is a no-op marker
    return {}


@register_op("c_comm_init_all")
def _c_comm_init_all(ins, attrs, ctx):
    return {}


@register_op("c_gen_nccl_id")
def _c_gen_nccl_id(ins, attrs, ctx):
    # parity marker: the unique-id exchange is the process group's store
    # (reference: c_gen_nccl_id_op.cc TCP bootstrap)
    return {}


@register_op("allreduce")
def _allreduce(ins, attrs, ctx):
    return _c_allreduce_sum(ins, attrs, ctx)


@register_op("broadcast")
def _broadcast(ins, attrs, ctx):
    return _c_broadcast(ins, attrs, ctx)
