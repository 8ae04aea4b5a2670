"""Named-axis collectives (counterpart of ``paddle_tpu/parallel/collectives.py``).

The JAX wrappers run ``lax`` collectives over a mesh axis inside
``shard_map``; here each runs the same ``torch.distributed`` collective over
the process group of that axis in the active mesh (``with mesh:``,
``mesh.py``).  Every wrapper is a no-op when the axis is absent or has size
1, so the same model code runs on any mesh and on one device.

Each wrapper differentiates as JAX differentiates its collective under
``check_vma=False``: psum's transpose is psum (a replicated cotangent is
summed once more, so a loss formed with a plain psum gives gradients the
axis size times the one-device ones, as in the reference), pmean's is
pmean, all_gather's is reduce_scatter and back, ppermute's is the inverse
shift and all_to_all's swaps its split and concat dims.  pmax and pmin have
no gradient, as ``lax.pmax`` has none.

Under the wrappers sits one backend layer (``backend_*``), each function a
collective over a process group on whole tensors.  It never stages through
host memory: gloo takes CUDA tensors for every collective used here in the
installed torch (two gloo ranks on one card run them on the card's tensors),
and NCCL takes nothing else.  The shift (``backend_permute``) sends one
tensor a rank point to point where the backend takes point-to-point calls
on the tensor's device, and runs as an all-gather where it does not
(``permute_route``, decided before the call).  A collective that fails
raises.
"""

import torch
import torch.distributed as dist

from .mesh import active_mesh

__all__ = [
    "axis_present", "axis_size_in", "axis_index",
    "psum", "pmean", "pmax", "pmin", "global_mean_loss", "all_gather",
    "reduce_scatter", "ppermute_shift", "all_to_all",
    "backend_all_reduce", "backend_all_gather", "backend_reduce_scatter",
    "backend_permute", "backend_all_to_all", "backend_broadcast",
    "permute_route",
]


# -- the backend layer (whole tensors over one process group) ----------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _n(group):
    return dist.get_world_size(group)


def backend_all_reduce(x, group, op="sum"):
    """A new tensor: ``x`` reduced over ``group`` (sum, max or min)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def backend_all_gather(x, group, dim=0):
    """The group's tensors concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((_n(group) * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def backend_reduce_scatter(x, group, dim=0):
    """The sum over the group, then this rank's shard of ``dim`` (which
    the group size divides)."""
    n = _n(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError("reduce_scatter: dim %d of size %d over %d ranks"
                         % (dim, xt.shape[0], n))
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def permute_route(x, group):
    """The route ``backend_permute`` takes for ``x`` over ``group``:
    ``"p2p"`` (``batch_isend_irecv``, each rank sends its tensor to one
    rank and receives one) on NCCL, and on gloo for CPU tensors;
    ``"all_gather"`` (every rank's tensor, then the source's slice) on gloo
    for CUDA tensors, whose point-to-point calls gloo does not take."""
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        return "all_gather"
    return "p2p"


def backend_permute(x, group, shift):
    """Rank i's ``x`` lands on rank (i + shift) mod n, by the route
    ``permute_route`` picks before the call."""
    n = _n(group)
    me = dist.get_rank(group)
    src, dst = (me - shift) % n, (me + shift) % n
    if src == me:
        return x.clone(memory_format=torch.contiguous_format)
    if permute_route(x, group) == "all_gather":
        return backend_all_gather(x.unsqueeze(0), group, 0)[src]
    send = x.contiguous()
    out = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)])
    for r in reqs:
        r.wait()
    return out


def backend_all_to_all(x, group, split_dim, concat_dim):
    """Chunk j of ``x`` along ``split_dim`` goes to rank j; the chunks
    received are concatenated along ``concat_dim`` in rank order."""
    n = _n(group)
    xt = x.movedim(split_dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError("all_to_all: dim %d of size %d over %d ranks"
                         % (split_dim, xt.shape[0], n))
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    chunks = out.view((n, xt.shape[0] // n) + tuple(xt.shape[1:]))
    return torch.cat([c.movedim(0, split_dim) for c in chunks], dim=concat_dim)


def backend_broadcast(x, group, src=0):
    """A new tensor: the group rank ``src``'s ``x`` on every rank."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
    return y


# -- axes ----------------------------------------------------------------------

def _group(axis):
    mesh = active_mesh()
    if axis is None or mesh is None or axis not in mesh.shape:
        return None
    return mesh.groups.get(axis)        # None at size 1


def axis_present(axis):
    mesh = active_mesh()
    return axis is not None and mesh is not None and axis in mesh.shape


def axis_size_in(axis):
    return active_mesh().shape[axis] if axis_present(axis) else 1


def axis_index(axis):
    """This rank's coordinate on ``axis`` (0 outside the mesh)."""
    return active_mesh().coords[axis] if axis_present(axis) else 0


# -- differentiable wrappers ---------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return backend_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return backend_all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return backend_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return backend_reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return backend_reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return backend_all_gather(g, ctx.group, ctx.dim), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return backend_permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return backend_permute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return backend_all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return (backend_all_to_all(g, group, concat_dim, split_dim),
                None, None, None)


class _Extremum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return backend_all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "pmax / pmin have no gradient (lax.pmax has no AD rule): take "
            "the operand stop-gradient, as the reference does")


def psum(x, axis):
    """All-reduce sum (parity: c_allreduce_sum, all_reduce_op_handle.cc:48)."""
    group = _group(axis)
    return x if group is None else _Psum.apply(x, group)


def pmean(x, axis):
    """psum, then division by the axis size (``lax.pmean``)."""
    group = _group(axis)
    return x if group is None else _Psum.apply(x, group) / _n(group)


def pmax(x, axis):
    group = _group(axis)
    return x if group is None else _Extremum.apply(x, group, "max")


def pmin(x, axis):
    """All-reduce min (the ``c_allreduce_min`` rule's ``lax.pmin``)."""
    group = _group(axis)
    return x if group is None else _Extremum.apply(x, group, "min")


def global_mean_loss(local_sum, global_count, axis):
    """Globally-reduced mean loss whose GRADIENT is exact for axis-sharded
    leaves: the local sum over the GLOBAL count, plus the other shards'
    contributions without a gradient (value = global mean; the cotangent
    reaching local compute stays exactly 1/global_count).  Why not
    pmean(local_mean): psum's transpose is psum, so a replicated cotangent
    picks up an extra axis-size factor (the ScaleLossGradOp 1/N placement
    problem, details/scale_loss_grad_op_handle)."""
    local = local_sum / global_count
    if _group(axis) is None:
        return local
    return (psum(local, axis) - local).detach() + local


def all_gather(x, axis, dim=0):
    """Concat shards along ``dim`` (parity: c_allgather op)."""
    group = _group(axis)
    return x if group is None else _AllGather.apply(x, group, dim)


def reduce_scatter(x, axis, dim=0):
    """Sum then keep this rank's shard of ``dim`` (parity: c_reducescatter)."""
    group = _group(axis)
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def ppermute_shift(x, axis, shift=1):
    """Rotate shards around the axis ring: rank i's value goes to rank
    (i + shift) mod n."""
    group = _group(axis)
    return x if group is None else _Permute.apply(x, group, int(shift))


def all_to_all(x, axis, split_dim, concat_dim):
    """Exchange shards (expert-parallel dispatch/combine primitive)."""
    group = _group(axis)
    return x if group is None else _AllToAll.apply(x, group, split_dim,
                                                   concat_dim)
