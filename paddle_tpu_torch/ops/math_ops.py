"""Math op rules on tensors: the elementwise binaries, compares and logical
ops, scale, sum, mul, mean, the reductions, floor and top_k (counterparts of
the rules in ``paddle_tpu/ops/math_ops.py`` that the Fluid slices run; the
others wait).

Reference parity: operators/elementwise/, controlflow/compare_op.cc,
logical_op.cc, scale_op.cc, sum_op.cc, mul_op.cc, mean_op.cc,
reduce_ops/, activation_op.cc (floor), top_k_op.cc.  A SelectedRows
gradient (``sparse.py``) passes ``scale``, a binary by a scalar and ``sum``
as the JAX rules pass it (math/selected_rows_functor.cc).
"""

import math

import torch

from ..registry import register_op
from ..sparse import SelectedRows
from .common import x, out, promote_float


def _bcast(a, b, axis):
    """Reference elementwise broadcast semantics (elementwise_op_function.h):
    Y's shape must match a contiguous suffix-run of X's shape starting at
    `axis`; numpy-style trailing broadcast when axis == -1."""
    if axis == -1 or a.ndim == b.ndim:
        return a, b
    # align b's dims to a's at position `axis`
    expand = [1] * a.ndim
    for i, s in enumerate(b.shape):
        expand[axis + i] = s
    return a, b.reshape(expand)


def _register_binary(name, fn):
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        a, b = x(ins, "X"), x(ins, "Y")
        if isinstance(a, SelectedRows):
            if b.numel() == 1:
                # sparse grad x scalar (the global-norm clip factor, a
                # shape-[1] fluid scalar included): map over the rows'
                # values, keep the sparse representation
                return out(Out=SelectedRows(a.rows, fn(a.values, b.reshape(())),
                                            a.height))
            raise NotImplementedError(
                "%s: SelectedRows lhs supports only scalar rhs" % name)
        a, b = _bcast(a, b, int(attrs.get("axis", -1)))
        return out(Out=fn(a, b))


_register_binary("elementwise_add", torch.add)
_register_binary("elementwise_sub", torch.sub)
_register_binary("elementwise_mul", torch.mul)
# true division, integers included, as jnp.divide
_register_binary("elementwise_div", torch.true_divide)
# bool ** bool in int32, as jnp.power (torch.pow refuses bool)
_register_binary("elementwise_pow", lambda a, b: torch.pow(
    *(t.int() if t.dtype == torch.bool else t for t in (a, b))))

_register_binary("less_than", torch.lt)
_register_binary("less_equal", torch.le)
_register_binary("greater_than", torch.gt)
_register_binary("greater_equal", torch.ge)
_register_binary("equal", torch.eq)
_register_binary("not_equal", torch.ne)

_register_binary("logical_and", torch.logical_and)
_register_binary("logical_or", torch.logical_or)


@register_op("logical_not")
def _logical_not(ins, attrs, ctx):
    return out(Out=torch.logical_not(x(ins, "X")))


@register_op("scale")
def _scale(ins, attrs, ctx):
    """An integer input computes in f32 and casts back, as JAX promotes an
    int array times a Python float; a bool input gives f32, as in JAX."""
    v = x(ins, "X")
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if isinstance(v, SelectedRows):
        return out(Out=SelectedRows(v.rows, v.values * scale + bias,
                                    v.height))
    w = v if v.is_floating_point() else v.to(torch.float32)
    if attrs.get("bias_after_scale", True):
        r = w * scale + bias
    else:
        r = (w + bias) * scale
    integer = not v.is_floating_point() and v.dtype != torch.bool
    return out(Out=r.to(v.dtype) if integer else r)


@register_op("sum")
def _sum(ins, attrs, ctx):
    vs = ins["X"]
    sparse = [v for v in vs if isinstance(v, SelectedRows)]
    if sparse:
        if len(sparse) == len(vs):
            # SelectedRows + SelectedRows: concatenate the slices; duplicate
            # rows merge when applied (MergeAdd semantics)
            return out(Out=SelectedRows(
                torch.cat([v.rows for v in sparse]),
                torch.cat([v.values for v in sparse]), sparse[0].height))
        # a SelectedRows gradient plus a dense term (the regularizer's
        # pattern): the term is added to the touched rows only, after the
        # rows are merged, so a duplicated id gets it once; merged() parks
        # empty slots at row == height, whose term is zero
        assert len(sparse) == 1, "at most one sparse addend supported"
        rows, vals = sparse[0].merged()
        height = sparse[0].height
        safe = rows.clamp(max=height - 1)
        valid = (rows < height)[:, None]
        for d in vs:
            if not isinstance(d, SelectedRows):
                vals = vals + torch.where(valid, d[safe], 0.0)
        return out(Out=SelectedRows(rows, vals, height))
    r = vs[0]
    for v in vs[1:]:
        r = r + v
    return out(Out=r)


@register_op("mul")
def _mul(ins, attrs, ctx):
    """Reference mul_op.cc: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, matmul, restore leading dims."""
    a, b = x(ins, "X"), x(ins, "Y")
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))

    def _flat2(t, d):
        return t.reshape(math.prod(t.shape[:d]), math.prod(t.shape[d:]))

    r = _flat2(a, xd) @ _flat2(b, yd)
    return out(Out=r.reshape(tuple(a.shape[:xd]) + tuple(b.shape[yd:])))


@register_op("floor")
def _floor(ins, attrs, ctx):
    """Integers and bool come back as they are, as from ``jnp.floor``."""
    v = x(ins, "X")
    return out(Out=torch.floor(v) if v.is_floating_point() else v)


def _reduce(fn, over_none=lambda v: v):
    """attrs: dim (default [0]), keep_dim, reduce_all.  ``fn(v, dims,
    keep)`` reduces over a tuple of dims, as ``jnp.sum(axis=...)``.  An
    empty ``dim`` list without reduce_all reduces no axis, as
    ``jnp.sum(axis=())`` (torch reads ``dim=()`` as every axis):
    ``over_none(v)`` gives the input in the dtype the reduction would."""
    def rule(ins, attrs, ctx):
        v = x(ins, "X")
        if attrs.get("reduce_all", False):
            dims = tuple(range(v.ndim))
        else:
            dims = tuple(a if a >= 0 else a + v.ndim
                         for a in attrs.get("dim", [0]))
            if not dims:
                return out(Out=over_none(v))
        return out(Out=fn(v, dims, bool(attrs.get("keep_dim", False))))

    return rule


def _one_dim_at_a_time(op):
    """A reduction torch takes over one dim at a time (prod, all, any),
    applied over each of ``dims`` from the last."""
    def fn(v, dims, keep):
        for d in sorted(set(dims), reverse=True):
            v = op(v, dim=d, keepdim=keep)
        return v

    return fn


def _summed(v):
    """``v`` in the dtype torch's sum and prod give it: integers and bool
    widen to int64 (JAX's int32 under x64 off; the values agree)."""
    return v if v.is_floating_point() else v.to(torch.int64)


register_op("reduce_sum")(_reduce(lambda v, d, k: v.sum(dim=d, keepdim=k),
                                  _summed))
# integers and bool average in f32, as jnp.mean
register_op("reduce_mean")(_reduce(
    lambda v, d, k: promote_float(v).mean(dim=d, keepdim=k), promote_float))
# amax/amin, as jnp.max/min: tied extremes share the gradient equally
register_op("reduce_max")(_reduce(lambda v, d, k: v.amax(dim=d, keepdim=k)))
register_op("reduce_min")(_reduce(lambda v, d, k: v.amin(dim=d, keepdim=k)))
register_op("reduce_prod")(_reduce(_one_dim_at_a_time(torch.prod), _summed))
register_op("reduce_all")(_reduce(_one_dim_at_a_time(torch.all),
                                  lambda v: v.bool()))
register_op("reduce_any")(_reduce(_one_dim_at_a_time(torch.any),
                                  lambda v: v.bool()))


@register_op("mean")
def _mean(ins, attrs, ctx):
    return out(Out=promote_float(x(ins, "X")).mean().reshape(()))


@register_op("top_k")
def _top_k(ins, attrs, ctx):
    """The k largest along the last axis.  Ties go to the lower index, as
    ``lax.top_k`` breaks them: a stable descending sort cut to k
    (``torch.topk`` promises no order among equal values)."""
    v = x(ins, "X")
    k = int(attrs["k"])
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return out(Out=vals[..., :k], Indices=idx[..., :k])
