"""Math op rules on tensors: the elementwise binaries, compares and logical
ops, scale, mul, mean and top_k (counterparts of the rules in
``paddle_tpu/ops/math_ops.py`` that LeNet and control-flow programs run;
the others wait).

Reference parity: operators/elementwise/, controlflow/compare_op.cc,
logical_op.cc, scale_op.cc, mul_op.cc, mean_op.cc, top_k_op.cc.
"""

import math

import torch

from ..registry import register_op
from ..sparse import SelectedRows
from .common import x, out


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
            raise NotImplementedError(
                "%s of a SelectedRows gradient: sparse gradients through the "
                "executor wait (ROADMAP Queue 1 item 3)" % name)
        a, b = _bcast(a, b, int(attrs.get("axis", -1)))
        return out(Out=fn(a, b))


_register_binary("elementwise_add", torch.add)
_register_binary("elementwise_sub", torch.sub)
_register_binary("elementwise_mul", torch.mul)
# true division, integers included, as jnp.divide
_register_binary("elementwise_div", torch.true_divide)

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
        raise NotImplementedError(
            "scale of a SelectedRows gradient: sparse gradients through the "
            "executor wait (ROADMAP Queue 1 item 3)")
    w = v if v.is_floating_point() else v.to(torch.float32)
    if attrs.get("bias_after_scale", True):
        r = w * scale + bias
    else:
        r = (w + bias) * scale
    integer = not v.is_floating_point() and v.dtype != torch.bool
    return out(Out=r.to(v.dtype) if integer else r)


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


@register_op("mean")
def _mean(ins, attrs, ctx):
    return out(Out=x(ins, "X").mean().reshape(()))


@register_op("top_k")
def _top_k(ins, attrs, ctx):
    """The k largest along the last axis.  Ties go to the lower index, as
    ``lax.top_k`` breaks them: a stable descending sort cut to k
    (``torch.topk`` promises no order among equal values)."""
    v = x(ins, "X")
    k = int(attrs["k"])
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return out(Out=vals[..., :k], Indices=idx[..., :k])
