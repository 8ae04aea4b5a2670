"""Math op rules on tensors: elementwise_add, mul, mean and top_k
(counterparts of the rules in ``paddle_tpu/ops/math_ops.py`` that LeNet
runs; the others wait).

Reference parity: operators/elementwise/elementwise_add_op.cc, mul_op.cc,
mean_op.cc, top_k_op.cc.
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


@register_op("elementwise_add")
def _elementwise_add(ins, attrs, ctx):
    a, b = x(ins, "X"), x(ins, "Y")
    if isinstance(a, SelectedRows):
        raise NotImplementedError(
            "elementwise_add of a SelectedRows gradient: sparse gradients "
            "through the executor wait (ROADMAP Queue 1 item 3)")
    a, b = _bcast(a, b, int(attrs.get("axis", -1)))
    return out(Out=a + b)


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
