"""Tensor op rules: fill_constant, gaussian_random and uniform_random (the
startup program's initializers), and assign, cast, reshape2, concat,
stack, gather, one_hot, increment and where, which control-flow programs
and ``Switch`` run (counterparts of the rules in
``paddle_tpu/ops/tensor_ops.py``; the others wait).

Parity: operators/fill_constant_op.cc, gaussian_random_op.cc,
uniform_random_op.cc, assign_op.cc, cast_op.cc, reshape_op.cc,
concat_op.cc, stack_op.cc, gather_op.cc, one_hot_op.cc, increment_op.cc,
where_op.cc.  Random ops draw from ``torch`` generators seeded per run and
op (``common.op_generator``); they do not reproduce ``jax.random`` streams,
only their distributions.
"""

import torch

from ..registry import register_op
from .common import x, out, op_generator, dtype_of


@register_op("fill_constant")
def _fill_constant(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    return out(Out=torch.full(shape, attrs.get("value", 0.0),
                              dtype=dtype_of(attrs), device=ctx.device))


@register_op("gaussian_random")
def _gaussian_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    v = torch.randn(shape, generator=op_generator(ctx, attrs),
                    dtype=dtype_of(attrs), device=ctx.device)
    return out(Out=attrs.get("mean", 0.0) + attrs.get("std", 1.0) * v)


@register_op("uniform_random")
def _uniform_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(shape, generator=op_generator(ctx, attrs),
                   dtype=dtype_of(attrs), device=ctx.device)
    return out(Out=lo + (hi - lo) * u)


@register_op("assign")
def _assign(ins, attrs, ctx):
    return out(Out=x(ins, "X"))


@register_op("cast")
def _cast(ins, attrs, ctx):
    return out(Out=x(ins, "X").to(dtype_of(attrs, attrs.get("out_dtype", "float32"))))


@register_op("reshape2")
def _reshape2(ins, attrs, ctx):
    v = x(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    # 0 means "copy this dim from input" (reference reshape_op.cc semantics)
    shape = ([v.shape[i] if s == 0 else s
              for i, s in enumerate(shape[:v.ndim])] + shape[v.ndim:])
    return out(Out=v.reshape(shape),
               XShape=v.new_zeros((0,) + tuple(v.shape)))


@register_op("concat")
def _concat(ins, attrs, ctx):
    return out(Out=torch.cat(ins["X"], dim=int(attrs.get("axis", 0))))


@register_op("stack")
def _stack(ins, attrs, ctx):
    return out(Y=torch.stack(ins["X"], dim=int(attrs.get("axis", 0))))


def _take_fill(v, idx):
    """Rows ``idx`` of ``v`` along axis 0 with ``jnp.take``'s default
    ("fill") semantics: a negative index counts from the end, and an index
    still outside [0, n) reads NaN (floats), the type's least value (signed
    integers), its largest (unsigned) or True (bool), and takes no
    gradient."""
    n = v.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    hit = (idx >= 0) & (idx < n)
    rows = v[idx.clamp(0, max(n - 1, 0))]
    if v.is_floating_point():
        fill = float("nan")
    elif v.dtype == torch.bool:
        fill = True
    elif v.dtype == torch.uint8:
        fill = torch.iinfo(v.dtype).max
    else:
        fill = torch.iinfo(v.dtype).min
    return torch.where(hit.reshape((-1,) + (1,) * (v.ndim - 1)), rows,
                       torch.full((), fill, dtype=v.dtype, device=v.device))


@register_op("gather")
def _gather(ins, attrs, ctx):
    v, idx = x(ins, "X"), x(ins, "Index")
    idx = idx.reshape(-1) if idx.ndim > 1 else idx
    return out(Out=_take_fill(v, idx))


@register_op("one_hot")
def _one_hot(ins, attrs, ctx):
    """An index outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot``."""
    v = x(ins, "X")
    depth = int(attrs["depth"])
    if v.ndim > 1 and v.shape[-1] == 1:
        v = v[..., 0]
    classes = torch.arange(depth, device=v.device)
    return out(Out=(v[..., None] == classes).to(torch.float32))


@register_op("increment")
def _increment(ins, attrs, ctx):
    """The step in the input's dtype (truncated for integers), as
    ``jnp.asarray(step, dtype=v.dtype)``."""
    v = x(ins, "X")
    step = attrs.get("step", 1.0)
    return out(Out=v + (step if v.is_floating_point() else int(step)))


@register_op("where")
def _where(ins, attrs, ctx):
    c, a, b = x(ins, "Condition"), x(ins, "X"), x(ins, "Y")
    return out(Out=torch.where(c, a, b))
