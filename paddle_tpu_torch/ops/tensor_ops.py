"""Tensor op rules: fill_constant, fill_constant_batch_size_like,
gaussian_random and uniform_random (the startup program's initializers),
and assign, cast, reshape2, transpose2, concat, split, squeeze2,
unsqueeze2, expand, stack, gather, one_hot, increment and where
(counterparts of the rules in ``paddle_tpu/ops/tensor_ops.py``; the others
wait).

Parity: operators/fill_constant_op.cc,
fill_constant_batch_size_like_op.cc, gaussian_random_op.cc,
uniform_random_op.cc, assign_op.cc, cast_op.cc, reshape_op.cc,
transpose_op.cc, concat_op.cc, split_op.cc, squeeze_op.cc,
unsqueeze_op.cc, expand_op.cc, stack_op.cc, gather_op.cc, one_hot_op.cc,
increment_op.cc, where_op.cc.  Random ops draw from ``torch`` generators
seeded per run and op (``common.op_generator``); they do not reproduce
``jax.random`` streams, only their distributions.
"""

import torch

from ..registry import register_op
from .common import x, out, op_generator, dtype_of, saturating_cast


def _fill_value(attrs):
    """The ``value`` attr converted as ``jnp.full`` converts it: a Python
    float through f32 (x64 off) then ``saturating_cast`` (NaN to 0, an
    integer type's range saturated, a float type's overflow to inf), an int
    or a bool as ``Tensor.to``."""
    value = attrs.get("value", 0.0)
    src = torch.tensor(value, dtype=torch.float32
                       if isinstance(value, float) else None)
    return saturating_cast(src, dtype_of(attrs)).item()


@register_op("fill_constant")
def _fill_constant(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    return out(Out=torch.full(shape, _fill_value(attrs),
                              dtype=dtype_of(attrs), device=ctx.device))


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ins, attrs, ctx):
    ref = x(ins, "Input")
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = ref.shape[
        int(attrs.get("input_dim_idx", 0))]
    return out(Out=torch.full(shape, _fill_value(attrs),
                              dtype=dtype_of(attrs), device=ref.device))


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
    """A float going to an integer type saturates, NaN to 0, as JAX's
    ``astype`` (``saturating_cast``)."""
    return out(Out=saturating_cast(
        x(ins, "X"), dtype_of(attrs, attrs.get("out_dtype", "float32"))))


def _xshape(v):
    return v.new_zeros((0,) + tuple(v.shape))


@register_op("reshape2")
def _reshape2(ins, attrs, ctx):
    v = x(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    # 0 means "copy this dim from input" (reference reshape_op.cc semantics)
    shape = ([v.shape[i] if s == 0 else s
              for i, s in enumerate(shape[:v.ndim])] + shape[v.ndim:])
    return out(Out=v.reshape(shape), XShape=_xshape(v))


@register_op("transpose2")
def _transpose2(ins, attrs, ctx):
    v = x(ins, "X")
    return out(Out=v.permute(*[int(a) for a in attrs["axis"]]),
               XShape=_xshape(v))


@register_op("split")
def _split(ins, attrs, ctx):
    """``sections`` (sizes) or ``num`` equal parts along ``axis``."""
    v = x(ins, "X")
    axis = int(attrs.get("axis", 0))
    sections = attrs.get("sections")
    if sections:
        parts = torch.split(v, [int(n) for n in sections], dim=axis)
    else:
        num = int(attrs.get("num", 0))
        if v.shape[axis] % num:
            raise ValueError("split: axis %d of size %d does not split into "
                             "%d equal parts" % (axis, v.shape[axis], num))
        parts = torch.split(v, v.shape[axis] // num, dim=axis)
    return out(Out=list(parts))


@register_op("squeeze2")
def _squeeze2(ins, attrs, ctx):
    """Drops the listed axes that have size 1 (all size-1 axes when none
    are listed); a listed axis of another size stays."""
    v = x(ins, "X")
    axes = attrs.get("axes") or [i for i, s in enumerate(v.shape) if s == 1]
    for ax in sorted(axes, reverse=True):
        if v.shape[ax] == 1:
            v = v.squeeze(ax)
    return out(Out=v, XShape=v.new_zeros((0,)))


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs, ctx):
    v = x(ins, "X")
    for ax in sorted(attrs["axes"]):
        v = v.unsqueeze(ax)
    return out(Out=v, XShape=v.new_zeros((0,)))


@register_op("expand")
def _expand(ins, attrs, ctx):
    """Tiles X ``expand_times`` along each axis (``jnp.tile``: a shorter
    list applies to the trailing axes)."""
    v = x(ins, "X")
    times = [int(t) for t in attrs["expand_times"]]
    return out(Out=v.repeat(*([1] * (v.ndim - len(times)) + times)))


@register_op("concat")
def _concat(ins, attrs, ctx):
    return out(Out=torch.cat(ins["X"], dim=int(attrs.get("axis", 0))))


@register_op("stack")
def _stack(ins, attrs, ctx):
    return out(Y=torch.stack(ins["X"], dim=int(attrs.get("axis", 0))))


def take_fill(v, idx):
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
    return out(Out=take_fill(v, idx))


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
    """A nonzero condition (NaN included) takes X, as ``jnp.where``."""
    c, a, b = x(ins, "Condition"), x(ins, "X"), x(ins, "Y")
    return out(Out=torch.where(c if c.dtype == torch.bool else c != 0, a, b))
