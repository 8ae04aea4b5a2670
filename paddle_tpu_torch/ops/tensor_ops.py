"""Tensor op rules: the fills (fill_constant, fill_constant_batch_size_like,
fill_zeros_like), the random initializers (gaussian_random,
truncated_gaussian_random, uniform_random, randint), assign,
assign_value, share_data, cast, the reshapes (reshape2, flatten2,
transpose2, squeeze2, unsqueeze2), concat, split, slice, strided_slice,
expand, expand_as, stack, unstack, the gathers and scatter, one_hot,
range, shape, increment, the pads, tile, where, linspace, diag, eye, flip,
roll and shard_index (counterparts of every rule in
``paddle_tpu/ops/tensor_ops.py``).  ``where_index`` and
``unique_with_counts`` refuse, as the JAX rules do: their output shapes
depend on the data.

Parity: operators/fill_constant_op.cc,
fill_constant_batch_size_like_op.cc, fill_zeros_like_op.cc,
gaussian_random_op.cc, truncated_gaussian_random_op.cc,
uniform_random_op.cc, randint_op.cc, assign_op.cc, assign_value_op.cc,
share_data_op.cc, cast_op.cc, reshape_op.cc, flatten_op.cc,
transpose_op.cc, concat_op.cc, split_op.cc, slice_op.cc,
strided_slice_op.cc, squeeze_op.cc, unsqueeze_op.cc, expand_op.cc,
expand_as_op.cc, stack_op.cc, unstack_op.cc, gather_op.cc,
gather_nd_op.cc, scatter_op.cc, one_hot_op.cc, range_op.cc, shape_op.cc,
increment_op.cc, pad2d_op.cc, pad_op.cc, tile_op.cc, where_op.cc,
linspace_op.cc, diag_op.cc, eye_op.cc, flip_op.cc, roll_op.cc,
shard_index_op.cc.  Random ops draw from ``torch`` generators seeded per
run and op (``common.op_generator``); they do not reproduce
``jax.random`` streams, only their distributions.
"""

import math

import torch

from ..registry import register_op
import numpy as np
import torch.nn.functional as F

from .common import (x, out, op_generator, dtype_of, saturating_cast,
                     take_clamp, take_fill)


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


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ins, attrs, ctx):
    """mean + std * a standard normal cut to [-2, 2], as
    ``jax.random.truncated_normal(key, -2, 2)``: the inverse normal CDF of
    a uniform draw between the CDF's values at -2 and 2 (another stream
    than JAX's, from ``op_generator``)."""
    shape = [int(s) for s in attrs["shape"]]
    gen = op_generator(ctx, attrs)
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=ctx.device) * (hi - lo) + lo
    v = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    return out(Out=(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * v)
               .to(dtype_of(attrs)))


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


@register_op("fill_zeros_like")
def _fill_zeros_like(ins, attrs, ctx):
    return out(Out=torch.zeros_like(x(ins, "X")))


@register_op("randint")
def _randint(ins, attrs, ctx):
    """Integers in [low, high) (int64 by default), from ``op_generator``:
    another stream than ``jax.random.randint``."""
    shape = [int(s) for s in attrs["shape"]]
    return out(Out=torch.randint(
        int(attrs.get("low", 0)), int(attrs.get("high", 100)), shape,
        generator=op_generator(ctx, attrs), dtype=dtype_of(attrs, "int64"),
        device=ctx.device))


@register_op("assign_value")
def _assign_value(ins, attrs, ctx):
    """``values`` as an array of ``dtype`` in its own shape (the ``shape``
    attr is not read, as in the JAX rule)."""
    return out(Out=torch.as_tensor(np.asarray(attrs["values"])).to(
        dtype_of(attrs)).to(ctx.device))


@register_op("share_data")
def _share_data(ins, attrs, ctx):
    return out(Out=x(ins, "X"))


@register_op("flatten2")
def _flatten2(ins, attrs, ctx):
    """[prod(shape[:axis]), prod(shape[axis:])]."""
    v = x(ins, "X")
    axis = int(attrs.get("axis", 1))
    lead = math.prod(v.shape[:axis]) if axis > 0 else 1
    return out(Out=v.reshape(lead, -1), XShape=_xshape(v))


@register_op("slice")
def _slice(ins, attrs, ctx):
    """Python slicing along ``axes``: negative starts and ends count from
    the end, ends past the axis stop at it."""
    v = x(ins, "Input")
    idx = [slice(None)] * v.ndim
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return out(Out=v[tuple(idx)])


@register_op("strided_slice")
def _strided_slice(ins, attrs, ctx):
    """Python slicing with a step along ``axes``.  A negative step (which
    torch's slicing refuses) slices the flipped axis with the positive
    step, from the mirrored start."""
    v = x(ins, "Input")
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                              attrs["strides"]):
        n = v.shape[ax]
        start, stop, step = slice(st, en, sd).indices(n)
        idx = [slice(None)] * v.ndim
        if step > 0:
            idx[ax] = slice(start, max(stop, start), step)
        else:
            v = torch.flip(v, (ax,))
            idx[ax] = slice(n - 1 - start, max(n - 1 - stop, n - 1 - start), -step)
        v = v[tuple(idx)]
    return out(Out=v)


@register_op("expand_as")
def _expand_as(ins, attrs, ctx):
    v, t = x(ins, "X"), x(ins, "target_tensor")
    return out(Out=torch.broadcast_to(v, t.shape))


@register_op("unstack")
def _unstack(ins, attrs, ctx):
    v = x(ins, "X")
    return out(Y=list(torch.unbind(v, dim=int(attrs.get("axis", 0)))))


@register_op("gather_nd")
def _gather_nd(ins, attrs, ctx):
    """X at the index tuples in the last axis of Index, as JAX indexes: a
    negative index counts from the end once, one still out of range reads
    the nearest element and takes no gradient (``take_clamp``)."""
    v, idx = x(ins, "X"), x(ins, "Index")
    return out(Out=take_clamp(v, *torch.unbind(idx, dim=-1)))


@register_op("scatter")
def _scatter(ins, attrs, ctx):
    """Rows ``Ids`` of X set to (``overwrite``, the default) or added with
    Updates, as ``.at[ids].set`` / ``.add``: a negative id counts from the
    end, one still out of range is dropped.  Dropped rows go to a scratch
    row past the end, so no mask and no host sync.  Under ``overwrite`` a
    repeated id keeps one of its updates, which one not being fixed (as in
    XLA)."""
    v, idx, upd = x(ins, "X"), x(ins, "Ids"), x(ins, "Updates")
    idx = idx.reshape(-1).long()
    n = v.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    padded = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
    padded = padded.index_put((idx,), upd.to(v.dtype),
                              accumulate=not attrs.get("overwrite", True))
    return out(Out=padded[:n])


@register_op("range")
def _range(ins, attrs, ctx):
    """From the attrs, ``jnp.arange(start, end, step, dtype)``; from the
    Start/End/Step tensors, Start + Step * arange(_static_len) in Start's
    dtype."""
    st, sp = x(ins, "Start"), x(ins, "Step")
    if st is None:
        return out(Out=torch.arange(attrs["start"], attrs["end"], attrs["step"],
                                    dtype=dtype_of(attrs), device=ctx.device))
    n = int(attrs["_static_len"])
    return out(Out=st + sp * torch.arange(n, dtype=st.dtype, device=st.device))


@register_op("shape")
def _shape(ins, attrs, ctx):
    v = x(ins, "Input")
    return out(Out=torch.tensor(tuple(v.shape), dtype=torch.int32,
                                device=v.device))


def _reflect_index(lo, n, hi, device):
    """The source index of each of lo + n + hi positions of an axis of n
    padded by reflection, as ``jnp.pad(mode="reflect")``: the walk bounces
    off both ends again and again (period 2 (n - 1)) however far the pad
    reaches; an axis of one repeats its element."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i < n, i, 2 * (n - 1) - i)


@register_op("pad2d")
def _pad2d(ins, attrs, ctx):
    """NCHW; paddings [top, bottom, left, right]; mode "constant"
    (``pad_value``), "reflect" (no edge repeat; a pad as long as the axis
    or longer reflects again, as ``jnp.pad``) or "edge" (bool as uint8:
    the replicate pad refuses bool)."""
    v = x(ins, "X")
    p = [int(i) for i in attrs["paddings"]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return out(Out=F.pad(v, (p[2], p[3], p[0], p[1]),
                             value=attrs.get("pad_value", 0.0)))
    if mode == "reflect":
        r = v.index_select(2, _reflect_index(p[0], v.shape[2], p[1], v.device))
        return out(Out=r.index_select(
            3, _reflect_index(p[2], v.shape[3], p[3], v.device)))
    w = v.to(torch.uint8) if v.dtype == torch.bool else v
    return out(Out=F.pad(w, (p[2], p[3], p[0], p[1]), mode="replicate")
               .to(v.dtype))


@register_op("pad")
def _pad(ins, attrs, ctx):
    """paddings [before0, after0, before1, after1, ...], constant."""
    v = x(ins, "X")
    p = [int(i) for i in attrs["paddings"]]
    pads = []
    for i in reversed(range(v.ndim)):
        pads += [p[2 * i], p[2 * i + 1]]
    return out(Out=F.pad(v, pads, value=attrs.get("pad_value", 0.0)))


@register_op("tile")
def _tile(ins, attrs, ctx):
    return out(Out=torch.tile(x(ins, "X"), tuple(int(t) for t in attrs["repeat_times"])))


@register_op("where_index")
def _where_index(ins, attrs, ctx):
    raise NotImplementedError(
        "where_index (nonzero) has a data-dependent output shape, which XLA "
        "cannot compile; use masked ops instead (SURVEY.md §7 'LoD/ragged')"
    )


@register_op("linspace")
def _linspace(ins, attrs, ctx):
    """``jnp.linspace``'s arithmetic in f32: start (1 - t) + stop t at
    t = i / (num - 1), the last value ``stop`` itself; integer dtypes take
    the floor."""
    dt = dtype_of(attrs)
    num = int(attrs["num"])
    start = torch.tensor(attrs["start"], dtype=torch.float32, device=ctx.device)
    stop = torch.tensor(attrs["stop"], dtype=torch.float32, device=ctx.device)
    if num > 1:
        t = torch.arange(num - 1, dtype=torch.float32, device=ctx.device) / (num - 1)
        r = torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])
    else:
        r = start.reshape(1)[:num]
    if not dt.is_floating_point:
        r = torch.floor(r)
    return out(Out=r.to(dt))


@register_op("diag")
def _diag(ins, attrs, ctx):
    return out(Out=torch.diag(x(ins, "Diagonal")))


@register_op("eye")
def _eye(ins, attrs, ctx):
    n = int(attrs["num_rows"])
    return out(Out=torch.eye(n, int(attrs.get("num_columns") or n),
                             dtype=dtype_of(attrs), device=ctx.device))


def _axes(a):
    return tuple(a) if isinstance(a, (list, tuple)) else (a,)


@register_op("flip")
def _flip(ins, attrs, ctx):
    return out(Out=torch.flip(x(ins, "X"), _axes(attrs["axis"])))


@register_op("roll")
def _roll(ins, attrs, ctx):
    """With no axis the flattened tensor rolls by the sum of the shifts,
    as ``jnp.roll`` rolls it by each in turn."""
    axis = attrs.get("axis")
    shifts = attrs["shifts"]
    shifts = tuple(shifts) if isinstance(shifts, (list, tuple)) else shifts
    if axis is None or axis == []:
        total = sum(shifts) if isinstance(shifts, tuple) else shifts
        return out(Out=torch.roll(x(ins, "X"), total))
    return out(Out=torch.roll(x(ins, "X"), shifts, _axes(axis)))


@register_op("unique_with_counts")
def _unique_with_counts(ins, attrs, ctx):
    raise NotImplementedError("unique has data-dependent shapes under XLA; use a host op")


@register_op("shard_index")
def _shard_index(ins, attrs, ctx):
    """An index in this shard becomes its offset in the shard; any other
    becomes ``ignore_value``.  Floor division, as ``//`` on JAX arrays."""
    v = x(ins, "X")
    nshards, shard_id = int(attrs["nshards"]), int(attrs["shard_id"])
    shard_size = (int(attrs["index_num"]) + nshards - 1) // nshards
    mask = torch.div(v, shard_size, rounding_mode="floor") == shard_id
    return out(Out=torch.where(mask, torch.remainder(v, shard_size),
                               torch.full((), int(attrs.get("ignore_value", -1)),
                                          dtype=v.dtype, device=v.device)))
