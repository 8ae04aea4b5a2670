"""Pooling-family op rules beyond pool2d: pool3d, max_pool2d_with_index,
maxout, unpool and spp (counterparts of the rules in
``paddle_tpu/ops/pooling_ops.py``), with the window arithmetic that
``pool2d`` and ``layers.pool2d`` use.

Parity: operators/pool_op.cc (NCDHW avg/max, global, adaptive,
exclusive), pool_with_index_op.cc (+ math/pooling.cc: the mask is
h W + w within each (N, C) plane), maxout_op.cc, unpool_op.cc,
spp_op.cc.  NCHW / NCDHW, as the reference.
"""

import math

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import out, promote_float, saturating_cast, x


def pool_out_size(size, k, s, p, ceil_mode):
    """pool_op.cc PoolOutputSize: floor or ceil division of the window walk."""
    num = size + 2 * p - k
    return (num + s - 1) // s + 1 if ceil_mode else num // s + 1


def ceil_pads(size, k, s, p, ceil_mode):
    """(lo, hi) spatial pads; ceil_mode adds the extra high-side padding the
    reference's ceil output shape implies (pool_op.cc ceil_mode)."""
    if not ceil_mode:
        return (p, p)
    o = pool_out_size(size, k, s, p, True)
    extra = max((o - 1) * s + k - (size + 2 * p), 0)
    return (p, p + extra)


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(a) for a in v)
    return (int(v),) * n


def _f_pads(pairs):
    """[(lo, hi) per spatial axis, first axis first] as F.pad's flat list
    (last axis first)."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


def _back_to(r, dtype):
    """A float64 max of integer or bool values back to their dtype: a
    window wholly in the padding (-inf) gives the type's least value, or
    False, as XLA's -inf init value converts."""
    return r > 0 if dtype == torch.bool else saturating_cast(r, dtype)


def window_max(v, k, s, pairs, pool):
    """The max of each window after padding with -inf: ``pool`` (a torch
    max pool) sends the gradient to the window's first maximum, as XLA's
    select_and_scatter does for ``lax.reduce_window(max)``.  Integer and
    bool inputs pool in float64, exactly, and come back to their dtype."""
    w = v if v.is_floating_point() else v.double()
    pads = _f_pads(pairs)
    if any(pads):
        w = F.pad(w, pads, value=float("-inf"))
    r = pool(w, k, s)
    return r if v.is_floating_point() else _back_to(r, v.dtype)


def window_mean(v, k, s, pairs, pool, exclusive):
    """The sum of each zero-padded window over its count: the window's
    cells inside the input (``exclusive``) or all of them."""
    v = promote_float(v)
    pads = _f_pads(pairs)
    ssum = pool(F.pad(v, pads), k, s, divisor_override=1)
    if not exclusive:
        return ssum / float(math.prod(k))
    ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                      device=v.device)
    return ssum / pool(F.pad(ones, pads), k, s, divisor_override=1)


@register_op("pool3d")
def _pool3d(ins, attrs, ctx):
    """NCDHW max or avg pooling: global, adaptive (an even split of each
    axis), or windows with ``ceil_mode``'s extra high-side pad; a global
    or adaptive max splits tied maxima's gradient equally, as ``jnp.max``."""
    v = x(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return out(Out=v.amax(dim=(2, 3, 4), keepdim=True))
        return out(Out=promote_float(v).mean(dim=(2, 3, 4), keepdim=True))
    k = _tuple(attrs.get("ksize", [2, 2, 2]), 3)
    s = _tuple(attrs.get("strides", [1, 1, 1]), 3)
    p = _tuple(attrs.get("paddings", [0, 0, 0]), 3)
    if attrs.get("adaptive", False):
        n, c, d, h, w_ = v.shape
        od, oh, ow = k
        v8 = v.reshape(n, c, od, d // od, oh, h // oh, ow, w_ // ow)
        if ptype == "max":
            return out(Out=v8.amax(dim=(3, 5, 7)))
        return out(Out=promote_float(v8).mean(dim=(3, 5, 7)))
    pairs = [ceil_pads(v.shape[2 + i], k[i], s[i], p[i],
                       attrs.get("ceil_mode", False)) for i in range(3)]
    if ptype == "max":
        return out(Out=window_max(v, k, s, pairs, F.max_pool3d))
    return out(Out=window_mean(v, k, s, pairs, F.avg_pool3d,
                               attrs.get("exclusive", True)))


def _window_stack(v, k, s, p, fill):
    """[k0 k1, N, C, OH, OW]: each window offset's strided view of v padded
    by p a side with ``fill`` (the JAX rule's shift stack; floor output
    sizes, so ``ceil_mode`` is not read, as there)."""
    oh = (v.shape[2] + 2 * p[0] - k[0]) // s[0] + 1
    ow = (v.shape[3] + 2 * p[1] - k[1]) // s[1] + 1
    vp = F.pad(v, (p[1], p[1], p[0], p[0]), value=fill) if any(p) else v
    return torch.stack([
        vp[:, :, i:i + (oh - 1) * s[0] + 1:s[0], j:j + (ow - 1) * s[1] + 1:s[1]]
        for i in range(k[0]) for j in range(k[1])]), oh, ow


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ins, attrs, ctx):
    """Out the max of each window (tied maxima share the gradient equally,
    as ``jnp.max`` over the stack); Mask the flat index gh W + gw in its
    (N, C) plane of the window's first maximum (a NaN counts as the
    maximum, as ``jnp.argmax``).  The floor output size whatever
    ``ceil_mode`` says, as in the JAX rule; torch's
    ``max_pool2d(return_indices=True)`` gives the same flat indices only
    where the two agree on the output's size."""
    v = x(ins, "X")
    if attrs.get("global_pooling", False):
        k, s, p = (v.shape[2], v.shape[3]), (1, 1), (0, 0)
    else:
        k = _tuple(attrs.get("ksize", [2, 2]), 2)
        s = _tuple(attrs.get("strides", list(k)), 2)
        p = _tuple(attrs.get("paddings", [0, 0]), 2)
    w = v if v.is_floating_point() else v.double()
    # jnp.pad holds -inf in a bool as True (nonzero), so a bool window
    # touching the padding gives True, as in the JAX rule
    fill = 1.0 if v.dtype == torch.bool else float("-inf")
    stack, oh, ow = _window_stack(w, k, s, p, fill)
    o = stack.amax(dim=0)
    # the first maximum: NaN above everything, as jnp.argmax ranks it
    key = torch.where(torch.isnan(stack), float("inf"), stack)
    best = key.amax(dim=0, keepdim=True)
    first = (key == best) & ~(torch.isnan(stack) ^ torch.isnan(o)[None])
    arg = torch.argmax(first.to(torch.uint8), dim=0)
    gh = (torch.arange(oh, device=v.device)[None, None, :, None] * s[0]
          + arg // k[1] - p[0])
    gw = (torch.arange(ow, device=v.device)[None, None, None, :] * s[1]
          + arg % k[1] - p[1])
    if not v.is_floating_point():
        o = _back_to(o, v.dtype)
    return out(Out=o, Mask=(gh * v.shape[3] + gw).to(torch.int32))


@register_op("maxout")
def _maxout(ins, attrs, ctx):
    """The max over each group of ``groups`` consecutive channels along
    ``axis`` (a negative axis counts from the end); tied maxima share the
    gradient equally, as ``jnp.max``."""
    v = x(ins, "X")
    g = int(attrs["groups"])
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += v.ndim
    shape = tuple(v.shape[:axis]) + (v.shape[axis] // g, g) + tuple(v.shape[axis + 1:])
    return out(Out=v.reshape(shape).amax(dim=axis + 1))


@register_op("unpool")
def _unpool(ins, attrs, ctx):
    """Max-unpooling: each pooled value written at its Indices' flat place
    in an (H - 1) s - 2 p + k a side plane of zeros (a negative index
    counts from the plane's end, one still outside it is dropped, as JAX's
    ``.at[].set``; of repeated indices one write stands)."""
    v, idx = x(ins, "X"), x(ins, "Indices")
    k = _tuple(attrs.get("ksize", [2, 2]), 2)
    s = _tuple(attrs.get("strides", [2, 2]), 2)
    p = _tuple(attrs.get("paddings", [0, 0]), 2)
    n, c, h, w_ = v.shape
    oh = (h - 1) * s[0] - 2 * p[0] + k[0]
    ow = (w_ - 1) * s[1] - 2 * p[1] + k[1]
    plane = oh * ow
    idx = idx.reshape(n * c, -1).long()
    idx = torch.where(idx < 0, idx + plane, idx)
    idx = torch.where((idx >= 0) & (idx < plane), idx, plane)
    flat = torch.zeros((n * c, plane + 1), dtype=v.dtype, device=v.device)
    flat = flat.scatter(1, idx, v.reshape(n * c, -1))   # the last column drops
    return out(Out=flat[:, :plane].reshape(n, c, oh, ow))


@register_op("spp")
def _spp(ins, attrs, ctx):
    """Spatial pyramid pooling: level l pools 2^l x 2^l bins of ceil(H /
    bins) x ceil(W / bins) windows (stride the window, centred pads),
    flattened and concatenated; avg is exclusive (spp_op.h)."""
    v = x(ins, "X")
    height = int(attrs.get("pyramid_height", 1))
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w_ = v.shape
    levels = []
    for lvl in range(height):
        bins = 2 ** lvl
        kh, kw = math.ceil(h / bins), math.ceil(w_ / bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w_ + 1) // 2
        pairs = [(ph, ph), (pw, pw)]
        if ptype == "max":
            r = window_max(v, (kh, kw), (kh, kw), pairs, F.max_pool2d)
        else:
            r = window_mean(v, (kh, kw), (kh, kw), pairs, F.avg_pool2d, True)
        levels.append(r[:, :, :bins, :bins].reshape(n, -1))
    return out(Out=torch.cat(levels, dim=1))
