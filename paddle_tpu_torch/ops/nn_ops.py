"""NN op rules on tensors: the activations, prelu, softmax and
log_softmax, dropout, the convolutions (conv2d, depthwise_conv2d,
conv2d_transpose, conv3d), pool2d, the norms (batch_norm, layer_norm,
group_norm, instance_norm, l2_normalize), lookup_table, the losses, the
resizes (interpolate and its bilinear/nearest/trilinear types),
grid_sampler, pixel_shuffle, lrn, temporal_shift and multihead_matmul
(counterparts of every rule in ``paddle_tpu/ops/nn_ops.py``).

Reference parity: operators/activation_op.cc, prelu_op.cc, softmax_op.cc,
log_softmax_op.cc, dropout_op.cc, conv_op.cc, conv_transpose_op.cc,
pool_op.cc, batch_norm_op.cc, layer_norm_op.cc, group_norm_op.cc,
instance_norm_op.cc, norm_op.cc, lookup_table_op.cc, cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc, sigmoid_cross_entropy_with_logits_op.cc,
square_error_cost, huber_loss_op.cc, smooth_l1_loss_op.cc,
label_smooth_op.cc, kldiv_loss_op.cc, margin_rank_loss_op.cc,
interpolate_op.cc, grid_sampler_op.cc, pixel_shuffle_op.cc, lrn_op.cc,
temporal_shift_op.cc, fused/multihead_matmul_op.cu.  NCHW, as the
reference.  The JAX rules leave the convolution and the pooling windows
to XLA (``lax.conv_general_dilated``, ``lax.reduce_window``); here they go
to PyTorch's own ops.  The norms compose their statistics as the JAX
rules do (a mean, then the mean of the squared deviations), not through
``F.layer_norm``, which returns no statistics and rounds otherwise.
``dropout`` draws its mask from a ``torch`` generator
(``common.op_generator``): the same keep rate and scaling as the JAX
rule's ``jax.random`` mask, not its bits.
"""

import itertools
import math

import torch
import torch.nn.functional as F

from ..parallel import collectives as col
from ..registry import register_op
from .common import (exact_conv, exact_matmul, x, out, op_generator,
                     promote_float, saturating_cast, take_clamp, take_fill)
from .math_ops import _clip_values
from .pooling_ops import ceil_pads, window_max, window_mean


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def _max0(v):
    """``jnp.maximum(v, 0)``: a value exactly at 0 takes half the
    gradient."""
    return torch.maximum(v, _zero(v))


def _elu(v, alpha):
    """``jax.nn.elu``: the gradient at 0 is alpha."""
    pos = v > 0
    return torch.where(pos, v, alpha * torch.expm1(torch.where(pos, _zero(v), v)))


def _softplus(v):
    """``jax.nn.softplus``: log(1 + e^v) as ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, _zero(v))


def _register_act(name, fn, promote=True):
    """``promote``: integer and bool inputs compute in f32, as the JAX
    activations (a jax.nn function, or a clip or where with a float
    constant) promote them."""
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        v = x(ins, "X")
        return out(Out=fn(promote_float(v) if promote else v, attrs))


# bool in int32, as jax.nn.relu's maximum with 0 (torch.relu refuses bool)
_register_act("relu", lambda v, a: torch.relu(
    v.int() if v.dtype == torch.bool else v), promote=False)
_register_act("relu6", lambda v, a: _clip_values(v, 0.0, a.get("threshold", 6.0)))
_register_act("sigmoid", lambda v, a: torch.sigmoid(v))
_register_act("logsigmoid", lambda v, a: F.logsigmoid(v))
_register_act("tanh", lambda v, a: torch.tanh(v))
# +inf gives +inf, as jax.nn.gelu's x (1 + erf(x / sqrt 2)) / 2 (F.gelu's
# CPU kernel gives NaN there)
_register_act("gelu", lambda v, a: torch.where(v == math.inf, v, F.gelu(
    v, approximate="tanh" if a.get("approximate", False) else "none")))
# x >= 0 keeps x, so the gradient at 0 is 1, as jax.nn.leaky_relu
_register_act("leaky_relu", lambda v, a: torch.where(
    v >= 0, v, a.get("alpha", 0.02) * v))
_register_act("elu", lambda v, a: _elu(v, a.get("alpha", 1.0)))
_register_act("selu", lambda v, a: _SELU_SCALE * _elu(v, _SELU_ALPHA))
_register_act("softplus", lambda v, a: _softplus(v))
_register_act("softsign", lambda v, a: v / (1 + torch.abs(v)))
_register_act("softshrink", lambda v, a: torch.sign(v) * _max0(
    torch.abs(v) - a.get("lambda", 0.5)))
_register_act("hard_shrink", lambda v, a: torch.where(
    torch.abs(v) > a.get("threshold", 0.5), v, _zero(v)))
_register_act("hard_sigmoid", lambda v, a: _clip_values(
    a.get("slope", 0.2) * v + a.get("offset", 0.5), 0.0, 1.0))
_register_act("hard_swish", lambda v, a: v * _clip_values(
    v + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0)) / a.get("scale", 6.0))
_register_act("swish", lambda v, a: v * torch.sigmoid(a.get("beta", 1.0) * v))
_register_act("mish", lambda v, a: v * torch.tanh(_softplus(v)))
_register_act("thresholded_relu", lambda v, a: torch.where(
    v > a.get("threshold", 1.0), v, _zero(v)))
_register_act("stanh", lambda v, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * v))
_register_act("brelu", lambda v, a: _clip_values(v, a.get("t_min", 0.0),
                                                 a.get("t_max", 24.0)))


@register_op("prelu")
def _prelu(ins, attrs, ctx):
    """``mode`` "all" (one alpha), "channel" (one a channel, axis 1) or
    "element" (alpha broadcast as it is)."""
    v, alpha = x(ins, "X"), x(ins, "Alpha")
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (v.ndim - 2))
    return out(Out=torch.where(v > 0, v, alpha * v))


@register_op("softmax")
def _softmax(ins, attrs, ctx):
    return out(Out=torch.softmax(promote_float(x(ins, "X")),
                                 dim=int(attrs.get("axis", -1))))


@register_op("log_softmax")
def _log_softmax(ins, attrs, ctx):
    return out(Out=torch.log_softmax(promote_float(x(ins, "X")),
                                     dim=int(attrs.get("axis", -1))))


@register_op("dropout")
def _dropout(ins, attrs, ctx):
    """``downgrade_in_infer`` (the default) keeps the kept values as they
    are in training and scales by 1 - p in inference; ``upscale_in_train``
    scales the kept values by 1 / (1 - p) in training and passes inference
    through."""
    v = x(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or p == 0.0:
        if impl == "downgrade_in_infer":
            return out(Out=v * (1.0 - p) if p else v, Mask=torch.ones_like(v))
        return out(Out=v, Mask=torch.ones_like(v))
    return dropout_apply(v, dropout_draw(v.shape, attrs, ctx, v.device), attrs)


def dropout_draw(shape, attrs, ctx, device):
    """The uniform draw behind a training dropout's mask."""
    return torch.rand(shape, generator=op_generator(ctx, attrs), device=device)


def dropout_apply(v, u, attrs):
    """A training dropout of ``v`` given its draw ``u`` (a value is kept
    where ``u < 1 - p``)."""
    p = attrs.get("dropout_prob", 0.5)
    mask = u < 1.0 - p
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    kept = (v / (1.0 - p) if attrs.get("dropout_implementation")
            == "upscale_in_train" else v)
    return out(Out=torch.where(mask, kept, zero).to(v.dtype),
               Mask=mask.to(v.dtype))


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


@register_op("conv2d")
def _conv2d(ins, attrs, ctx):
    v, w = x(ins, "Input"), x(ins, "Filter")
    r = exact_conv(F.conv2d, v, w, stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])),
                   groups=int(attrs.get("groups", 1)))
    return out(Output=r)


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ins, attrs, ctx):
    """conv2d with ``groups`` set to the input's channels, whatever the
    attr says."""
    attrs = dict(attrs)
    attrs["groups"] = x(ins, "Input").shape[1]
    return _conv2d(ins, attrs, ctx)


@register_op("conv2d_transpose")
def _conv2d_transpose(ins, attrs, ctx):
    """The gradient of a convolution (Filter [in, out, kh, kw]): the
    output is (H - 1) stride - 2 pad + dilation (k - 1) + 1 a side, as the
    JAX rule's dilated convolution gives it; ``output_size`` is not read.
    ``groups`` > 1 is refused, as in the JAX rule."""
    v, w = x(ins, "Input"), x(ins, "Filter")
    if int(attrs.get("groups", 1)) != 1:
        raise NotImplementedError(
            "conv2d_transpose: groups > 1 is not supported on the TPU path")
    r = exact_conv(F.conv_transpose2d, v, w,
                   stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])))
    return out(Output=r)


@register_op("conv3d")
def _conv3d(ins, attrs, ctx):
    v, w = x(ins, "Input"), x(ins, "Filter")
    r = exact_conv(F.conv3d, v, w,
                   stride=_pair(attrs.get("strides", [1, 1, 1]), 3),
                   padding=_pair(attrs.get("paddings", [0, 0, 0]), 3),
                   dilation=_pair(attrs.get("dilations", [1, 1, 1]), 3),
                   groups=int(attrs.get("groups", 1)))
    return out(Output=r)


@register_op("pool2d")
def _pool2d(ins, attrs, ctx):
    v = x(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    if ptype != "max":
        v = promote_float(v)          # integers average in f32, as in JAX
    # amax, as jnp.max: tied maxima share the gradient equally
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return out(Out=v.amax(dim=(2, 3), keepdim=True))
        return out(Out=v.mean(dim=(2, 3), keepdim=True))
    k = _pair(attrs.get("ksize", [2, 2]))
    s = _pair(attrs.get("strides", [1, 1]))
    p = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("adaptive", False):
        n, c, h, w_ = v.shape
        oh, ow = k
        v6 = v.reshape(n, c, oh, h // oh, ow, w_ // ow)
        if ptype == "max":
            return out(Out=v6.amax(dim=(3, 5)))
        return out(Out=v6.mean(dim=(3, 5)))
    pairs = [ceil_pads(v.shape[2 + i], k[i], s[i], p[i],
                       attrs.get("ceil_mode", False)) for i in range(2)]
    if ptype == "max":
        return out(Out=window_max(v, k, s, pairs, F.max_pool2d))
    return out(Out=window_mean(v, k, s, pairs, F.avg_pool2d,
                               attrs.get("exclusive", True)))


@register_op("batch_norm")
def _batch_norm(ins, attrs, ctx):
    """Batch statistics (population variance) in training, the running
    ones under is_test / use_global_stats; the running stats move by
    ``momentum`` without a gradient.  Computes in the input's dtype, as the
    JAX rule; an integer X normalises in f32 and Y goes back to its dtype
    (the statistics stay f32), as ``jnp.mean`` and ``astype`` do.
    ``_sync_axis`` (sync BN) pmeans the mean and the mean square over that
    mesh axis, as the reference's ``:235-237``."""
    v = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    mean, var = x(ins, "Mean"), x(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else v.ndim - 1
    axes = tuple(i for i in range(v.ndim) if i != c_axis)
    cshape = [1] * v.ndim
    cshape[c_axis] = -1
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        m, va = mean, var
        new_mean, new_var = mean, var
    else:
        # the mean, then the mean of the squared deviations, as jnp.var
        m, va = (t.reshape(-1) for t in _moments(promote_float(v), axes))
        if attrs.get("_sync_axis"):  # sync BN over a mesh axis
            ax = attrs["_sync_axis"]
            m = col.pmean(m, ax)
            va = col.pmean(torch.square(promote_float(v)).mean(dim=axes),
                           ax) - torch.square(m)
        new_mean = momentum * mean + (1.0 - momentum) * m.detach()
        new_var = momentum * var + (1.0 - momentum) * va.detach()
    y = (v - m.reshape(cshape)) * torch.rsqrt(va + eps).reshape(cshape)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return out(Y=saturating_cast(y, v.dtype), MeanOut=new_mean, VarianceOut=new_var,
               SavedMean=m, SavedVariance=va)


def _moments(v, dims):
    """``jnp.mean`` and ``jnp.var`` over ``dims`` (kept): the mean, then
    the mean of the squared deviations from it."""
    m = v.mean(dim=dims, keepdim=True)
    return m, torch.square(v - m).mean(dim=dims, keepdim=True)


def _scale_shift(y, scale, bias, shape):
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register_op("layer_norm")
def _layer_norm(ins, attrs, ctx):
    """Statistics over the axes from ``begin_norm_axis`` on, in f32; Y in
    the input's dtype; Mean and Variance (the population variance) of
    shape X.shape[:begin_norm_axis]."""
    v = x(ins, "X")
    begin = int(attrs.get("begin_norm_axis", 1))
    dims = tuple(range(begin, v.ndim))
    m, va = _moments(v.float(), dims)
    y = (promote_float(v) - m) * torch.rsqrt(va + attrs.get("epsilon", 1e-5))
    y = _scale_shift(y, x(ins, "Scale"), x(ins, "Bias"), v.shape[begin:])
    return out(Y=saturating_cast(y, v.dtype), Mean=m.reshape(v.shape[:begin]),
               Variance=va.reshape(v.shape[:begin]))


@register_op("group_norm")
def _group_norm(ins, attrs, ctx):
    """NCHW; statistics per sample and group in the input's dtype.  Mean
    and Variance drop every unit dim (``jnp.squeeze``), so a batch of 1 or
    one group changes their shape.  Integer and bool inputs normalise in
    f32, as ``jnp.mean`` promotes them."""
    v = promote_float(x(ins, "X"))
    g = int(attrs.get("groups", 32))
    n, c = v.shape[0], v.shape[1]
    vg = v.reshape((n, g, c // g) + tuple(v.shape[2:]))
    m, va = _moments(vg, tuple(range(2, vg.ndim)))
    y = ((vg - m) * torch.rsqrt(va + attrs.get("epsilon", 1e-5))).reshape(v.shape)
    y = _scale_shift(y, x(ins, "Scale"), x(ins, "Bias"),
                     [1, c] + [1] * (v.ndim - 2))
    return out(Y=y, Mean=m.squeeze(), Variance=va.squeeze())


@register_op("instance_norm")
def _instance_norm(ins, attrs, ctx):
    v = promote_float(x(ins, "X"))
    m, va = _moments(v, tuple(range(2, v.ndim)))
    y = (v - m) * torch.rsqrt(va + attrs.get("epsilon", 1e-5))
    y = _scale_shift(y, x(ins, "Scale"), x(ins, "Bias"),
                     [1, v.shape[1]] + [1] * (v.ndim - 2))
    return out(Y=y, SavedMean=m.squeeze(), SavedVariance=va.squeeze())


@register_op("l2_normalize")
def _l2_normalize(ins, attrs, ctx):
    v = x(ins, "X")
    norm = torch.sqrt(torch.square(v).sum(dim=int(attrs.get("axis", -1)),
                                          keepdim=True)
                      + attrs.get("epsilon", 1e-10))
    return out(Out=v / norm, Norm=norm)


@register_op("lookup_table")
def _lookup_table(ins, attrs, ctx):
    """Rows of W at Ids (a trailing Ids dim of 1 is dropped) with
    ``jnp.take``'s semantics: an id in [-V, 0) counts from the end, any
    other id outside [0, V) reads a NaN row and takes no gradient.  Rows
    at ``padding_idx`` read zeros."""
    w, ids = x(ins, "W"), x(ins, "Ids")
    padding_idx = int(attrs.get("padding_idx", -1))
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    r = take_fill(w, ids.reshape(-1)).reshape(tuple(ids.shape) + tuple(w.shape[1:]))
    if padding_idx >= 0:
        r = torch.where((ids == padding_idx)[..., None],
                        torch.zeros((), dtype=r.dtype, device=r.device), r)
    return out(Out=r)


register_op("lookup_table_v2")(_lookup_table)


def _squeeze_label(label):
    if label.ndim > 1 and label.shape[-1] == 1:
        return label[..., 0]
    return label


@register_op("cross_entropy")
def _cross_entropy(ins, attrs, ctx):
    p, label = x(ins, "X"), x(ins, "Label")
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(p.clamp_min(1e-20))).sum(-1, keepdim=True)
        return out(Y=loss)
    li = _squeeze_label(label).long()
    ignore = int(attrs.get("ignore_index", -100))
    ignored = (li == ignore)[..., None]
    n_cls = p.shape[-1]
    # a label in [-C, 0) counts from the end and any other label outside
    # [0, C) reads NaN, as JAX's filling gather does; an ignored row reads a
    # real entry, so no NaN meets its zero gradient
    li = torch.where(li < 0, li + n_cls, li)
    picked = torch.gather(p, -1, li.clamp(0, n_cls - 1)[..., None])
    in_range = ((li >= 0) & (li < n_cls))[..., None]
    picked = torch.where(in_range | ignored, picked, float("nan"))
    loss = -torch.log(picked.clamp_min(1e-20))
    return out(Y=torch.where(ignored, torch.zeros((), dtype=loss.dtype,
                                                  device=loss.device), loss))


def _pick(logp, li, axis):
    """``take_along_axis(logp, li[..., None], axis)`` with JAX's fill
    semantics: a label in [-C, 0) counts from the end; any other label
    outside [0, C) picks NaN (and no gradient)."""
    n_cls = logp.shape[axis]
    li = torch.where(li < 0, li + n_cls, li).unsqueeze(axis)
    in_range = (li >= 0) & (li < n_cls)
    picked = torch.gather(logp, axis, li.clamp(0, n_cls - 1))
    return torch.where(in_range, picked, float("nan"))


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ins, attrs, ctx):
    logits, label = promote_float(x(ins, "Logits")), x(ins, "Label")
    axis = int(attrs.get("axis", -1)) % logits.ndim
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        li = _squeeze_label(label).long()
        loss = -_pick(logp, li, axis)
        ignore = int(attrs.get("ignore_index", -100))
        loss = torch.where(li.unsqueeze(axis) == ignore,
                           torch.zeros((), dtype=loss.dtype,
                                       device=loss.device), loss)
    return out(Loss=loss, Softmax=torch.exp(logp))


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ins, attrs, ctx):
    """max(x, 0) - x * label + log1p(exp(-|x|)), 0 where label equals
    ignore_index; ``normalize`` divides by the count of other labels."""
    v, label = x(ins, "X"), x(ins, "Label")
    label = label.to(v.dtype)
    loss = torch.clamp(v, min=0.0) - v * label + torch.log1p(torch.exp(-torch.abs(v)))
    ignore = attrs.get("ignore_index", -100)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(label == ignore, zero, loss)
    if attrs.get("normalize", False):
        norm = torch.clamp(torch.sum((label != ignore).to(loss.dtype)),
                           min=1.0)
        loss = loss / norm
    return out(Out=loss)


@register_op("square_error_cost")
def _square_error_cost(ins, attrs, ctx):
    return out(Out=torch.square(x(ins, "X") - x(ins, "Y")))


@register_op("huber_loss")
def _huber_loss(ins, attrs, ctx):
    v, label = x(ins, "X"), x(ins, "Y")
    d = attrs.get("delta", 1.0)
    r = label - v
    ar = torch.abs(r)
    loss = torch.where(ar <= d, 0.5 * torch.square(r), d * (ar - 0.5 * d))
    return out(Out=loss, Residual=r)


@register_op("smooth_l1_loss")
def _smooth_l1(ins, attrs, ctx):
    """The elementwise loss summed over every axis but the first, as an
    [N, 1] column (a 1-D input sums nothing); the weight inputs are not
    read, as in the JAX rule."""
    v, label = x(ins, "X"), x(ins, "Y")
    sigma2 = attrs.get("sigma", 1.0) ** 2
    diff = v - label
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * torch.square(diff),
                       ad - 0.5 / sigma2)
    if v.ndim > 1:
        elem = elem.sum(dim=tuple(range(1, v.ndim)))
    return out(Out=elem.reshape(-1, 1), Diff=diff)


@register_op("label_smooth")
def _label_smooth(ins, attrs, ctx):
    """(1 - eps) x + eps / k over the last axis of k classes; PriorDist is
    not read, as in the JAX rule."""
    v = x(ins, "X")
    eps = attrs.get("epsilon", 0.1)
    return out(Out=(1.0 - eps) * v + eps / v.shape[-1])


@register_op("kldiv_loss")
def _kldiv_loss(ins, attrs, ctx):
    """target (log(max(target, 1e-20)) - x), reduced by ``reduction``:
    "mean" (the default), "sum", "batchmean" (the sum over the batch size)
    or "none"."""
    v, t = promote_float(x(ins, "X")), promote_float(x(ins, "Target"))
    tiny = torch.tensor(1e-20, dtype=t.dtype, device=t.device)
    loss = t * (torch.log(torch.maximum(t, tiny)) - v)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / v.shape[0]
    return out(Loss=loss)


@register_op("margin_rank_loss")
def _margin_rank_loss(ins, attrs, ctx):
    l, r, label = x(ins, "X1"), x(ins, "X2"), x(ins, "Label")
    o = _max0(-label * (l - r) + attrs.get("margin", 0.0))
    return out(Out=o, Activated=(o > 0).to(l.dtype))


@register_op("interpolate")
def _interpolate(ins, attrs, ctx):
    """``jax.image.resize`` to (out_h, out_w): "nearest" samples at
    half-pixel centres (``nearest-exact``); any other ``interp_method`` is
    bilinear with half-pixel centres, antialiased when it shrinks an axis
    (JAX scales the triangle kernel by the shrink factor).
    ``align_corners``, ``align_mode`` and ``scale`` are not read, as in the
    JAX rule."""
    v = x(ins, "X")
    size = (int(attrs["out_h"]), int(attrs["out_w"]))
    if attrs.get("interp_method", "bilinear") == "nearest":
        # a gather: integers and bool pass through float64 exactly
        w = v if v.is_floating_point() else v.double()
        r = F.interpolate(w, size=size, mode="nearest-exact")
    else:
        r = F.interpolate(promote_float(v), size=size, mode="bilinear",
                          align_corners=False, antialias=True)
    # integers truncate and saturate, bool is "nonzero", as astype
    return out(Out=saturating_cast(r, v.dtype))


register_op("bilinear_interp")(_interpolate)
register_op("nearest_interp")(_interpolate)


@register_op("grid_sampler")
def _grid_sampler(ins, attrs, ctx):
    """Bilinear sampling of X (NCHW) at Grid (NHW2, x then y, in [-1, 1]
    with the corners at -1 and 1); corners outside the image read the
    nearest edge pixel."""
    v, grid = x(ins, "X"), x(ins, "Grid")
    n, c, h, w = v.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx).to(torch.int32)
    y0 = torch.floor(gy).to(torch.int32)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = gx - x0, gy - y0
    batch = torch.arange(n, device=v.device)[:, None, None]

    def gather(yy, xx):                        # N, H, W, C
        return v[batch, :, yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]

    r = (gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
         + gather(y0, x1) * (wx * (1 - wy))[..., None]
         + gather(y1, x0) * ((1 - wx) * wy)[..., None]
         + gather(y1, x1) * (wx * wy)[..., None])
    return out(Output=r.permute(0, 3, 1, 2))


@register_op("pixel_shuffle")
def _pixel_shuffle(ins, attrs, ctx):
    v = x(ins, "X")
    r = int(attrs.get("upscale_factor", 2))
    n, c, h, w = v.shape
    v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return out(Out=v.reshape(n, c // (r * r), h * r, w * r))


@register_op("lrn")
def _lrn(ins, attrs, ctx):
    """Across channels (NCHW): the sum of squares over a window of n
    channels, added one shifted slice at a time as the JAX rule adds
    them."""
    v = x(ins, "X")
    n_ = int(attrs.get("n", 5))
    k, alpha, beta = (attrs.get("k", 1.0), attrs.get("alpha", 1e-4),
                      attrs.get("beta", 0.75))
    pad = n_ // 2
    sqp = F.pad(torch.square(v), (0, 0, 0, 0, pad, pad))
    acc = sqp[:, 0:v.shape[1]]
    for i in range(1, n_):
        acc = acc + sqp[:, i:i + v.shape[1]]
    return out(Out=v / torch.pow(k + alpha * acc, beta), MidOut=acc)


@register_op("temporal_shift")
def _temporal_shift(ins, attrs, ctx):
    """[N T, C, H, W]: the first ``shift_ratio`` of the channels take the
    next frame's values, the second the previous frame's, zero past the
    ends; the rest stay."""
    v = x(ins, "X")
    seg = int(attrs["seg_num"])
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = v.shape
    v5 = v.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    fwd = F.pad(v5[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    back = F.pad(v5[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    return out(Out=torch.cat([fwd, back, v5[:, :, c2:]], dim=2)
               .reshape(nt, c, h, w))


@register_op("multihead_matmul")
def _multihead_matmul(ins, attrs, ctx):
    """Attention as the JAX rule composes it: einsum, scale, bias,
    softmax, einsum (not a fused attention kernel)."""
    q, k, v = x(ins, "Q"), x(ins, "K"), promote_float(x(ins, "V"))
    bias_qk = x(ins, "BiasQK")
    if q.is_floating_point():
        s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    else:
        # integer and bool scores as JAX's einsum gives them, then f32
        s = promote_float(exact_matmul(q, k.transpose(-1, -2)))
    s = s * attrs.get("alpha", 1.0)
    if bias_qk is not None:
        s = s + bias_qk
    p = torch.softmax(s, dim=-1)
    return out(Out=torch.einsum("bhqk,bhkd->bhqd", p, v))


def _linear_taps(out_n, in_n, align, device):
    """The two source indices (clamped to the axis, as ``map_coordinates``
    with mode "nearest") and their weights for each of ``out_n`` outputs,
    from the f32 coordinates the JAX rule computes."""
    idx = torch.arange(out_n, dtype=torch.float32, device=device)
    if align and out_n > 1:
        c = idx * (in_n - 1) / (out_n - 1)
    else:
        c = ((idx + 0.5) * in_n / out_n - 0.5).clamp(0, in_n - 1)
    lo = torch.floor(c)
    w1 = c - lo
    lo = lo.long()
    return ((lo.clamp(0, in_n - 1), 1 - w1),
            ((lo + 1).clamp(0, in_n - 1), w1))


@register_op("trilinear_interp")
def _trilinear_interp(ins, attrs, ctx):
    """NCDHW resize to (out_d, out_h, out_w), in f32 and back to the
    input's dtype.  ``align_corners`` defaults to True (source coordinate
    idx (in - 1) / (out - 1)); False samples at half-pixel centres, clamped
    to the axis.  The eight corners are summed in ``map_coordinates``'s
    order, each gather times the product of its three weights."""
    v = x(ins, "X")
    align = attrs.get("align_corners", True)
    taps = [_linear_taps(int(attrs[k]), v.shape[2 + i], align, v.device)
            for i, k in enumerate(("out_d", "out_h", "out_w"))]
    vf = v.float()
    r = None
    for (iz, wz), (iy, wy), (ix, wx) in itertools.product(*taps):
        g = vf[:, :, iz[:, None, None], iy[None, :, None], ix[None, None, :]]
        t = g * (wz[:, None, None] * wy[None, :, None] * wx[None, None, :])
        r = t if r is None else r + t
    return out(Out=r.to(v.dtype))
