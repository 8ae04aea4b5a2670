"""NN op rules on tensors: activations, softmax, dropout, conv2d, pool2d,
batch_norm, lookup_table and the losses cross_entropy,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits and
square_error_cost (counterparts of the
rules in ``paddle_tpu/ops/nn_ops.py`` that the Fluid slices run; the others
wait).

Reference parity: operators/activation_op.cc, softmax_op.cc,
dropout_op.cc, conv_op.cc, pool_op.cc, batch_norm_op.cc,
lookup_table_op.cc, cross_entropy_op.cc, softmax_with_cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, square_error_cost.  NCHW, as the reference.  The JAX rules leave the
convolution and the pooling windows to XLA (``lax.conv_general_dilated``,
``lax.reduce_window``); here they go to PyTorch's own ops.  ``dropout``
draws its mask from a ``torch`` generator (``common.op_generator``): the
same keep rate and scaling as the JAX rule's ``jax.random`` mask, not its
bits.
"""

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import (x, out, op_generator, promote_float, saturating_cast,
                     take_fill)
from .pooling_ops import ceil_pads


def _register_act(name, fn):
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        return out(Out=fn(x(ins, "X"), attrs))


# bool in int32, as jax.nn.relu's maximum with 0 (torch.relu refuses bool)
_register_act("relu", lambda v, a: torch.relu(
    v.int() if v.dtype == torch.bool else v))
_register_act("sigmoid", lambda v, a: torch.sigmoid(v))
_register_act("tanh", lambda v, a: torch.tanh(v))


@register_op("softmax")
def _softmax(ins, attrs, ctx):
    return out(Out=torch.softmax(promote_float(x(ins, "X")),
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
    u = torch.rand(v.shape, generator=op_generator(ctx, attrs),
                   device=v.device)
    mask = u < 1.0 - p
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    kept = v / (1.0 - p) if impl == "upscale_in_train" else v
    return out(Out=torch.where(mask, kept, zero).to(v.dtype),
               Mask=mask.to(v.dtype))


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


@register_op("conv2d")
def _conv2d(ins, attrs, ctx):
    v, w = x(ins, "Input"), x(ins, "Filter")
    r = F.conv2d(v, w, stride=_pair(attrs.get("strides", [1, 1])),
                 padding=_pair(attrs.get("paddings", [0, 0])),
                 dilation=_pair(attrs.get("dilations", [1, 1])),
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
    (hl, hh), (wl, wh) = (ceil_pads(v.shape[2 + i], k[i], s[i], p[i],
                                    attrs.get("ceil_mode", False))
                          for i in range(2))
    pads = (wl, wh, hl, hh)           # F.pad: last axis first
    if ptype == "max":
        # the window's first maximum takes the gradient, as XLA's
        # select_and_scatter does for lax.reduce_window(max)
        vp = F.pad(v, pads, value=float("-inf")) if any(pads) else v
        return out(Out=F.max_pool2d(vp, k, s))
    ssum = F.avg_pool2d(F.pad(v, pads), k, s, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones_like(v[:1, :1]), pads)
        cnt = F.avg_pool2d(ones, k, s, divisor_override=1)
    else:
        cnt = float(k[0] * k[1])
    return out(Out=ssum / cnt)


@register_op("batch_norm")
def _batch_norm(ins, attrs, ctx):
    """Batch statistics (population variance) in training, the running
    ones under is_test / use_global_stats; the running stats move by
    ``momentum`` without a gradient.  Computes in the input's dtype, as the
    JAX rule; an integer X normalises in f32 and Y goes back to its dtype
    (the statistics stay f32), as ``jnp.mean`` and ``astype`` do."""
    v = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    mean, var = x(ins, "Mean"), x(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    if attrs.get("_sync_axis"):
        raise NotImplementedError(
            "batch_norm over a mesh axis (sync BN) waits for data-parallel "
            "execution (ROADMAP Queue 1 item 5)")
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else v.ndim - 1
    axes = tuple(i for i in range(v.ndim) if i != c_axis)
    cshape = [1] * v.ndim
    cshape[c_axis] = -1
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        m, va = mean, var
        new_mean, new_var = mean, var
    else:
        m = promote_float(v).mean(dim=axes)
        va = promote_float(v).var(dim=axes, unbiased=False)
        new_mean = momentum * mean + (1.0 - momentum) * m.detach()
        new_var = momentum * var + (1.0 - momentum) * va.detach()
    y = (v - m.reshape(cshape)) * torch.rsqrt(va + eps).reshape(cshape)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return out(Y=saturating_cast(y, v.dtype), MeanOut=new_mean, VarianceOut=new_var,
               SavedMean=m, SavedVariance=va)


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
