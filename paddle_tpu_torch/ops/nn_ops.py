"""NN op rules on tensors: activations, softmax, conv2d, pool2d and
cross_entropy (counterparts of the rules in ``paddle_tpu/ops/nn_ops.py``
that LeNet and the book's MLP run; the others wait).

Reference parity: operators/activation_op.cc, softmax_op.cc, conv_op.cc,
pool_op.cc, cross_entropy_op.cc.  NCHW, as the reference.  The JAX rules
leave the convolution and the pooling windows to XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``); here they go to
PyTorch's own ops.
"""

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import x, out
from .pooling_ops import ceil_pads


def _register_act(name, fn):
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        return out(Out=fn(x(ins, "X"), attrs))


_register_act("relu", lambda v, a: torch.relu(v))
_register_act("sigmoid", lambda v, a: torch.sigmoid(v))
_register_act("tanh", lambda v, a: torch.tanh(v))


@register_op("softmax")
def _softmax(ins, attrs, ctx):
    return out(Out=torch.softmax(x(ins, "X"), dim=int(attrs.get("axis", -1))))


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
    picked = torch.gather(p, -1, li.clamp(0, n_cls - 1)[..., None])
    # a label outside [0, C) reads NaN, as JAX's filling gather does; an
    # ignored row reads a real entry, so no NaN meets its zero gradient
    in_range = ((li >= 0) & (li < n_cls))[..., None]
    picked = torch.where(in_range | ignored, picked, float("nan"))
    loss = -torch.log(picked.clamp_min(1e-20))
    return out(Y=torch.where(ignored, torch.zeros((), dtype=loss.dtype,
                                                  device=loss.device), loss))
