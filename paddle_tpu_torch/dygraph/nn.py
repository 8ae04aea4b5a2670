"""Dygraph layer library (parity: python/paddle/fluid/dygraph/nn.py — Conv2D,
Pool2D, FC, BatchNorm, Embedding, LayerNorm, GRUUnit, …).

The counterpart of the JAX package's ``dygraph/nn.py``, in torch ops with
the reference's semantics: an ``act`` name means the ``jax.nn`` function
(``gelu`` its tanh form, ``softmax`` over the last axis; ``_ACTS``);
``Pool2D`` ignores ``ceil_mode``, ``exclusive`` and ``use_cudnn``, its
average counts only the cells inside the input, its max pads with −inf
and sends a tie's gradient to the first maximum, and its global pools
split a tie's gradient evenly; ``BatchNorm`` in training mode uses the
population variance and updates its moving statistics outside the tape,
after the output; ``Embedding`` drops a trailing id axis of 1, gives NaN
rows for ids out of range (``take_fill``) and zeroes ``padding_idx``
rows.  The last nine layers run the registered op rules eagerly
(``_lowering_apply``), as program mode runs them."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..initializer import ConstantInitializer, NormalInitializer
from ..ops.common import take_fill
from ..registry import OpLoweringContext, get_lowering
from .base import VarBase, _apply, as_tensor
from .layers import Layer

__all__ = ["Conv2D", "Pool2D", "Linear", "FC", "BatchNorm", "Embedding",
           "LayerNorm", "GRUUnit", "Dropout", "NCE", "PRelu",
           "BilinearTensorProduct", "Conv2DTranspose", "SequenceConv",
           "RowConv", "GroupNorm", "SpectralNorm", "TreeConv"]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


# the jax.nn functions an ``act`` name reaches, with jax.nn's defaults
_ACTS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": lambda x: torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x))),
    "celu": lambda x: (torch.maximum(x, torch.zeros_like(x))
                       + torch.expm1(torch.minimum(x, torch.zeros_like(x)))),
    "selu": lambda x: 1.0507009873554804934193349852946 * torch.where(
        x > 0, x, 1.6732632423543772848170429916717
        * torch.expm1(torch.where(x > 0, 0.0, x))),
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "softplus": _softplus,
    "soft_sign": lambda x: x / (torch.abs(x) + 1),
    "silu": lambda x: x * torch.sigmoid(x),
    "swish": lambda x: x * torch.sigmoid(x),
    "log_sigmoid": lambda x: -_softplus(-x),
    "hard_tanh": lambda x: torch.where(x > 1, 1.0, torch.where(x < -1, -1.0, x)),
    "hard_sigmoid": _hard_sigmoid,
    "hard_silu": lambda x: x * _hard_sigmoid(x),
    "hard_swish": lambda x: x * _hard_sigmoid(x),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
}


def _act_fn(name, numpy_too=False):
    """The activation ``name``: a ``jax.nn`` function, or with
    ``numpy_too`` (Conv2D, FC, TreeConv) a ``jnp`` one of that name."""
    if name in _ACTS:
        return _ACTS[name]
    if numpy_too and hasattr(torch, name):
        return getattr(torch, name)
    raise AttributeError("no activation %r" % (name,))


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 2


class Conv2D(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        k = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._act = act
        self.weight = self.create_parameter(
            param_attr, [num_filters, num_channels // groups, k[0], k[1]], dtype,
            default_initializer=NormalInitializer(
                0.0, (2.0 / max(k[0] * k[1] * num_filters, 1)) ** 0.5))
        self.bias = self.create_parameter(bias_attr, [num_filters], dtype, is_bias=True)

    def forward(self, input):
        s, p, d, g = self._stride, self._padding, self._dilation, self._groups

        def conv(v, w):
            return F.conv2d(v, w, None, s, p, d, g)

        out = _apply(conv, input, self.weight)
        if self.bias is not None:
            out = _apply(lambda v, b: v + b.reshape(1, -1, 1, 1), out, self.bias)
        if self._act:
            out = _apply(_act_fn(self._act, numpy_too=True), out)
        return out


def _window_sum(v, k, s, p):
    """Each window's sum over the cells inside ``v`` (zero padding)."""
    if p[0] <= k[0] // 2 and p[1] <= k[1] // 2:
        return F.avg_pool2d(v, k, s, p, divisor_override=1)
    v = F.pad(v, (p[1], p[1], p[0], p[0]))
    return F.avg_pool2d(v, k, s, divisor_override=1)


class Pool2D(Layer):
    def __init__(self, name_scope=None, pool_size=-1, pool_type="max",
                 pool_stride=1, pool_padding=0, global_pooling=False,
                 use_cudnn=True, ceil_mode=False, exclusive=True):
        super().__init__(name_scope)
        self._k = _pair(pool_size)
        self._s = _pair(pool_stride)
        self._p = _pair(pool_padding)
        self._type = pool_type
        self._global = global_pooling

    def forward(self, input):
        k, s, p, ptype, gp = self._k, self._s, self._p, self._type, self._global

        def pool(v):
            if gp:
                if ptype == "max":
                    return torch.amax(v, dim=(2, 3), keepdim=True)
                return torch.mean(v, dim=(2, 3), keepdim=True)
            if ptype == "max":
                if p[0] <= k[0] // 2 and p[1] <= k[1] // 2:
                    return F.max_pool2d(v, k, s, p)
                v = F.pad(v, (p[1], p[1], p[0], p[0]), value=-math.inf)
                return F.max_pool2d(v, k, s)
            cnt = _window_sum(torch.ones_like(v[:1, :1]), k, s, p)
            return _window_sum(v, k, s, p) / cnt

        return _apply(pool, input)


class Linear(Layer):
    """2.0-style Linear; FC keeps the 1.x num_flatten_dims semantics."""

    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__("linear", dtype)
        self._act = act
        self.weight = self.create_parameter(param_attr, [input_dim, output_dim], dtype)
        self.bias = self.create_parameter(bias_attr, [output_dim], dtype, is_bias=True)

    def forward(self, input):
        out = _apply(torch.matmul, input, self.weight)
        if self.bias is not None:
            out = _apply(torch.add, out, self.bias)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class FC(Layer):
    """Parity: dygraph/nn.py FC — flattens input at num_flatten_dims."""

    def __init__(self, name_scope=None, size=None, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._nfd = num_flatten_dims
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        in_features = int(np.prod(input.shape[self._nfd:]))
        self.weight = self.create_parameter(self._param_attr, [in_features, self._size],
                                            self._dtype)
        self.bias = self.create_parameter(self._bias_attr, [self._size], self._dtype,
                                          is_bias=True)

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        nfd = self._nfd

        def matmul_flat(v, w):
            lead = tuple(v.shape[:nfd])
            return (v.reshape((int(np.prod(lead)), -1)) @ w).reshape(lead + (w.shape[1],))

        out = _apply(matmul_flat, input, self.weight)
        if self.bias is not None:
            out = _apply(torch.add, out, self.bias)
        if self._act:
            out = _apply(_act_fn(self._act, numpy_too=True), out)
        return out


class BatchNorm(Layer):
    def __init__(self, name_scope=None, num_channels=None, act=None,
                 is_test=False, momentum=0.9, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32", data_layout="NCHW",
                 use_global_stats=False):
        super().__init__(name_scope, dtype)
        c = num_channels
        self._momentum = momentum
        self._eps = epsilon
        self._act = act
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(param_attr, [c], dtype,
                                            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter(bias_attr, [c], dtype, is_bias=True)
        self._mean = VarBase(as_tensor(np.zeros(c, np.float32)),
                             stop_gradient=True, persistable=True)
        self._variance = VarBase(as_tensor(np.ones(c, np.float32)),
                                 stop_gradient=True, persistable=True)

    def forward(self, input):
        training = self.training and not self._use_global_stats
        eps = self._eps
        cshape = [1, -1] + [1] * (len(input.shape) - 2)

        if training:
            axes = tuple(i for i in range(len(input.shape)) if i != 1)
            stats = []

            def bn(v, scale, bias):
                m = torch.mean(v, dim=axes)
                va = torch.var(v, dim=axes, correction=0)
                stats.append((m.detach(), va.detach()))
                y = (v - m.reshape(cshape)) * torch.rsqrt(va + eps).reshape(cshape)
                return y * scale.reshape(cshape) + bias.reshape(cshape)

            out = _apply(bn, input, self.weight, self.bias)
            # moving averages updated out-of-tape
            m, va = stats[-1]
            self._mean.set_value(self._momentum * self._mean._value + (1 - self._momentum) * m)
            self._variance.set_value(
                self._momentum * self._variance._value + (1 - self._momentum) * va)
        else:
            def bn(v, scale, bias, m, va):
                y = (v - m.reshape(cshape)) * torch.rsqrt(va + eps).reshape(cshape)
                return y * scale.reshape(cshape) + bias.reshape(cshape)

            out = _apply(bn, input, self.weight, self.bias, self._mean, self._variance)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class Embedding(Layer):
    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            param_attr, list(size), dtype,
            default_initializer=NormalInitializer(0.0, 1.0 / np.sqrt(size[1])))

    def forward(self, input):
        pad = self._padding_idx

        def lookup(w, ids):
            if ids.ndim > 1 and ids.shape[-1] == 1:
                ids = ids[..., 0]
            r = take_fill(w, ids.reshape(-1)).reshape(tuple(ids.shape) + tuple(w.shape[1:]))
            if pad is not None and pad >= 0:
                r = torch.where((ids == pad)[..., None], 0.0, r)
            return r

        return _apply(lookup, self.weight, input)


class LayerNorm(Layer):
    def __init__(self, name_scope=None, normalized_shape=None, scale=True,
                 shift=True, begin_norm_axis=1, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        n = int(np.prod(normalized_shape)) if normalized_shape else None
        self._eps = epsilon
        self._begin = begin_norm_axis
        self._act = act
        self.weight = self.create_parameter(
            param_attr, [n], dtype, default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = self.create_parameter(bias_attr, [n], dtype, is_bias=True) if shift else None

    def forward(self, input):
        begin, eps = self._begin, self._eps

        def ln(v, *sb):
            axes = tuple(range(begin, v.ndim))
            m = torch.mean(v, dim=axes, keepdim=True)
            va = torch.var(v, dim=axes, keepdim=True, correction=0)
            y = (v - m) * torch.rsqrt(va + eps)
            i = 0
            if self.weight is not None:
                y = y * sb[i].reshape(v.shape[begin:])
                i += 1
            if self.bias is not None:
                y = y + sb[i].reshape(v.shape[begin:])
            return y

        args = [a for a in (self.weight, self.bias) if a is not None]
        out = _apply(ln, input, *args)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class GRUUnit(Layer):
    """Returns its new state three times; always tanh and sigmoid, as the
    reference's dygraph GRUUnit does."""

    def __init__(self, name_scope=None, size=None, param_attr=None,
                 bias_attr=None, activation="tanh", gate_activation="sigmoid",
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        d = size // 3
        self._d = d
        self.weight = self.create_parameter(param_attr, [d, d * 3], dtype)
        self.bias = self.create_parameter(bias_attr, [1, d * 3], dtype, is_bias=True)

    def forward(self, input, hidden):
        def gru(x, h, w, b):
            xg = x + b
            u_x, r_x, c_x = torch.chunk(xg, 3, dim=-1)
            hw = h @ w
            u_h, r_h, c_h = torch.chunk(hw, 3, dim=-1)
            u = torch.sigmoid(u_x + u_h)
            r = torch.sigmoid(r_x + r_h)
            c = torch.tanh(c_x + r * c_h)
            return u * h + (1 - u) * c

        new_h = _apply(gru, input, hidden, self.weight, self.bias)
        return new_h, new_h, new_h


class Dropout(Layer):
    """Draws its mask from a ``torch.Generator`` on the input's device,
    seeded from ``Dropout._seed`` (not ``jax.random``'s mask)."""

    _seed = 7

    def __init__(self, p=0.5):
        super().__init__("dropout")
        self._p = p

    def forward(self, input):
        if not self.training or self._p == 0.0:
            return input
        Dropout._seed += 1
        seed = Dropout._seed
        p = self._p

        def drop(v):
            gen = torch.Generator(v.device).manual_seed(seed)
            keep = torch.rand(v.shape, generator=gen, device=v.device) < 1 - p
            return torch.where(keep, v / (1 - p), 0.0)

        return _apply(drop, input)


# ---------------------------------------------------------------------------
# r5 completion batch (ref dygraph/nn.py:1837-2927): NCE, PRelu,
# BilinearTensorProduct, Conv2DTranspose, SequenceConv, RowConv, GroupNorm,
# SpectralNorm, TreeConv.  Each forwards through the SAME registered op
# rule the program-mode layer uses.
# ---------------------------------------------------------------------------

def _lowering_apply(op_type, slot_names, attrs, out_slot, *var_inputs,
                    seed_root=0):
    """Run a registered op rule eagerly over VarBase inputs (the whole rule
    is one tape node, like any eager op); its random ops draw from a
    generator seeded with ``seed_root``."""
    rule = get_lowering(op_type)

    def fn(*arrays):
        gen = torch.Generator(arrays[0].device).manual_seed(seed_root)
        ins = {slot: [a] for slot, a in zip(slot_names, arrays)}
        return rule(ins, attrs, OpLoweringContext(None, gen))[out_slot][0]

    return _apply(fn, *var_inputs)


class PRelu(Layer):
    """Parity: dygraph/nn.py PRelu (:2090) — modes all/channel/element."""

    def __init__(self, name_scope=None, mode="all", param_attr=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        assert mode in ("all", "channel", "element")
        self._mode = mode
        self._param_attr = param_attr
        self.weight = None
        if mode == "all":
            self.weight = self.create_parameter(
                param_attr, [1], dtype,
                default_initializer=ConstantInitializer(0.25))

    def _build_once(self, input):
        shape = ([input.shape[1]] if self._mode == "channel"
                 else list(input.shape[1:]))
        self.weight = self.create_parameter(
            self._param_attr, shape, self._dtype,
            default_initializer=ConstantInitializer(0.25))

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        return _lowering_apply("prelu", ("X", "Alpha"), {"mode": self._mode},
                               "Out", input, self.weight)


class BilinearTensorProduct(Layer):
    """Parity: dygraph/nn.py BilinearTensorProduct (:2178)."""

    def __init__(self, name_scope=None, size=None, name=None, act=None,
                 param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, x, y):
        self.weight = self.create_parameter(
            self._param_attr, [self._size, x.shape[-1], y.shape[-1]],
            self._dtype)
        self.bias = self.create_parameter(
            self._bias_attr, [1, self._size], self._dtype, is_bias=True)

    def forward(self, x, y):
        if self.weight is None:
            self._build_once(x, y)
        slots = ("X", "Y", "Weight") + (("Bias",) if self.bias is not None
                                        else ())
        args = (x, y, self.weight) + ((self.bias,) if self.bias is not None
                                      else ())
        out = _lowering_apply("bilinear_tensor_product", slots, {}, "Out",
                              *args)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class Conv2DTranspose(Layer):
    """Parity: dygraph/nn.py Conv2DTranspose (:2300) — NCHW/IOHW."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, output_size=None, padding=0, stride=1,
                 dilation=1, groups=1, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._attrs = {
            "strides": list(_pair(stride)),
            "paddings": list(_pair(padding)),
            "dilations": list(_pair(dilation)),
            "groups": groups,
        }
        self._act = act
        self._num_channels = num_channels
        self._num_filters = num_filters
        self._output_size = (
            output_size if output_size is None
            or isinstance(output_size, (list, tuple)) else (output_size,) * 2)
        self._param_attr = param_attr
        self._filter_size = filter_size
        self.weight = None
        if filter_size is not None:
            k = _pair(filter_size)
            self.weight = self.create_parameter(
                param_attr, [num_channels, num_filters, k[0], k[1]], dtype)
        elif output_size is None:
            raise ValueError(
                "Conv2DTranspose: give filter_size, or output_size to "
                "derive it (reference conv2d_transpose contract)")
        self.bias = self.create_parameter(bias_attr, [num_filters], dtype,
                                          is_bias=True)

    def _build_once(self, input):
        # derive filter size from output_size (ref layers/nn.py
        # conv2d_transpose: k = out - (in - 1) * stride + 2 * pad)
        s, p = self._attrs["strides"], self._attrs["paddings"]
        k = [self._output_size[i] - (input.shape[2 + i] - 1) * s[i]
             + 2 * p[i] for i in range(2)]
        assert min(k) >= 1, ("output_size %s unreachable from input %s"
                             % (self._output_size, input.shape))
        self.weight = self.create_parameter(
            self._param_attr,
            [self._num_channels, self._num_filters, k[0], k[1]], self._dtype)

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        out = _lowering_apply("conv2d_transpose", ("Input", "Filter"),
                              self._attrs, "Output", input, self.weight)
        if self.bias is not None:
            out = _apply(lambda v, b: v + b.reshape(1, -1, 1, 1), out,
                         self.bias)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class SequenceConv(Layer):
    """Parity: dygraph/nn.py SequenceConv (:2554) over the padded [N, T, D]
    sequence representation (optional seq_len masks the tail)."""

    def __init__(self, name_scope=None, num_filters=None, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._num_filters = num_filters
        self._filter_size = filter_size
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        d = input.shape[-1]
        self.weight = self.create_parameter(
            self._param_attr, [self._filter_size * d, self._num_filters],
            self._dtype)
        self.bias = self.create_parameter(
            self._bias_attr, [self._num_filters], self._dtype, is_bias=True)

    def forward(self, input, seq_len=None):
        if self.weight is None:
            self._build_once(input)
        attrs = {"contextLength": self._filter_size,
                 "contextStart": -(self._filter_size // 2),
                 "contextStride": 1}
        slots = ("X", "Filter") + (("SeqLen",) if seq_len is not None else ())
        args = (input, self.weight) + ((seq_len,) if seq_len is not None
                                       else ())
        out = _lowering_apply("sequence_conv", slots, attrs, "Out", *args)
        if self.bias is not None:
            out = _apply(torch.add, out, self.bias)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class RowConv(Layer):
    """Parity: dygraph/nn.py RowConv (:2648) — lookahead convolution."""

    def __init__(self, name_scope=None, future_context_size=2,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._k = future_context_size
        self._act = act
        self._param_attr = param_attr
        self.weight = None

    def _build_once(self, input):
        self.weight = self.create_parameter(
            self._param_attr, [self._k + 1, input.shape[-1]], self._dtype)

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        out = _lowering_apply("row_conv", ("X", "Filter"), {}, "Out", input,
                              self.weight)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class GroupNorm(Layer):
    """Parity: dygraph/nn.py GroupNorm (:2727)."""

    def __init__(self, name_scope=None, channels=None, groups=32,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups
        self._eps = epsilon
        self._act = act
        self.weight = self.create_parameter(
            param_attr, [channels], dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter(bias_attr, [channels], dtype,
                                          is_bias=True)

    def forward(self, input):
        attrs = {"groups": self._groups, "epsilon": self._eps}
        slots, args = ("X",), (input,)
        if self.weight is not None:
            slots, args = slots + ("Scale",), args + (self.weight,)
        if self.bias is not None:
            slots, args = slots + ("Bias",), args + (self.bias,)
        out = _lowering_apply("group_norm", slots, attrs, "Y", *args)
        if self._act:
            out = _apply(_act_fn(self._act), out)
        return out


class SpectralNorm(Layer):
    """Parity: dygraph/nn.py SpectralNorm (:2827) — power-iteration u/v kept
    as non-trainable state like the reference's persistable U/V vars."""

    def __init__(self, name_scope=None, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        self.weight_u = None
        self.weight_v = None

    def _build_once(self, weight):
        h = weight.shape[self._dim]
        w = int(np.prod(weight.shape)) // h
        rng = np.random.RandomState(0)
        self.weight_u = VarBase(
            as_tensor(rng.randn(h, 1).astype(self._dtype)), stop_gradient=True)
        self.weight_v = VarBase(
            as_tensor(rng.randn(w, 1).astype(self._dtype)), stop_gradient=True)

    def forward(self, weight):
        if self.weight_u is None:
            self._build_once(weight)
        attrs = {"dim": self._dim, "power_iters": self._power_iters,
                 "eps": self._eps}
        return _lowering_apply("spectral_norm", ("Weight", "U", "V"), attrs,
                               "Out", weight, self.weight_u, self.weight_v)


class TreeConv(Layer):
    """Parity: dygraph/nn.py TreeConv (:2927) — TBCNN tree convolution."""

    def __init__(self, name_scope=None, output_size=None, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._output_size = output_size
        self._num_filters = num_filters
        self._max_depth = max_depth
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, nodes_vector):
        f = nodes_vector.shape[-1]
        self.weight = self.create_parameter(
            self._param_attr,
            [f, 3, self._output_size, self._num_filters], self._dtype)
        self.bias = self.create_parameter(
            self._bias_attr, [self._num_filters], self._dtype, is_bias=True)

    def forward(self, nodes_vector, edge_set):
        if self.weight is None:
            self._build_once(nodes_vector)
        out = _lowering_apply("tree_conv",
                              ("NodesVector", "EdgeSet", "Filter"),
                              {"max_depth": self._max_depth}, "Out",
                              nodes_vector, edge_set, self.weight)
        if self.bias is not None:
            out = _apply(torch.add, out, self.bias)
        if self._act:
            out = _apply(_act_fn(self._act, numpy_too=True), out)
        return out


class NCE(Layer):
    """Parity: dygraph/nn.py NCE (:1837) — noise-contrastive estimation."""

    _seed_counter = 1000

    def __init__(self, name_scope=None, num_total_classes=None,
                 sample_weight=None, param_attr=None, bias_attr=None,
                 num_neg_samples=None, sampler="uniform", custom_dist=None,
                 seed=0, is_sparse=False, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._num_total_classes = num_total_classes
        self._num_neg_samples = (10 if num_neg_samples is None
                                 else int(num_neg_samples))
        self._sampler = sampler
        self._custom_dist = custom_dist
        self._seed = seed
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def _build_once(self, input):
        dim = input.shape[-1]
        self.weight = self.create_parameter(
            self._param_attr, [self._num_total_classes, dim], self._dtype)
        self.bias = self.create_parameter(
            self._bias_attr, [self._num_total_classes, 1], self._dtype,
            is_bias=True)

    def forward(self, input, label, sample_weight=None):
        if self.weight is None:
            self._build_once(input)
        NCE._seed_counter += 1
        sampler_id = {"uniform": 0, "log_uniform": 1,
                      "custom_dist": 2}[self._sampler]
        attrs = {"num_total_classes": self._num_total_classes,
                 "num_neg_samples": self._num_neg_samples,
                 "seed": self._seed, "sampler": sampler_id,
                 "is_sparse": False, "custom_neg_classes": []}
        slots = ("Input", "Label", "Weight")
        args = (input, label, self.weight)
        if self.bias is not None:
            slots, args = slots + ("Bias",), args + (self.bias,)
        if sample_weight is not None:
            slots, args = (slots + ("SampleWeight",),
                           args + (sample_weight,))
        if self._sampler == "custom_dist":
            if self._custom_dist is None:
                raise ValueError("NCE(sampler='custom_dist') needs "
                                 "custom_dist probabilities")
            probs = VarBase(as_tensor(np.asarray(self._custom_dist, np.float32),
                                      input._value.device),
                            stop_gradient=True)
            slots, args = (slots + ("CustomDistProbs",), args + (probs,))
        return _lowering_apply("nce", slots, attrs, "Cost", *args,
                               seed_root=NCE._seed_counter)
