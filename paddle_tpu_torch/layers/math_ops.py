"""Elementwise/scalar math layers (parity: layers/nn.py elementwise wrappers +
layers/ops.py generated unary ops).  A copy of the JAX package's
``layers/math_ops.py``."""

import numpy as np

from ..layer_helper import LayerHelper
from ..framework import Variable
from ..dtypes import is_floating

__all__ = [
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_pow",
    "elementwise_max",
    "elementwise_min",
    "elementwise_mod",
    "elementwise_floordiv",
    "scale",
    "abs",
    "sqrt",
    "rsqrt",
    "square",
    "exp",
    "log",
    "sin",
    "cos",
    "tanh",
    "sigmoid",
    "ceil",
    "floor",
    "round",
    "reciprocal",
    "sign",
    "erf",
    "pow",
    "clip",
    "clip_by_norm",
    "sums",
    "sum",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "equal",
    "not_equal",
    "logical_and",
    "logical_or",
]


def _broadcast_shape(s1, s2):
    if len(s2) > len(s1):
        s1, s2 = s2, s1
    return s1


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    dtype = x.dtype if is_floating(x.dtype) or not is_floating(y.dtype) else y.dtype
    if op_type in ("less_than", "less_equal", "greater_than", "greater_equal",
                   "equal", "not_equal", "logical_and", "logical_or", "logical_xor"):
        dtype = "bool"
    out = helper.create_variable_for_type_inference(
        dtype, _broadcast_shape(x.shape, y.shape))
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


def _elementwise_op_with_scalar(op_type, x, other, reverse=False):
    """Support `var + 3.0` style expressions (framework.Variable overloads)."""
    if not isinstance(other, Variable):
        val = np.asarray(other)
        from . import tensor as tensor_layers

        dt = x.dtype if val.dtype.kind in "fiub" else str(val.dtype)
        if val.dtype.kind == "f" and not is_floating(x.dtype):
            dt = "float32"
        other = tensor_layers.fill_constant(
            shape=list(val.shape) or [1], dtype=dt, value=float(val)
        )
    a, b = (other, x) if reverse else (x, other)
    return _elementwise(op_type, a, b)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def _cmp(op_type, x, y, out=None):
    """Comparison/logical builder shared with control_flow.py; when `out`
    (fluid's `cond=`) is given, the result is written into that variable."""
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def less_than(x, y, force_cpu=None, cond=None, name=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None, name=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None, name=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None, name=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None, name=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None, name=None):
    return _cmp("not_equal", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _cmp("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _cmp("logical_or", x, y, out)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def _unary(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs)
    return out


def abs(x, name=None):
    return _unary("abs", x, name)


def sqrt(x, name=None):
    return _unary("sqrt", x, name)


def rsqrt(x, name=None):
    return _unary("rsqrt", x, name)


def square(x, name=None):
    return _unary("square", x, name)


def exp(x, name=None):
    return _unary("exp", x, name)


def log(x, name=None):
    return _unary("log", x, name)


def sin(x, name=None):
    return _unary("sin", x, name)


def cos(x, name=None):
    return _unary("cos", x, name)


def tanh(x, name=None):
    return _unary("tanh", x, name)


def sigmoid(x, name=None):
    return _unary("sigmoid", x, name)


def ceil(x, name=None):
    return _unary("ceil", x, name)


def floor(x, name=None):
    return _unary("floor", x, name)


def round(x, name=None):
    return _unary("round", x, name)


def reciprocal(x, name=None):
    return _unary("reciprocal", x, name)


def sign(x, name=None):
    return _unary("sign", x, name)


def erf(x, name=None):
    return _unary("erf", x, name)


def pow(x, factor=1.0, name=None):
    return _unary("pow", x, name, factor=float(factor))


def clip(x, min, max, name=None):
    return _unary("clip", x, name, min=float(min), max=float(max))


def clip_by_norm(x, max_norm, name=None):
    return _unary("clip_by_norm", x, name, max_norm=float(max_norm))


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype, input[0].shape)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def sum(x):
    if isinstance(x, (list, tuple)):
        return sums(x)
    from .nn import reduce_sum

    return reduce_sum(x, dim=None)
