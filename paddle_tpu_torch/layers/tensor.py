"""Tensor layers (parity: layers/tensor.py — fill_constant, cast, concat,
assign, zeros/ones, create_global_var, argmax/argsort…).  A copy of the JAX
package's ``layers/tensor.py``."""

import numpy as np

from ..layer_helper import LayerHelper
from ..framework import Variable, default_startup_program
from ..initializer import ConstantInitializer

__all__ = [
    "fill_constant",
    "fill_constant_batch_size_like",
    "cast",
    "concat",
    "assign",
    "zeros",
    "ones",
    "zeros_like",
    "create_tensor",
    "create_global_var",
    "argmax",
    "argmin",
    "argsort",
    "reverse",
    "linspace",
    "range",
    "diag",
    "eye",
    "one_hot",
    "stack",
    "unstack",
    "gather",
    "gather_nd",
    "scatter",
    "where",
    "increment",
    "shape",
    "slice",
]


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": out.dtype, "value": float(value)},
    )
    return out


def fill_constant_batch_size_like(
    input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0, name=None
):
    helper = LayerHelper("fill_constant_batch_size_like", name=name)
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": [int(s) for s in shape],
            "dtype": out.dtype,
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype, x.shape)
    helper.append_op(
        type="cast", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"out_dtype": out.dtype}
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = list(input[0].shape)
    if shape:
        ax = axis if axis >= 0 else axis + len(shape)
        tot = 0
        for v in input:
            if v.shape[ax] < 0:
                tot = -1
                break
            tot += v.shape[ax]
        shape[ax] = tot
    out = helper.create_variable_for_type_inference(input[0].dtype, tuple(shape))
    helper.append_op(
        type="concat", inputs={"X": list(input)}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype, input.shape)
        helper.append_op(type="assign", inputs={"X": [input]}, outputs={"Out": [output]})
    else:
        value = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(str(value.dtype), value.shape)
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={"shape": list(value.shape), "dtype": output.dtype, "values": value},
        )
    return output


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.global_block().create_var(
        name=name, dtype=dtype, shape=(), persistable=persistable
    )


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """Parity: layers/tensor.py create_global_var — var lives in the global
    block and is initialized by the startup program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.main_program.global_block().create_var(
        name=name or helper.name, shape=tuple(shape), dtype=dtype,
        persistable=persistable, stop_gradient=True,
    )
    sblock = default_startup_program().global_block()
    if var.name not in sblock.vars:
        svar = sblock.create_var(
            name=var.name, shape=tuple(shape), dtype=dtype, persistable=persistable
        )
        ConstantInitializer(value)(svar, sblock)
    return var


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    shape = tuple(s for i, s in enumerate(x.shape) if i != (axis % len(x.shape)))
    out = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op(
        type="arg_max", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def argmin(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    shape = tuple(s for i, s in enumerate(x.shape) if i != (axis % len(x.shape)))
    out = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op(
        type="arg_min", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    ids = helper.create_variable_for_type_inference("int64", x.shape)
    helper.append_op(
        type="argsort",
        inputs={"X": [x]},
        outputs={"Out": [out], "Indices": [ids]},
        attrs={"axis": axis, "descending": descending},
    )
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="flip", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": axis if isinstance(axis, (list, tuple)) else [axis]},
    )
    return out


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype, (int(num),))
    helper.append_op(
        type="linspace", outputs={"Out": [out]},
        attrs={"start": float(start), "stop": float(stop), "num": int(num), "dtype": out.dtype},
    )
    return out


def range(start, end, step, dtype="float32"):
    helper = LayerHelper("range")
    n = int(np.ceil((end - start) / step))
    out = helper.create_variable_for_type_inference(dtype, (n,))
    helper.append_op(
        type="range", outputs={"Out": [out]},
        attrs={"start": start, "end": end, "step": step, "dtype": out.dtype},
    )
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    n = diagonal.shape[0]
    out = helper.create_variable_for_type_inference(diagonal.dtype, (n, n))
    helper.append_op(type="diag", inputs={"Diagonal": [diagonal]}, outputs={"Out": [out]})
    return out


def eye(num_rows, num_columns=None, dtype="float32"):
    helper = LayerHelper("eye")
    nc = num_columns or num_rows
    out = helper.create_variable_for_type_inference(dtype, (num_rows, nc))
    helper.append_op(
        type="eye", outputs={"Out": [out]},
        attrs={"num_rows": num_rows, "num_columns": nc, "dtype": out.dtype},
    )
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    shape = tuple(input.shape[:-1] if input.shape and input.shape[-1] == 1 else input.shape) + (depth,)
    out = helper.create_variable_for_type_inference("float32", shape)
    helper.append_op(
        type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"depth": depth}
    )
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(xs[0].dtype, tuple(shape))
    helper.append_op(type="stack", inputs={"X": list(xs)}, outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    shape = tuple(s for i, s in enumerate(x.shape) if i != (axis % len(x.shape)))
    outs = [helper.create_variable_for_type_inference(x.dtype, shape) for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs}, attrs={"axis": axis})
    return outs


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(
        input.dtype, (index.shape[0],) + tuple(input.shape[1:]))
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]})
    return out


def gather_nd(input, index):
    helper = LayerHelper("gather_nd")
    out_shape = tuple(index.shape[:-1]) + tuple(input.shape[index.shape[-1]:])
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(type="gather_nd", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True):
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
        attrs={"overwrite": overwrite},
    )
    return out


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="where",
        inputs={"Condition": [condition], "X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="increment", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"step": float(value)}
    )
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", (len(input.shape),))
    helper.append_op(type="shape", inputs={"Input": [input]}, outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = list(input.shape)
    for ax, st, en in zip(axes, starts, ends):
        if shape[ax] >= 0:
            real_en = min(en, shape[ax]) if en >= 0 else shape[ax] + en
            real_st = st if st >= 0 else shape[ax] + st
            shape[ax] = max(real_en - real_st, 0)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def _getitem(var, item):
    """Variable.__getitem__ support (basic int/slice indexing)."""
    if not isinstance(item, tuple):
        item = (item,)
    axes, starts, ends, squeeze_axes = [], [], [], []
    import builtins

    for ax, it in enumerate(item):
        if isinstance(it, int):
            axes.append(ax)
            starts.append(it)
            # it == -1: end 0 would make the slice empty; INT_MAX means
            # "to the end" in the slice op (parity: slice_op.cc end clamping)
            ends.append(it + 1 if it != -1 else 10**9)
            squeeze_axes.append(ax)
        elif isinstance(it, builtins.slice):
            if it.start is None and it.stop is None:
                continue
            axes.append(ax)
            starts.append(it.start or 0)
            ends.append(it.stop if it.stop is not None else 10**9)
        else:
            raise TypeError("unsupported index %r" % (it,))
    r = slice(var, axes, starts, ends) if axes else var
    if squeeze_axes:
        from .nn import squeeze

        r = squeeze(r, squeeze_axes)
    return r
