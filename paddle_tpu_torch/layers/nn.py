"""NN layers (parity: python/paddle/fluid/layers/nn.py — fc, embedding,
conv2d, pool2d, batch_norm, layer_norm, dropout, softmax_with_cross_entropy,
reduce_*, topk, matmul, reshape, transpose, …).  A copy of the JAX package's
``layers/nn.py``."""

import numpy as np

from ..layer_helper import LayerHelper
from ..framework import Variable
from ..initializer import ConstantInitializer, NormalInitializer

__all__ = [
    "warpctc",
    "nce",
    "hsigmoid",
    "sampled_softmax_with_cross_entropy",
    "sampling_id",
    "fc",
    "embedding",
    "conv2d",
    "conv2d_transpose",
    "conv3d",
    "pool2d",
    "adaptive_pool2d",
    "batch_norm",
    "layer_norm",
    "group_norm",
    "instance_norm",
    "l2_normalize",
    "dropout",
    "relu",
    "relu6",
    "leaky_relu",
    "elu",
    "gelu",
    "prelu",
    "selu",
    "softplus",
    "softsign",
    "swish",
    "hard_sigmoid",
    "hard_swish",
    "brelu",
    "softmax",
    "log_softmax",
    "log",
    "cross_entropy",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "square_error_cost",
    "huber_loss",
    "smooth_l1",
    "kldiv_loss",
    "label_smooth",
    "margin_rank_loss",
    "mean",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "reduce_all",
    "reduce_any",
    "matmul",
    "mul",
    "topk",
    "reshape",
    "squeeze",
    "unsqueeze",
    "flatten",
    "transpose",
    "split",
    "expand",
    "expand_as",
    "pad",
    "pad2d",
    "image_resize",
    "resize_bilinear",
    "resize_nearest",
    "pixel_shuffle",
    "lrn",
    "grid_sampler",
    "multihead_attention",
    "uniform_random",
    "gaussian_random",
    "cumsum",
    "maxout",
    "pool3d",
    "elementwise_clip",
]


def _conv_out(size, k, p, s, d=1):
    if size < 0:
        return -1
    ke = d * (k - 1) + 1
    return (size + 2 * p - ke) // s + 1


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
    tp_split=None,
):
    """Parity: layers/nn.py fc — mul (+ sum over multiple inputs) + bias + act.

    tp_split ("col" | "row" | None): tensor-parallel sharding hook
    (supersedes the DistFC stub, incubate/fleet/collective/__init__.py:36).
    With BuildStrategy/DistributedStrategy.tensor_parallel_degree > 1,
    "col" shards the weight's output dim (and the bias) over the mesh's
    model axis, "row" shards the input dim; GSPMD partitions the matmul and
    inserts the collectives — the fluid-API model needs no other change."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for i, inp in enumerate(inputs):
        in_features = int(np.prod([s for s in inp.shape[num_flatten_dims:]]))
        w = helper.create_parameter(
            helper.param_attr(), [in_features, size], inp.dtype, suffix="w%d" % i if i else "w"
        )
        if tp_split in ("col", "row"):
            w._tp_split = tp_split
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(inp.dtype, out_shape)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype, mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    bias = helper.create_parameter(helper.param_attr(is_bias=True), [size], pre_bias.dtype, is_bias=True)
    if bias is not None:
        if tp_split == "col":
            bias._tp_split = "col"
        pre_act = helper.create_variable_for_type_inference(pre_bias.dtype, pre_bias.shape)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [pre_bias], "Y": [bias]},
            outputs={"Out": [pre_act]},
            attrs={"axis": len(pre_bias.shape) - 1},
        )
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
    name=None,
    tp_split=None,
):
    """Parity: layers/nn.py embedding (lookup_table_op).  is_sparse selects the
    SelectedRows gradient: the executor differentiates the gathered rows, not
    the table, when the table is eligible (``executor._find_sparse_lookups``).

    tp_split ("row" | "col" | None): tensor-parallel hook — "row" shards the
    vocab dim over the mesh's model axis (distributed_lookup_table layout),
    "col" the embedding dim; see layers.fc for the contract."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(
        helper.param_attr(), list(size), dtype,
        default_initializer=NormalInitializer(0.0, 1.0 / np.sqrt(size[1])),
    )
    if tp_split in ("col", "row"):
        w._tp_split = tp_split
    out_shape = tuple(input.shape[:-1] if input.shape and input.shape[-1] == 1 else input.shape) + (size[1],)
    out = helper.create_variable_for_type_inference(dtype, out_shape)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": is_sparse, "is_distributed": is_distributed},
    )
    return out


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    s = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    p = padding if isinstance(padding, (list, tuple)) else (padding, padding)
    d = dilation if isinstance(dilation, (list, tuple)) else (dilation, dilation)
    cin = input.shape[1]
    w = helper.create_parameter(
        helper.param_attr(), [num_filters, cin // groups, k[0], k[1]], input.dtype,
        default_initializer=NormalInitializer(
            0.0, (2.0 / max(k[0] * k[1] * num_filters, 1)) ** 0.5),
    )
    oh = _conv_out(input.shape[2], k[0], p[0], s[0], d[0])
    ow = _conv_out(input.shape[3], k[1], p[1], s[1], d[1])
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], num_filters, oh, ow))
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": list(s), "paddings": list(p), "dilations": list(d), "groups": groups},
    )
    bias = helper.create_parameter(helper.param_attr(is_bias=True), [num_filters], input.dtype, is_bias=True)
    if bias is not None:
        pre_act = helper.create_variable_for_type_inference(input.dtype, out.shape)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [out], "Y": [bias]},
            outputs={"Out": [pre_act]},
            attrs={"axis": 1},
        )
    else:
        pre_act = out
    return helper.append_activation(pre_act)


def conv2d_transpose(
    input, num_filters, output_size=None, filter_size=None, stride=1, padding=0,
    dilation=1, groups=1, param_attr=None, bias_attr=None, act=None, name=None,
):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    s = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    p = padding if isinstance(padding, (list, tuple)) else (padding, padding)
    cin = input.shape[1]
    w = helper.create_parameter(helper.param_attr(), [cin, num_filters, k[0], k[1]], input.dtype)
    oh = (input.shape[2] - 1) * s[0] - 2 * p[0] + k[0] if input.shape[2] > 0 else -1
    ow = (input.shape[3] - 1) * s[1] - 2 * p[1] + k[1] if input.shape[3] > 0 else -1
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], num_filters, oh, ow))
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": list(s), "paddings": list(p), "dilations": [1, 1], "groups": groups},
    )
    bias = helper.create_parameter(helper.param_attr(is_bias=True), [num_filters], input.dtype, is_bias=True)
    if bias is not None:
        pre = helper.create_variable_for_type_inference(input.dtype, out.shape)
        helper.append_op(type="elementwise_add", inputs={"X": [out], "Y": [bias]},
                         outputs={"Out": [pre]}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size,) * 3
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * 3
    p = padding if isinstance(padding, (list, tuple)) else (padding,) * 3
    cin = input.shape[1]
    w = helper.create_parameter(helper.param_attr(), [num_filters, cin // groups] + list(k), input.dtype)
    dims = [_conv_out(input.shape[2 + i], k[i], p[i], s[i]) for i in range(3)]
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], num_filters) + tuple(dims))
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]}, outputs={"Output": [out]},
        attrs={"strides": list(s), "paddings": list(p), "dilations": [1, 1, 1], "groups": groups},
    )
    bias = helper.create_parameter(helper.param_attr(is_bias=True), [num_filters], input.dtype, is_bias=True)
    if bias is not None:
        pre = helper.create_variable_for_type_inference(input.dtype, out.shape)
        helper.append_op(type="elementwise_add", inputs={"X": [out], "Y": [bias]},
                         outputs={"Out": [pre]}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    exclusive=True,
    name=None,
):
    helper = LayerHelper("pool2d", name=name)
    k = pool_size if isinstance(pool_size, (list, tuple)) else (pool_size, pool_size)
    s = pool_stride if isinstance(pool_stride, (list, tuple)) else (pool_stride, pool_stride)
    p = pool_padding if isinstance(pool_padding, (list, tuple)) else (pool_padding, pool_padding)
    if global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        from ..ops.pooling_ops import pool_out_size

        oh = pool_out_size(input.shape[2], k[0], s[0], p[0], ceil_mode)
        ow = pool_out_size(input.shape[3], k[1], s[1], p[1], ceil_mode)
        shape = (input.shape[0], input.shape[1], oh, ow)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(k),
            "strides": list(s),
            "paddings": list(p),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("pool2d", name=name)
    k = pool_size if isinstance(pool_size, (list, tuple)) else (pool_size, pool_size)
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], input.shape[1]) + tuple(k))
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(k), "adaptive": True},
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    use_global_stats=False,
):
    """Parity: layers/nn.py batch_norm (batch_norm_op.cc)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr(), [c], input.dtype, default_initializer=ConstantInitializer(1.0),
        suffix="scale")
    bias = helper.create_parameter(
        helper.param_attr(is_bias=True), [c], input.dtype, is_bias=True, suffix="offset")
    # moving stats are persistable but not trainable
    from .. import unique_name as _un
    from ..framework import default_startup_program

    mean_name = moving_mean_name or _un.generate(helper.name + ".mean")
    var_name = moving_variance_name or _un.generate(helper.name + ".var")
    gblock = helper.main_program.global_block()
    if mean_name in gblock.vars:
        mean = gblock.vars[mean_name]
        variance = gblock.vars[var_name]
    else:
        mean = gblock.create_var(name=mean_name, shape=(c,), dtype=input.dtype,
                                 persistable=True, stop_gradient=True)
        variance = gblock.create_var(name=var_name, shape=(c,), dtype=input.dtype,
                                     persistable=True, stop_gradient=True)
        sblock = default_startup_program().global_block()
        smean = sblock.create_var(name=mean_name, shape=(c,), dtype=input.dtype, persistable=True)
        ConstantInitializer(0.0)(smean, sblock)
        svar = sblock.create_var(name=var_name, shape=(c,), dtype=input.dtype, persistable=True)
        ConstantInitializer(1.0)(svar, sblock)

    y = helper.create_variable_for_type_inference(input.dtype, input.shape)
    saved_mean = helper.create_variable_for_type_inference(input.dtype, (c,), stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(input.dtype, (c,), stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats},
    )
    return helper.append_activation(y)


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(helper.param_attr(), norm_shape, input.dtype,
                                    default_initializer=ConstantInitializer(1.0), suffix="scale")
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.param_attr(is_bias=True), norm_shape, input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(input.dtype, input.shape[:begin_norm_axis],
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, input.shape[:begin_norm_axis],
                                                    stop_gradient=True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(y)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    c = input.shape[1]
    inputs = {"X": [input]}
    s = helper.create_parameter(helper.param_attr(), [c], input.dtype,
                                default_initializer=ConstantInitializer(1.0), suffix="scale")
    b = helper.create_parameter(helper.param_attr(is_bias=True), [c], input.dtype, is_bias=True)
    if s is not None:
        inputs["Scale"] = [s]
    if b is not None:
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(input.dtype, (input.shape[0], groups),
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, (input.shape[0], groups),
                                                    stop_gradient=True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(y)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr, bias_attr=bias_attr, name=name)
    c = input.shape[1]
    inputs = {"X": [input]}
    s = helper.create_parameter(helper.param_attr(), [c], input.dtype,
                                default_initializer=ConstantInitializer(1.0), suffix="scale")
    b = helper.create_parameter(helper.param_attr(is_bias=True), [c], input.dtype, is_bias=True)
    if s is not None:
        inputs["Scale"] = [s]
    if b is not None:
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(input.dtype, input.shape)
    sm = helper.create_variable_for_type_inference(input.dtype, (input.shape[0], c), stop_gradient=True)
    sv = helper.create_variable_for_type_inference(input.dtype, (input.shape[0], c), stop_gradient=True)
    helper.append_op(type="instance_norm", inputs=inputs,
                     outputs={"Y": [y], "SavedMean": [sm], "SavedVariance": [sv]},
                     attrs={"epsilon": epsilon})
    return y


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype, x.shape, stop_gradient=True)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference(x.dtype, x.shape, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else helper.main_program.next_seed(),
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def _act_layer(op_type):
    def f(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=kwargs)
        return out

    f.__name__ = op_type
    return f


relu = _act_layer("relu")
relu6 = _act_layer("relu6")
elu = _act_layer("elu")
selu = _act_layer("selu")
gelu = _act_layer("gelu")
softplus = _act_layer("softplus")
softsign = _act_layer("softsign")
swish = _act_layer("swish")
hard_sigmoid = _act_layer("hard_sigmoid")
hard_swish = _act_layer("hard_swish")
brelu = _act_layer("brelu")
log = _act_layer("log")


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="leaky_relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(helper.param_attr(), alpha_shape, x.dtype,
                                    default_initializer=ConstantInitializer(0.25), suffix="alpha")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def softmax(input, axis=-1, use_cudnn=False, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="log_softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


# -- losses ----------------------------------------------------------------

def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = tuple(input.shape[:-1]) + (1,)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def softmax_with_cross_entropy(
    logits, label, soft_label=False, ignore_index=-100, numeric_stable_mode=True,
    return_softmax=False, axis=-1,
):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss_shape = list(logits.shape)
    loss_shape[axis] = 1
    loss = helper.create_variable_for_type_inference(logits.dtype, tuple(loss_shape))
    smax = helper.create_variable_for_type_inference(logits.dtype, logits.shape)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Loss": [loss], "Softmax": [smax]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return loss, smax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="square_error_cost", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    resid = helper.create_variable_for_type_inference(input.dtype, input.shape, stop_gradient=True)
    helper.append_op(type="huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [resid]}, attrs={"delta": delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(x.dtype, (x.shape[0], 1))
    diff = helper.create_variable_for_type_inference(x.dtype, x.shape, stop_gradient=True)
    helper.append_op(type="smooth_l1_loss", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    shape = () if reduction in ("mean", "sum", "batchmean") else x.shape
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="kldiv_loss", inputs={"X": [x], "Target": [target]},
                     outputs={"Loss": [out]}, attrs={"reduction": reduction})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype, label.shape)
    helper.append_op(type="label_smooth", inputs={"X": [label]}, outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    act = helper.create_variable_for_type_inference(left.dtype, left.shape, stop_gradient=True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"X1": [left], "X2": [right], "Label": [label]},
                     outputs={"Out": [out], "Activated": [act]}, attrs={"margin": margin})
    return out


# -- reductions / linalg ---------------------------------------------------

def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, ())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        reduce_all = dim is None
        dims = [0] if dim is None else (list(dim) if isinstance(dim, (list, tuple)) else [dim])
        if reduce_all:
            shape = ()
        else:
            nd = len(input.shape)
            axes = {d % nd for d in dims}
            if keep_dim:
                shape = tuple(1 if i in axes else s for i, s in enumerate(input.shape))
            else:
                shape = tuple(s for i, s in enumerate(input.shape) if i not in axes)
        out = helper.create_variable_for_type_inference(input.dtype, shape)
        helper.append_op(
            type=op_type, inputs={"X": [input]}, outputs={"Out": [out]},
            attrs={"dim": dims, "keep_dim": keep_dim, "reduce_all": reduce_all},
        )
        return out

    f.__name__ = op_type
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    shape = tuple(xs[:-1] + ys[-1:]) if len(ys) >= 2 else tuple(xs[:-1])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    shape = tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(
        type="mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_variable_for_type_inference(input.dtype, shape)
    indices = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op(
        type="top_k", inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]}, attrs={"k": k},
    )
    return values, indices


# -- shape manipulation ----------------------------------------------------

def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    # static shape inference incl. -1/0 conventions
    known = 1
    minus_one = False
    inferred = []
    for i, s in enumerate(shape):
        if s == 0:
            inferred.append(x.shape[i])
        elif s == -1:
            minus_one = True
            inferred.append(-1)
        else:
            inferred.append(s)
    total = int(np.prod([s for s in x.shape])) if all(s >= 0 for s in x.shape) else -1
    if minus_one and total >= 0:
        rest = int(np.prod([s for s in inferred if s > 0])) or 1
        inferred = [total // rest if s == -1 else s for s in inferred]
    out = helper.create_variable_for_type_inference(x.dtype, tuple(inferred))
    xshape = helper.create_variable_for_type_inference(x.dtype, (0,) + tuple(x.shape),
                                                       stop_gradient=True)
    helper.append_op(
        type="reshape2", inputs={"X": [x]}, outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    shape = tuple(s for i, s in enumerate(input.shape)
                  if not (i in [a % len(input.shape) for a in axes] and s == 1))
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    xshape = helper.create_variable_for_type_inference(input.dtype, (0,), stop_gradient=True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    xshape = helper.create_variable_for_type_inference(input.dtype, (0,), stop_gradient=True)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs={"axes": list(axes)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    lead = int(np.prod(x.shape[:axis])) if all(s >= 0 for s in x.shape[:axis]) else -1
    rest = int(np.prod(x.shape[axis:])) if all(s >= 0 for s in x.shape[axis:]) else -1
    out = helper.create_variable_for_type_inference(x.dtype, (lead, rest))
    xshape = helper.create_variable_for_type_inference(x.dtype, (0,), stop_gradient=True)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs={"axis": axis})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shape = tuple(x.shape[p] for p in perm)
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    xshape = helper.create_variable_for_type_inference(x.dtype, (0,), stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    nd = len(input.shape)
    ax = dim % nd
    if isinstance(num_or_sections, int):
        n = num_or_sections
        sections = None
        sizes = [input.shape[ax] // n if input.shape[ax] > 0 else -1] * n
    else:
        sections = list(num_or_sections)
        sizes = sections
        n = len(sections)
    outs = []
    for sz in sizes:
        shape = tuple(sz if i == ax else s for i, s in enumerate(input.shape))
        outs.append(helper.create_variable_for_type_inference(input.dtype, shape))
    helper.append_op(
        type="split", inputs={"X": [input]}, outputs={"Out": outs},
        attrs={"axis": ax, "num": 0 if sections else n, "sections": sections or []},
    )
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = tuple(s * t if s > 0 else -1 for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, target_tensor.shape)
    helper.append_op(type="expand_as", inputs={"X": [x], "target_tensor": [target_tensor]},
                     outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shape = tuple(
        s + paddings[2 * i] + paddings[2 * i + 1] if s >= 0 else -1
        for i, s in enumerate(x.shape)
    )
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    n, c, h, w = input.shape
    shape = (n, c,
             h + paddings[0] + paddings[1] if h >= 0 else -1,
             w + paddings[2] + paddings[3] if w >= 0 else -1)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="pad2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode, "pad_value": pad_value})
    return out


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR", name=None,
                 actual_shape=None, align_corners=True, align_mode=1):
    helper = LayerHelper("interpolate", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], input.shape[1], out_shape[0], out_shape[1]))
    helper.append_op(
        type="interpolate", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"out_h": int(out_shape[0]), "out_w": int(out_shape[1]),
               "interp_method": resample.lower()},
    )
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, "BILINEAR", name)


def resize_nearest(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, "NEAREST", name)


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle")
    n, c, h, w = x.shape
    r = upscale_factor
    out = helper.create_variable_for_type_inference(x.dtype, (n, c // (r * r), h * r, w * r))
    helper.append_op(type="pixel_shuffle", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"upscale_factor": r})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mid = helper.create_variable_for_type_inference(input.dtype, input.shape, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    n, c, h, w = x.shape
    out = helper.create_variable_for_type_inference(x.dtype, (n, c, grid.shape[1], grid.shape[2]))
    helper.append_op(type="grid_sampler", inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return out


def multihead_attention(queries, keys, values, bias=None, num_heads=1, name=None):
    """Fused multi-head attention core (ref: fused/multihead_matmul_op.cu).
    q/k/v: [B, H, T, D] — XLA-composed softmax(QK^T/sqrt(d))V."""
    helper = LayerHelper("multihead_matmul", name=name)
    out = helper.create_variable_for_type_inference(queries.dtype, queries.shape)
    inputs = {"Q": [queries], "K": [keys], "V": [values]}
    if bias is not None:
        inputs["BiasQK"] = [bias]
    d = queries.shape[-1]
    helper.append_op(type="multihead_matmul", inputs=inputs, outputs={"Out": [out]},
                     attrs={"alpha": 1.0 / float(np.sqrt(d))})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape), stop_gradient=True)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": out.dtype, "min": min, "max": max,
                            "seed": seed or helper.main_program.next_seed()})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape), stop_gradient=True)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": out.dtype, "mean": mean, "std": std,
                            "seed": seed or helper.main_program.next_seed()})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive, "reverse": reverse})
    return out


def maxout(x, groups, name=None, axis=1):
    """Parity: layers/nn.py maxout over operators/maxout_op.cc."""
    helper = LayerHelper("maxout", name=name)
    shape = list(x.shape)
    ax = axis if axis >= 0 else axis + len(shape)
    shape[ax] = shape[ax] // groups
    o = helper.create_variable_for_type_inference(x.dtype, tuple(shape))
    helper.append_op(type="maxout", inputs={"X": [x]}, outputs={"Out": [o]},
                     attrs={"groups": groups, "axis": axis})
    return o


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    """Parity: layers/nn.py pool3d over operators/pool_op.cc (NCDHW)."""
    helper = LayerHelper("pool3d", name=name)
    k = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 3
    s = pool_stride if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 3
    p = pool_padding if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 3
    n, c, d, h, w = input.shape
    if global_pooling:
        od = oh = ow = 1
    else:
        from ..ops.pooling_ops import pool_out_size

        od = pool_out_size(d, k[0], s[0], p[0], ceil_mode)
        oh = pool_out_size(h, k[1], s[1], p[1], ceil_mode)
        ow = pool_out_size(w, k[2], s[2], p[2], ceil_mode)
    o = helper.create_variable_for_type_inference(input.dtype,
                                                  (n, c, od, oh, ow))
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [o]},
        attrs={"pooling_type": pool_type, "ksize": list(k),
               "strides": list(s), "paddings": list(p),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return o


def elementwise_clip(x, min, max):
    from .math_ops import clip as _clip

    return _clip(x, min, max)


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss (parity: layers/nn.py warpctc over operators/warpctc_op.cc).
    input: [B, T, C] unnormalized logits (batch-major padded form of the
    reference's LoD contract); label: [B, L] padded ids; lengths optional.
    Returns [B, 1] per-sequence negative log-likelihood."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference("float32",
                                                     (input.shape[0], 1))
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    helper.append_op(type="warpctc", inputs=ins, outputs={"Loss": [loss]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """NCE loss (parity: layers/nn.py nce over operators/nce_op.cc).
    input: [B, D] float; label: [B, T] int; returns [B, 1] cost.  custom_dist
    is a host numpy array of per-class probabilities (the reference's alias
    tables are a host-sampler implementation detail; the lowering samples
    from the distribution directly)."""
    from ..layer_helper import LayerHelper
    from . import tensor as tensor_layers

    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = int(input.shape[1])
    num_true = int(label.shape[1]) if len(label.shape) == 2 else 1
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    w = helper.create_parameter(helper.param_attr(),
                                [num_total_classes, dim], input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    b = helper.create_parameter(helper.param_attr(is_bias=True),
                                [num_total_classes, 1], input.dtype,
                                is_bias=True)
    if b is not None:
        inputs["Bias"] = [b]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]

    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    if sampler == "custom_dist":
        assert custom_dist is not None
        probs = np.asarray(custom_dist, dtype="float32")
        inputs["CustomDistProbs"] = [tensor_layers.assign(probs)]

    cost = helper.create_variable_for_type_inference(input.dtype,
                                                     (input.shape[0], 1))
    sample_logits = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], num_true + num_neg_samples))
    sample_labels = helper.create_variable_for_type_inference(
        "int64", (input.shape[0], num_true + num_neg_samples))
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples, "seed": seed,
               "sampler": sampler_id, "is_sparse": is_sparse,
               "custom_neg_classes": []})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid (parity: layers/nn.py hsigmoid over
    operators/hierarchical_sigmoid_op.cc).  Returns [B, 1] cost."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[1])
    if is_custom and (path_table is None or path_code is None):
        raise ValueError("is_custom=True requires path_table and path_code")
    n_nodes = num_classes if is_custom else num_classes - 1
    w = helper.create_parameter(helper.param_attr(), [n_nodes, dim],
                                input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if is_custom:
        inputs["PathTable"] = [path_table]
        inputs["PathCode"] = [path_code]
    b = helper.create_parameter(helper.param_attr(is_bias=True),
                                [n_nodes, 1], input.dtype, is_bias=True)
    if b is not None:
        inputs["Bias"] = [b]
    code_len = max(int(num_classes - 1).bit_length(), 1) \
        if not is_custom else int(path_table.shape[1])
    o = helper.create_variable_for_type_inference(input.dtype,
                                                  (input.shape[0], 1))
    pre_out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], code_len))
    helper.append_op(
        type="hierarchical_sigmoid", inputs=inputs,
        outputs={"Out": [o], "PreOut": [pre_out], "W_Out": [w]},
        attrs={"num_classes": num_classes, "is_sparse": is_sparse})
    return o


def sampled_softmax_with_cross_entropy(logits, label, num_samples, num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Sampled softmax CE (parity: layers/nn.py over
    operators/sample_logits_op.cc).  Returns [B, 1] loss."""
    from ..layer_helper import LayerHelper
    from .tensor import one_hot

    helper = LayerHelper("sample_logits")
    B = logits.shape[0]
    width = num_true + num_samples
    samples = helper.create_variable_for_type_inference("int64", (B, width))
    probabilities = helper.create_variable_for_type_inference(
        logits.dtype, (B, width))
    sampled_logits = helper.create_variable_for_type_inference(
        logits.dtype, (B, width))
    sampled_label = helper.create_variable_for_type_inference(
        "int64", (B, num_true))
    logits_dim = helper.create_variable_for_type_inference("int64", (2,))
    labels_dim = helper.create_variable_for_type_inference("int64", (2,))
    ins = {"Logits": [logits], "Labels": [label]}
    if use_customized_samples:
        ins["CustomizedSamples"] = [customized_samples]
        ins["CustomizedProbabilities"] = [customized_probabilities]
    helper.append_op(
        type="sample_logits", inputs=ins,
        outputs={"Samples": [samples], "Probabilities": [probabilities],
                 "SampledLabels": [sampled_label],
                 "SampledLogits": [sampled_logits],
                 "LogitsDim": [logits_dim], "LabelsDim": [labels_dim]},
        attrs={"use_customized_samples": use_customized_samples, "uniq": True,
               "remove_accidental_hits": remove_accidental_hits,
               "num_samples": num_samples, "seed": seed})
    soft_label = one_hot(sampled_label, width)
    loss = softmax_with_cross_entropy(sampled_logits, soft_label,
                                      soft_label=True)
    return loss / num_true


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """Multinomial single draw per row (parity: layers/nn.py sampling_id over
    operators/sampling_id_op.cc).  x: [B, C] row distributions -> [B]."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("sampling_id")
    o = helper.create_variable_for_type_inference(dtype, (x.shape[0],))
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [o]},
                     attrs={"min": min, "max": max, "seed": seed})
    return o
