"""contrib.layers (counterpart of ``paddle_tpu/contrib/layers.py``;
parity: fluid/contrib/layers/nn.py — the search/text-matching extension
surface: match_matrix_tensor, var_conv_2d, sequence_topk_avg_pooling,
tree_conv, fused_embedding_seq_pool, fused_elemwise_activation,
search_pyramid_hash, multiclass_nms2).

Each builds the program the JAX package's builds.  The ops of
``match_matrix_tensor``, ``var_conv_2d``, ``search_pyramid_hash``
(``pyramid_hash``) and ``multiclass_nms2`` (``multiclass_nms``) have no
rule in the port yet (ROADMAP Queue 1 item 3-B, tranches 6-7): running
them raises the registry's "no lowering registered"."""

from ..layer_helper import LayerHelper
from ..layers.extras import _op, _shape, multiclass_nms, tree_conv  # noqa: F401

__all__ = ["match_matrix_tensor", "var_conv_2d",
           "sequence_topk_avg_pooling", "tree_conv",
           "fused_embedding_seq_pool", "fused_elemwise_activation",
           "search_pyramid_hash", "multiclass_nms2"]


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None, x_len=None, y_len=None):
    """A W B^T per channel (ref contrib nn.py:219).  Padded-dense contract:
    x [B, Tx, H], y [B, Ty, H] (+ optional length vectors); returns
    (out [B, C, Tx, Ty], tmp [B, Tx, C, H])."""
    helper = LayerHelper("match_matrix_tensor", param_attr=param_attr,
                         act=act, name=name)
    H = _shape(x)[-1]
    Hy = _shape(y)[-1]
    w = helper.create_parameter(helper.param_attr(),
                                [H, channel_num, Hy], dtype)
    B, Tx = _shape(x)[0], _shape(x)[1]
    Ty = _shape(y)[1]
    o = helper.create_variable_for_type_inference(
        dtype, (B, channel_num, Tx, Ty))
    tmp = helper.create_variable_for_type_inference(
        dtype, (B, Tx, channel_num, Hy))
    ins = {"X": [x], "Y": [y], "W": [w]}
    if x_len is not None:
        ins["XLen"] = [x_len]
    if y_len is not None:
        ins["YLen"] = [y_len]
    helper.append_op(type="match_matrix_tensor", inputs=ins,
                     outputs={"Out": [o], "Tmp": [tmp]})
    return helper.append_activation(o), tmp


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """Per-row top-k averages per channel (ref contrib nn.py:302).  input
    [B, Ch, R, C] padded; row/col are [B] length vectors."""
    B, Ch, R = _shape(input)[0], _shape(input)[1], _shape(input)[2]
    return _op("sequence_topk_avg_pooling",
               {"X": input, "ROW": row, "COLUMN": col},
               {"Out": ("float32", (B, R, channel_num * len(topks)))},
               {"topks": list(topks), "channel_num": channel_num})["Out"]


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    """Variable-region 2D conv (ref contrib nn.py:103); input
    [B, Cin, R, C] padded with row/col length vectors."""
    helper = LayerHelper("var_conv_2d", param_attr=param_attr, act=act,
                         name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    s = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    w = helper.create_parameter(
        helper.param_attr(), [output_channel, input_channel, k[0], k[1]],
        dtype)
    B, R, C = _shape(input)[0], _shape(input)[2], _shape(input)[3]
    o = helper.create_variable_for_type_inference(
        dtype, (B, output_channel, (R + s[0] - 1) // s[0],
                (C + s[1] - 1) // s[1]))
    helper.append_op(type="var_conv_2d",
                     inputs={"X": [input], "W": [w], "ROW": [row],
                             "COLUMN": [col]},
                     outputs={"Out": [o]},
                     attrs={"kernel_h": k[0], "kernel_w": k[1],
                            "stride_h": s[0], "stride_w": s[1],
                            "input_channel": input_channel,
                            "output_channel": output_channel})
    return helper.append_activation(o)


def fused_embedding_seq_pool(input, size, is_sparse=False, padding_idx=None,
                             combiner="sum", param_attr=None,
                             dtype="float32"):
    """Embedding lookup + sequence sum-pool in one call (ref contrib
    nn.py:435 fuses them in one CPU kernel; here the two layers
    compose)."""
    from ..layers.nn import embedding
    from ..layers.sequence import sequence_pool

    assert combiner == "sum", "reference supports sum only"
    emb = embedding(input, size=size, is_sparse=is_sparse,
                    padding_idx=padding_idx, param_attr=param_attr,
                    dtype=dtype)
    return sequence_pool(emb, "sum")


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """ref contrib nn.py:39 (fused_elemwise_activation_op.cc): compose
    one elementwise op with one activation, e.g.
    ['elementwise_add', 'relu'] or ['relu', 'elementwise_add'], as the two
    layers in turn; this wrapper keeps the API."""
    from ..layers import math_ops
    from .. import layers as L

    unary = {"relu", "sigmoid", "tanh", "scale"}

    def apply_one(name, a, b=None):
        if name.startswith("elementwise_"):
            return getattr(math_ops, name)(a, b, axis=axis)
        if name == "scale":
            return math_ops.scale(a, scale=scale)
        return getattr(L, name)(a)

    f0, f1 = functor_list
    if f0.startswith("elementwise_"):
        mid = apply_one(f0, x, y)
        return apply_one(f1, mid)
    # unary first: applied to y, then the binary combines (ref binary
    # composition f0(f1(y), x) ordering for unary_in_binary)
    mid = apply_one(f0, y)
    return apply_one(f1, x, mid)


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent=0.0, is_training=False,
                        use_filter=True, white_list_len=0, black_list_len=0,
                        seed=0, lr=0.0, param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32"):
    """ref contrib nn.py:631 over pyramid_hash_op.cc; the white/black-list
    filters (a CPU bloom-filter serving optimisation) are accepted and
    unused, as in the JAX package."""
    helper = LayerHelper("search_pyramid_hash", param_attr=param_attr,
                         name=name)
    w = helper.create_parameter(helper.param_attr(), [space_len, num_emb],
                                dtype)
    B, T = _shape(input)[0], _shape(input)[1]
    o = helper.create_variable_for_type_inference(dtype, (B, T, num_emb))
    helper.append_op(type="pyramid_hash",
                     inputs={"X": [input], "W": [w]},
                     outputs={"Out": [o]},
                     attrs={"num_emb": num_emb, "space_len": space_len,
                            "pyramid_layer": pyramid_layer,
                            "rand_len": rand_len,
                            "drop_out_percent": drop_out_percent,
                            "is_training": is_training,
                            "use_filter": use_filter,
                            "white_list_len": white_list_len,
                            "black_list_len": black_list_len,
                            "seed": seed, "lr": lr})
    return o


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """ref contrib nn.py:501 — multiclass_nms that can also return the kept
    indices (the static-shape NMS already tracks them)."""
    o = multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=nms_threshold,
                       normalized=normalized, nms_eta=nms_eta,
                       background_label=background_label, name=name,
                       return_rois_num=True)
    dets, nums = o
    if return_index:
        return dets, nums
    return dets
