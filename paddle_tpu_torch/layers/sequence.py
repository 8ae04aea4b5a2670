"""Sequence layers over the padded-dense representation (parity:
layers/sequence_lod ops in nn.py — sequence_pool/softmax/reverse/… built on
LoDTensor in the reference, built on (data, length) pairs here; see
ops/sequence_ops.py).  A copy of the JAX package's ``layers/sequence.py``."""

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_pool",
    "sequence_softmax",
    "sequence_reverse",
    "sequence_mask",
    "sequence_concat",
    "sequence_expand_as",
    "sequence_first_step",
    "sequence_last_step",
]


def sequence_pool(input, pool_type, seq_len=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    shape = (input.shape[0],) + tuple(input.shape[2:])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    inputs = {"X": [input]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_pool", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, seq_len=None):
    return sequence_pool(input, "first", seq_len)


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "last", seq_len)


def sequence_softmax(input, seq_len=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    inputs = {"X": [input]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_softmax", inputs=inputs, outputs={"Out": [out]})
    return out


def sequence_reverse(x, seq_len=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    inputs = {"X": [x]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_reverse", inputs=inputs, outputs={"Y": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, (x.shape[0], maxlen))
    helper.append_op(type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    t = sum(v.shape[1] for v in input)
    shape = (input[0].shape[0], t) + tuple(input[0].shape[2:])
    out = helper.create_variable_for_type_inference(input[0].dtype, shape)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    shape = (x.shape[0], y.shape[1]) + tuple(x.shape[1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out
