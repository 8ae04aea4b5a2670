"""Collective layers (counterpart of ``paddle_tpu/layers/collective.py``, a
copy; parity: layers/collective.py:64-172 — _c_allreduce, _c_broadcast,
_c_allgather, _c_reducescatter, _c_sync_*; used by the collective
transpiler / Fleet)."""

from ..layer_helper import LayerHelper

__all__ = ["_c_allreduce", "_c_broadcast", "_c_allgather", "_c_reducescatter",
           "_c_sync_calc_stream", "_c_sync_comm_stream"]


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allreduce_" + reduce_type)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="c_allreduce_" + reduce_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_broadcast")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="c_broadcast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"root": root, "ring_id": ring_id,
                            "use_calc_stream": use_calc_stream})
    return out


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allgather")
    shape = (x.shape[0] * nranks if x.shape[0] > 0 else -1,) + tuple(x.shape[1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="c_allgather", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"nranks": nranks, "ring_id": ring_id,
                            "use_calc_stream": use_calc_stream})
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_reducescatter")
    shape = (x.shape[0] // nranks if x.shape[0] > 0 else -1,) + tuple(x.shape[1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="c_reducescatter", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"nranks": nranks, "ring_id": ring_id,
                            "use_calc_stream": use_calc_stream})
    return out


def _c_sync_calc_stream(x):
    helper = LayerHelper("c_sync_calc_stream")
    helper.append_op(type="c_sync_calc_stream", inputs={"X": [x]}, outputs={"Out": [x]})
    return x


def _c_sync_comm_stream(x, ring_id=0):
    helper = LayerHelper("c_sync_comm_stream")
    helper.append_op(type="c_sync_comm_stream", inputs={"X": [x]}, outputs={"Out": [x]},
                     attrs={"ring_id": ring_id})
    return x
