"""Metric layers (parity: layers/metric_op.py — accuracy, auc).  A copy of
the JAX package's ``layers/metric_op.py``."""

from ..layer_helper import LayerHelper
from .nn import topk

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", (), stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference("int32", (1,), stop_gradient=True)
    total = total or helper.create_variable_for_type_inference("int32", (1,), stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Indices": [indices], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    return acc


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    from . import tensor as T

    helper = LayerHelper("auc")
    stat_pos = T.create_global_var([num_thresholds + 1], 0.0, "int64", persistable=True,
                                   name=helper.name + ".stat_pos")
    stat_neg = T.create_global_var([num_thresholds + 1], 0.0, "int64", persistable=True,
                                   name=helper.name + ".stat_neg")
    auc_out = helper.create_variable_for_type_inference("float64", (), stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos], "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": num_thresholds, "curve": curve},
    )
    return auc_out, [stat_pos, stat_neg]
