"""Metric op rules on tensors: accuracy (counterpart of
``paddle_tpu/ops/metric_ops.py:11``; its auc and precision_recall rules
wait).  Parity: operators/metrics/accuracy_op.cc."""

import torch

from ..registry import register_op
from .common import x, out


@register_op("accuracy")
def _accuracy(ins, attrs, ctx):
    """ref accuracy_op.cc: Out = fraction of rows where Label appears in the
    top-k Indices (layers.accuracy feeds topk output here)."""
    indices, label = x(ins, "Indices"), x(ins, "Label")
    if label.ndim > 1 and label.shape[-1] == 1:
        label = label[..., 0]
    correct = (indices == label[:, None].to(indices.dtype)).any(dim=1)
    total = indices.shape[0]
    num_correct = correct.float().sum()
    return out(
        Accuracy=(num_correct / total).reshape(()),
        Correct=num_correct.to(torch.int32).reshape((1,)),
        Total=torch.tensor([total], dtype=torch.int32, device=indices.device),
    )
