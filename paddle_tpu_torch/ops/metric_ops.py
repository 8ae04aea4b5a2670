"""Metric op rules on tensors: accuracy, auc and precision_recall
(counterparts of the rules in ``paddle_tpu/ops/metric_ops.py``).  Parity:
operators/metrics/accuracy_op.cc, auc_op.cc, precision_recall_op.cc."""

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import out, saturating_cast, x


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


@register_op("auc")
def _auc(ins, attrs, ctx):
    """Streaming ROC AUC: each prediction's positive score falls in bucket
    trunc(score num_thresholds) clipped to [0, num_thresholds] (a score of
    1.0 takes the last of the num_thresholds + 1), StatPos / StatNeg (the
    persistable histograms, written back by the executor) count the batch's
    positives and negatives there, and the AUC is the trapezoid area under
    (FPR, TPR) over the thresholds from the top.  The counts are integers,
    so the scatter-add's atomics on the card are exact whatever their
    order."""
    preds, label = x(ins, "Predict"), x(ins, "Label")
    stat_pos, stat_neg = x(ins, "StatPos"), x(ins, "StatNeg")
    nt = int(attrs.get("num_thresholds", 4095))
    bucket = saturating_cast(preds[:, -1] * nt, torch.int32).clamp(0, nt).long()
    lab = label.reshape(-1).to(torch.int32)
    stat_pos = stat_pos.index_add(0, bucket, lab.to(stat_pos.dtype))
    stat_neg = stat_neg.index_add(0, bucket, (1 - lab).to(stat_neg.dtype))
    tp = torch.flip(torch.cumsum(torch.flip(stat_pos, (0,)), 0), (0,))
    fp = torch.flip(torch.cumsum(torch.flip(stat_neg, (0,)), 0), (0,))
    tpr = tp / tp[0].clamp(min=1)
    fpr = fp / fp[0].clamp(min=1)
    # jnp.trapezoid: 0.5 sum(dx (y[1:] + y[:-1]))
    area = 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()
    return out(AUC=(-area).reshape(()), StatPosOut=stat_pos,
               StatNegOut=stat_neg)


def _precision_recall_metrics(st):
    """[6]: macro precision, recall, F1 over the classes, then micro."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]

    def ratio(a, b):
        return torch.where(b > 0, a / b.clamp(min=1e-12), 0.0)

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mp, mr = ratio(stp, stp + sfp), ratio(stp, stp + sfn)
    mf = ratio(2 * mp * mr, mp + mr)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


@register_op("precision_recall")
def _precision_recall(ins, attrs, ctx):
    """Indices [N, 1] predicted classes, Labels [N, 1], Weights [N, 1]
    (ones without) and StatesInfo [C, 4] accumulated (TP, FP, TN, FN) per
    class: BatchMetrics and AccumMetrics [6] (macro precision, recall,
    F1, then micro), AccumStatesInfo the sum."""
    idx = x(ins, "Indices").reshape(-1).long()
    lab = x(ins, "Labels").reshape(-1).long()
    weights, states = x(ins, "Weights"), x(ins, "StatesInfo")
    C = int(attrs["class_number"])
    w = (weights.reshape(-1).float() if weights is not None
         else torch.ones(idx.shape, device=idx.device))
    pred_oh = F.one_hot(idx, C).float()
    hit = (idx == lab).float() * w
    tp = (pred_oh * hit[:, None]).sum(dim=0)
    fp = (pred_oh * w[:, None]).sum(dim=0) - tp
    fn = (F.one_hot(lab, C).float() * w[:, None]).sum(dim=0) - tp
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = batch if states is None else states + batch
    return out(BatchMetrics=_precision_recall_metrics(batch),
               AccumMetrics=_precision_recall_metrics(accum),
               AccumStatesInfo=accum)
