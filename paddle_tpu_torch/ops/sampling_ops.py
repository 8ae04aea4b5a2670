"""Sampled large-vocabulary training op rules: nce and hierarchical_sigmoid
(counterparts of the rules in ``paddle_tpu/ops/sampling_ops.py``; its
sample_logits and sampling_id wait).

Parity: operators/nce_op.h (Gutmann & Hyvarinen NCE; the samplers of
math/sampler.cc: 0 uniform, 1 log-uniform, 2 a custom distribution) and
hierarchical_sigmoid_op.h with math/matrix_bit_code.h (SimpleCode, the
default tree, or a custom PathTable / PathCode).

The negatives are drawn from a ``torch`` generator seeded per run and op
(``common.op_generator``), with the JAX samplers' distributions but not
their ``jax.random`` bits; ``custom_neg_classes`` fixes them, and is how the
two packages are held to each other.
"""

import math

import torch

from ..registry import register_op
from .common import op_generator, out, take_clamp, x


def _log_uniform_prob(k, range_):
    # P(k) = log((k + 2) / (k + 1)) / log(range + 2), k in [0, range]
    kf = k.float()
    return torch.log((kf + 2.0) / (kf + 1.0)) / math.log(range_ + 2.0)


def _sample_neg(gen, sampler, n, num_total, probs, device):
    """n class ids, i.i.d. from sampler 0 (uniform), 1 (log-uniform) or 2
    (``probs``)."""
    if sampler == 0:
        return torch.randint(0, num_total, (n,), generator=gen, device=device)
    if sampler == 1:
        u = torch.rand((n,), generator=gen, device=device)
        ids = torch.exp(u * math.log(num_total + 1.0)).long() - 1
        return ids.clamp(0, num_total - 1)
    return torch.multinomial(probs.float().clamp(min=1e-30), n,
                             replacement=True, generator=gen)


@register_op("nce")
def _nce(ins, attrs, ctx):
    """Per-row cost: -log(o / (o + b)) over the true labels plus
    -log(b / (o + b)) over the negatives, where o = sigmoid(x . W[c] +
    bias[c]) and b = P(c) * num_neg_samples."""
    inp = x(ins, "Input")                       # [B, D]
    label = x(ins, "Label").long()              # [B, T]
    weight = x(ins, "Weight")                   # [C, D]
    bias = x(ins, "Bias")                       # [C] or [C, 1]
    sample_weight = x(ins, "SampleWeight")      # [B] optional
    dist_probs = x(ins, "CustomDistProbs")      # [C] optional
    B = inp.shape[0]
    T = label.shape[1] if label.ndim == 2 else 1
    label = label.reshape(B, T)
    num_total = int(attrs["num_total_classes"])
    num_neg = int(attrs.get("num_neg_samples", 10))
    sampler = int(attrs.get("sampler", 0))
    custom_neg = attrs.get("custom_neg_classes") or []
    if custom_neg:
        num_neg = len(custom_neg)
        negs = torch.tensor(custom_neg, dtype=torch.long,
                            device=inp.device).expand(B, num_neg)
    else:
        negs = _sample_neg(op_generator(ctx, attrs), sampler, B * num_neg,
                           num_total, dist_probs, inp.device).reshape(B, num_neg)
    sample_labels = torch.cat([label, negs], dim=1)          # [B, T + neg]

    # a label outside [0, num_total) reads as JAX's gather reads it
    logits = torch.einsum("bd,btd->bt", inp, take_clamp(weight, sample_labels))
    if bias is not None:
        logits = logits + take_clamp(bias.reshape(-1), sample_labels)
    o = torch.sigmoid(logits)
    if sampler == 0:
        pt = torch.full(sample_labels.shape, 1.0 / num_total,
                        device=inp.device)
    elif sampler == 1:
        pt = _log_uniform_prob(sample_labels, num_total - 1)
    else:
        pt = take_clamp(dist_probs, sample_labels)
    bq = pt * num_neg
    true = torch.arange(T + num_neg, device=inp.device)[None, :] < T
    cost = torch.where(true, -torch.log(o / (o + bq)),
                       -torch.log(bq / (o + bq)))
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(B, 1)
    return out(Cost=cost.sum(dim=1, keepdim=True), SampleLogits=o,
               SampleLabels=sample_labels)


@register_op("hierarchical_sigmoid")
def _hierarchical_sigmoid(ins, attrs, ctx):
    """Sum over the label's path of softplus(pre) - bit * pre, pre = x .
    W[node] + bias[node] clipped to [-40, 40].  Slots past a path's end
    contribute softplus(0) = log 2, as the reference does (its TODO at
    hierarchical_sigmoid_op.h:157)."""
    xin = x(ins, "X")                            # [B, D]
    w = x(ins, "W")                              # [num_nodes, D]
    label = x(ins, "Label").long().reshape(-1)   # [B]
    bias = x(ins, "Bias")                        # [num_nodes] / [num_nodes, 1]
    path = x(ins, "PathTable")                   # [B, L] custom tree
    code = x(ins, "PathCode")                    # [B, L]
    num_classes = int(attrs["num_classes"])
    if path is not None:
        idx = path.long()
        bits = code.float()
    else:
        # SimpleCode: c = label + num_classes; node j = (c >> (j + 1)) - 1,
        # bit j = (c >> j) & 1
        L = max(int(num_classes - 1).bit_length(), 1)
        c = (label + num_classes)[:, None]
        j = torch.arange(L, device=xin.device)[None, :]
        idx = (c >> (j + 1)) - 1
        bits = ((c >> j) & 1).float()
    valid = idx >= 0
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    zero = torch.zeros((), dtype=xin.dtype, device=xin.device)
    # a node past the table (a label outside [0, num_classes)) reads as
    # JAX's gather reads it
    pre = torch.einsum("bd,bld->bl", xin, take_clamp(w, idx))
    if bias is not None:
        pre = pre + take_clamp(bias.reshape(-1), idx)
    pre = torch.where(valid, pre, zero).clamp(-40.0, 40.0)
    o = (torch.log1p(torch.exp(pre)).sum(dim=1, keepdim=True)
         - (torch.where(valid, bits, 0.0) * pre).sum(dim=1, keepdim=True))
    return out(Out=o, PreOut=pre, W_Out=w)
