"""Sampled large-vocabulary training op rules: nce, hierarchical_sigmoid,
sample_logits and sampling_id (counterparts of the rules in
``paddle_tpu/ops/sampling_ops.py``).

Parity: operators/nce_op.h (Gutmann & Hyvarinen NCE; the samplers of
math/sampler.cc: 0 uniform, 1 log-uniform, 2 a custom distribution),
hierarchical_sigmoid_op.h with math/matrix_bit_code.h (SimpleCode, the
default tree, or a custom PathTable / PathCode), sample_logits_op.h and
sampling_id_op.h.

The draws come from a ``torch`` generator seeded per run and op
(``common.op_generator``), with the JAX samplers' distributions but not
their ``jax.random`` bits; ``custom_neg_classes`` and sample_logits'
customized samples fix them, and are how the two packages are held to
each other.
"""

import math

import torch

from ..registry import register_op
from .math_ops import _clip_values
from .common import op_generator, out, promote_float, take_clamp, take_steps, x


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


def nce_negatives(rows, attrs, ctx, device, probs=None):
    """``num_neg_samples`` negative class ids for each of ``rows`` rows,
    [rows, num_neg], from the op's generator (data parallelism draws them
    for the global batch and keeps its rows)."""
    num_neg = int(attrs.get("num_neg_samples", 10))
    return _sample_neg(op_generator(ctx, attrs), int(attrs.get("sampler", 0)),
                       rows * num_neg, int(attrs["num_total_classes"]), probs,
                       device).reshape(rows, num_neg)


def nce_apply(ins, attrs, negs):
    """Per-row cost: -log(o / (o + b)) over the true labels plus
    -log(b / (o + b)) over the negatives ``negs`` [B, num_neg], where
    o = sigmoid(x . W[c] + bias[c]) and b = P(c) * num_neg_samples."""
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
    num_neg = negs.shape[1]
    sampler = int(attrs.get("sampler", 0))
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


@register_op("nce")
def _nce(ins, attrs, ctx):
    """``nce_apply`` with ``custom_neg_classes`` for every row, or with
    ``nce_negatives`` drawn for each row."""
    inp = x(ins, "Input")
    custom_neg = attrs.get("custom_neg_classes") or []
    if custom_neg:
        negs = torch.tensor(custom_neg, dtype=torch.long,
                            device=inp.device).expand(inp.shape[0],
                                                      len(custom_neg))
    else:
        negs = nce_negatives(inp.shape[0], attrs, ctx, inp.device,
                             x(ins, "CustomDistProbs"))
    return nce_apply(ins, attrs, negs)


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


def _tolerable(v):
    """sample_logits_op.h TolerableValue: NaN to 0, then clipped to
    [-1e10, 1e10] as ``jnp.clip`` clips (a value at a bound takes half
    its gradient; ``clamp`` would pass all of it)."""
    return _clip_values(torch.where(torch.isnan(v), 0.0, v), -1e10, 1e10)


@register_op("sample_logits")
def _sample_logits(ins, attrs, ctx):
    """Logits [B, C] at each row's true Labels [B, T] and S shared
    negatives: with ``use_customized_samples`` the given Samples [B, T + S]
    and their probabilities; else S distinct classes drawn log-uniformly
    without replacement (Gumbel top-S over the class weights), each
    probability scaled by S (sample_prob.h's num_tries).  A negative
    equal to one of the row's true labels takes -1e20 with
    ``remove_accidental_hits``; SampledLogits = logit - log(probability),
    each kept tolerable."""
    logits = promote_float(x(ins, "Logits"))   # f32 out, as in the JAX rule
    labels = x(ins, "Labels").long()
    B, C = logits.shape
    T = labels.shape[1]
    S = int(attrs["num_samples"])
    dev = logits.device
    if attrs.get("use_customized_samples", False):
        samples = x(ins, "CustomizedSamples").long()
        probabilities = x(ins, "CustomizedProbabilities")
    else:
        k = torch.arange(C, device=dev, dtype=torch.float32)
        weights = torch.log(torch.log((k + 2.0) / (k + 1.0)))
        u = torch.rand((C,), generator=op_generator(ctx, attrs), device=dev)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        neg = torch.sort(weights + gumbel, descending=True, stable=True)[1][:S]
        p_neg = _log_uniform_prob(neg, C - 1) * S
        p_true = _log_uniform_prob(labels, C - 1) * S
        samples = torch.cat([labels, neg[None, :].expand(B, S)], dim=1)
        probabilities = torch.cat([p_true, p_neg[None, :].expand(B, S)], dim=1)
    sampled = take_steps(logits, samples)
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, None, :] == samples[:, :T, None]).any(dim=1)
        negative = torch.arange(samples.shape[1], device=dev)[None, :] >= T
        sampled = torch.where(negative & hit, sampled - 1e20, sampled)
    sampled = _tolerable(sampled - _tolerable(torch.log(probabilities)))
    return out(SampledLogits=sampled, Samples=samples,
               Probabilities=probabilities.detach(),
               SampledLabels=torch.arange(T, dtype=torch.int32, device=dev)
               [None, :].expand(B, T),
               LogitsDim=torch.tensor(tuple(logits.shape), dtype=torch.int32,
                                      device=dev),
               LabelsDim=torch.tensor(tuple(labels.shape), dtype=torch.int32,
                                      device=dev))


@register_op("sampling_id")
def _sampling_id(ins, attrs, ctx):
    """One draw from each row's distribution X [B, C]: the first index
    whose running sum reaches r ~ U[min, max) (a lower bound on the
    running sum, clipped to [0, C)), in X's dtype as the JAX rule
    returns it."""
    v = x(ins, "X")
    lo, hi = float(attrs.get("min", 0.0)), float(attrs.get("max", 1.0))
    r = torch.rand((v.shape[0], 1), generator=op_generator(ctx, attrs),
                   device=v.device) * (hi - lo) + lo
    cum = torch.cumsum(v.float(), dim=1)
    idx = (cum < r).sum(dim=1).clamp(0, v.shape[1] - 1)
    return out(Out=idx.to(v.dtype))
