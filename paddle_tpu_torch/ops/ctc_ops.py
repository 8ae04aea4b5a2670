"""The CTC loss op rule, warpctc (counterpart of
``paddle_tpu/ops/ctc_ops.py``; parity: operators/warpctc_op.cc, which
dlopens Baidu's warp-ctc).  As in the JAX rule, the forward recursion runs
in log space over the extended label sequence (a blank between labels and
at both ends), one time step at a time, and the gradient is autograd's
through it rather than warp-ctc's hand-written backward.

Shapes (the padded form of the reference's LoD contract):
  Logits       [B, T, C]  unnormalized; the ``blank`` attr picks the blank
  Label        [B, L]     padded label ids
  LogitsLength [B]        valid time steps of each row
  LabelLength  [B]        valid labels of each row
Output:
  Loss         [B, 1]     the negative log-likelihood of each row
"""

import torch

from ..registry import register_op
from .common import out, take_steps, x

# log(0) stand-in, as the JAX rule's; a float32 value, so that a float64
# run (the card checks' reference) starts from the f32 sentinel itself
NEG = float(torch.tensor(-1e30, dtype=torch.float32))


def _shift(alpha, k):
    """alpha moved k states right along axis 1, NEG in the k first."""
    return torch.cat([torch.full_like(alpha[:, :k], NEG), alpha[:, :-k]], dim=1)


def ctc_loss(logits, labels, logit_lens, label_lens, blank=0):
    """The CTC negative log-likelihood of each row ([B]): logits [B, T, C]
    (f32 unless float64), labels [B, L], lengths [B].  A row whose time
    steps ended keeps its alpha; a label id outside [0, C) reads NaN, as
    the JAX rule's ``take_along_axis`` fills."""
    B, T, C = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    lg = logits if logits.dtype == torch.float64 else logits.float()
    logp = torch.log_softmax(lg, dim=-1)
    dev = logits.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    pos = torch.arange(S, device=dev)[None, :]
    label_lens = label_lens.reshape(B, 1).long()
    valid = pos < 2 * label_lens + 1
    prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long, device=dev),
                       ext[:, :-2]], dim=1)
    can_skip = (pos % 2 == 1) & (ext != prev2)
    # every step's emissions at once: [B, T, S]
    emit = take_steps(logp.transpose(1, 2), ext).transpose(1, 2)
    neg = torch.full((), NEG, dtype=logp.dtype, device=dev)
    alpha = torch.where((pos == 0) | ((pos == 1) & (label_lens > 0)),
                        emit[:, 0], neg)
    alpha = torch.where(valid, alpha, neg)
    active = torch.arange(T, device=dev)[None, :] < logit_lens.reshape(B, 1)
    for t in range(1, T):
        acc = torch.logaddexp(alpha, _shift(alpha, 1))
        acc = torch.where(can_skip, torch.logaddexp(acc, _shift(alpha, 2)), acc)
        new = torch.where(valid, acc + emit[:, t], neg)
        alpha = torch.where(active[:, t:t + 1], new, alpha)
    last = 2 * label_lens
    a_last = take_steps(alpha, last)[:, 0]
    a_prev = take_steps(alpha, (last - 1).clamp(min=0))[:, 0]
    a_prev = torch.where(label_lens[:, 0] > 0, a_prev, neg)
    return -torch.logaddexp(a_last, a_prev)


@register_op("warpctc")
def _warpctc(ins, attrs, ctx):
    """``norm_by_times`` divides the gradient by each row's time steps and
    leaves the loss as it is (warpctc_op.cc): loss / T plus the rest with
    no gradient, the JAX rule's expression."""
    logits, labels = x(ins, "Logits"), x(ins, "Label")
    logit_lens, label_lens = x(ins, "LogitsLength"), x(ins, "LabelLength")
    B, T, _ = logits.shape
    dev = logits.device
    if logit_lens is None:
        logit_lens = torch.full((B,), T, dtype=torch.long, device=dev)
    if label_lens is None:
        label_lens = torch.full((B,), labels.shape[1], dtype=torch.long,
                                device=dev)
    loss = ctc_loss(logits, labels, logit_lens.reshape(-1),
                    label_lens.reshape(-1), blank=int(attrs.get("blank", 0)))
    if attrs.get("norm_by_times", False):
        t_f = logit_lens.reshape(-1).clamp(min=1).to(loss.dtype)
        scaled = loss / t_f
        loss = scaled + (loss - scaled).detach()
    return out(Loss=loss[:, None])
