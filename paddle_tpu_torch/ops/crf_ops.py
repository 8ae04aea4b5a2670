"""Linear-chain CRF op rules on the padded-batch representation:
linear_chain_crf and crf_decoding (counterparts of
``paddle_tpu/ops/crf_ops.py``).

Parity: operators/linear_chain_crf_op.h, crf_decoding_op.h.  Transition is
[D + 2, D]: row 0 the start weights a, row 1 the end weights b, rows 2.. the
pairwise matrix w (w[i, j]: tag i -> tag j).  ``linear_chain_crf`` emits the
positive loss log Z - score(label path) per row, as the reference's
LogLikelihood output; ``crf_decoding`` the Viterbi path, or with a Label the
per-step match indicator.  The JAX rules' ``lax.scan`` over time steps is a
Python loop here; the Viterbi argmax takes the first of tied maxima, as
``jnp.argmax`` (and ``torch.argmax``) do.
"""

import torch

from ..registry import register_op
from .common import x, out


def _unpack(transition):
    return transition[0], transition[1], transition[2:]


def _lengths(length, B, T, device):
    if length is None:
        return torch.full((B,), T, dtype=torch.long, device=device)
    return length.reshape(B).long()


def crf_nll(emission, transition, label, lengths):
    """[B] positive losses: log Z - score(label path).  A row of length 0
    costs exactly 0 (linear_chain_crf_op.h)."""
    B, T, D = emission.shape
    a, b, w = _unpack(transition)
    em = emission.float()
    lab = label.long()
    ln = lengths.reshape(B).long()

    # partition function: the forward algorithm in log space; a row past
    # its length keeps its alpha
    alpha = a[None, :] + em[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + em[:, t]
        alpha = torch.where((t < ln)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + b[None, :], dim=1)

    # the gold path's score
    t_idx = torch.arange(T, device=em.device)[None, :]
    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    em_lab = torch.gather(em, 2, lab.clamp(0, D - 1)[:, :, None])[:, :, 0]
    em_score = torch.where(t_idx < ln[:, None], em_lab, zero).sum(dim=1)
    pair = w[lab[:, :-1], lab[:, 1:]]                       # [B, T - 1]
    trans_score = torch.where(t_idx[:, 1:] < ln[:, None], pair, zero).sum(dim=1)
    last = torch.gather(lab, 1, (ln - 1).clamp(min=0)[:, None])[:, 0]
    path = em_score + trans_score + a[lab[:, 0]] + b[last]
    return torch.where(ln > 0, logz - path, zero)


@register_op("linear_chain_crf")
def _linear_chain_crf(ins, attrs, ctx):
    emission = x(ins, "Emission")                # [B, T, D] padded
    transition = x(ins, "Transition")            # [D + 2, D]
    label = x(ins, "Label")                      # [B, T]
    B, T, _ = emission.shape
    if label.ndim == 3:
        label = label[..., 0]
    length = _lengths(x(ins, "Length"), B, T, emission.device)
    return out(LogLikelihood=crf_nll(emission, transition, label,
                                     length)[:, None])


@register_op("crf_decoding")
def _crf_decoding(ins, attrs, ctx):
    """Viterbi decode.  Without Label: ViterbiPath holds the best tag per
    step, 0 past each row's length.  With Label: 1 where the decoded tag
    equals the label inside the length, else 0."""
    emission = x(ins, "Emission")                # [B, T, D]
    transition = x(ins, "Transition")
    label = x(ins, "Label")
    B, T, D = emission.shape
    a, b, w = _unpack(transition)
    em = emission.float()
    ln = _lengths(x(ins, "Length"), B, T, em.device)

    delta = a[None, :] + em[:, 0]
    backptr = []                                 # T - 1 of [B, D]
    for t in range(1, T):
        cand = delta[:, :, None] + w[None]       # [B, prev, cur]
        best = cand.amax(dim=1) + em[:, t]
        backptr.append(cand.argmax(dim=1))       # the first of tied maxima
        delta = torch.where((t < ln)[:, None], best, delta)
    last_tag = (delta + b[None, :]).argmax(dim=1)            # [B]

    # the backward walk emits the tag at t = T-1 .. 0: each row starts at
    # its own last step (t == ln - 1) with last_tag and follows the back
    # pointers inside [1, ln - 1]; padding steps carry through and are
    # masked after
    rows = torch.arange(B, device=em.device)
    tag = last_tag
    path = [None] * T
    for t in range(T - 1, -1, -1):
        tag_here = torch.where(t == ln - 1, last_tag, tag)
        if T > 1:
            prev = backptr[min(max(t - 1, 0), T - 2)][rows, tag_here]
            tag = torch.where((t > 0) & (t <= ln - 1), prev, tag_here)
        else:
            tag = tag_here
        path[t] = tag_here
    path = torch.stack(path, dim=1)                          # [B, T]
    valid = torch.arange(T, device=em.device)[None, :] < ln[:, None]
    path = torch.where(valid, path, torch.zeros_like(path))
    if label is not None:
        lab = label[..., 0] if label.ndim == 3 else label
        return out(ViterbiPath=((path == lab.long()) & valid).long())
    return out(ViterbiPath=path.long())
