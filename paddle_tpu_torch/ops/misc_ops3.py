"""Misc op rules on tensors: cos_sim and edit_distance (counterparts of
the rules in ``paddle_tpu/ops/misc_ops3.py``; the module's others wait,
ROADMAP Queue 1 item 3-B, tranche 5).

Parity: operators/cos_sim_op.cc, edit_distance_op.cc.
"""

import torch

from ..registry import register_op
from .common import x, out


@register_op("cos_sim")
def _cos_sim(ins, attrs, ctx):
    """Row cosines of X [B, D] and Y [B, D] (or [1, D], broadcast), with
    the row norms as XNorm and YNorm."""
    xv, y = x(ins, "X"), x(ins, "Y")
    xn = torch.sqrt(torch.square(xv).sum(dim=1, keepdim=True))
    yn = torch.sqrt(torch.square(y).sum(dim=1, keepdim=True))
    prod = (xv * y).sum(dim=1, keepdim=True)
    return out(Out=prod / (xn * yn), XNorm=xn, YNorm=yn)


def _levenshtein(hyps, refs, hlen, rlen):
    """The edit distance of each row's first hlen hyps and rlen refs, in
    f32: one DP row a hypothesis step, as the JAX rule's scan, each row
    in closed form.  With A[j] = min(row[j + 1] + 1, row[j] + cost(i, j))
    and new[-1] = i + 1, new[j] = min(A[j], new[j - 1] + 1) is
    min(i + 1 + j + 1, min_{k <= j} (A[k] - k) + j), a running minimum;
    the values are small integers, exact in f32.  Steps past hlen leave
    the row; entries past rlen never reach entry rlen."""
    B, Lh = hyps.shape
    Lr = refs.shape[1]
    dev = hyps.device
    j = torch.arange(Lr, device=dev, dtype=torch.float32)[None, :]
    row = torch.arange(Lr + 1, device=dev, dtype=torch.float32)[None, :]
    row = torch.minimum(row, rlen[:, None].float())
    for i in range(Lh):
        cost = (hyps[:, i:i + 1] != refs).float()
        a = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)
        run = torch.cummin(a - j, dim=1).values + j
        new = torch.minimum(run, (i + 1) + j + 1.0)
        new = torch.cat([torch.full((B, 1), float(i + 1), device=dev), new], 1)
        row = torch.where((i < hlen)[:, None], new, row)
    return row.gather(1, rlen.clamp(0, Lr)[:, None])[:, 0]


@register_op("edit_distance")
def _edit_distance(ins, attrs, ctx):
    """Hyps [B, Lh] and Refs [B, Lr] padded ids with their lengths (all
    of each without): the Levenshtein distance of each row [B, 1] (f32),
    divided by max(the ref's length, 1) when ``normalized``; SequenceNum
    the batch size."""
    hyps = x(ins, "Hyps").to(torch.int32)
    refs = x(ins, "Refs").to(torch.int32)
    hlen, rlen = x(ins, "HypsLength"), x(ins, "RefsLength")
    B = hyps.shape[0]
    dev = hyps.device
    hyps, refs = hyps.reshape(B, -1), refs.reshape(B, -1)
    hlen = (torch.full((B,), hyps.shape[1], dtype=torch.long, device=dev)
            if hlen is None else hlen.reshape(-1).long())
    rlen = (torch.full((B,), refs.shape[1], dtype=torch.long, device=dev)
            if rlen is None else rlen.reshape(-1).long())
    d = _levenshtein(hyps, refs, hlen, rlen)
    if attrs.get("normalized", False):
        d = d / rlen.float().clamp(min=1.0)
    return out(Out=d.reshape(B, 1),
               SequenceNum=torch.tensor(B, dtype=torch.int32, device=dev))
