"""Misc op rules on tensors: cos_sim (the counterpart of the rule in
``paddle_tpu/ops/misc_ops3.py``; the module's others wait).

Parity: operators/cos_sim_op.cc.
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
