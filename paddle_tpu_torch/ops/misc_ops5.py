"""Misc op rules on tensors: weight_norm (the counterpart of the rule in
``paddle_tpu/ops/misc_ops5.py``; the module's others wait).

Parity: param_attr.py WeightNormParamAttr's reparameterisation
(arXiv:1602.07868), emitted by ``layer_helper.py``.
"""

import torch

from ..registry import register_op
from .common import x, out


@register_op("weight_norm")
def _weight_norm(ins, attrs, ctx):
    """w = g * v / ||v||, the norm taken in f32.  ``dim`` is the axis kept
    un-normalised; None or negative normalises over every element, with a
    scalar g."""
    v, g = x(ins, "V"), x(ins, "G")
    dim = attrs.get("dim", None)
    sq = torch.square(v.float())
    if dim is None or dim < 0:
        norm = torch.sqrt(torch.sum(sq))
        scale = g.reshape(())
    else:
        axes = tuple(i for i in range(v.ndim) if i != dim)
        norm = torch.sqrt(torch.sum(sq, dim=axes, keepdim=True))
        shape = [1] * v.ndim
        shape[dim] = -1
        scale = g.reshape(shape)
    return out(Out=(scale / torch.clamp(norm, min=1e-12)).to(v.dtype) * v)
