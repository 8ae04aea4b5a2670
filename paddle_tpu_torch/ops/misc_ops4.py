"""ctc_align, the one rule of ``paddle_tpu/ops/misc_ops4.py`` the port has
(parity: operators/ctc_align_op.cc,.h: merge repeated tokens, then drop
the blanks); the module's others wait (ROADMAP Queue 1 item 3-B,
tranche 5)."""

import torch

from ..registry import register_op
from .common import out, x


@register_op("ctc_align")
def _ctc_align(ins, attrs, ctx):
    """Input [B, T] ids with InputLength [B] (all T without it): each row's
    kept tokens (not ``blank``, and with ``merge_repeated`` not equal to
    the step before, a blank included) packed to the front of Output
    [B, T], ``padding_value`` after; OutputLength [B, 1] their count."""
    inp = x(ins, "Input")
    lens = x(ins, "InputLength")
    blank = int(attrs.get("blank", 0))
    pad = int(attrs.get("padding_value", 0))
    B, T = inp.shape[:2]
    inp = inp.reshape(B, T).to(torch.int32)
    dev = inp.device
    lens = (torch.full((B,), T, dtype=torch.long, device=dev) if lens is None
            else lens.reshape(-1).long())
    keep = (torch.arange(T, device=dev)[None, :] < lens[:, None]) & (inp != blank)
    if attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full((B, 1), -1, dtype=inp.dtype, device=dev),
                          inp[:, :-1]], dim=1)
        keep = keep & (inp != prev)
    slot = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, T)
    packed = torch.full((B, T + 1), pad, dtype=torch.int32, device=dev)
    packed = packed.scatter(1, slot, inp)          # column T takes the drops
    return out(Output=packed[:, :T],
               OutputLength=keep.sum(dim=1).to(torch.int32).reshape(B, 1))
