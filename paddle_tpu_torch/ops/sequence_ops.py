"""Sequence op rules over the padded-dense representation: sequence_mask,
sequence_pool, sequence_reverse and sequence_conv (counterparts of the
rules in ``paddle_tpu/ops/sequence_ops.py``; its others wait).

Reference parity: operators/sequence_ops/ built on LoDTensor ragged offsets
(lod_tensor.h:52).  As in the JAX package, a batch of sequences is a
(padded data [N, T, ...], length [N]) pair: layers pass the length tensor
in the ``SeqLen`` slot, and masks stand in for the LoD offset walks, so no
value past a row's length reaches a result.
"""

import torch

from ..dtypes import convert_dtype
from ..registry import register_op
from .common import x, out
from .tensor_ops import take_fill


def _valid(data, length):
    """[N, T, 1, ...] bool: step t of row n lies inside its length."""
    t = torch.arange(data.shape[1], device=data.device)
    shape = [1, data.shape[1]] + [1] * (data.ndim - 2)
    return t.reshape(shape) < length.reshape([-1] + [1] * (data.ndim - 1))


def _per_row(length, data):
    return length.reshape([-1] + [1] * (data.ndim - 2))


def _take_steps(data, idx):
    """``data[n, idx[n, k]]`` for an [N, K] index, with
    ``jnp.take_along_axis``'s fill: a negative step counts from the end,
    and a step still outside [0, T) reads ``take_fill``'s fill (NaN for
    floats) and takes no gradient."""
    N, T = data.shape[:2]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + T, idx)
    flat = torch.arange(N, device=data.device)[:, None] * T + idx
    flat = torch.where((idx >= 0) & (idx < T), flat, N * T)   # past the end
    rows = take_fill(data.reshape((N * T,) + data.shape[2:]), flat.reshape(-1))
    return rows.reshape(tuple(idx.shape) + data.shape[2:])


@register_op("sequence_mask")
def _sequence_mask(ins, attrs, ctx):
    length = x(ins, "X")
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen, as the "
                         "JAX rule does")
    m = (torch.arange(maxlen, device=length.device)[None, :]
         < length.reshape(-1, 1))
    return out(Y=m.to(convert_dtype(attrs.get("out_dtype", "int64"))))


@register_op("sequence_pool")
def _sequence_pool(ins, attrs, ctx):
    """SUM / AVERAGE / SQRT / MAX / LAST / FIRST over each row's first
    ``length`` steps (all T without SeqLen).  MAX takes ``amax``, so tied
    maxima share the gradient as under ``jnp.max``; a row of length 0 gives
    -inf under MAX and 0 under the sums."""
    data, length = x(ins, "X"), x(ins, "SeqLen")
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    if length is None:
        length = torch.full((data.shape[0],), data.shape[1],
                            dtype=torch.int64, device=data.device)
    m = _valid(data, length)
    # a float 0, as the JAX rule's: integer data sums in f32
    if ptype == "SUM":
        r = torch.where(m, data, 0.0).sum(dim=1)
    elif ptype == "AVERAGE":
        r = (torch.where(m, data, 0.0).sum(dim=1)
             / _per_row(length, data).clamp(min=1))
    elif ptype == "SQRT":
        r = (torch.where(m, data, 0.0).sum(dim=1)
             / torch.sqrt(_per_row(length, data).clamp(min=1).to(data.dtype)))
    elif ptype == "MAX":
        r = torch.where(m, data, float("-inf")).amax(dim=1)
    elif ptype == "LAST":
        # a length past T reads the fill, as take_along_axis
        r = _take_steps(data, (length - 1).clamp(min=0).reshape(-1, 1))[:, 0]
    elif ptype == "FIRST":
        r = data[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return out(Out=r)


@register_op("sequence_reverse")
def _sequence_reverse(ins, attrs, ctx):
    """Reverses each row's first ``length`` steps in place; the padding
    stays where it is (the whole time axis without SeqLen).  A length past
    T reads steps past T: ``take_fill``'s fill (NaN for floats), as the
    JAX rule's ``take_along_axis``."""
    data, length = x(ins, "X"), x(ins, "SeqLen")
    if length is None:
        return out(Y=torch.flip(data, dims=(1,)))
    t = torch.arange(data.shape[1], device=data.device)[None, :]
    ln = length.reshape(-1, 1)
    return out(Y=_take_steps(data, torch.where(t < ln, ln - 1 - t, t)))


@register_op("sequence_conv")
def _sequence_conv(ins, attrs, ctx):
    """Context-window convolution over time (ref sequence_conv_op.cc): each
    step concatenates contextLength neighbouring steps, starting at
    contextStart relative to t, zero outside [0, length), and projects by
    Filter [ctx * D, M]; steps past the length give zeros."""
    data = x(ins, "X")                                # [B, T, D]
    filt = x(ins, "Filter")                           # [ctx * D, M]
    seq_len = x(ins, "SeqLen")
    if attrs.get("paddingTrainable", False):
        raise NotImplementedError(
            "sequence_conv: paddingTrainable/PaddingData is not implemented "
            "(out-of-window context is zero-padded), as in the JAX rule")
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    B, T, D = data.shape
    dev = data.device
    src = (torch.arange(T, device=dev)[None, :, None]
           + torch.arange(ctx_len, device=dev)[None, None, :] + ctx_start)
    lim = seq_len.reshape(-1, 1, 1) if seq_len is not None else T
    inb = (src >= 0) & (src < lim)                    # [B or 1, T, ctx]
    g = data[torch.arange(B, device=dev)[:, None, None], src.clamp(0, T - 1)]
    g = torch.where(inb[..., None], g, torch.zeros((), dtype=g.dtype,
                                                  device=dev))
    r = g.reshape(B, T, ctx_len * D) @ filt
    if seq_len is not None:
        r = r * (torch.arange(T, device=dev)[None, :, None]
                 < seq_len.reshape(-1, 1, 1)).to(r.dtype)
    return out(Out=r)
