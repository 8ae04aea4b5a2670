"""Sequence op rules over the padded-dense representation (counterparts of
every rule in ``paddle_tpu/ops/sequence_ops.py``): sequence_mask,
sequence_pool, sequence_softmax, sequence_reverse, sequence_expand_as,
sequence_concat, sequence_pad, sequence_unpad, im2sequence,
sequence_slice, sequence_erase, sequence_enumerate, sequence_conv,
sequence_expand, sequence_scatter and sequence_topk_avg_pooling.

Reference parity: operators/sequence_ops/ built on LoDTensor ragged offsets
(lod_tensor.h:52).  As in the JAX package, a batch of sequences is a
(padded data [N, T, ...], length [N]) pair: layers pass the length tensor
in the ``SeqLen`` slot, and masks stand in for the LoD offset walks, so no
value past a row's length reaches a result.
"""

import torch
import torch.nn.functional as F

from ..dtypes import convert_dtype
from ..registry import register_op
from .common import lax_top_k, out, take_steps, x


def _valid(data, length):
    """[N, T, 1, ...] bool: step t of row n lies inside its length."""
    t = torch.arange(data.shape[1], device=data.device)
    shape = [1, data.shape[1]] + [1] * (data.ndim - 2)
    return t.reshape(shape) < length.reshape([-1] + [1] * (data.ndim - 1))


def _per_row(length, data):
    return length.reshape([-1] + [1] * (data.ndim - 2))


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
        r = take_steps(data, (length - 1).clamp(min=0).reshape(-1, 1))[:, 0]
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
    return out(Y=take_steps(data, torch.where(t < ln, ln - 1 - t, t)))


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


def _step_mask(data, length):
    """``_valid``, or every step when there is no SeqLen input."""
    if length is None:
        return torch.ones((1, data.shape[1]) + (1,) * (data.ndim - 2),
                          dtype=torch.bool, device=data.device)
    return _valid(data, length)


@register_op("sequence_softmax")
def _sequence_softmax(ins, attrs, ctx):
    """A softmax over each row's valid steps (axis 1); the padding gives 0
    and takes no gradient, a row of length 0 included."""
    data, length = x(ins, "X"), x(ins, "SeqLen")
    m = _step_mask(data, length)
    r = torch.softmax(torch.where(m, data, float("-inf")), dim=1)
    return out(Out=torch.where(m, r, 0.0))


@register_op("sequence_expand_as")
def _sequence_expand_as(ins, attrs, ctx):
    """Row i of X repeated over Y's time axis: [B, T_y, ...]."""
    data, ref = x(ins, "X"), x(ins, "Y")
    return out(Out=data[:, None].expand(
        (data.shape[0], ref.shape[1]) + tuple(data.shape[1:])))


@register_op("sequence_concat")
def _sequence_concat(ins, attrs, ctx):
    return out(Out=torch.cat(list(ins["X"]), dim=1))


@register_op("sequence_pad")
def _sequence_pad(ins, attrs, ctx):
    """The inputs are padded already: X passes, with its lengths."""
    return out(Out=x(ins, "X"), Length=x(ins, "SeqLen"))


@register_op("sequence_unpad")
def _sequence_unpad(ins, attrs, ctx):
    return out(Out=x(ins, "X"), SeqLen=x(ins, "Length"))


@register_op("im2sequence")
def _im2sequence(ins, attrs, ctx):
    """Each kh x kw window of an NCHW image (stride, no padding: the
    ``paddings`` attr is not read, as in the JAX rule) as one step of
    C kh kw values, channel-major: [N, oh ow, C kh kw].  Integer and bool
    images gather in float64, exactly, and come back to their dtype."""
    v = x(ins, "X")
    kh, kw = (int(k) for k in attrs["kernels"])
    sh, sw = (int(s) for s in attrs.get("strides", [1, 1]))
    w = v if v.is_floating_point() else v.double()
    cols = F.unfold(w, (kh, kw), stride=(sh, sw)).transpose(1, 2)
    if not v.is_floating_point():
        cols = cols != 0 if v.dtype == torch.bool else cols.to(v.dtype)
    return out(Out=cols)


@register_op("sequence_slice")
def _sequence_slice(ins, attrs, ctx):
    """Row b holds X[b, Offset[b] : Offset[b] + Length[b]] left-aligned
    (steps read past either end clamp to it), zero after Length[b]."""
    data = x(ins, "X")
    offset = x(ins, "Offset").reshape(-1).long()
    length = x(ins, "Length").reshape(-1).long()
    T = data.shape[1]
    t = torch.arange(T, device=data.device)[None, :]
    got = take_steps(data, (offset[:, None] + t).clamp(0, T - 1))
    if got.dtype == torch.bool:
        got = got.int()       # bool and the 0 fill promote to int32 in JAX
    valid = (t < length[:, None]).reshape(tuple(got.shape[:2])
                                          + (1,) * (data.ndim - 2))
    return out(Out=torch.where(valid, got, torch.zeros((), dtype=got.dtype,
                                                         device=data.device)))


@register_op("sequence_erase")
def _sequence_erase(ins, attrs, ctx):
    """Drops the listed tokens from each row's valid steps: the survivors
    pack to the front, zeros after, SeqLenOut the new lengths."""
    data, seq_len = x(ins, "X"), x(ins, "SeqLen")
    B, T = data.shape
    t = torch.arange(T, device=data.device)[None, :]
    keep = ((t < seq_len.reshape(-1, 1)) if seq_len is not None
            else torch.ones_like(data, dtype=torch.bool)).expand(B, T)
    for tok in attrs.get("tokens", []):
        keep = keep & (data != tok)
    pos = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, T)
    packed = torch.zeros((B, T + 1), dtype=data.dtype, device=data.device)
    packed = packed.scatter(1, pos, data)          # column T takes the drops
    return out(Out=packed[:, :T], SeqLenOut=keep.long().sum(dim=1))


@register_op("sequence_enumerate")
def _sequence_enumerate(ins, attrs, ctx):
    """Out[b, t] = X[b, t : t + win_size], ``pad_value`` past the row's
    length (past T without SeqLen)."""
    data, seq_len = x(ins, "X"), x(ins, "SeqLen")
    win = int(attrs["win_size"])
    T = data.shape[1]
    dev = data.device
    src = (torch.arange(T, device=dev)[None, :, None]
           + torch.arange(win, device=dev)[None, None, :])
    lim = seq_len.reshape(-1, 1, 1) if seq_len is not None else T
    B = data.shape[0]
    got = take_steps(data, src.clamp(0, T - 1).expand(B, T, win)
                     .reshape(B, T * win)).reshape(B, T, win)
    pad = torch.full((), attrs.get("pad_value", 0), dtype=data.dtype, device=dev)
    return out(Out=torch.where(src < lim, got, pad))


@register_op("sequence_expand")
def _sequence_expand(ins, attrs, ctx):
    """Each row of X repeated k times in place, k = Y.shape[1] (1 for a
    1-D Y): Out[i k + j] = X[i], the uniform repeat of the padded form."""
    data, ref = x(ins, "X"), x(ins, "Y")
    k = int(ref.shape[1]) if ref.ndim >= 2 else 1
    return out(Out=torch.repeat_interleave(data, k, dim=0))


@register_op("sequence_scatter")
def _sequence_scatter(ins, attrs, ctx):
    """Out = X; Out[b, Ids[b, l]] += Updates[b, l] for l < SeqLen[b].  A
    negative id counts from the end, one still outside [0, D) is dropped,
    as JAX's ``.at[].add``."""
    base = x(ins, "X")
    ids, upd, seq_len = x(ins, "Ids"), x(ins, "Updates"), x(ins, "SeqLen")
    B, D = base.shape
    L = ids.shape[1]
    ids = ids.reshape(B, L).long()
    upd = upd.reshape(B, L)
    if seq_len is not None:
        m = torch.arange(L, device=ids.device)[None, :] < seq_len.reshape(-1, 1)
        upd = torch.where(m, upd, torch.zeros((), dtype=upd.dtype,
                                              device=upd.device))
    ids = torch.where(ids < 0, ids + D, ids)
    ids = torch.where((ids >= 0) & (ids < D), ids, D)
    flat = (torch.arange(B, device=ids.device)[:, None] * (D + 1) + ids).reshape(-1)
    wide = F.pad(base, (0, 1))
    wide = wide.reshape(-1).index_put((flat,), upd.reshape(-1).to(base.dtype),
                                      accumulate=True)
    return out(Out=wide.reshape(B, D + 1)[:, :D])


@register_op("sequence_topk_avg_pooling")
def _sequence_topk_avg_pooling(ins, attrs, ctx):
    """X [B, C, R, L] with COLUMN lengths [B]: for each k of ``topks`` the
    sum of each (row, channel)'s top min(k, length) scores over k, as
    Out [B, R, C len(topks)]; pos [B, R, C, max k] the top columns (-1
    where fewer are valid), chosen as ``lax.top_k`` (``lax_top_k``); a
    non-finite score counts as missing, as in the JAX rule."""
    data, col_len = x(ins, "X"), x(ins, "COLUMN")
    dtype = data.dtype
    topks = [int(k) for k in attrs["topks"]]
    max_k = max(topks)
    B, C, R, L = data.shape
    channel_num = int(attrs.get("channel_num", C))
    if channel_num != C:
        raise ValueError(
            "sequence_topk_avg_pooling: channel_num attr (%d) != X channel "
            "dim (%d)" % (channel_num, C))
    if col_len is not None:
        m = (torch.arange(L, device=data.device)[None, None, None, :]
             < col_len.reshape(-1).long()[:, None, None, None])
        data = torch.where(m, data, float("-inf"))
    vals, pos = lax_top_k(data, min(max_k, L))
    if max_k > L:
        vals = F.pad(vals, (0, max_k - L), value=float("-inf"))
        pos = F.pad(pos, (0, max_k - L), value=-1)
    invalid = ~torch.isfinite(vals)
    cum = torch.cumsum(torch.where(invalid, 0.0, vals), dim=-1)
    o = torch.stack([cum[..., kk - 1] / kk for kk in topks], dim=-1)
    o = o.permute(0, 2, 1, 3).reshape(B, R, C * len(topks))
    pos = torch.where(invalid, -1, pos).permute(0, 2, 1, 3)
    return out(Out=o.to(dtype), pos=pos.to(torch.int32))
