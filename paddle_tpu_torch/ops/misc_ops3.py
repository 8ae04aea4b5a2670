"""Misc op rules on tensors: the counterparts of every rule in
``paddle_tpu/ops/misc_ops3.py`` (cos_sim and edit_distance since ROADMAP
Queue 1 item 3-B's tranche 4, the other sixteen since tranche 5).

Parity (operators/): edit_distance_op.cc, chunk_eval_op.cc,.h,
mean_iou_op.cc, spectral_norm_op.cc, affine_grid_op.cc,
bilinear_tensor_product_op.cc, cos_sim_op.cc, squared_l2_distance_op.cc,
modified_huber_loss_op.cc,.h, unique_op.cc, size_op.cc,
fill_any_like_op.cc, one_hot_v2_op.cc, crop_tensor_op.cc,
add_position_encoding_op.h, random_crop_op.cc,.h, lstm_unit_op.h,
deformable_conv_op.cc (DCNv2).

``unique`` keeps the JAX rule's static shape: Out is padded to the
input's length with the last unique value, in first-appearance order, and
Index is exact.
"""

import numpy as np
import torch

from ..dtypes import convert_dtype
from ..registry import register_op
from .common import (exact_matmul, op_generator, out, promote_float,
                     promoting_matmul, saturating_cast, x)
from .misc_ops import _dynamic_slice, _static_slice


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


# -- chunk_eval -------------------------------------------------------------

_SCHEMES = {
    # num_tag_types, tag_begin, tag_inside, tag_end, tag_single
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, 0, -1, -1),
}


def _chunk_begin(pt, pty, t, ty, other, tb, ti, te, ts):
    """ChunkBegin (chunk_eval_op.h:83), elementwise."""
    w = torch.where
    return w(pty == other, ty != other,
           w(ty == other, False,
           w(ty != pty, True,
           w(t == tb, True,
           w(t == ti, (pt == te) | (pt == ts),
           w(t == te, (pt == te) | (pt == ts), t == ts))))))


def _chunk_end(pt, pty, t, ty, other, tb, ti, te, ts):
    """ChunkEnd (chunk_eval_op.h:96), elementwise."""
    w = torch.where
    return w(pty == other, False,
           w(ty == other, True,
           w(ty != pty, True,
           w(pt == tb, (t == tb) | (t == ts),
           w(pt == ti, (t == tb) | (t == ts),
           (pt == te) | (pt == ts))))))


def _segments(labels, valid, num_tag, other, scheme):
    """Per position of [B, L] labels: whether a chunk begins there, the
    position its chunk ends at (L + 1 past every end) and its type."""
    B, L = labels.shape
    dev = labels.device
    tags = torch.remainder(labels, num_tag)
    types = torch.div(labels, num_tag, rounding_mode="floor")
    ptag = torch.cat([torch.full((B, 1), -2, dtype=tags.dtype, device=dev),
                      tags[:, :-1]], dim=1)
    ptype = torch.cat([torch.full((B, 1), other, dtype=types.dtype, device=dev),
                       types[:, :-1]], dim=1)
    beg = _chunk_begin(ptag, ptype, tags, types, other, *scheme) & valid
    ntag = torch.cat([tags[:, 1:], torch.full((B, 1), -2, dtype=tags.dtype,
                                              device=dev)], dim=1)
    ntype = torch.cat([types[:, 1:], torch.full((B, 1), other,
                                                dtype=types.dtype, device=dev)],
                      dim=1)
    nvalid = torch.cat([valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool,
                                                  device=dev)], dim=1)
    ntype = torch.where(nvalid, ntype, other)
    end_at = (_chunk_end(tags, types, ntag, ntype, other, *scheme) & valid
              & (types != other))
    idx = torch.arange(L, device=dev).expand(B, L)
    endpos = torch.where(end_at, idx, L + 1)
    endpos = torch.flip(torch.cummin(torch.flip(endpos, (1,)), dim=1).values,
                        (1,))
    return beg, endpos, types


def _kept(types, excluded):
    keep = torch.ones_like(types, dtype=torch.bool)
    for e in excluded:
        keep &= types != e
    return keep


@register_op("chunk_eval")
def _chunk_eval(ins, attrs, ctx):
    """Chunk precision, recall and F1 of padded [B, L] tag ids against the
    labels (rows cut at SeqLength), under the IOB, IOE, IOBES or plain
    scheme, without ``excluded_chunk_types``; the three counts int32."""
    inf = x(ins, "Inference").to(torch.int32)
    lab = x(ins, "Label").to(torch.int32)
    seqlen = x(ins, "SeqLength")
    B, L = tuple(inf.shape[:2]) if inf.ndim >= 2 else (1, inf.shape[0])
    inf, lab = inf.reshape(B, L), lab.reshape(B, L)
    dev = inf.device
    lens = (torch.full((B,), L, dtype=torch.int32, device=dev) if seqlen is None
            else seqlen.reshape(-1).to(torch.int32))
    num_tag, *scheme = _SCHEMES[attrs.get("chunk_scheme", "IOB")]
    other = int(attrs["num_chunk_types"])
    excluded = list(attrs.get("excluded_chunk_types") or [])
    valid = torch.arange(L, device=dev)[None, :] < lens[:, None]
    bi, ei, tyi = _segments(inf, valid, num_tag, other, scheme)
    bl, el, tyl = _segments(lab, valid, num_tag, other, scheme)
    keep_i = _kept(tyi, excluded)
    num_infer = (bi & keep_i).sum().to(torch.int32)
    num_label = (bl & _kept(tyl, excluded)).sum().to(torch.int32)
    num_correct = (bi & bl & (ei == el) & (tyi == tyl) & keep_i).sum().to(
        torch.int32)
    return chunk_scores(num_infer, num_label, num_correct)


def chunk_scores(num_infer, num_label, num_correct):
    """chunk_eval's outputs from its three int32 counts (data parallelism
    passes the counts summed over the ranks)."""
    one = torch.ones((), dtype=torch.int32, device=num_infer.device)
    p = torch.where(num_infer > 0, num_correct / torch.maximum(num_infer, one),
                    0.0)
    r = torch.where(num_label > 0, num_correct / torch.maximum(num_label, one),
                    0.0)
    f1 = torch.where(num_correct > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     0.0)
    return out(Precision=p.float(), Recall=r.float(), F1=f1.float(),
               NumInferChunks=num_infer, NumLabelChunks=num_label,
               NumCorrectChunks=num_correct)


# -- mean_iou ---------------------------------------------------------------

def _class_counts(ids, weights, n):
    """``zeros(n).at[ids].add(weights)``, int32: a negative id counts from
    the end once, one still out of range is dropped."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    acc = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    return acc.index_add(0, torch.where(ok, ids, n), weights.to(torch.int32))[:n]


@register_op("mean_iou")
def _mean_iou(ins, attrs, ctx):
    """Per class, correct and wrong counts (int32, with the In* inputs
    added) and the mean IoU over the classes that occur."""
    pred = x(ins, "Predictions").to(torch.int32).reshape(-1)
    label = x(ins, "Labels").to(torch.int32).reshape(-1)
    n = int(attrs["num_classes"])
    correct = _class_counts(label, pred == label, n)
    ones = torch.ones_like(pred)
    wrong = _class_counts(pred, ones, n) + _class_counts(label, ones, n) \
        - 2 * correct
    for t in ins.get("InWrongs") or []:
        wrong = wrong + t.to(torch.int32)
    corr = correct
    for t in ins.get("InCorrects") or []:
        corr = corr + t.to(torch.int32)
    denom = wrong + corr
    valid = denom > 0
    iou = torch.where(valid, corr / denom.clamp(min=1), 0.0)
    mean_iou = iou.sum() / valid.sum().to(torch.int32).clamp(min=1)
    for t in ins.get("InMeanIou") or []:
        mean_iou = mean_iou + t
    return out(MeanIou=mean_iou.float(), OutWrong=wrong, OutCorrect=corr)


# -- spectral_norm ----------------------------------------------------------

@register_op("spectral_norm")
def _spectral_norm(ins, attrs, ctx):
    """Weight / sigma, sigma = u^T W v after ``power_iters`` unrolled power
    iterations from the inputs U and V (each normalised as a / (||a|| +
    eps)); u and v take no gradient."""
    w = x(ins, "Weight")
    u, v = x(ins, "U").reshape(-1), x(ins, "V").reshape(-1)
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)

    def l2norm(a):
        a = promote_float(a)
        return a / (torch.linalg.vector_norm(a) + eps)

    # integer and bool products keep their kind until a float meets them
    for _ in range(int(attrs.get("power_iters", 1))):
        v = l2norm(promoting_matmul(mat.T, u))
        u = l2norm(promoting_matmul(mat, v))
    u, v = u.detach(), v.detach()
    sigma = promoting_matmul(promoting_matmul(u, mat), v)
    o = (mat / sigma).reshape([w.shape[d] for d in perm])
    return out(Out=o.permute(tuple(np.argsort(perm).tolist())))


# -- affine_grid ------------------------------------------------------------

@register_op("affine_grid")
def _affine_grid(ins, attrs, ctx):
    """Theta [N, 2, 3] over an align-corners grid in [-1, 1]: Output
    [N, H, W, 2].  The size comes from ``output_shape`` (an OutputShape
    input is read where the attr is absent)."""
    theta = x(ins, "Theta")
    if "output_shape" in attrs or x(ins, "OutputShape") is None:
        oshape = list(attrs["output_shape"])
    else:
        oshape = x(ins, "OutputShape").reshape(-1).tolist()
    H, W = int(oshape[2]), int(oshape[3])
    dev = theta.device

    def linspace(n):
        if n > 1:
            return (torch.arange(n, dtype=torch.float32, device=dev)
                    * np.float32(2.0 / (n - 1)) - 1.0)
        return torch.zeros(n, dtype=torch.float32, device=dev)

    gy, gx = torch.meshgrid(linspace(H), linspace(W), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)    # [H, W, 3]
    grid = torch.einsum("hwk,njk->nhwj", base, promote_float(theta))
    return out(Output=saturating_cast(grid, theta.dtype))


# -- bilinear_tensor_product ------------------------------------------------

@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ins, attrs, ctx):
    """out[b, k] = x[b] W[k] y[b] (+ bias[k])."""
    xv, y, w = x(ins, "X"), x(ins, "Y"), x(ins, "Weight")
    bias = x(ins, "Bias")
    if xv.is_floating_point() or y.is_floating_point() or w.is_floating_point():
        o = torch.einsum("bm,kmn,bn->bk", xv, w, y)
    else:
        xw = exact_matmul(xv[:, None, None, :], w[None])         # [B, K, 1, N]
        o = exact_matmul(xw, y[:, None, :, None])[:, :, 0, 0]
    if bias is not None:
        o = o + bias.reshape(1, -1)
    return out(Out=o)


# -- squared_l2_distance / modified_huber_loss -------------------------------

@register_op("squared_l2_distance")
def _squared_l2_distance(ins, attrs, ctx):
    sub = x(ins, "X") - x(ins, "Y")                      # Y broadcasts if B == 1
    return out(Out=torch.square(sub).sum(dim=1, keepdim=True), sub_result=sub)


@register_op("modified_huber_loss")
def _modified_huber_loss(ins, attrs, ctx):
    """-4 z below -1, (1 - z)^2 up to 1, then 0, z = x (2 y - 1)."""
    inter = x(ins, "X") * (2.0 * x(ins, "Y") - 1.0)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, torch.square(1.0 - inter), 0.0))
    return out(Out=loss, IntermediateVal=inter)


# -- unique -----------------------------------------------------------------

@register_op("unique")
def _unique(ins, attrs, ctx):
    """Sort-based dedup in first-appearance order, static shape: Out [n]
    holds the uniques, then the last one repeated; Index [n] each input's
    unique position (``dtype``, int32 by default).  The sort is stable,
    -0 equal to +0 and NaN the largest (each NaN a value of its own), as
    ``jnp.argsort``'s."""
    xv = x(ins, "X").reshape(-1)
    n = xv.shape[0]
    dev = xv.device
    xs, order = torch.sort(xv, stable=True)
    newf = torch.ones(n, dtype=torch.bool, device=dev)
    newf[1:] = xs[1:] != xs[:-1]
    gid = torch.cumsum(newf.to(torch.int64), 0) - 1
    count = newf.sum()
    gfirst = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, order, reduce="amin")
    grank = torch.argsort(torch.argsort(gfirst, stable=True), stable=True)
    index = torch.zeros(n, dtype=torch.int64, device=dev).scatter(
        0, order, grank[gid])
    slot = torch.where(newf, grank[gid], n)
    uniq = torch.zeros(n + 1, dtype=xv.dtype, device=dev).scatter(
        0, slot, xs)[:n]
    last = uniq[(count - 1).clamp(min=0)]
    uniq = torch.where(torch.arange(n, device=dev) < count, uniq, last)
    return out(Out=uniq,
               Index=index.to(convert_dtype(attrs.get("dtype", "int32"))))


# -- size / fill_any_like / one_hot_v2 -------------------------------------

@register_op("size")
def _size(ins, attrs, ctx):
    v = x(ins, "Input")
    return out(Out=torch.tensor(v.numel(), dtype=torch.int32, device=v.device))


@register_op("fill_any_like")
def _fill_any_like(ins, attrs, ctx):
    """X's shape filled with ``value`` in ``dtype`` (X's for -1), the value
    converted as ``fill_constant``'s."""
    from .tensor_ops import _fill_value

    v = x(ins, "X")
    dt = attrs.get("dtype", -1)
    dtype = v.dtype if dt in (-1, None) else convert_dtype(dt)
    value = _fill_value({"value": attrs.get("value", 0.0), "dtype": dtype})
    return out(Out=torch.full(tuple(v.shape), value, dtype=dtype,
                              device=v.device))


@register_op("one_hot_v2")
def _one_hot_v2(ins, attrs, ctx):
    """The depth axis appended (f32); an id outside [0, depth) gives a row
    of zeros."""
    ids = x(ins, "X").to(torch.int32)
    depth = int(attrs["depth"])
    return out(Out=(ids[..., None] == torch.arange(
        depth, dtype=torch.int32, device=ids.device)).to(torch.float32))


# -- crop_tensor ------------------------------------------------------------

@register_op("crop_tensor")
def _crop_tensor(ins, attrs, ctx):
    """Crop to ``shape`` (attr, or the Shape input; -1 or 0 keeps the axis)
    from ``offsets``: static offsets (the attr, or none) past the axis
    raise (``lax.slice``); an Offsets input is clamped into the axis
    (``dynamic_slice``)."""
    v = x(ins, "X")
    shape = attrs.get("shape") or x(ins, "Shape").reshape(-1).tolist()
    offsets = attrs.get("offsets")
    shape = [int(v.shape[i]) if int(s) in (-1, 0) else int(s)
             for i, s in enumerate(shape)]
    if offsets is None and x(ins, "Offsets") is not None:
        return out(Out=_dynamic_slice(
            v, x(ins, "Offsets").reshape(-1).tolist()[:v.ndim], shape))
    offsets = [0] * v.ndim if offsets is None else [int(o) for o in offsets]
    return out(Out=_static_slice(v, offsets,
                                 [o + s for o, s in zip(offsets, shape)]))


# -- add_position_encoding --------------------------------------------------

@register_op("add_position_encoding")
def _add_position_encoding(ins, attrs, ctx):
    """alpha x + beta PE, PE [L, D] half sines then half cosines of
    pos / 10000^(k / (D/2 - 1)), back in x's dtype."""
    v = x(ins, "X")
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    B, L, D = v.shape
    half = D // 2
    dev = v.device
    pos = torch.arange(L, dtype=torch.float32, device=dev)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=dev)[None, :]
    denom = (torch.pow(torch.tensor(10000.0, device=dev), k / (half - 1))
             if half > 1 else torch.full((1, 1), 10000.0, device=dev))
    val = pos / denom
    enc = torch.cat([torch.sin(val), torch.cos(val)], dim=1)
    return out(Out=saturating_cast(alpha * v + beta * enc[None], v.dtype))


# -- random_crop ------------------------------------------------------------

@register_op("random_crop")
def _random_crop(ins, attrs, ctx):
    """A crop of ``shape`` over the trailing axes at a start drawn
    uniformly in [0, dim - size] on each (``op_generator``'s stream, not
    JAX's); SeedOut the ``seed`` attr (int32)."""
    v = x(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    nlead = v.ndim - len(shape)
    gen = op_generator(ctx, attrs)
    starts = [int(torch.randint(max(v.shape[nlead + i] - s, 0) + 1, (1,),
                                generator=gen, device=ctx.device))
              for i, s in enumerate(shape)]
    o = _dynamic_slice(v, [0] * nlead + starts, list(v.shape[:nlead]) + shape)
    return out(Out=o, SeedOut=torch.tensor(int(attrs.get("seed", 0)),
                                           dtype=torch.int32, device=v.device))


# -- lstm_unit --------------------------------------------------------------

@register_op("lstm_unit")
def _lstm_unit(ins, attrs, ctx):
    """One LSTM cell step from X [B, 4D] gates in (i, f, o, g) order and
    C_prev [B, D]; ``forget_bias`` added to f."""
    xv, c_prev = x(ins, "X"), x(ins, "C_prev")
    fb = float(attrs.get("forget_bias", 0.0))
    D = c_prev.shape[1]
    xv = promote_float(xv)
    i = torch.sigmoid(xv[:, :D])
    f = torch.sigmoid(xv[:, D:2 * D] + fb)
    o = torch.sigmoid(xv[:, 2 * D:3 * D])
    g = torch.tanh(xv[:, 3 * D:])
    c = f * c_prev + i * g
    return out(C=c, H=o * torch.tanh(c))


# -- deformable_conv (DCNv2) ------------------------------------------------

@register_op("deformable_conv")
def _deformable_conv(ins, attrs, ctx):
    """DCNv2: each filter tap samples the input bilinearly at its offset
    position (zero outside the image), times its mask, then a grouped
    product with the filter.  The four corners of each sample are gathered
    (no dense sampling matrix); gradients reach the input, the offsets,
    the mask and the filter."""
    # integer inputs sample and multiply in f32, as the JAX rule's
    # where(inb, tap, 0.0) promotes them (bool raises in both)
    v, offset, mask, w = (t if t is None or t.is_floating_point()
                          or t.dtype == torch.bool else t.float()
                          for t in (x(ins, "Input"), x(ins, "Offset"),
                                    x(ins, "Mask"), x(ins, "Filter")))
    s = [int(a) for a in attrs.get("strides", [1, 1])]
    p = [int(a) for a in attrs.get("paddings", [0, 0])]
    d = [int(a) for a in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1))
    dg = int(attrs.get("deformable_groups", 1))
    N, Cin, H, W = v.shape
    Cout, _, kh, kw = w.shape
    K = kh * kw
    Ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    Wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    dev = v.device
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    dy, dx = off[:, :, :, 0], off[:, :, :, 1]
    msk = (torch.ones((N, dg, K, Ho, Wo), dtype=v.dtype, device=dev)
           if mask is None else mask.reshape(N, dg, K, Ho, Wo))
    ti = torch.arange(kh, device=dev).repeat_interleave(kw)
    tj = torch.arange(kw, device=dev).repeat(kh)
    ys = torch.arange(Ho, device=dev) * s[0] - p[0]
    xs = torch.arange(Wo, device=dev) * s[1] - p[1]
    base_y = (ys[None, :, None] + (ti * d[0])[:, None, None]).expand(K, Ho, Wo)
    base_x = (xs[None, None, :] + (tj * d[1])[:, None, None]).expand(K, Ho, Wo)
    py = base_y.to(v.dtype) + dy                    # [N, dg, K, Ho, Wo]
    px = base_x.to(v.dtype) + dx
    cg = Cin // dg
    # each input channel reads its deformable group's positions
    py, px, msk = (t.repeat_interleave(cg, dim=1) for t in (py, px, msk))
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    y0i = saturating_cast(y0, torch.int32).long()
    x0i = saturating_cast(x0, torch.int32).long()
    img = v.reshape(N, Cin, H * W)
    cols = 0.0
    for oy, ox, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0i + oy, x0i + ox
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        tap = torch.gather(img, 2, flat.reshape(N, Cin, -1)).reshape(flat.shape)
        cols = cols + torch.where(inb, tap, 0.0) * wgt
    cols = cols * msk                               # [N, Cin, K, Ho, Wo]
    cpg, opg = Cin // groups, Cout // groups
    o = torch.einsum("ngckhw,gock->ngohw",
                     cols.reshape(N, groups, cpg, K, Ho, Wo),
                     w.reshape(groups, opg, cpg, K))
    return out(Output=o.reshape(N, Cout, Ho, Wo))
