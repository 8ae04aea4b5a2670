"""Op rules on tensors: the losses, tensor utilities, NCHW rearranges and
sequence/CTR extras of ``paddle_tpu/ops/misc_ops.py`` (ROADMAP Queue 1
item 3-B, tranche 5).

Losses: hinge_loss, log_loss, rank_loss, bpr_loss, sigmoid_focal_loss.
Tensor utils: minus, l1_norm, norm, multiplex, reverse, crop,
pad_constant_like, unfold, gather_tree.
Vision/NCHW rearranges: space_to_depth, shuffle_channel, affine_channel.
Sequence/CTR extras: row_conv, conv_shift, cvm.

Parity: operators/hinge_loss_op.cc, log_loss_op.cc, rank_loss_op.cc,
bpr_loss_op.cc, detection/sigmoid_focal_loss_op.cc, minus_op.cc,
l1_norm_op.cc, norm_op.cc, multiplex_op.cc, reverse_op.cc, crop_op.cc,
pad_constant_like_op.cc, unfold_op.cc, gather_tree_op.cc,
space_to_depth_op.h, shuffle_channel_op.cc, affine_channel_op.cc,
row_conv_op.cc, conv_shift_op.cc, cvm_op.h.

A maximum against a constant is ``torch.maximum`` with a tensor, whose
gradient at a tie is halved as ``jnp.maximum``'s (``clamp`` gives it
whole); an absolute value takes ``_abs_like_jax``'s gradient of 1 at 0.
"""

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import out, promote_float, take_clamp, take_steps, x
from .math_ops import _abs_like_jax


def _max0(v):
    """``jnp.maximum(0.0, v)``: ties with 0 take half the gradient."""
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _softplus0(v):
    """``jnp.logaddexp(0.0, v)`` (an integer ``v`` in f32)."""
    v = promote_float(v)
    return torch.logaddexp(torch.zeros_like(v), v)


# -- losses ------------------------------------------------------------------

@register_op("hinge_loss")
def _hinge_loss(ins, attrs, ctx):
    """loss = max(0, 1 - (2 label - 1) logits)."""
    logits, label = x(ins, "Logits"), x(ins, "Labels")
    return out(Loss=_max0(1.0 - (2.0 * label - 1.0) * logits))


@register_op("log_loss")
def _log_loss(ins, attrs, ctx):
    """-l log(p + eps) - (1 - l) log(1 - p + eps)."""
    p, l = promote_float(x(ins, "Predicted")), promote_float(x(ins, "Labels"))
    eps = attrs.get("epsilon", 1e-4)
    return out(Loss=-(l * torch.log(p + eps)
                      + (1.0 - l) * torch.log(1.0 - p + eps)))


@register_op("rank_loss")
def _rank_loss(ins, attrs, ctx):
    """o = left - right; log(1 + exp(o)) - label o."""
    label = x(ins, "Label")
    o = x(ins, "Left") - x(ins, "Right")
    return out(Out=_softplus0(o) - label * o)


@register_op("bpr_loss")
def _bpr_loss(ins, attrs, ctx):
    """Per row i with target y: the mean over j != y of
    -log(sigmoid(x[i, y] - x[i, j])); a target out of range reads
    ``take_along_axis``' fill (NaN)."""
    scores, label = x(ins, "X"), x(ins, "Label")
    N, C = scores.shape
    y = label.reshape(-1).to(torch.int32)
    pos = take_steps(scores, y[:, None])                         # [N, 1]
    lsm = _softplus0(-(pos - scores))
    mask = (torch.arange(C, device=scores.device)[None, :] != y[:, None])
    loss = torch.where(mask, lsm, 0.0).sum(dim=1) / max(C - 1, 1)
    return out(Loss=loss[:, None])


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ins, attrs, ctx):
    """Per-class focal loss of logits [N, C] with int labels [N, 1] (0 the
    background, class c in column c - 1) over max(FgNum, 1); a label of -1
    is ignored (no loss, no gradient)."""
    logits, label, fg = x(ins, "X"), x(ins, "Label"), x(ins, "FgNum")
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    N, C = logits.shape
    lab = label.reshape(-1).to(torch.int32)
    hit = lab[:, None] == (torch.arange(C, device=logits.device)[None, :] + 1)
    p = torch.sigmoid(promote_float(logits))
    ce = _softplus0(torch.where(hit, -logits, logits))
    pt = torch.where(hit, p, 1.0 - p)
    a = torch.where(hit, alpha, 1.0 - alpha)
    fg_num = torch.maximum(fg.reshape(()).to(p.dtype),
                           torch.ones((), dtype=p.dtype, device=p.device))
    loss = a * torch.pow(1.0 - pt, gamma) * ce / fg_num
    return out(Out=torch.where((lab == -1)[:, None], 0.0, loss))


# -- tensor utils ------------------------------------------------------------

@register_op("minus")
def _minus(ins, attrs, ctx):
    return out(Out=x(ins, "X") - x(ins, "Y"))


@register_op("l1_norm")
def _l1_norm(ins, attrs, ctx):
    """The scalar sum of |x| (the gradient 1 at 0, as ``jnp.abs``'s)."""
    return out(Out=_abs_like_jax(x(ins, "X")).sum().reshape(()))


@register_op("norm")
def _norm(ins, attrs, ctx):
    """l2-normalise along ``axis``; Norm holds sqrt(sum x^2 + eps)."""
    v = x(ins, "X")
    axis = int(attrs.get("axis", 1))
    eps = attrs.get("epsilon", 1e-10)
    n = torch.sqrt(torch.square(promote_float(v)).sum(dim=axis, keepdim=True)
                   + eps)
    return out(Out=v / n, Norm=n)


@register_op("multiplex")
def _multiplex(ins, attrs, ctx):
    """out[i] = X[ids[i]][i]; an id out of range reads the nearest
    candidate, as JAX's clamping gather."""
    ids = x(ins, "Ids").reshape(-1).to(torch.int32)
    cands = torch.stack(ins["X"], dim=0)                       # [K, N, D]
    N = cands.shape[1]
    return out(Out=take_clamp(cands, ids, torch.arange(N, device=ids.device)))


@register_op("reverse")
def _reverse_op(ins, attrs, ctx):
    v = x(ins, "X")
    axes = attrs.get("axis", [0])
    axes = [axes] if isinstance(axes, int) else axes
    return out(Out=torch.flip(v, dims=[int(a) for a in axes]))


def _dynamic_slice(v, starts, sizes):
    """``lax.dynamic_slice``: a negative start counts from the end once,
    then each start is clamped to [0, dim - size]."""
    idx = []
    for d, (s, n) in enumerate(zip(starts, sizes)):
        if n > v.shape[d] or n < 0:
            raise ValueError("dynamic_slice: slice size %d outside axis %d "
                             "of size %d" % (n, d, v.shape[d]))
        s = int(s) + v.shape[d] if int(s) < 0 else int(s)
        s = min(max(s, 0), v.shape[d] - n)
        idx.append(slice(s, s + n))
    return v[tuple(idx)]


def _static_slice(v, starts, limits):
    """``lax.slice``: a start or limit outside the axis raises."""
    if len(starts) != v.ndim or len(limits) != v.ndim:
        raise ValueError("slice: %d starts / %d limits for rank %d" % (
            len(starts), len(limits), v.ndim))
    for d, (s, e) in enumerate(zip(starts, limits)):
        if not 0 <= s <= e <= v.shape[d]:
            raise ValueError("slice: [%d, %d) outside axis %d of size %d" % (
                s, e, d, v.shape[d]))
    return v[tuple(slice(int(s), int(e)) for s, e in zip(starts, limits))]


@register_op("crop")
def _crop(ins, attrs, ctx):
    """Crop X to ``shape`` (or Y's) from ``offsets``; an Offsets input
    takes precedence and is clamped into the axis (``dynamic_slice``),
    static offsets past the axis raise (``lax.slice``)."""
    v = x(ins, "X")
    y = x(ins, "Y")
    off_in = x(ins, "Offsets")
    shape = list(y.shape) if y is not None else [int(s) for s in attrs["shape"]]
    if off_in is not None:
        return out(Out=_dynamic_slice(v, off_in.reshape(-1).tolist()[:v.ndim],
                                      shape))
    offsets = [int(o) for o in attrs.get("offsets", [0] * v.ndim)]
    return out(Out=_static_slice(v, offsets,
                                 [o + s for o, s in zip(offsets, shape)]))


@register_op("pad_constant_like")
def _pad_constant_like(ins, attrs, ctx):
    """Y padded at the end of each axis up to X's shape with pad_value
    (cast to Y's dtype, as ``jnp.asarray(value, dtype)``)."""
    big, small = x(ins, "X"), x(ins, "Y")
    val = torch.tensor(attrs.get("pad_value", 0.0)).to(small.dtype).item()
    pads = []
    for b, s in zip(reversed(big.shape), reversed(small.shape)):
        pads += [0, b - s]                  # a negative pad crops
    return out(Out=F.pad(small, pads, value=val))


@register_op("unfold")
def _unfold(ins, attrs, ctx):
    """im2col: [N, C, H, W] -> [N, C kh kw, L], one strided slice a tap
    (any dtype; a zero pad of [up, left, down, right])."""
    v = x(ins, "X")
    kh, kw = attrs["kernel_sizes"]
    sh, sw = attrs.get("strides", [1, 1])
    pads = list(attrs.get("paddings", [0, 0, 0, 0]))
    if len(pads) == 2:
        pads = [pads[0], pads[1], pads[0], pads[1]]
    if len(pads) != 4:
        raise ValueError("unfold: paddings must be [up, left, down, right] "
                         "(unfold_op.cc enforce), got %r" % (pads,))
    pu, pl, pd, pr = pads
    dh, dw = attrs.get("dilations", [1, 1])
    N, C, H, W = v.shape
    vp = F.pad(v, (pl, pr, pu, pd))
    OH = (H + pu + pd - dh * (kh - 1) - 1) // sh + 1
    OW = (W + pl + pr - dw * (kw - 1) - 1) // sw + 1
    cols = [vp[:, :, i * dh:i * dh + (OH - 1) * sh + 1:sh,
               j * dw:j * dw + (OW - 1) * sw + 1:sw].reshape(N, C, OH * OW)
            for i in range(kh) for j in range(kw)]
    return out(Y=torch.stack(cols, dim=2).reshape(N, C * kh * kw, OH * OW))


@register_op("gather_tree")
def _gather_tree(ins, attrs, ctx):
    """Backtrack beam parents so column k holds final beam k's whole token
    history ([T, B, K])."""
    from .beam_search_ops import beam_backtrack

    seqs = beam_backtrack(x(ins, "Ids"), x(ins, "Parents"))     # [B, K, T]
    return out(Out=seqs.permute(2, 0, 1))


# -- vision rearranges -------------------------------------------------------

@register_op("space_to_depth")
def _space_to_depth(ins, attrs, ctx):
    """The darknet reorg mapping of space_to_depth_op.h (not TF's):
    x[b, k, j, i] goes to y[b, k % (C/bs^2), j bs + (k / (C/bs^2)) / bs,
    i bs + (k / (C/bs^2)) % bs], read back as [B, C bs^2, H/bs, W/bs]."""
    v = x(ins, "X")
    bs = int(attrs["blocksize"])
    N, C, H, W = v.shape
    if C % (bs * bs) or H % bs or W % bs:
        raise ValueError("space_to_depth: C % bs^2 and H, W % bs must be 0 "
                         "(space_to_depth_op.cc enforce)")
    oc = C // (bs * bs)
    y = v.reshape(N, bs, bs, oc, H, W).permute(0, 3, 4, 1, 5, 2)
    return out(Out=y.reshape(N, C * bs * bs, H // bs, W // bs))


@register_op("shuffle_channel")
def _shuffle_channel(ins, attrs, ctx):
    """ShuffleNet's [N, G Cg, H, W] -> the (G, Cg) grouping transposed."""
    v = x(ins, "X")
    g = int(attrs.get("group", 1))
    N, C, H, W = v.shape
    v = v.reshape(N, g, C // g, H, W).transpose(1, 2)
    return out(Out=v.reshape(N, C, H, W))


@register_op("affine_channel")
def _affine_channel(ins, attrs, ctx):
    """Per-channel x scale + bias (the frozen-BN form)."""
    v, scale, bias = x(ins, "X"), x(ins, "Scale"), x(ins, "Bias")
    shape = ((1, -1, 1, 1) if attrs.get("data_layout", "NCHW") == "NCHW"
             else (1, 1, 1, -1))
    return out(Out=v * scale.reshape(shape) + bias.reshape(shape))


# -- sequence/CTR extras -----------------------------------------------------

@register_op("row_conv")
def _row_conv(ins, attrs, ctx):
    """Lookahead convolution: out[b, t] = sum_k filter[k] x[b, t + k], zero
    past the row ([B, T, D] padded)."""
    v, filt = x(ins, "X"), x(ins, "Filter")                     # [B,T,D], [K,D]
    B, T, D = v.shape
    acc = torch.zeros_like(v)
    for k in range(filt.shape[0]):
        shifted = torch.cat([v[:, k:], v.new_zeros((B, min(k, T), D))],
                            dim=1)[:, :T]
        acc = acc + shifted * filt[k][None, None, :]
    return out(Out=acc)


@register_op("conv_shift")
def _conv_shift(ins, attrs, ctx):
    """NTM circular convolution: out[i, j] = sum_k x[i, (j + k - K/2) mod
    W] y[i, k]."""
    v, y = x(ins, "X"), x(ins, "Y")                             # [B, W], [B, K]
    K = y.shape[1]
    acc = torch.zeros_like(v)
    for k in range(K):
        acc = acc + torch.roll(v, K // 2 - k, dims=1) * y[:, k:k + 1]
    return out(Out=acc)


@register_op("cvm")
def _cvm(ins, attrs, ctx):
    """X's first two columns are (show, click): with use_cvm they become
    (log(show + 1), log(click + 1) - log(show + 1)) with an identity
    gradient (cvm_op.h's backward copies dY to dX), else they are
    dropped."""
    v = x(ins, "X")
    if attrs.get("use_cvm", True):
        show = torch.log(v[:, :1] + 1.0)
        ctr = torch.log(v[:, 1:2] + 1.0) - show
        head = promote_float(v[:, :2])
        head = head + (torch.cat([show, ctr], dim=1) - head).detach()
        return out(Y=torch.cat([head, v[:, 2:]], dim=1))
    return out(Y=v[:, 2:])
