"""Op rules on tensors: scatter_nd_add, cross_entropy2, center_loss,
data_norm, lod_reset, gru_unit and sequence_reshape (counterparts of
``paddle_tpu/ops/misc_ops2.py``; ROADMAP Queue 1 item 3-B, tranche 5).

Parity: operators/scatter_nd_add_op.cc, cross_entropy_op.h
(HardLabelCrossEntropyForwardFunctor), center_loss_op.cc,
data_norm_op.cc, lod_reset_op.cc, gru_unit_op.cc,
sequence_ops/sequence_reshape_op.cc.
"""

import torch

from ..registry import register_op
from .common import exact_matmul, out, promote_float, take_clamp, x


def scatter_add_rows(ref, idx, upd):
    """``ref.at[tuple(idx[..., k])].add(upd, mode="drop")``: idx [..., K]
    addresses ref's first K axes (a negative index counts from the end
    once; one still outside its axis drops its update); duplicates
    accumulate; updates take ref's dtype."""
    K = idx.shape[-1]
    lead = ref.shape[:K]
    flat = idx.reshape(-1, K).long()
    n = 1
    for s in lead:
        n *= s
    lin = torch.zeros(flat.shape[0], dtype=torch.long, device=ref.device)
    ok = torch.ones(flat.shape[0], dtype=torch.bool, device=ref.device)
    for k, size in enumerate(lead):
        i = flat[:, k]
        i = torch.where(i < 0, i + size, i)
        ok &= (i >= 0) & (i < size)
        lin = lin * size + i.clamp(0, max(size - 1, 0))
    lin = torch.where(ok, lin, n)                        # the dump row
    rest = tuple(ref.shape[K:])
    table = torch.cat([ref.reshape((n,) + rest),
                       ref.new_zeros((1,) + rest)], dim=0)
    upd = upd.reshape((flat.shape[0],) + rest).to(ref.dtype)
    return table.index_add(0, lin, upd)[:n].reshape(ref.shape)


@register_op("scatter_nd_add")
def _scatter_nd_add(ins, attrs, ctx):
    """Out = X with Out[Index[i]] += Updates[i], duplicates accumulating,
    an index out of range dropped."""
    return out(Out=scatter_add_rows(x(ins, "X"), x(ins, "Index"),
                                    x(ins, "Updates")))


@register_op("cross_entropy2")
def _cross_entropy2(ins, attrs, ctx):
    """Y = -log(X[label]) over the last axis (the picked probability floored
    at 1e-20); MatchX the picked probability; ignore_index rows give 0;
    XShape a zero-size tensor whose dims[1:] are X's shape.  A label out of
    range picks the nearest class."""
    p, label = x(ins, "X"), x(ins, "Label")
    ignore = int(attrs.get("ignore_index", -100))
    lab = label.to(torch.int32)
    if lab.ndim == p.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    safe = lab.clamp(0, p.shape[-1] - 1).long()
    match = torch.gather(p, -1, safe[..., None])[..., 0]
    fmatch = promote_float(match)
    y = -torch.log(torch.maximum(fmatch, torch.full((), 1e-20, dtype=fmatch.dtype,
                                                    device=p.device)))
    ign = lab == ignore
    return out(Y=torch.where(ign, 0.0, y)[..., None],
               MatchX=torch.where(ign, 0.0, match)[..., None],
               XShape=p.new_zeros((0,) + tuple(p.shape)))


@register_op("center_loss")
def _center_loss(ins, attrs, ctx):
    """Loss = 0.5 ||x - centers[y]||^2 a sample; with need_update each
    centre moves toward its class: centers[c] += alpha sum_{y_i = c}
    (x_i - centers[c]) / (1 + count_c) (no gradient through the update;
    a label out of range reads the nearest centre and updates none)."""
    feat, label, centers = x(ins, "X"), x(ins, "Label"), x(ins, "Centers")
    rate = x(ins, "CenterUpdateRate")
    alpha = (rate.reshape(()) if rate is not None
             else torch.tensor(float(attrs.get("alpha", 0.5)),
                               dtype=torch.float32, device=feat.device))
    lab = label.reshape(-1).to(torch.int32)
    C = centers.shape[0]
    diff = feat - take_clamp(centers, lab)
    loss = 0.5 * torch.square(diff).sum(dim=1, keepdim=True)
    if attrs.get("need_update", True):
        one = torch.ones(lab.shape[0], 1, dtype=torch.float32, device=feat.device)
        count = scatter_add_rows(torch.zeros(C, 1, dtype=torch.float32,
                                             device=feat.device),
                                 lab[:, None], one)[:, 0]
        acc = scatter_add_rows(torch.zeros_like(centers), lab[:, None],
                               diff.detach())
        centers_out = centers + alpha * acc / (1.0 + count)[:, None]
    else:
        centers_out = centers
    return out(Loss=loss, SampleCenterDiff=diff, CentersOut=centers_out)


@register_op("data_norm")
def _data_norm(ins, attrs, ctx):
    """Normalisation by accumulated batch statistics: means = BatchSum /
    BatchSize, scales = sqrt(BatchSize / BatchSquareSum), Y = (X - means)
    scales.  With ``update_stats`` the post-batch accumulators come out as
    BatchSizeOut / BatchSumOut / BatchSquareSumOut, so that a program's
    state threads through them."""
    v = x(ins, "X")
    bsize, bsum, bsq = (x(ins, "BatchSize"), x(ins, "BatchSum"),
                        x(ins, "BatchSquareSum"))
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    vf = v.float() if v.dtype == torch.bool else v    # as jnp's bool - float
    res = out(Y=(vf - means) * scales, Means=means, Scales=scales)
    if attrs.get("update_stats", False):
        res["BatchSizeOut"] = [bsize + v.shape[0]]
        res["BatchSumOut"] = [bsum + v.sum(dim=0)]
        res["BatchSquareSumOut"] = [bsq + (v * v).sum(dim=0)]
    return res


@register_op("lod_reset")
def _lod_reset(ins, attrs, ctx):
    """The data passes through; the new lengths come out as SeqLenOut: from
    Y, level-0 offsets (as [0, 4, 6] for lengths [4, 2]), which take
    precedence, else from the ``target_lod`` attr."""
    v, y = x(ins, "X"), x(ins, "Y")
    res = out(Out=v)
    if y is not None:
        off = y.reshape(-1).to(torch.int32)
        res["SeqLenOut"] = [off[1:] - off[:-1]]
    elif "target_lod" in attrs:
        lod = attrs["target_lod"]
        res["SeqLenOut"] = [torch.tensor(
            [lod[i + 1] - lod[i] for i in range(len(lod) - 1)],
            dtype=torch.int32, device=v.device)]
    return res


# gru_unit_op.cc declares the activations as int enums
_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


@register_op("gru_unit")
def _gru_unit(ins, attrs, ctx):
    """One GRU step: Input [B, 3D] projected, HiddenPrev [B, D], Weight
    [D, 3D] ([W_u | W_r | W_c]), Bias [1, 3D] optional; the activations by
    name or enum; ``origin_mode`` picks u h + (1 - u) c over
    (1 - u) h + u c."""
    from .rnn_ops import _ACTS

    def act_of(val):
        return _ACTS[_ENUM[val] if isinstance(val, int) else val]

    inp, h, w = x(ins, "Input"), x(ins, "HiddenPrev"), x(ins, "Weight")
    bias = x(ins, "Bias")
    D = h.shape[1]
    if bias is not None:
        inp = inp + bias.reshape(1, -1)
    act_g = act_of(attrs.get("gate_activation", "sigmoid"))
    act_c = act_of(attrs.get("activation", "tanh"))
    u = act_g(inp[:, :D] + exact_matmul(h, w[:, :D]))
    r = act_g(inp[:, D:2 * D] + exact_matmul(h, w[:, D:2 * D]))
    c = act_c(inp[:, 2 * D:] + exact_matmul(r * h, w[:, 2 * D:]))
    if attrs.get("origin_mode", False):
        nh = u * h + (1 - u) * c
    else:
        nh = (1 - u) * h + u * c
    return out(Hidden=nh, Gate=torch.cat([u, r, c], dim=1),
               ResetHiddenPrev=r * h)


@register_op("sequence_reshape")
def _sequence_reshape(ins, attrs, ctx):
    """Each row's [T, D] payload as [T D / new_dim, new_dim] (padded batch:
    the time axis rescales by D / new_dim)."""
    v = x(ins, "X")
    new_dim = int(attrs["new_dim"])
    B, T, D = v.shape
    if (T * D) % new_dim:
        raise ValueError("sequence_reshape: T*D=%d not divisible by "
                         "new_dim=%d" % (T * D, new_dim))
    seq_len = x(ins, "SeqLen")
    res = out(Out=v.reshape(B, (T * D) // new_dim, new_dim))
    if seq_len is not None:
        res["SeqLenOut"] = [torch.div(seq_len.reshape(-1) * D, new_dim,
                                      rounding_mode="floor")]
    return res
